"""The `syncs_per_round.stream` metric in `bigann-1m.stream`
(`segbench.spans.syncs_per_round`)."""
from segbench.spans import syncs_per_round as read  # noqa: F401
