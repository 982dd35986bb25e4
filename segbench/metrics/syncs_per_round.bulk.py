"""The `syncs_per_round.bulk` metric in `bigann-4x250k.bulk`
(`segbench.spans.syncs_per_round`)."""
from segbench.spans import syncs_per_round as read  # noqa: F401
