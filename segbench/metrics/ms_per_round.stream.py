"""The `ms_per_round.stream` metric in `bigann-1m.stream`
(`segbench.reduce.ms_per_round`)."""
from segbench.reduce import ms_per_round as read  # noqa: F401
