"""The `launches_per_round.stream` metric in `bigann-1m.stream`
(`segbench.reduce.launches_per_round`)."""
from segbench.reduce import launches_per_round as read  # noqa: F401
