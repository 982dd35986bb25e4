"""The `launches_per_round.bulk` metric in `bigann-4x250k.bulk`
(`segbench.reduce.launches_per_round`)."""
from segbench.reduce import launches_per_round as read  # noqa: F401
