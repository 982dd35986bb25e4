"""The `rounds_per_batch.stream` metric in `bigann-1m.stream`
(`segbench.reduce.rounds_per_batch`)."""
from segbench.reduce import rounds_per_batch as read  # noqa: F401
