"""The `rounds_per_batch.bulk` metric in `bigann-4x250k.bulk`
(`segbench.reduce.rounds_per_batch`)."""
from segbench.reduce import rounds_per_batch as read  # noqa: F401
