"""The `io_per_query.bulk` metric in `bigann-4x250k.bulk`
(`segbench.reduce.io_per_query`)."""
from segbench.reduce import io_per_query as read  # noqa: F401
