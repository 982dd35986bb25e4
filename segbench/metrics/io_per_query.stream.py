"""The `io_per_query.stream` metric in `bigann-1m.stream`
(`segbench.reduce.io_per_query`)."""
from segbench.reduce import io_per_query as read  # noqa: F401
