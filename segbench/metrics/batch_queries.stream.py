"""The `batch_queries.stream` metric in `bigann-1m.stream`
(`segbench.reduce.batch_queries`)."""
from segbench.reduce import batch_queries as read  # noqa: F401
