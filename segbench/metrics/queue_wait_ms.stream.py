"""The `queue_wait_ms.stream` metric in `bigann-1m.stream`
(`segbench.reduce.queue_wait_ms`)."""
from segbench.reduce import queue_wait_ms as read  # noqa: F401
