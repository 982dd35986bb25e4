"""The `latency_p95_ms` metric (`segbench.reduce.latency_p95_ms`)."""
from segbench.reduce import latency_p95_ms as read  # noqa: F401
