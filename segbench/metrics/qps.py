"""The `qps` metric (`segbench.reduce.qps`)."""
from segbench.reduce import qps as read  # noqa: F401
