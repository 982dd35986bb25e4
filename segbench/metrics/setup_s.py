"""The `setup_s` metric (`segbench.reduce.setup_s`)."""
from segbench.reduce import setup_s as read  # noqa: F401
