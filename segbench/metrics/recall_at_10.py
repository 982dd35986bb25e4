"""The `recall_at_10` metric (`segbench.reduce.recall_at_10`)."""
from segbench.reduce import recall_at_10 as read  # noqa: F401
