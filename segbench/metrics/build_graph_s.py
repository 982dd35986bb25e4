"""The `build_graph_s` metric (`segbench.reduce.build_graph_s`)."""
from segbench.reduce import build_graph_s as read  # noqa: F401
