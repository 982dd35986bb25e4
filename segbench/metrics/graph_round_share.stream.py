"""The `graph_round_share.stream` metric in `bigann-1m.stream`
(`segbench.graph_rounds.graph_round_share`)."""
from segbench.graph_rounds import graph_round_share as read  # noqa: F401
