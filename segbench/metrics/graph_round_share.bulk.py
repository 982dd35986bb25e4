"""The `graph_round_share.bulk` metric in `bigann-4x250k.bulk`
(`segbench.graph_rounds.graph_round_share`)."""
from segbench.graph_rounds import graph_round_share as read  # noqa: F401
