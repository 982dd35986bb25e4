"""The share of the round loop's rounds replayed from a CUDA graph (the
port's ``core.device_search``: the ``graph`` arg of each
``search.round`` span), over the batches that ``segbench.spans``' readers
read; ``None`` where no round carries the arg, as in a program that
replays no round."""
from __future__ import annotations

from typing import Optional

from segbench import spans


def graph_round_share(run) -> Optional[float]:
    graphed = rounds = 0
    for b in spans._batches(run):
        for e in run.batch_spans(b):
            if e.name == "search.round" and "graph" in e.args:
                rounds += 1
                graphed += bool(e.args["graph"])
    return graphed / rounds if rounds else None
