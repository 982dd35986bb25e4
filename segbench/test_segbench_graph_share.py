"""The ``graph_round_share`` reader (``segbench.graph_rounds``) on
hand-made spans: the share of the ``search.round`` spans, in the batches
before the traced sub-window, whose ``graph`` arg is true."""
import pytest

from segbench import graph_rounds as G
from segbench import harness
from segbench.test_segbench_spans import run_of

NAMES = ["graph_round_share.stream", "graph_round_share.bulk"]


def with_graph_args(run, graphed):
    """Sets each round's ``graph`` arg to ``graphed(t)``, ``t`` its
    round in its segment search."""
    for e in run.spans:
        if e.name == "search.round":
            e.args["graph"] = graphed(e.args["t"])
    return run


def test_the_share_of_rounds_replayed_from_a_graph():
    # the first round of each search eager, as through a new entry; the
    # sub-window's batch (three rounds) is not read
    run = with_graph_args(run_of([[4], [2, 3]]), lambda t: t > 0)
    assert G.graph_round_share(run) == pytest.approx((3 + 1 + 2) / 9)
    run = with_graph_args(run_of([[4], [2, 3]]), lambda t: True)
    assert G.graph_round_share(run) == 1.0
    run = with_graph_args(run_of([[5]]), lambda t: False)
    assert G.graph_round_share(run) == 0.0


def test_rounds_without_the_arg_read_nothing():
    assert G.graph_round_share(run_of([[4], [2, 3]])) is None
    run = run_of([[4]])
    run.spans = [e for e in run.spans if e.name != "search.round"]
    for b in run.rec.batches:
        b["spans"] = (0, len(run.spans))
    assert G.graph_round_share(run) is None


@pytest.mark.parametrize("name", NAMES)
def test_metric_files_are_the_reader(name):
    read = harness.plugin("metrics", name).read
    assert read is G.graph_round_share
    run = with_graph_args(run_of([[3]]), lambda t: t != 1)
    assert read(run) == pytest.approx(2 / 3)
