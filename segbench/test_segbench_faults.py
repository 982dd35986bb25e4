"""The comparison refuses what it must: the control (the reference in
the program's place in bfloat16) and runs with the timed path broken
underneath, each at a tiny size on the CPU, through the rest of a run
(the harness's look for a card skipped)."""
import contextlib

import numpy as np
import pytest
import torch

from repro_torch.core import device_search as DS
from repro_torch.serving import coordinator as C

from segbench import control, harness, plant, tiny


@pytest.fixture(scope="module")
def builds():
    torch.set_num_threads(1)
    return tiny.Builds()


def one_round_of_nothing(ds, queries, lut, state, **kw):
    """A search step that returns its state unchanged."""
    return dict(state), None


def half_batch(search):
    """Searches the first half of the batch and hands its answers to the
    second half too."""
    def run(self, queries, k=None):
        h = (queries.shape[0] + 1) // 2
        ids, d, io = search(self, queries[:h], k)
        take = np.arange(queries.shape[0]) % h
        return ids[take], d[take], io[take]
    return run


def altered(anns):
    """Alters one answer where the device search produces it."""
    def run(ds, q, p, **kw):
        r = anns(ds, q, p, **kw)
        ids = r.ids.clone()
        ids[:, 0] = (ids[:, 0] + 1) % ds.block_of.shape[0]
        return r._replace(ids=ids)
    return run


def no_offsets(merge):
    def run(ids, dists, offsets, k):
        return merge(ids, dists, [0] * len(offsets), k)
    return run


FAULTS = {
    "state_unchanged": (DS, "_block_search_loop",
                        lambda f: one_round_of_nothing),
    "half_batch": (C.SegmentServer, "search", half_batch),
    "answer_altered": (C, "device_anns", altered),
}
NODE_FAULTS = {
    "offsets_left_out": (C, "merge_topk", no_offsets),
}
CELLS = ["bigann-1m.stream", "bigann-4x250k.bulk"]


def cases():
    for cell in CELLS:
        for name in FAULTS:
            yield cell, name
    for name in NODE_FAULTS:
        yield "bigann-4x250k.bulk", name


@pytest.mark.parametrize("cell,fault", list(cases()))
def test_a_broken_timed_path_is_not_correct(cell, fault, builds,
                                            monkeypatch):
    c = tiny.cell(cell)
    owner, attr, make = {**FAULTS, **NODE_FAULTS}[fault]
    monkeypatch.setattr(owner, attr, make(getattr(owner, attr)))
    out = tiny.run(c, builds=builds)
    assert out["correct"] is False, out["checks"]


@pytest.mark.parametrize("cell", CELLS)
def test_the_bf16_control_is_not_correct(cell):
    c = tiny.cell(cell)
    ref = harness.plugin("references", c.config["reference"])
    control.size_closed_loop(c, ref, "cpu")
    out = tiny.run(c, seconds=0.2, builds=control.control_builder(ref))
    assert out["correct"] is False
    assert out["checks"]["dist_gap"]["value"] > \
        out["checks"]["dist_gap"]["limit"]


PLANTED = [(cell, name) for cell in CELLS for name in plant.FAULTS
           if name != "one_segment_merged"] + [
    ("bigann-4x250k.bulk", "one_segment_merged")]


def run_planted(c, fault, builds) -> dict:
    """One tiny run with ``fault`` planted in the built node, restored
    afterwards."""
    with contextlib.ExitStack() as stack:
        def build(cfg, base, device, tracer):
            node = builds(cfg, base, device, tracer)
            stack.enter_context(plant.FAULTS[fault](node))
            return node
        return tiny.run(c, builds=build)


@pytest.mark.parametrize("cell,fault", PLANTED)
def test_a_broken_build_product_or_merge_is_not_correct(cell, fault,
                                                        builds):
    """Faults planted in the built node (``segbench.plant``) give exact
    distances but miss the true neighbours: ``recall_miss`` fails, and
    the same node with the fault taken out again passes. At 2,000 rows
    and 8 hops, where the search cannot visit most blocks anyway."""
    c = tiny.cell(cell, n=2000, max_hops=8)
    bad = run_planted(c, fault, builds)
    assert bad["correct"] is False, bad["checks"]
    assert bad["checks"]["recall_miss"]["value"] > \
        bad["checks"]["recall_miss"]["limit"]
    assert tiny.run(c, builds=builds)["correct"] is True


def test_a_merge_that_drops_segments_shows_in_recall(builds):
    """Answers from one segment alone are exact but miss the others'
    neighbours: ``recall_at_10`` falls by far more than its bound, and
    the recall floor of ``correct`` refuses the run."""
    c = tiny.cell("bigann-4x250k.bulk", n=2000, max_hops=8)
    whole = tiny.run(c, builds=builds)["metrics"]["recall_at_10"]["value"]
    out = run_planted(c, "one_segment_merged", builds)
    assert out["metrics"]["recall_at_10"]["value"] < 0.5 * whole
    assert out["correct"] is False, out["checks"]
