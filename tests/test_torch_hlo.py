"""The port's op-trace analyzer (``repro_torch.distributed.hlo``) against
the JAX package's HLO analyzer on the CPU.

Replays of ``tests/test_distributed.py``'s two analyzer cases: seven
``tanh(c @ w)`` in a Python loop give exactly 7 x 2 x 64 x 128 x 128
FLOPs (JAX needs the scan's trip count; the loop runs every iteration);
an all-gather, an all-reduce and a reduce-scatter of that test's shapes
on a fake 128-rank group in groups of 16 give the bytes JAX's
``analyze_hlo`` gives on that test's text. Also ``count_ops``,
``collective_summary``, a saved trace, per-rank counting of a DTensor
product and the views left out of ``bytes_fused``.
"""
import contextlib

import numpy as np
import pytest
import torch
import torch.distributed as dist

from repro_torch.distributed import hlo as TH

# tests/test_distributed.py's synthetic module, as that test writes it
HLO_TEXT = """
HloModule test, entry_computation_layout={()->f32[]}

ENTRY %main.1 () -> f32[] {
  %x = f32[1024]{0} parameter(0)
  %ag = f32[16384]{0} all-gather(%x), replica_groups=[8,16]<=[128], dimensions={0}
  %ar = f32[1024]{0} all-reduce(%x), replica_groups=[8,16]<=[128], to_apply=%add
  %rs = f32[64]{0} reduce-scatter(%x), replica_groups=[8,16]<=[128], dimensions={0}
}
"""


@contextlib.contextmanager
def fake_group(size):
    from torch.testing._internal.distributed.fake_pg import FakeStore
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=size)
    try:
        yield
    finally:
        dist.destroy_process_group()


def test_loop_flops_exact():
    c = torch.ones((64, 128))
    w = torch.ones((128, 128))
    with TH.OpTrace() as tr:
        for _ in range(7):
            c = torch.tanh(c @ w)
    t = TH.analyze_trace(tr.ops)
    assert t.flops == 7 * 2 * 64 * 128 * 128
    assert TH.count_ops(tr.ops, "mm") == 7
    assert TH.count_ops(tr.ops, "tanh") == 7


def _collectives_trace():
    """All-gather, all-reduce, reduce-scatter of a [1024] f32 over the
    16-rank groups of a (8, 16) mesh on a fake group of 128."""
    import torch.distributed._functional_collectives as fc
    from torch.distributed.device_mesh import init_device_mesh
    mesh = init_device_mesh("cpu", (8, 16), mesh_dim_names=("a", "b"))
    x = torch.ones(1024)
    with TH.OpTrace() as tr:
        ag = fc.all_gather_tensor(x, 0, (mesh, 1))
        ar = fc.all_reduce(x, "sum", (mesh, 1))
        rs = fc.reduce_scatter_tensor(x, "sum", 0, (mesh, 1))
        for t in (ag, ar, rs):
            fc.wait_tensor(t)
    assert ag.shape == (16384,) and rs.shape == (64,)
    return tr.ops


def test_collective_bytes_equal_jax():
    """Per kind, the bytes and counts JAX's ``analyze_hlo`` gives on
    ``tests/test_distributed.py``'s text."""
    from repro.distributed.hlo import analyze_hlo
    with fake_group(128):
        ops = _collectives_trace()
    want = analyze_hlo(HLO_TEXT)
    got = TH.analyze_trace(ops)
    assert set(got.per_collective) == set(want.per_collective)
    for k, v in want.per_collective.items():
        assert got.per_collective[k]["bytes"] == v["bytes"], k
        assert got.per_collective[k]["count"] == v["count"], k
    assert got.collective_bytes == want.collective_bytes
    assert [op.group for op in ops if op.name in TH._COLLECTIVES] == [16] * 3


def test_collective_summary_and_count_ops():
    from repro.distributed.hlo import collective_summary as jsummary
    with fake_group(128):
        ops = _collectives_trace()
    assert TH.collective_summary(ops) == jsummary(HLO_TEXT)
    total, per = TH.collective_bytes(ops)
    assert total == 16384 * 4 // 16 + 1024 * 4 + 64 * 4 * 16
    assert per["all-gather"] == {"count": 1, "bytes": 16384 * 4 // 16}
    for kind in ("all-gather", "all-reduce", "reduce-scatter"):
        assert TH.count_ops(ops, kind) == 1
    assert TH.count_ops(ops, "all-to-all") == 0


def test_dtensor_product_counts_one_rank():
    """A product of a row-sharded [2048, 8192] and a column-sharded
    [8192, 1024] on a fake (16, 16) mesh under ``FakeTensorMode``: the
    trace holds the rank's local product (1/256 of the global FLOPs) and
    the collective its redistribution makes; nothing is allocated."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import DTensor, Replicate, Shard
    with fake_group(256):
        mesh = init_device_mesh("cpu", (16, 16), mesh_dim_names=("data",
                                                                "model"))
        with FakeTensorMode():
            a = DTensor.from_local(torch.empty(128, 8192), mesh,
                                   (Shard(0), Replicate()), run_check=False)
            w = DTensor.from_local(torch.empty(8192, 64), mesh,
                                   (Replicate(), Shard(1)), run_check=False)
            with TH.OpTrace() as tr:
                y = a @ w
                y.redistribute(mesh, (Shard(0), Replicate()))
    t = TH.analyze_trace(tr.ops)
    assert t.flops == 2 * 128 * 64 * 8192
    assert t.flops * 256 == 2 * 2048 * 1024 * 8192
    assert TH.count_ops(tr.ops, "all-gather") == 1
    assert t.per_collective["all-gather"]["bytes"] == 128 * 64 * 4


def test_views_are_left_out_of_fused_bytes_and_trace_round_trips(tmp_path):
    x = torch.ones((4, 8))
    with TH.OpTrace() as tr:
        y = x.view(8, 4).t()
        z = y + 1
    t = TH.analyze_trace(tr.ops)
    each = 4 * 8 * 4
    assert t.bytes_accessed == 2 * each + 2 * each + 2 * each
    assert t.bytes_fused == 2 * each            # the add's operand, result
    assert set(t.bytes_by_op) == {"add"}
    path = str(tmp_path / "t.trace.gz")
    TH.save_trace(path, tr.ops)
    back = TH.load_trace(path)
    assert back == tr.ops
    assert TH.analyze_trace(back).bytes_fused == t.bytes_fused
    np.testing.assert_array_equal(z.numpy(), np.ones((4, 8)) * 2)


@pytest.mark.parametrize("name,shapes,want", [
    ("mm", [((64, 32), "float32"), ((32, 16), "float32")],
     2 * 64 * 16 * 32),
    ("bmm", [((3, 64, 32), "float32"), ((3, 32, 16), "float32")],
     2 * 3 * 64 * 16 * 32),
    ("addmm", [((16,), "float32"), ((64, 32), "float32"),
               ((32, 16), "float32")], 2 * 64 * 16 * 32),
    ("baddbmm", [((3, 64, 16), "float32"), ((3, 64, 32), "float32"),
                 ((3, 32, 16), "float32")], 2 * 3 * 64 * 16 * 32),
])
def test_dot_flops_of_each_matmul_op(name, shapes, want):
    out = {"mm": (64, 16), "bmm": (3, 64, 16), "addmm": (64, 16),
           "baddbmm": (3, 64, 16)}[name]
    op = TH.Op(name, shapes, [(out, "float32")])
    assert TH.analyze_trace([op]).flops == want
