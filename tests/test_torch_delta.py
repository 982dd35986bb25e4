"""The port's mutable delta segment (``repro_torch.core.delta``:
``DeltaSegment``, ``swap_into_host_server``, ``swap_into_device_server``)
against the JAX package's (``repro.core.delta``), on the CPU.

The cases of ``tests/test_hybrid.py`` — insert, delete and search; the
compaction against a fresh build of the live set; the scheduler's window
after a device swap — run as one scenario per package on the same
segment: JAX's build of the hybrid setup (600 Gaussian vectors of width
24, the default ``SegmentParams``) carried across with ``save_segment``
-> ``load_segment``. Their records must be equal: the live set, ``gids``,
``num_deleted``, the search's ids and every per-query ``IOStats`` field,
its distances within rtol 1e-5 / atol 1e-4 (the hot route's beam sums
each distance in another order than numpy's einsum), the scheduler's
window, decision and pack. On integer data (every f32 distance exact)
the compacted segment equals JAX's compaction stage by stage, and the
host server swapped onto it serves JAX's answers.
"""
import dataclasses
from types import SimpleNamespace

import numpy as np
import pytest

import repro.core  # noqa: F401  (the JAX package's import order)
from repro.core import delta as JDL
from repro.core import device_search as JDS
from repro.core import params as JP
from repro.core import segment as JSEG
from repro.serving import coordinator as JC
from repro.serving import scheduler as JSCH
from tests.test_torch_build import (_ints, _same_segment, _t_params_all,
                                    int_segment_params)

from repro_torch.core import delta as TDL
from repro_torch.core import device_search as TDS
from repro_torch.core import params as TP
from repro_torch.core import segment as TSEG
from repro_torch.serving import coordinator as TC
from repro_torch.serving import scheduler as TSCH

N, DIM, K = 600, 24, 10
CPU = "cpu"

JAX = SimpleNamespace(
    name="jax", DL=JDL, DS=JDS, P=JP,
    wrap=lambda seg, p: JDL.DeltaSegment.wrap(seg, p),
    from_segment=lambda seg, **kw: JDS.from_segment(seg, **kw),
    server=lambda **kw: JC.SegmentServer(**kw),
    host_server=lambda seg: JC.HostSegmentServer.from_segment(seg, 0),
    Scheduler=JSCH.RepackScheduler)
TORCH = SimpleNamespace(
    name="torch", DL=TDL, DS=TDS, P=TP,
    wrap=lambda seg, p: TDL.DeltaSegment.wrap(seg, p, device=CPU),
    from_segment=lambda seg, **kw: TDS.from_segment(seg, device=CPU, **kw),
    server=lambda **kw: TC.SegmentServer(device=CPU, **kw),
    host_server=lambda seg: TC.HostSegmentServer.from_segment(
        seg, 0, device=CPU),
    Scheduler=TSCH.RepackScheduler)


def _carry(jseg, tmp_path_factory):
    path = tmp_path_factory.mktemp("delta") / "seg.npz"
    JSEG.save_segment(jseg, str(path))
    return TSEG.load_segment(str(path), _t_params_all(jseg.params))


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    """``tests/test_hybrid.py``'s ``hybrid_setup`` in both packages."""
    rng = np.random.default_rng(7)
    x = rng.standard_normal((N, DIM)).astype(np.float32)
    q = rng.standard_normal((12, DIM)).astype(np.float32)
    jseg = JSEG.build_segment(x, JP.SegmentParams())
    d2 = ((q[:, None, :] - x[None, :, :]) ** 2).sum(-1)
    truth = np.argsort(d2, axis=1)[:, :K]
    return x, q, truth, {"jax": jseg,
                         "torch": _carry(jseg, tmp_path_factory)}


@pytest.fixture(scope="module")
def int_setup(tmp_path_factory):
    """A JAX segment over integer vectors (every f32 distance exact),
    and its carried twin with the same build parameters."""
    x = _ints(400, 16, seed=1)
    jseg = JSEG.build_segment(x, int_segment_params())
    return x, _ints(8, 16, seed=2), {"jax": jseg,
                                    "torch": _carry(jseg, tmp_path_factory)}


def _stats(stats):
    return [dataclasses.asdict(s) for s in stats]


def _same_search(a, b):
    """(ids, dists, stats) of the two packages: ids and IOStats equal,
    distances within the hot route's tolerance."""
    np.testing.assert_array_equal(a[0], b[0])
    np.testing.assert_allclose(a[1], b[1], rtol=1e-5, atol=1e-4)
    assert a[2] == b[2]


def _insert_delete_search(m, seg, q, truth):
    """``test_delta_insert_delete_search`` as a scenario: its record."""
    d = m.wrap(seg, m.P.HotTierParams(budget_frac=0.10))
    p = seg.params.search
    rec = {}
    new = np.random.default_rng(3).standard_normal((4, DIM)).astype(
        np.float32)
    gids = d.insert(new)
    rec["gids"] = gids.tolist()
    assert rec["gids"] == [N, N + 1, N + 2, N + 3]
    ids, dists, st = d.search(new[:1], 3, p)
    assert int(ids[0, 0]) == N and float(dists[0, 0]) == 0.0
    rec["self"] = (ids, dists, _stats(st))
    victim = int(truth[0, 0])
    rec["deletes"] = [d.delete(victim), d.delete(int(gids[1])),
                      d.delete(victim), d.delete(10 ** 6), d.delete(-1)]
    assert rec["deletes"] == [True, True, False, False, False]
    ids, dists, st = d.search(q, K, p)
    assert victim not in ids and int(gids[1]) not in ids
    rec["search"] = (ids, dists, _stats(st))
    rec["census"] = (d.live_count, d.num_deleted, d.base_n, d.next_gid)
    assert d.live_count == N + 4 - 2
    ids, dists, st = d.search(q[:2], K, p)
    assert all(s["hot_tier_hits"] > 0 for s in _stats(st))
    rec["two"] = (ids, dists, _stats(st))
    x_live, live_gids = d.live_vectors()
    rec["live"] = (x_live, live_gids)
    return rec


def test_delta_insert_delete_search_equals_jax(setup):
    _, q, truth, segs = setup
    jr, tr = (_insert_delete_search(m, segs[m.name], q, truth)
              for m in (JAX, TORCH))
    assert tr["gids"] == jr["gids"] and tr["deletes"] == jr["deletes"]
    assert tr["census"] == jr["census"]
    for key in ("self", "search", "two"):
        _same_search(tr[key], jr[key])
    for a, b in zip(tr["live"], jr["live"]):
        np.testing.assert_array_equal(a, b)


def _compact(m, seg, new, victims):
    d = m.wrap(seg, m.P.HotTierParams(budget_frac=0.10))
    gids = d.insert(new)
    for g in victims(gids):
        assert d.delete(g)
    live = d.live_vectors()
    compacted, live_gids = d.compact()
    return d, live, compacted, live_gids


def test_delta_compact_bit_identical_to_fresh_build(setup):
    """insert -> delete -> ``compact()`` equals a fresh port build of the
    live set; the live set and ``gids`` equal JAX's."""
    x, _, _, segs = setup
    new = np.random.default_rng(5).standard_normal((6, DIM)).astype(
        np.float32)
    victims = lambda gids: (0, 17, int(gids[2]))                # noqa: E731
    d, live, compacted, live_gids = _compact(TORCH, segs["torch"], new,
                                             victims)
    keep = np.ones(N, bool)
    keep[[0, 17]] = False
    x_live = np.concatenate([x[keep], new[[0, 1, 3, 4, 5]]]).astype(
        np.float32)
    np.testing.assert_array_equal(live[0], x_live)
    assert live_gids.shape[0] == x_live.shape[0] == d.live_count
    fresh = TSEG.build_segment(x_live, segs["torch"].params, device=CPU)
    for f in ("vid", "vecs", "meta", "blocks", "block_of", "slot_of", "adj",
              "deg", "pq_codes", "pq_cent", "nav_ids", "nav_adj", "nav_deg",
              "nav_vecs"):
        np.testing.assert_array_equal(getattr(compacted, f),
                                      getattr(fresh, f), err_msg=f)
    assert (compacted.entry, compacted.nav_entry) == (fresh.entry,
                                                      fresh.nav_entry)
    jd = JDL.DeltaSegment.wrap(segs["jax"], JP.HotTierParams(
        budget_frac=0.10))
    jgids = jd.insert(new)
    for g in victims(jgids):
        jd.delete(g)
    jx, jg = jd.live_vectors()
    np.testing.assert_array_equal(live[0], jx)
    np.testing.assert_array_equal(live_gids, jg)
    assert d.num_deleted == jd.num_deleted == 3


def test_delta_compact_on_integer_data_equals_jax(int_setup):
    """On integer data the port's compaction equals JAX's, stage by
    stage (graph, layout, store, navigation graph, PQ)."""
    x, _, segs = int_setup
    new = _ints(5, 16, seed=3)
    victims = lambda gids: (3, 40, 41, int(gids[1]))             # noqa: E731
    _, jl, jseg, jg = _compact(JAX, segs["jax"], new, victims)
    _, tl, tseg, tg = _compact(TORCH, segs["torch"], new, victims)
    for a, b in zip(tl, jl):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(tg, jg)
    assert tseg.num_vectors == 400 + 5 - 4
    _same_segment(tseg, jseg)
    assert not np.isin(tg, [3, 40, 41]).any()


def _host_swap(m, seg, compacted, q):
    server = m.host_server(seg)
    before = server.search(q, 5)
    sched = m.Scheduler(m.P.RepackParams(min_observed=1))
    m.DL.swap_into_host_server(server, compacted, scheduler=sched)
    assert server.view is compacted.view
    assert server.num_vectors == compacted.num_vectors
    assert server.params == compacted.params.search
    ids, dists, io = server.search(q, 5)
    return before, (ids, dists, io, _stats(server.last_stats))


def test_swap_into_host_server_equals_jax(int_setup):
    x, q, segs = int_setup
    new = _ints(5, 16, seed=3)
    victims = lambda gids: (3, 40, int(gids[0]))                  # noqa: E731
    recs = []
    for m in (JAX, TORCH):
        _, _, compacted, _ = _compact(m, segs[m.name], new, victims)
        recs.append(_host_swap(m, segs[m.name], compacted, q))
    (jb, ja), (tb, ta) = recs
    for a, b in zip(tb, jb):
        np.testing.assert_array_equal(a, b)
    for a, b in zip(ta[:3], ja[:3]):
        np.testing.assert_array_equal(a, b)
    assert ta[3] == ja[3]


def _device_swap(m, seg):
    """``test_scheduler_drops_stale_window_on_layout_swap`` as a
    scenario: the window, the forced decision and the pack after it."""
    ds = m.from_segment(seg, tier0_frac=0.2)
    server = m.server(segment=ds, offset=0, num_vectors=N, host=seg)
    sched = m.Scheduler(m.P.RepackParams(min_observed=1))
    sched.attach_target(server)
    old_total = int(seg.view.store.num_blocks)
    sched._window.update({b: 50 for b in range(old_total - 4, old_total)})
    sched._window.update({1: 7, 2: 3})
    d = m.wrap(seg, m.P.HotTierParams(budget_frac=0.10))
    for g in range(0, N, 2):
        d.delete(g)
    compacted, gids = d.compact()
    new_total = int(compacted.view.store.num_blocks)
    assert new_total < old_total
    m.DL.swap_into_device_server(server, compacted, scheduler=sched,
                                 tier0_frac=0.2)
    assert server.host is compacted and server.num_vectors == N // 2
    window = dict(sched._window)
    assert all(0 <= b < new_total for b in window)
    decision = sched.maybe_repack(force=True)
    assert decision is not None
    pack = sorted(m.DS.hot_pack_blocks(server.segment))
    assert all(0 <= b < new_total for b in pack)
    return {"window": window, "decision": dataclasses.asdict(decision),
            "pack": pack, "gids": gids.tolist(), "total": new_total,
            "stats": sched.stats()}


def test_scheduler_window_after_device_swap_equals_jax(setup):
    segs = setup[3]
    jr, tr = (_device_swap(m, segs[m.name]) for m in (JAX, TORCH))
    assert tr["window"] == jr["window"] == {1: 7, 2: 3}
    assert tr["decision"] == jr["decision"]
    assert tr == jr


def test_device_swap_keeps_hot_tier_and_tombstones(setup):
    """A property of the reference, kept: the device swap re-packs the
    arrays but leaves a hybrid server's hot tier and tombstones as they
    are (both packages)."""
    segs = setup[3]
    for m in (JAX, TORCH):
        seg = segs[m.name]
        d = m.wrap(seg, m.P.HotTierParams(budget_frac=0.10))
        tomb = np.zeros(N, bool)
        tomb[5] = True
        server = m.server(segment=m.from_segment(seg, tier0_frac=0.1),
                          offset=0, num_vectors=N, host=seg, hot_tier=d.hot,
                          tombstones=tomb)
        assert d.delete(5)
        compacted, _ = d.compact()
        m.DL.swap_into_device_server(server, compacted, tier0_frac=0.1)
        assert server.hot_tier is d.hot and server.tombstones is tomb
        assert int(server.segment.vid.shape[0]) == compacted.view.store \
            .num_blocks
