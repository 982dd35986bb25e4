"""The port's accounting layer (``repro_torch.core.iostats``,
``repro_torch.obs.roundlog``) against the JAX package's
(``repro.core.iostats``, ``repro.obs.roundlog``).

The unit cases of ``tests/test_accounting.py`` (merge, the trip
invariant, ``from_device*``, the dedup and speculation columns, the
pricing regimes) and seeded random columns run through both packages:
every ``IOStats`` must be equal field for field, and both constant sets
must price it the same (``latency_us`` and ``breakdown``, plain and
pipelined). Then the served path: on the conformance segment the port's
``SegmentServer.batch_stats`` fold to the JAX server's ``IOStats`` and to
``GOLDEN_DEVICE``, and with ``trace_rounds`` the port's round log folds
to JAX's records and holds the invariants of ``tests/
test_trace_roundlog.py``.
"""
import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.core import device_search as DS
from repro.core import iostats as JI
from repro.core.segment import save_segment
from repro.obs import roundlog as JR
from repro.serving import SegmentServer
from test_e2e_conformance import GOLDEN_DEVICE, P_CONF
from test_torch_device_search import COUNTERS, _tparams
from test_trace_roundlog import P as P_TRACE

import repro_torch.obs as TO
from repro_torch.core import device_search as TDS
from repro_torch.core import iostats as TI
from repro_torch.core.segment import load_segment
from repro_torch.obs import roundlog as TR
from repro_torch.serving.coordinator import SegmentServer as TServer

MODELS = ("NVME_SEGMENT", "TPU_HBM_SEGMENT")


def _same(got, want) -> None:
    """Port and JAX stats equal field for field, with the same derived
    rates, and priced the same by both constant sets."""
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert got.cache_hit_rate == want.cache_hit_rate
    assert got.vertex_utilization == want.vertex_utilization
    for name in MODELS:
        tm, jm = getattr(TI, name), getattr(JI, name)
        for pipeline in (False, True):
            assert tm.latency_us(got, pipeline) == jm.latency_us(
                want, pipeline), (name, pipeline)
            assert tm.breakdown(got, pipeline) == jm.breakdown(
                want, pipeline), (name, pipeline)


def _fold(m, bs):
    """One served batch's columns folded as ``repro.serving.scheduler.
    RepackScheduler.note_batch`` folds a target's ``batch_stats``."""
    return m.IOStats.from_device_batch(
        np.asarray(bs["io"]), np.asarray(bs["tier0_hits"]),
        np.asarray(bs["hops"]), np.asarray(bs["dedup_saved"]),
        int(bs["rounds"]), np.asarray(bs["dedup_cross"]),
        bool(bs.get("dma_pipelined", False)), np.asarray(bs["spec_hits"]),
        np.asarray(bs["spec_wasted"]), bool(bs.get("dma_speculative", False)),
        np.asarray(bs["hot_tier_hits"]))


# ------------------------------------------------ the unit cases, by name
# each takes an iostats module and returns the stats it builds

def _merge(m):
    a = m.IOStats(block_reads=5, cache_misses=5, dedup_saved_fetches=2,
                  rounds_active_weight=0.5, inflight_peak=3,
                  batch_rounds=10, hops=4, hops_to_best=2)
    b = m.IOStats(block_reads=3, cache_misses=3, dedup_saved_fetches=1,
                  rounds_active_weight=0.75, inflight_peak=7,
                  batch_rounds=6, hops=6, hops_to_best=5)
    a.merge(b)
    return [a, b]


def _from_device(m):
    return [m.IOStats.from_device(10, 3, 6, 2, 8),
            m.IOStats.from_device(4, 0, 4, 0, 0),
            m.IOStats.from_device(6, 2, 6, 0, 9, hot_tier=7)]


def _from_device_batch(m):
    return [m.IOStats.from_device_batch([10, 4, 0], [3, 1, 0], [6, 8, 0],
                                        [2, 0, 0], 8)]


def _dedup_split(m):
    a = m.IOStats.from_device(10, 0, 5, 4, 8, dedup_cross=3)
    b = m.IOStats.from_device(6, 0, 4, 2, 8, dedup_cross=1)
    a.merge(b)
    return [a, m.IOStats.from_device(5, 0, 3, 2, 8, dedup_cross=9)]


def _pipelined(m):
    a = m.IOStats.from_device(4, 0, 2, 0, 4, pipelined=True)
    a.merge(m.IOStats.from_device(4, 0, 2, 0, 4, pipelined=True))
    cols = ([10, 4, 0], [3, 1, 0], [6, 8, 0], [2, 1, 0], 8)
    return [a, m.IOStats.from_device(4, 0, 2, 0, 4),
            m.IOStats.from_device_batch(*cols, [1, 1, 0], True),
            m.IOStats.from_device_batch(*cols),
            m.IOStats.from_device_batch(*cols[:4], 8, pipelined=True)]


def _speculative(m):
    io, t0, hops, sv, cx = [10, 4, 0], [3, 1, 0], [6, 8, 0], [2, 1, 0], \
        [1, 1, 0]
    a = m.IOStats.from_device(10, 0, 5, 2, 8, spec_hits=3, spec_wasted=1,
                              speculative=True)
    a.merge(m.IOStats.from_device(6, 0, 4, 1, 8, spec_hits=2,
                                  spec_wasted=4, speculative=True))
    cols = ([10, 4], [3, 1], [6, 8], [2, 0], 8)
    return [
        m.IOStats.from_device(10, 0, 5, 4, 8, spec_hits=9, spec_wasted=3,
                              speculative=True), a,
        m.IOStats.from_device_batch(io, t0, hops, sv, 8, cx, False,
                                    [3, 1, 0], [2, 0, 0], True),
        m.IOStats.from_device_batch(io, t0, hops, sv, 8, cx),
        m.IOStats.from_device_batch(*cols, pipelined=True, spec_hits=[4, 2],
                                    spec_wasted=[0, 0], speculative=True),
        m.IOStats.from_device_batch(*cols, pipelined=True, spec_hits=[0, 0],
                                    spec_wasted=[0, 0], speculative=True),
        m.IOStats.from_device_batch(*cols, pipelined=True, spec_hits=[4, 2],
                                    spec_wasted=[3, 2], speculative=True),
        m.IOStats.from_device_batch(*cols, spec_hits=[4, 2],
                                    spec_wasted=[1, 0], speculative=True),
        m.IOStats.from_device(6, 2, 6, 0, 0, spec_hits=3, speculative=True)]


def _round_granular(m):
    agg = m.IOStats.from_device_batch([10, 4], [3, 1], [6, 8], [2, 0], 8)
    rdev = m.IOStats.from_device(6, 2, 6, 0, 9)
    return [agg, dataclasses.replace(
                agg, rounds_active_weight=agg.rounds_active_weight * 2),
            m.IOStats(block_reads=5, cache_misses=5, io_round_trips=5,
                      hops=5),
            m.IOStats.from_device(6, 2, 6, 0, 0), rdev,
            dataclasses.replace(rdev, batch_rounds=0)]


def _host_counters(m):
    """The host paths' counters (tiers 1-2, the async queue, joins,
    speculative-only trips), which the device cases leave at zero."""
    a = m.IOStats(block_reads=20, io_round_trips=12, cache_hits=5,
                  tier2_hits=2, cache_misses=10, prefetched_blocks=7,
                  queue_fetches=9, queue_occ_weight=2.5, inflight_peak=4,
                  inflight_joins=3, join_residual=1.25,
                  completion_reorders=2, vertices_fetched=120,
                  vertices_used=30, hops=20, hops_to_best=7, dist_comps=50,
                  pq_comps=300, hot_tier_hits=11)
    b = m.IOStats(block_reads=6, io_round_trips=6, cache_hits=4,
                  cache_misses=2, prefetched_blocks=9, hops=6)
    c = m.IOStats()
    c.merge(a)
    c.merge(b)
    return [a, b, c, m.IOStats()]


CASES = {"merge": _merge, "from_device": _from_device,
         "from_device_batch": _from_device_batch,
         "dedup_split": _dedup_split, "pipelined": _pipelined,
         "speculative": _speculative, "round_granular": _round_granular,
         "host_counters": _host_counters}


@pytest.mark.parametrize("case", sorted(CASES))
def test_iostats_cases_match_jax(case):
    want, got = CASES[case](JI), CASES[case](TI)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        _same(g, w)


def test_fields_and_constants_match_jax():
    for cls in ("IOStats", "CostModel"):
        assert ([f.name for f in dataclasses.fields(getattr(TI, cls))]
                == [f.name for f in dataclasses.fields(getattr(JI, cls))])
    assert TI.IOStats._MAX_FIELDS == JI.IOStats._MAX_FIELDS
    for name in MODELS:
        assert (dataclasses.asdict(getattr(TI, name))
                == dataclasses.asdict(getattr(JI, name)))


def test_merge_keeps_the_trip_invariant_as_jax():
    """A merge that would put more round trips than block reads raises
    in both packages and leaves the accumulator as it was."""
    errors = []
    for m in (JI, TI):
        a = m.IOStats(block_reads=2, io_round_trips=2)
        with pytest.raises(ValueError) as e:
            a.merge(m.IOStats(block_reads=0, io_round_trips=1))
        errors.append(str(e.value))
        assert dataclasses.asdict(a) == dataclasses.asdict(
            m.IOStats(block_reads=2, io_round_trips=2))
    assert errors[0] == errors[1]


def _columns(rng, n, width):
    """Seeded per-query device columns; the first ``width`` of (io,
    tier0_hits, hops, dedup_saved, rounds, dedup_cross, pipelined,
    spec_hits, spec_wasted, speculative, hot_tier). dedup_saved,
    dedup_cross and spec_hits exceed what they refine on some queries,
    so the clamps run."""
    io = rng.integers(0, 50, n)
    cols = (io, rng.integers(0, 20, n), rng.integers(0, 60, n),
            rng.integers(0, 30, n), int(rng.integers(0, 40)),
            rng.integers(0, 20, n), bool(rng.integers(0, 2)),
            rng.integers(0, 40, n), rng.integers(0, 10, n),
            bool(rng.integers(0, 2)), rng.integers(0, 300, n))
    return cols[:width]


@pytest.mark.parametrize("seed", range(4))
@pytest.mark.parametrize("width", [5, 6, 7, 10, 11])
def test_from_device_batch_on_random_columns_matches_jax(seed, width):
    cols = _columns(np.random.default_rng([seed, width]),
                    1 + 9 * seed, width)
    _same(TI.IOStats.from_device_batch(*cols),
          JI.IOStats.from_device_batch(*cols))


@pytest.mark.parametrize("seed", range(3))
def test_fold_rank_batches_and_merge_ranks_match_jax(seed):
    """A mesh step's per-rank columns, of every tuple length the fold
    takes, and rank keys given out of order and as numpy integers."""
    rng = np.random.default_rng(seed + 100)
    columns = {np.int64(r): _columns(rng, int(rng.integers(1, 12)), w)
               for r, w in zip((3, 0, 2, 1, 4), (5, 6, 7, 9, 10))}
    want = JI.IOStats.fold_rank_batches(columns)
    got = TI.IOStats.fold_rank_batches(columns)
    assert list(got) == list(want) and all(type(r) is int for r in got)
    for r in want:
        _same(got[r], want[r])
    _same(TI.IOStats.merge_ranks(got), JI.IOStats.merge_ranks(want))


# ---------------------------------------------- the served conformance path

@pytest.fixture(scope="module")
def jds(small_segment):
    return DS.from_segment(small_segment, tier0_frac=0.1)


@pytest.fixture(scope="module")
def tds(small_segment, tmp_path_factory):
    path = tmp_path_factory.mktemp("seg") / "small.npz"
    save_segment(small_segment, str(path))
    return TDS.from_segment(load_segment(str(path)), tier0_frac=0.1,
                            device="cpu")


def test_served_batch_folds_to_jax_iostats(jds, tds, small_data):
    """Both servers serve the conformance queries at ``P_CONF``; their
    ``batch_stats`` fold to equal ``IOStats``, the totals of
    ``GOLDEN_DEVICE``."""
    x, q = small_data
    js = SegmentServer(segment=jds, offset=0, num_vectors=x.shape[0],
                       params=P_CONF)
    ts = TServer(segment=tds, offset=0, num_vectors=x.shape[0],
                 params=_tparams(P_CONF), device="cpu")
    js.search(q, 10)
    ts.search(q, 10)
    got, want = _fold(TI, ts.batch_stats()), _fold(JI, js.batch_stats())
    _same(got, want)
    assert got.block_reads == GOLDEN_DEVICE["touches"] == 912
    assert got.batch_rounds == GOLDEN_DEVICE["rounds"] == 23
    assert got.io_round_trips == (GOLDEN_DEVICE["io"]
                                  - GOLDEN_DEVICE["dedup_saved"])
    assert got.hops == GOLDEN_DEVICE["hops"]
    assert got.dma_pipelined == 1


def test_round_log_cols_pinned():
    """The fold's columns, the port's import-free twin in
    ``device_search`` and the JAX package's are one tuple."""
    assert TR.ROUND_LOG_COLS == TDS._ROUND_LOG_COLS == JR.ROUND_LOG_COLS
    assert DS._ROUND_LOG_COLS == JR.ROUND_LOG_COLS
    assert TR.N_ROUND_COLS == JR.N_ROUND_COLS == len(TR.ROUND_LOG_COLS)
    assert TO.ROUND_LOG_COLS is TR.ROUND_LOG_COLS
    assert TO.fold_round_log is TR.fold_round_log


@pytest.mark.parametrize("shape,rounds", [((6, 8), 4), ((3, 8), 9),
                                          ((5, 8), 0), ((4, 7), 2),
                                          ((8,), 1)])
def test_fold_round_log_on_raw_buffers_matches_jax(shape, rounds):
    """Rows past ``rounds`` dropped, a buffer shorter than ``rounds``
    folded whole, a wrong shape refused, as in JAX."""
    log = np.random.default_rng(rounds).integers(0, 9, shape).astype(
        np.int32)
    if len(shape) != 2 or shape[1] != JR.N_ROUND_COLS:
        for m in (JR, TR):
            with pytest.raises(ValueError):
                m.fold_round_log(log, rounds)
        return
    want, got = JR.fold_round_log(log, rounds), TR.fold_round_log(log,
                                                                  rounds)
    assert [dataclasses.asdict(r) for r in got] == [
        dataclasses.asdict(r) for r in want]
    assert TR.round_log_totals(got) == JR.round_log_totals(want)


KNOBS = {"plain": {}, "compaction": {"compact_frac": 0.5},
         "speculation": {"speculate": True}}


@pytest.mark.parametrize("knob", sorted(KNOBS))
def test_round_log_folds_like_jax(jds, tds, small_data, knob):
    """``tests/test_trace_roundlog.py``'s knobs on 8 queries: the port's
    folded records and totals equal JAX's, its batch fold equals JAX's,
    and the port's log holds that file's invariants: the column sums are
    the counters, rows past the rounds are zero, live never rises nor
    exceeds the batch, ``rounds_active_weight`` is the mean live count,
    the spec columns tie (hits within each round's paying gathers; all
    zero without speculation, the other columns then unchanged)."""
    _, q = small_data
    p = dataclasses.replace(P_TRACE, trace_rounds=True, **KNOBS[knob])
    want = DS.device_anns(jds, jnp.asarray(q[:8]), p)
    got = TDS.device_anns(tds, torch.as_tensor(q[:8]), _tparams(p))
    rounds = int(got.rounds)
    assert rounds == int(want.rounds)
    log = got.round_log.numpy()
    records = TR.fold_round_log(log, rounds)
    want_records = JR.fold_round_log(np.asarray(want.round_log), rounds)
    assert [dataclasses.asdict(r) for r in records] == [
        dataclasses.asdict(r) for r in want_records]
    tot = TR.round_log_totals(records)
    assert tot == JR.round_log_totals(want_records)

    cols = {name: getattr(got, name).numpy() for name in COUNTERS}
    assert tot["rounds"] == rounds
    for key in COUNTERS:
        assert tot[key] == int(cols[key].sum()), key
    assert not log[rounds:].any()
    live = np.array([r.live for r in records])
    assert (live <= 8).all() and (np.diff(live) <= 0).all()
    batch = TI.IOStats.from_device_batch(
        cols["io"], cols["tier0_hits"], cols["hops"], cols["dedup_saved"],
        rounds, cols["dedup_cross"], p.pipeline_dma, cols["spec_hits"],
        cols["spec_wasted"], p.speculate)
    _same(batch, JI.IOStats.from_device_batch(
        *(np.asarray(getattr(want, n)) for n in COUNTERS[:4]), rounds,
        np.asarray(want.dedup_cross), p.pipeline_dma,
        np.asarray(want.spec_hits), np.asarray(want.spec_wasted),
        p.speculate))
    assert batch.batch_rounds == tot["rounds"]
    assert batch.rounds_active_weight == pytest.approx(
        tot["live_weight"] / rounds)
    if p.compact_frac == 0.0:
        assert tot["compactions"] == 0
    for rec in records:
        assert rec.spec_hits <= rec.cold - rec.joins
    if not p.speculate:
        assert not log[:, 6:8].any()
        return
    assert tot["spec_hits"] > 0
    off = TDS.device_anns(tds, torch.as_tensor(q[:8]),
                          _tparams(dataclasses.replace(p, speculate=False)))
    assert torch.equal(off.ids, got.ids) and torch.equal(off.dists,
                                                         got.dists)
    np.testing.assert_array_equal(off.round_log.numpy()[:, :6], log[:, :6])
