"""The round graph of the port's device round loop
(``core.device_search``: ``_RoundGraph``, ``RoundGraphCache``): a
round's pick and post-stage phases replayed from CUDA graphs must give
what the eager loop gives, bit for bit: ids, dists, every counter,
rounds and syncs.

Each comparison runs twice: on the card (``gpu``, skips without one)
against the eager loop on the same card (``_eager_rounds``), and here on
the CPU as a rehearsal in which each captured graph is its callable run
eagerly, so the static buffers, the compaction's ping-pong sets and the
copies in and out are exercised where no card is. On the CPU without
the rehearsal the graph never engages. The file imports nothing of the
JAX package (``pytest -m gpu --noconftest`` on the card).
"""
import dataclasses
import types

import pytest
import torch

from repro_torch.core import device_search as DS
from repro_torch.core import params as P
from repro_torch.core import segment as S
from repro_torch.data.vectors import clustered_vectors, query_set
from repro_torch.obs import manual_tracer
from repro_torch.serving.coordinator import SegmentServer

PARAMS = P.SegmentParams(
    graph=P.GraphParams(max_degree=16, build_beam=32, algo="nsg"),
    layout=P.LayoutParams(block_kb=1.0, shuffle="bnf", bnf_iters=4),
    pq=P.PQParams(num_subspaces=8, train_iters=6, train_sample=2048),
    nav=P.NavGraphParams(sample_ratio=0.1, max_degree=8, build_beam=16))
SEARCH = P.DeviceSearchParams(k=10, candidates=32, max_hops=64,
                              fetch_width=2, compact_frac=0.25,
                              tier0_frac=0.1)
RESULT = [f for f in DS.DeviceSearchResult._fields
          if f not in ("round_log", "graph_rounds")]


@pytest.fixture(scope="module")
def built():
    """Four segments of 600 vectors, and 96 queries."""
    x = clustered_vectors(2400, 24, num_clusters=16, seed=0)
    q = query_set(x, 96, seed=1)
    segs = [S.build_segment(x[i * 600:(i + 1) * 600], PARAMS, device="cpu")
            for i in range(4)]
    return segs, q


@pytest.fixture(params=["rehearsal", pytest.param("cuda",
                                                  marks=pytest.mark.gpu)])
def dev(request, monkeypatch):
    """The device, with a fresh graph cache; the rehearsal engages the
    graph on the CPU and replays each capture eagerly."""
    monkeypatch.setattr(DS, "_ROUND_GRAPHS", DS.RoundGraphCache(4))
    if request.param == "cuda":
        if not torch.cuda.is_available():
            pytest.skip("needs a CUDA card")
        return torch.device("cuda")
    monkeypatch.setattr(DS, "_graphs_on", lambda d, impl, trace: (
        DS._ROUND_GRAPHS.enabled and impl == "fused" and not trace))
    monkeypatch.setattr(DS, "_capture_graphs", lambda fns: [
        types.SimpleNamespace(replay=fn) for fn in fns])
    return torch.device("cpu")


def _on(seg, dev):
    return DS.from_segment(seg, tier0_frac=0.1, device=dev)


def _host(r):
    """A result's arrays on the host, as bytes, and its host ints."""
    return {f: (getattr(r, f).cpu().numpy().tobytes()
                if isinstance(getattr(r, f), torch.Tensor)
                else getattr(r, f)) for f in RESULT}


def _eager(ds, q, p):
    with DS._eager_rounds():
        return DS.device_anns(ds, q, p)


def _graphed_rounds(tr):
    return [e.args["graph"] for e in tr.by_name("search.round")]


CASES = [
    pytest.param(0.0, False, 2, id="compaction-off"),
    pytest.param(0.25, False, 2, id="compaction"),
    pytest.param(0.25, True, 2, id="compaction-speculate"),
    pytest.param(0.25, False, 1, id="compaction-fw1"),
    pytest.param(0.0, True, 1, id="speculate-fw1"),
]


@pytest.mark.parametrize("compact_frac,speculate,fetch_width", CASES)
def test_graph_rounds_equal_eager_rounds(built, dev, compact_frac,
                                         speculate, fetch_width):
    segs, q = built
    ds = _on(segs[0], dev)
    qt = torch.as_tensor(q, device=dev)
    p = dataclasses.replace(SEARCH, compact_frac=compact_frac,
                            speculate=speculate, fetch_width=fetch_width)
    want = _host(_eager(ds, qt, p))
    assert not DS._ROUND_GRAPHS.entries
    for first in (True, False):              # capture, then replay only
        tr = manual_tracer()
        r = DS.device_anns(ds, qt, p, tracer=tr)
        assert _host(r) == want
        flags = _graphed_rounds(tr)
        assert len(flags) == r.rounds > 1
        # the first round through a new entry runs eagerly
        assert flags == [not first] + [True] * (r.rounds - 1)
        assert r.graph_rounds == r.rounds - first
        fired = [e.args["fired"] for e in tr.by_name("search.round")]
        assert any(fired) == (compact_frac > 0)
    assert len(DS._ROUND_GRAPHS.entries) == 1


@pytest.mark.parametrize("compact_frac", [0.0, 0.25])
def test_a_later_search_leaves_the_returned_arrays_alone(built, dev,
                                                         compact_frac):
    segs, q = built
    ds = _on(segs[0], dev)
    p = dataclasses.replace(SEARCH, compact_frac=compact_frac)
    a, b = (torch.as_tensor(x, device=dev) for x in (q[:48], q[48:]))
    ra = DS.device_anns(ds, a, p)
    kept = _host(ra)
    rb = DS.device_anns(ds, b, p)
    assert rb.graph_rounds == rb.rounds      # through the same entry
    assert _host(ra) == kept
    assert _host(rb) == _host(_eager(ds, b, p))


def test_the_stage_keeps_ids_that_no_later_round_overwrites(
        built, dev, monkeypatch):
    """The round stage gets the picked ids as a tensor of its own (the
    benchmark's roofline reader keeps each launch's ids and reads them
    after the window)."""
    segs, q = built
    ds = _on(segs[0], dev)
    qt = torch.as_tensor(q, device=dev)
    DS.device_anns(ds, qt, SEARCH)            # the graphs captured
    seen = []
    fused = DS.K.fused_round

    def keep(queries, u, *args, **kw):
        seen.append((u, u.clone()))
        return fused(queries, u, *args, **kw)

    monkeypatch.setattr(DS.K, "fused_round", keep)
    r = DS.device_anns(ds, qt, SEARCH)
    assert len(seen) == r.rounds == r.graph_rounds
    assert all(torch.equal(u, u0) for u, u0 in seen)


def test_four_segments_alternate_through_four_entries(built, dev):
    segs, q = built
    dss = [_on(s, dev) for s in segs]
    qt = torch.as_tensor(q, device=dev)
    want = [_host(_eager(ds, qt, SEARCH)) for ds in dss]
    for rep in range(2):
        for ds, w in zip(dss, want):
            r = DS.device_anns(ds, qt, SEARCH)
            assert _host(r) == w
            assert r.graph_rounds == r.rounds - (rep == 0)
    assert len(DS._ROUND_GRAPHS.entries) == 4


def test_a_repacked_tier0_gets_its_own_entry(built, dev):
    segs, q = built
    ds = _on(segs[0], dev)
    qt = torch.as_tensor(q, device=dev)
    DS.device_anns(ds, qt, SEARCH)
    hot = DS.hot_pack_blocks(ds)
    cold = [b for b in range(segs[0].num_blocks) if b not in hot]
    ds2, changed = DS.repack_tier0(ds, segs[0],
                                   {b: 100 for b in cold[:len(hot)]})
    assert changed > 0
    r = DS.device_anns(ds2, qt, SEARCH)
    assert r.graph_rounds == r.rounds - 1    # a new entry, captured anew
    assert len(DS._ROUND_GRAPHS.entries) == 2
    assert _host(r) == _host(_eager(ds2, qt, SEARCH))


def test_the_graph_never_engages_on_the_cpu(built):
    segs, q = built
    srv = SegmentServer(segment=_on(segs[0], "cpu"), offset=0,
                        num_vectors=600, params=SEARCH, device="cpu")
    tr = manual_tracer()
    srv.search(q, tracer=tr)
    rounds = tr.by_name("search.round")
    assert rounds and not any(e.args["graph"] for e in rounds)
    st = srv.batch_stats()
    assert st["rounds"] == len(rounds) and st["graph_rounds"] == 0
    assert not DS._ROUND_GRAPHS.entries


def test_the_cache_drops_the_least_recently_used():
    cache = DS.RoundGraphCache(2)
    made = []

    def make(name):
        return lambda: made.append(name) or name

    assert cache.get("a", make("a")) == "a"
    assert cache.get("b", make("b")) == "b"
    assert cache.get("a", make("a2")) == "a"     # a hit, now the newest
    assert cache.get("c", make("c")) == "c"      # drops b
    assert list(cache.entries) == ["a", "c"]
    assert cache.get("b", make("b2")) == "b2"    # made again; drops a
    assert made == ["a", "b", "c", "b2"]
    assert list(cache.entries) == ["c", "b"]


def test_the_key_follows_shapes_knobs_and_the_segments_arrays(built):
    segs, q = built
    ds = _on(segs[0], "cpu")
    qt = torch.as_tensor(q)
    _, _, st = DS.initial_state(ds, qt, SEARCH)
    names = ["cand_id", "visited", "res_id"]

    def key(ds=ds, st=st, **knobs):
        return DS._graph_key(ds, st, names, **{"tile": 8, **knobs})

    assert key() == key()
    # a view of the same arrays, as a per-call cast of vecs makes
    assert key(ds=dataclasses.replace(ds, vecs=ds.vecs.clone())) == key()
    assert key(tile=16) != key()
    _, _, st_half = DS.initial_state(ds, qt[:48], SEARCH)
    assert key(st=st_half) != key()
    wide = dataclasses.replace(SEARCH, candidates=64)
    assert key(st=DS.initial_state(ds, qt, wide)[2]) != key()
    hot = DS.hot_pack_blocks(ds)
    cold = [b for b in range(segs[0].num_blocks) if b not in hot]
    repacked, _ = DS.repack_tier0(ds, segs[0],
                                  {b: 100 for b in cold[:len(hot)]})
    assert key(ds=repacked) != key()
    assert key(ds=_on(segs[1], "cpu")) != key()
