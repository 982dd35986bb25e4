"""The port's round kernels and dedup helpers (``repro_torch.kernels``)
against the JAX package, on the same numpy inputs.

On the CPU the port's wrappers run their plain versions; the JAX
kernels run in interpret mode, as the JAX package's own tests run them.
Integer outputs must be equal. Distances agree within atol 1e-5 /
rtol 1e-6: the JAX reference itself differs between its Pallas
interpreter and XLA by up to 3.8e-6 (ROADMAP §C), and torch sums in
another order. The expansion order is compared exactly, after checking
that the data has no near-ties closer than 1e-4.

The ``gpu`` tests hold each CUDA kernel against its plain version; they
skip without a card. JAX is imported inside the tests that use it, so
the ``gpu`` tests also run where JAX is not installed.
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels import block_topk as TBT
from repro_torch.kernels import dedup as TD
from repro_torch.kernels import l2_tile as TL2
from repro_torch.kernels import ops as TO
from repro_torch.kernels import pq_adc as TPQ
from repro_torch.kernels import ref as TR
from repro_torch.kernels import tier0_fetch as TT

ATOL, RTOL = 1e-5, 1e-6


def _keys(r, lo, hi, seed):
    return np.random.default_rng(seed).integers(lo, hi, (r,)).astype(
        np.int32)


@pytest.mark.parametrize("r,lo,hi,seed", [
    (8, 0, 4, 0), (64, 0, 12, 1), (96, 0, 96, 2), (128, 0, 3, 3),
    (16, 0, 1, 4), (300, -40, 40, 5), (257, -3, 1000, 6)])
def test_sorted_unique_ranks_matches_jax(r, lo, hi, seed):
    import jax.numpy as jnp
    from repro.kernels import dedup as JD
    flat = _keys(r, lo, hi, seed)
    uj, rj = JD.sorted_unique_ranks(jnp.asarray(flat))
    ut, rt = TD.sorted_unique_ranks(torch.as_tensor(flat))
    np.testing.assert_array_equal(ut.numpy(), np.asarray(uj))
    np.testing.assert_array_equal(rt.numpy(), np.asarray(rj))
    assert ut.dtype == torch.int32 and rt.dtype == torch.int32


@pytest.mark.parametrize("r,hi,seed", [(8, 4, 0), (64, 12, 1),
                                       (96, 96, 2), (128, 3, 3),
                                       (16, 1, 4)])
def test_union_slot_map_matches_jax(r, hi, seed):
    import jax.numpy as jnp
    from repro.kernels import dedup as JD
    flat = _keys(r, 0, hi, seed)
    uj, rj = JD.union_slot_map(jnp.asarray(flat))
    ut, rt = TD.union_slot_map(torch.as_tensor(flat))
    np.testing.assert_array_equal(ut.numpy(), np.asarray(uj))
    np.testing.assert_array_equal(rt.numpy(), np.asarray(rj))
    us, rs = TD.sorted_unique_ranks(torch.as_tensor(flat))
    assert torch.equal(ut, us) and torch.equal(rt, rs)


@pytest.mark.parametrize("t,r,lo,hi,seed", [
    (1, 64, 0, 8, 0), (4, 32, -16, 16, 1), (3, 48, -100, 5, 2),
    (8, 16, 0, 2, 3)])
def test_join_mask_matches_jax(t, r, lo, hi, seed):
    import jax.numpy as jnp
    from repro.kernels import dedup as JD
    keys = np.random.default_rng(seed).integers(lo, hi, (t, r)).astype(
        np.int32)
    # unique negative sentinels, as the accounting mirror writes them
    keys[:, ::5] = -1000 - np.arange(t * len(range(0, r, 5))).reshape(t, -1)
    want = np.asarray(JD.join_mask(jnp.asarray(keys)))
    got = TD.join_mask(torch.as_tensor(keys)).numpy()
    np.testing.assert_array_equal(got, want)


def _store(seed, rho=24, eps=4, d=16, lam=5):
    rng = np.random.default_rng(seed)
    vecs = rng.standard_normal((rho, eps, d)).astype(np.float32)
    vid = rng.permutation(rho * eps).reshape(rho, eps).astype(np.int32)
    nbrs = rng.integers(-1, rho * eps, (rho, eps, lam)).astype(np.int32)
    return vecs, vid, nbrs


@pytest.mark.parametrize("qn,f,seed,store", [
    pytest.param(16, 3, 7, {}, id="16-3-7"),
    pytest.param(8, 1, 8, {}, id="8-1-8"),
    pytest.param(37, 2, 9, {}, id="37-2-9"),
    pytest.param(2560, 2, 10, {}, id="2560-2-10"),      # R = 5,120
    # rows of eps*D = 15 and eps*Lam = 9 words: the kernels' single-word
    # copies
    pytest.param(24, 3, 11, dict(eps=3, d=5, lam=3), id="odd-rows")])
def test_gather_union_and_unique_match_jax(qn, f, seed, store):
    import jax.numpy as jnp
    from repro.kernels.tier0_fetch import gather_union, gather_unique
    vecs, vid, nbrs = _store(seed, **store)
    b = np.random.default_rng(seed).integers(0, vecs.shape[0], (qn, f)
                                             ).astype(np.int32)
    jstore = [jnp.asarray(a) for a in (vecs, vid, nbrs)]
    tstore = [torch.as_tensor(a) for a in (vecs, vid, nbrs)]
    want = gather_union(jnp.asarray(b), *jstore)
    got = TT.gather_union(torch.as_tensor(b), *tstore)
    for name, g, w in zip(("uniq", "rank2d", "tiles", "vid", "nbrs"),
                          got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w),
                                      err_msg=name)
    r = qn * f
    want_u = gather_unique(want[0], *jstore, rb=r)
    got_u = TT.gather_unique(got[0], *tstore)
    for name, g, w in zip(("tiles", "vid", "nbrs"), got_u, want_u):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w),
                                      err_msg=name)


def _round_case(q, rho, eps, d, f, hot_n, lam=5, seed=0, idle_rows=0):
    """The JAX package's ``_fused_round_case`` inputs, as numpy."""
    rng = np.random.default_rng(seed)
    n = rho * eps
    qs = rng.standard_normal((q, d)).astype(np.float32)
    cold = rng.standard_normal((rho, eps, d)).astype(np.float32)
    vid = rng.permutation(n).reshape(rho, eps).astype(np.int32)
    nbrs = rng.integers(-1, n, (rho, eps, lam)).astype(np.int32)
    block_of = np.zeros(n, np.int32)
    block_of[vid.reshape(-1)] = np.repeat(np.arange(rho, dtype=np.int32),
                                          eps)
    slot_of = np.full(rho, -1, np.int32)
    if hot_n > 0:
        hot_ids = rng.permutation(rho)[:hot_n]
        slot_of[hot_ids] = np.arange(hot_n, dtype=np.int32)
        hot = (cold[hot_ids], vid[hot_ids], nbrs[hot_ids])
    else:
        hot = (np.zeros((1, eps, d), np.float32),
               np.full((1, eps), -1, np.int32),
               np.full((1, eps, lam), -1, np.int32))
    u = rng.integers(0, n, (q, f)).astype(np.int32)
    u[rng.random((q, f)) < 0.2] = -1
    if idle_rows:
        u[-idle_rows:] = -1
    return (qs, u, block_of, slot_of, *hot, cold, vid, nbrs)


ROUND_CASES = {
    # name: (q, rho, eps, d, f, hot_n, bq, idle_rows, lam, n_expand)
    "one_tile": (16, 32, 4, 16, 1, 8, None, 0, 5, 2),
    "ragged_no_hot": (37, 64, 8, 32, 2, 0, None, 0, 5, 4),
    "wide_fetch": (8, 16, 6, 24, 3, 16, None, 0, 5, 6),
    "idle_tile": (16, 32, 4, 16, 2, 8, 8, 8, 5, 4),
    "part_idle_tile": (24, 32, 4, 16, 2, 8, 8, 5, 5, 4),
    # the rank kernel's edges: F*eps = 48 slots, past one warp's 32 lanes;
    # D and Lam not multiples of 4 (single-word moves); every slot ordered
    "slots_past_a_warp": (16, 40, 12, 16, 4, 10, 8, 0, 5, 8),
    "ragged_d_lam": (16, 32, 4, 10, 2, 8, None, 0, 3, 4),
    "n_expand_all_slots": (16, 32, 6, 16, 3, 8, None, 0, 5, 18),
}


def _selection_key(dd, vid, u):
    eps = vid.shape[1] // u.shape[1]
    valid = (vid >= 0) & np.repeat(u >= 0, eps, axis=1)
    is_t = (vid[:, :, None] == u[:, None, :]).any(-1) & (vid >= 0)
    return np.where(is_t, -np.inf, np.where(valid, dd, np.inf))


def _assert_no_near_ties(sel):
    for row in sel:
        fin = np.sort(row[np.isfinite(row)])
        gaps = np.diff(fin)
        assert not ((gaps > 0) & (gaps < 1e-4)).any(), \
            "data has a near-tie: the order comparison would be flaky"


@pytest.mark.parametrize("metric", ["l2", "ip"])
@pytest.mark.parametrize("case", sorted(ROUND_CASES))
def test_fused_round_matches_jax(case, metric):
    import jax.numpy as jnp
    from repro import kernels as JK
    q, rho, eps, d, f, hot_n, bq, idle, lam, n_expand = ROUND_CASES[case]
    args = _round_case(q, rho, eps, d, f, hot_n, lam=lam, seed=q * rho,
                       idle_rows=idle)
    want = [np.asarray(a) for a in JK.fused_round(
        *[jnp.asarray(a) for a in args], n_expand, metric=metric, bq=bq,
        fuse_union=True)]
    for fuse in (True, False):
        got = [a.numpy() for a in TO.fused_round(
            *[torch.as_tensor(a) for a in args], n_expand, metric=metric,
            bq=bq, fuse_union=fuse)]
        for name, i in (("vid", 1), ("nbrs", 2), ("hit", 3)):
            np.testing.assert_array_equal(got[i], want[i], err_msg=name)
        np.testing.assert_allclose(got[0], want[0], atol=ATOL, rtol=RTOL)
        _assert_no_near_ties(_selection_key(want[0], want[1], args[1]))
        np.testing.assert_array_equal(got[4], want[4], err_msg="order")
    if idle:
        tile = bq or q
        idle_tiles = [t for t in range(0, q, tile)
                      if (args[1][t:t + tile] < 0).all()]
        for t in idle_tiles:
            assert (got[1][t:t + tile] == -1).all()
            assert (got[0][t:t + tile] == 0).all()
            assert (got[4][t:t + tile] == 0).all()
        assert bool(idle_tiles) == (idle >= tile)


def test_fused_round_ref_matches_jax_ref():
    import jax.numpy as jnp
    from repro.kernels import ref as JR
    args = _round_case(37, 64, 8, 32, 2, 12, seed=5)
    want = [np.asarray(a) for a in JR.fused_round_ref(
        *[jnp.asarray(a) for a in args], 4)]
    got = [a.numpy() for a in TR.fused_round_ref(
        *[torch.as_tensor(a) for a in args], 4)]
    for i in (1, 2, 3, 4):
        np.testing.assert_array_equal(got[i], want[i])
    np.testing.assert_allclose(got[0], want[0], atol=ATOL, rtol=RTOL)


def test_cpu_wrappers_launch_nothing():
    from repro_torch import kernels as K
    K.reset_all_launches()
    args = _round_case(16, 32, 4, 16, 2, 8)
    TO.fused_round(*[torch.as_tensor(a) for a in args], 4)
    TO.pairwise_l2(torch.ones(3, 4), torch.ones(5, 4))
    TO.pq_adc_batch(torch.zeros(6, 2, dtype=torch.uint8), torch.ones(1, 2, 4))
    assert all(v == 0 for v in K.launch_counts().values())
    q, b, slot_of, hot, cold = _tier0_case(16, 32, 4, 16, 1, 8)
    TO.tier0_rank(*map(torch.as_tensor, (q, b, slot_of, hot, cold)))
    TO.block_rank(torch.ones(3, 4), torch.ones(3, 5, 4), 2)
    assert all(v == 0 for v in K.launch_counts().values())
    assert set(K.launch_counts()) == {"gather_union", "fused_round_rank",
                                      "gather_unique", "l2_tile", "pq_adc",
                                      "tier0_fetch_rank", "block_topk"}
    assert TL2.OPS["l2_tile"] == 0


# the JAX kernel sweeps' shapes and tolerances (tests/test_kernels.py)
@pytest.mark.parametrize("q,n,d", [(8, 64, 16), (37, 203, 64), (1, 9, 8)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("metric", ["l2", "ip"])
def test_pairwise_l2_matches_jax(q, n, d, dtype, metric):
    import jax.numpy as jnp
    from repro import kernels as JK
    rng = np.random.default_rng(q * n)
    qa = rng.standard_normal((q, d)).astype(np.float32)
    xa = rng.standard_normal((n, d)).astype(np.float32)
    jd, td = getattr(jnp, dtype), getattr(torch, dtype)
    want = np.asarray(JK.pairwise_l2(jnp.asarray(qa, jd), jnp.asarray(xa, jd),
                                     metric=metric))
    got = TO.pairwise_l2(torch.as_tensor(qa).to(td),
                         torch.as_tensor(xa).to(td), metric=metric)
    assert got.dtype == torch.float32 and got.shape == (q, n)
    tol = 1e-3 if dtype == "float32" else 5e-2
    np.testing.assert_allclose(got.numpy(), want, rtol=tol, atol=tol * d)


@pytest.mark.parametrize("n,m,k,b", [(64, 4, 16, 1), (133, 8, 256, 5),
                                     (17, 2, 64, 2)])
def test_pq_adc_batch_matches_jax(n, m, k, b):
    import jax.numpy as jnp
    from repro import kernels as JK
    rng = np.random.default_rng(n * m)
    codes = rng.integers(0, k, (n, m)).astype(np.uint8)
    luts = rng.standard_normal((b, m, k)).astype(np.float32)
    want = np.asarray(JK.pq_adc_batch(jnp.asarray(codes), jnp.asarray(luts)))
    got = TO.pq_adc_batch(torch.as_tensor(codes), torch.as_tensor(luts))
    assert got.shape == (b, n)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("m,k,b,bq", [(8, 256, 1024, 16), (8, 256, 9, 16),
                                      (8, 256, 8, 8), (8, 256, 5, 8),
                                      (8, 256, 4, 4), (8, 256, 1, 4),
                                      (16, 256, 100, 8), (32, 256, 100, 4),
                                      (4, 16, 3, 4)])
def test_pq_adc_query_tile(m, k, b, bq):
    """The CUDA wrapper's LUT tile: 16 queries where they fit in shared
    memory and the batch fills them, else 8 or 4."""
    assert TPQ.tile_queries(m, k, b) == bq
    assert bq * m * k * 4 <= TPQ.SMEM_BYTES


def test_pq_adc_query_tile_too_large():
    with pytest.raises(ValueError):
        TPQ.tile_queries(64, 256, 16)


# the JAX sweeps' cases (tests/test_kernels.py): hot_n = 0 is the
# sentinel pack (all cold), hot_n = rho packs every block
T0_CASES = [(16, 32, 4, 16, 1, 8), (37, 64, 8, 32, 2, 0),
            (8, 16, 6, 24, 3, 16), (128, 96, 5, 64, 2, 40)]
# (q, eps, d, top_m); the last has top_m > eps (slots past eps hold 0)
BT_CASES = [(19, 8, 32, 3), (64, 16, 128, 5), (5, 4, 16, 4),
            (128, 12, 64, 1), (7, 4, 16, 6)]


def _tier0_case(q, rho, eps, d, f, hot_n):
    """The inputs of the JAX ``test_tier0_fetch_rank_sweep``, as numpy."""
    rng = np.random.default_rng(q * rho)
    qs = rng.standard_normal((q, d)).astype(np.float32)
    cold = rng.standard_normal((rho, eps, d)).astype(np.float32)
    slot_of = np.full(rho, -1, np.int32)
    if hot_n > 0:
        hot_ids = rng.permutation(rho)[:hot_n]
        slot_of[hot_ids] = np.arange(hot_n, dtype=np.int32)
        hot = cold[hot_ids]
    else:
        hot = np.zeros((1, eps, d), np.float32)
    blocks = rng.integers(0, rho, (q, f)).astype(np.int32)
    return qs, blocks, slot_of, hot, cold


def _bt_case(q, eps, d):
    rng = np.random.default_rng(q * eps)
    return (rng.standard_normal((q, d)).astype(np.float32),
            rng.standard_normal((q, eps, d)).astype(np.float32))


@pytest.mark.parametrize("metric", ["l2", "ip"])
@pytest.mark.parametrize("case", T0_CASES)
def test_tier0_rank_matches_jax(case, metric):
    """hit equal, distances within atol 1e-4 / rtol 1e-5 (the tolerance
    of the JAX sweep), and the hot pack's exact copies rank exactly as
    the all-cold store does."""
    import jax.numpy as jnp
    from repro import kernels as JK
    arrays = _tier0_case(*case)
    want_d, want_h = JK.tier0_rank(*map(jnp.asarray, arrays), metric=metric)
    got_d, got_h = TO.tier0_rank(*map(torch.as_tensor, arrays),
                                 metric=metric)
    np.testing.assert_array_equal(got_h.numpy(), np.asarray(want_h))
    np.testing.assert_allclose(got_d.numpy(), np.asarray(want_d), atol=1e-4,
                               rtol=1e-5)
    qs, blocks, slot_of, _, cold = arrays
    cold_d, cold_h = TO.tier0_rank(
        *map(torch.as_tensor, (qs, blocks, np.full_like(slot_of, -1),
                               np.zeros((1,) + cold.shape[1:], np.float32),
                               cold)), metric=metric)
    assert torch.equal(got_d, cold_d)
    assert not cold_h.any()


@pytest.mark.parametrize("metric", ["l2", "ip"])
@pytest.mark.parametrize("q,eps,d,top", BT_CASES)
def test_block_rank_matches_jax(q, eps, d, top, metric):
    """Distances within atol 1e-3 / rtol 1e-5 of the JAX kernel's (both
    the norm expansion, summed in another order); the slots equal JAX's
    on every row whose first top+1 distances are apart by more than the
    tolerance, and always the stable argsort of the port's own
    distances."""
    import jax.numpy as jnp
    from repro import kernels as JK
    qs, tiles = _bt_case(q, eps, d)
    want_d, want_i = (np.asarray(a) for a in JK.block_rank(
        jnp.asarray(qs), jnp.asarray(tiles), top, metric=metric))
    got_d, got_i = TO.block_rank(torch.as_tensor(qs), torch.as_tensor(tiles),
                                 top, metric=metric)
    assert got_i.shape == (q, top) and got_i.dtype == torch.int32
    np.testing.assert_allclose(got_d.numpy(), want_d, atol=1e-3, rtol=1e-5)
    srt = np.sort(want_d, axis=1)[:, : min(top, eps - 1) + 1]
    clear = (np.diff(srt, axis=1) > 1e-3).all(axis=1)
    assert clear.mean() > 0.5
    np.testing.assert_array_equal(got_i.numpy()[clear], want_i[clear])
    own = torch.argsort(got_d, dim=1, stable=True)[:, :top]
    np.testing.assert_array_equal(got_i.numpy()[:, : min(top, eps)],
                                  own.numpy())
    assert (got_i.numpy()[:, eps:] == 0).all()


def test_plain_twins_match_jax_refs():
    import jax.numpy as jnp
    from repro.kernels import ref as JR
    for case in T0_CASES:
        arrays = _tier0_case(*case)
        for metric in ("l2", "ip"):
            wd, wh = JR.tier0_fetch_rank_ref(*map(jnp.asarray, arrays),
                                             metric=metric)
            gd, gh = TR.tier0_fetch_rank_ref(*map(torch.as_tensor, arrays),
                                             metric=metric)
            np.testing.assert_array_equal(gh.numpy(), np.asarray(wh))
            np.testing.assert_allclose(gd.numpy(), np.asarray(wd),
                                       atol=1e-4, rtol=1e-5)
    for q, eps, d, top in BT_CASES:
        qs, tiles = _bt_case(q, eps, d)
        for metric in ("l2", "ip"):
            wd, wi = JR.block_rank_ref(jnp.asarray(qs), jnp.asarray(tiles),
                                       top, metric=metric)
            gd, gi = TR.block_rank_ref(torch.as_tensor(qs),
                                       torch.as_tensor(tiles), top,
                                       metric=metric)
            np.testing.assert_allclose(gd.numpy(), np.asarray(wd),
                                       atol=1e-4, rtol=1e-5)
            np.testing.assert_array_equal(gi.numpy(), np.asarray(wi))


# ---------------------------------------------------------------- on the card

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _on(dev, arrays):
    return [torch.as_tensor(a, device=dev) for a in arrays]


@pytest.mark.gpu
@pytest.mark.parametrize("qn,f", [(1024, 2), (37, 3), (8, 1)])
def test_cuda_gather_kernels_match_plain(cuda, qn, f):
    vecs, vid, nbrs = _on(cuda, _store(qn, rho=5000, eps=6, d=128, lam=24))
    b = torch.as_tensor(np.random.default_rng(qn).integers(
        0, 5000, (qn, f)).astype(np.int32), device=cuda)
    TT.reset_launches()
    got = TT.gather_union(b, vecs, vid, nbrs)
    torch.cuda.synchronize()
    want = TR.gather_union_ref(b, vecs, vid, nbrs)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    got_u = TT.gather_unique(want[0], vecs, vid, nbrs)
    for g, w in zip(got_u, want[2:]):
        assert torch.equal(g, w)
    assert TT.LAUNCHES["gather_union"] == 1
    assert TT.LAUNCHES["gather_unique"] == 1


@pytest.mark.gpu
@pytest.mark.parametrize("r,rho,eps,d,lam,lo,hi", [
    (2048, 166_667, 6, 8, 24, 0, 166_667),       # the served rho
    (8192, 166_667, 6, 8, 24, 0, 166_667),       # 4,096 queries at F=2
    (20_000, 166_667, 6, 8, 24, 0, 1000),        # many repeats
    (8192, 5000, 6, 128, 24, -7, 5007),          # ids out of range
    (20_000, 2_000_000, 6, 8, 4, 0, 2_000_000),  # device bitmap
])
def test_cuda_gather_union_any_r_and_rho(cuda, r, rho, eps, d, lam, lo, hi):
    """Past 4,096 union slots (R) and past the shared-memory
    bitmap (rho > ~1.8M blocks): all five outputs equal the plain
    version's, bit for bit, in one counted launch."""
    gen = torch.Generator(device=cuda).manual_seed(r + rho)
    vecs = torch.randn((rho, eps, d), generator=gen, device=cuda)
    vid = torch.randint(-1, rho * eps, (rho, eps), generator=gen,
                        device=cuda, dtype=torch.int32)
    nbrs = torch.randint(-1, rho * eps, (rho, eps, lam), generator=gen,
                         device=cuda, dtype=torch.int32)
    b = torch.randint(lo, hi, (r // 2, 2), generator=gen, device=cuda,
                      dtype=torch.int32)
    TT.reset_launches()
    got = TT.gather_union(b, vecs, vid, nbrs)
    torch.cuda.synchronize()
    assert TT.LAUNCHES["gather_union"] == 1
    # an id out of range is clamped by the kernel, not by the plain
    # version (which follows JAX): compare there on the clamped ids
    want = TR.gather_union_ref(b.clamp(0, rho - 1), vecs, vid, nbrs)
    for name, g, w in zip(("uniq", "rank2d", "tiles", "vid", "nbrs"),
                          got, want):
        assert torch.equal(g, w), name


@pytest.mark.gpu
@pytest.mark.parametrize("fuse_union", [True, False])
@pytest.mark.parametrize("metric", ["l2", "ip"])
@pytest.mark.parametrize("case", sorted(ROUND_CASES))
def test_cuda_fused_round_matches_plain(cuda, case, metric, fuse_union):
    q, rho, eps, d, f, hot_n, bq, idle, lam, n_expand = ROUND_CASES[case]
    args = _round_case(q, rho, eps, d, f, hot_n, lam=lam, seed=q * rho,
                       idle_rows=idle)
    TT.reset_launches()
    got = TO.fused_round(*_on(cuda, args), n_expand, metric=metric, bq=bq,
                         fuse_union=fuse_union)
    torch.cuda.synchronize()
    want = TO.fused_round(*[torch.as_tensor(a) for a in args], n_expand,
                          metric=metric, bq=bq, fuse_union=fuse_union)
    gather = "gather_union" if fuse_union else "gather_unique"
    other = "gather_unique" if fuse_union else "gather_union"
    assert TT.LAUNCHES["fused_round_rank"] == 1
    assert TT.LAUNCHES[gather] == 1 and TT.LAUNCHES[other] == 0
    for i in (1, 2, 3):
        np.testing.assert_array_equal(got[i].cpu().numpy(),
                                      want[i].numpy())
    np.testing.assert_allclose(got[0].cpu().numpy(), want[0].numpy(),
                               atol=1e-4, rtol=1e-5)
    u = args[1]
    if bq is None:
        bq = TO.round_tile(q)
    pad = (-q) % bq
    live = np.repeat(np.pad(u, ((0, pad), (0, 0)), constant_values=-1)
                     .reshape(-1, bq * f).max(1) >= 0, bq)[:q]
    _, own = TR.selection_order(got[0].cpu(), got[1].cpu(),
                                torch.as_tensor(u), n_expand)
    own = np.where(live[:, None], own.numpy(), 0)
    np.testing.assert_array_equal(got[4].cpu().numpy(), own)


@pytest.mark.gpu
@pytest.mark.parametrize("metric", ["l2", "ip"])
def test_cuda_rank_dists_are_the_probe_bits(cuda, metric):
    """At the served shape (1,024 queries, F = 2, eps = 6, D = 128,
    Lam = 24, 500 of 5,000 blocks hot, the last tile idle): on live rows
    ``fused_round_rank``'s dd equals ``tier0_fetch_rank``'s on the same
    queries and target blocks bit for bit (one f32 order, warp_dists)."""
    qs, u, block_of, slot_of, hv, hvid, hn, cold, vid, nbrs = _on(
        cuda, _round_case(1024, 5000, 6, 128, 2, 500, lam=24, seed=15,
                          idle_rows=TT.BQ))
    b = block_of[u.long().clamp_min(0)]
    uniq, rank2d, tv, ti, tn = TT.gather_union(b, cold, vid, nbrs)
    dd = TT.fused_round_rank(qs, u, rank2d, uniq, slot_of, hv, hvid, hn,
                             tv, ti, tn, 6, metric=metric)[0]
    pd, _ = TT.tier0_fetch_rank(qs, b, slot_of, hv, cold, metric=metric)
    torch.cuda.synchronize()
    live = torch.repeat_interleave(
        (u >= 0).reshape(-1, TT.BQ * 2).any(1), TT.BQ)
    assert 0 < int(live.sum()) < 1024
    assert torch.equal(dd[live].view(torch.int32),
                       pd[live].view(torch.int32))


@pytest.mark.gpu
@pytest.mark.parametrize("q,n,d", [(8, 64, 16), (37, 203, 64), (1, 9, 8),
                                   (300, 1029, 128), (129, 257, 100),
                                   (2049, 100_003, 128), (129, 70_001, 100)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("metric", ["l2", "ip"])
def test_cuda_l2_tile_matches_plain(cuda, q, n, d, dtype, metric):
    """f32 sums in another order than cuBLAS: atol 1e-3 on values of a
    few hundred (bf16 inputs are cast to f32 first, so the same). The
    last two shapes are ragged and past one wave of CTAs (2049 x 100,003
    is 17 x 782 tiles, two CTAs an SM on 132 SMs). Each output is one
    fmaf chain over D in order, so a slice of the rows and columns gives
    the same bits; the counters add one launch and 2·Q·N·D operations."""
    rng = np.random.default_rng(q * n)
    qa = torch.as_tensor(rng.standard_normal((q, d)), dtype=dtype,
                         device=cuda)
    xa = torch.as_tensor(rng.standard_normal((n, d)), dtype=dtype,
                         device=cuda)
    TL2.reset_launches()
    got = TL2.l2_tile(qa, xa, metric=metric)
    torch.cuda.synchronize()
    assert TL2.LAUNCHES["l2_tile"] == 1
    assert TL2.OPS["l2_tile"] == 2 * q * n * d
    want = TR.pairwise_l2_ref(qa, xa, metric=metric)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-3)
    part = TL2.l2_tile(qa[q // 3:].contiguous(), xa[n // 3:].contiguous(),
                       metric=metric)
    assert torch.equal(part, got[q // 3:, n // 3:])


@pytest.mark.gpu
@pytest.mark.parametrize("n,m,k,b", [
    (64, 4, 16, 1), (133, 8, 256, 5), (17, 2, 64, 2), (10000, 8, 256, 37),
    (5000, 16, 256, 9), (1001, 8, 16, 7), (77, 4, 256, 18),
    (4099, 16, 16, 3), (64, 8, 256, 1), (33, 8, 256, 1030),
    (70, 16, 20, 21), (99, 32, 256, 3)])
def test_cuda_pq_adc_matches_plain(cuda, n, m, k, b):
    """The kernel sums over m in the plain version's order: the same
    bits, at ragged N (not a multiple of a warp's 32 rows), B (not a
    multiple of 4 or of the 16-query tile), K below 256 with code bytes
    at or above K (clamped to K - 1), and every query tile (16, 8, 4)."""
    rng = np.random.default_rng(n * m)
    codes = torch.as_tensor(rng.integers(0, 256, (n, m)).astype(np.uint8),
                            device=cuda)
    luts = torch.as_tensor(rng.standard_normal((b, m, k)).astype(np.float32),
                           device=cuda)
    TPQ.reset_launches()
    got = TPQ.pq_adc(codes, luts)
    torch.cuda.synchronize()
    assert TPQ.LAUNCHES["pq_adc"] == 1
    want = TR.pq_adc_ref(luts, codes)
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))


@pytest.mark.gpu
def test_cuda_pq_adc_rejects_what_it_has_no_instance_for(cuda):
    """M outside the kernel's instances, or LUTs past shared memory,
    raise before a launch."""
    codes = torch.zeros((8, 6), dtype=torch.uint8, device=cuda)
    with pytest.raises(ValueError):
        TPQ.pq_adc(codes, torch.zeros((2, 6, 16), device=cuda))
    codes = torch.zeros((8, 32), dtype=torch.uint8, device=cuda)
    with pytest.raises(ValueError):
        TPQ.pq_adc(codes, torch.zeros((2, 32, 512), device=cuda))


@pytest.mark.gpu
@pytest.mark.parametrize("metric", ["l2", "ip"])
@pytest.mark.parametrize("case", T0_CASES + [(1024, 5000, 6, 128, 2, 500),
                                             (3, 7, 6, 128, 2, 7)])
def test_cuda_tier0_fetch_rank_matches_plain(cuda, case, metric):
    """hit equal; the kernel sums each row as the rank pass does (warp
    lanes, xor shuffles): atol 1e-4 / rtol 1e-5 against the plain sum."""
    arrays = _on(cuda, _tier0_case(*case))
    TT.reset_launches()
    got_d, got_h = TO.tier0_rank(*arrays, metric=metric)
    torch.cuda.synchronize()
    assert TT.LAUNCHES["tier0_fetch_rank"] == 1
    want_d, want_h = TR.tier0_fetch_rank_ref(*arrays, metric=metric)
    assert torch.equal(got_h, want_h)
    torch.testing.assert_close(got_d, want_d, atol=1e-4, rtol=1e-5)


# (F, eps, D): F*eps past 16 and 32 slots, eps past a pass of 8 rows, D
# past 128 and not a multiple of it
T0_SHAPES = [(f, eps, d) for f in (1, 2, 3, 8) for eps in (1, 6, 17, 33)
             for d in (32, 96, 128, 200)]


@pytest.mark.gpu
@pytest.mark.parametrize("metric", ["l2", "ip"])
@pytest.mark.parametrize("pack", ["hot", "cold", "mixed"])
def test_cuda_tier0_fetch_rank_any_shape(cuda, pack, metric):
    """Every shape of ``T0_SHAPES`` with every block packed, none, or
    half of them; the hot tiles differ from the cold ones (so a wrong pick
    shows), one hot slot lies past the pack and a tenth of the block ids
    outside [0, rho), all clamped as the plain version clamps: hit equal,
    distances within atol 1e-4 / rtol 1e-5, one launch a call."""
    qn, rho = 37, 50
    hot_n = {"hot": rho, "cold": 0, "mixed": rho // 2}[pack]
    for f, eps, d in T0_SHAPES:
        rng = np.random.default_rng([f, eps, d])
        qs = rng.standard_normal((qn, d)).astype(np.float32)
        cold = rng.standard_normal((rho, eps, d)).astype(np.float32)
        slot_of = np.full(rho, -1, np.int32)
        slot_of[rng.permutation(rho)[:hot_n]] = np.arange(hot_n)
        hot = rng.standard_normal((max(hot_n, 1), eps, d)).astype(np.float32)
        if pack == "mixed":
            slot_of[np.flatnonzero(slot_of < 0)[0]] = hot_n + 3
        blocks = rng.integers(0, rho, (qn, f)).astype(np.int32)
        out = rng.random((qn, f)) < 0.1
        blocks[out] = rng.choice([-7, -1, rho, rho + 9], int(out.sum()))
        arrays = _on(cuda, (qs, blocks, slot_of, hot, cold))
        TT.reset_launches()
        got_d, got_h = TT.tier0_fetch_rank(*arrays, metric=metric)
        torch.cuda.synchronize()
        assert TT.LAUNCHES["tier0_fetch_rank"] == 1
        want_d, want_h = TR.tier0_fetch_rank_ref(*arrays, metric=metric)
        assert torch.equal(got_h, want_h), (f, eps, d)
        torch.testing.assert_close(got_d, want_d, atol=1e-4, rtol=1e-5,
                                   msg=lambda m: f"{(f, eps, d)}: {m}")


@pytest.mark.gpu
@pytest.mark.parametrize("metric", ["l2", "ip"])
@pytest.mark.parametrize("q,eps,d,top", BT_CASES + [
    (1024, 6, 128, 6), (128, 16, 128, 5), (33, 40, 100, 41),
    (9, 1, 128, 3), (64, 6, 128, 9), (17, 31, 40, 33), (11, 33, 24, 35),
    (5, 48, 20, 50)])
def test_cuda_block_topk_matches_plain(cuda, q, eps, d, top, metric):
    """Distances within atol 1e-3 / rtol 1e-5 of the plain norm
    expansion; the slots are the stable argsort of the kernel's own
    distances (the masked argmin), 0 past eps; eps from 1 to 48 (one
    slot a lane, then passes of 32), top_m past eps."""
    qs, tiles = _on(cuda, _bt_case(q, eps, d))
    TBT.reset_launches()
    got_d, got_i = TO.block_rank(qs, tiles, top, metric=metric)
    torch.cuda.synchronize()
    assert TBT.LAUNCHES["block_topk"] == 1
    want_d, _ = TR.block_topk_ref(qs, tiles, top, metric=metric)
    torch.testing.assert_close(got_d, want_d, atol=1e-3, rtol=1e-5)
    own = torch.argsort(got_d, dim=1, stable=True)[:, :top].to(torch.int32)
    assert torch.equal(got_i[:, : min(top, eps)], own)
    assert not got_i[:, eps:].any()
