"""State-space / linear-recurrence trunks (port of ``repro.models.ssm``):
Mamba2 (SSD) and RWKV6 (Finch).

Both run in *chunked* form — intra-chunk work is matmuls, the
inter-chunk carry a short loop over chunks — plus O(1)-state recurrent
``*_decode_step`` functions used by serving.

Numerics notes (model definition, applied consistently in both paths):
  * Mamba2 per-head decay alpha_t = exp(A * dt_t), A = -exp(A_log) < 0;
    pairwise intra-chunk exponents are <= 0, and future pairs are masked
    in the exponent (not the product), so the factored form is safe in
    f32.
  * RWKV6 per-channel log-decay is clamped to >= -4 so the factored
    chunk form (exp(+cumsum) up to chunk length 16·4 = 64 < log(f32max))
    cannot overflow.
  * Both scans and their states are f32 whatever the compute dtype.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.distributed.sharding import (batch_local, einsum, shard,
                                              unshard_dim, ways)
from repro_torch.models.layers import remat, rms_norm

RWKV_CHUNK = 16
RWKV_LOGW_MIN = -4.0


def _scan_chunks(body, carry, xs, num_chunks: int):
    """``lax.scan`` over the leading (chunk) axis of each tensor in
    ``xs``, with JAX's sqrt-checkpointing while autograd records.
    ``body(carry, xs_run) -> (carry, ys_run)`` takes a run of consecutive
    chunks and loops over them itself. When the chunk count is large (past
    32, with ``inner`` ~ sqrt(nc) dividing it) the chunks go in groups of
    ``inner``, each group rematerialized, so the backward keeps O(sqrt(nc))
    carries instead of O(nc) (the inter-chunk carry is large: [B, H, K,
    V]); otherwise ``body`` takes every chunk at once. JAX also
    checkpoints each chunk's body: here that body is the carry update
    alone (the scans batch every other term over the chunk axis), which
    holds nothing a checkpoint would drop, so that level is left out."""
    if not torch.is_grad_enabled() or num_chunks <= 32:
        return body(carry, xs)
    inner = 1
    while inner * inner < num_chunks:
        inner *= 2
    if num_chunks % inner:
        return body(carry, xs)
    group = remat(body)
    ys = []
    for xg in zip(*(t.split(inner) for t in xs)):
        carry, y = group(carry, xg)
        ys.append(y)
    return carry, torch.cat(ys)


def _carry(st, fall, add):
    """The inter-chunk carry of both scans over a run of chunks (chunk-
    major ``fall`` and ``add``): S_c = fall_c * S_{c-1} + add_c. Returns
    (the last state, each chunk's incoming state stacked). The chunks are
    ``unbind`` views, whose backward stacks their gradients in one op."""
    s_in = []
    for f, a in zip(fall.unbind(0), add.unbind(0)):
        s_in.append(st)
        st = f * st + a
    return st, torch.stack(s_in)


# =====================================================================
# Mamba2 (chunked SSD)
# =====================================================================

def _causal_conv(x: torch.Tensor, kernel: torch.Tensor,
                 state: Optional[torch.Tensor] = None
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Depthwise causal conv. x [B, S, C], kernel [K, C],
    state [B, K-1, C] (history) -> (y [B, S, C], new_state). The taps
    add in f32, rounded once, as XLA fuses them."""
    k = kernel.shape[0]
    if state is None:
        state = torch.zeros((x.shape[0], k - 1, x.shape[2]), dtype=x.dtype,
                            device=x.device)
    xp = torch.cat([state.to(x.dtype), x], dim=1)
    y = sum(xp[:, i:i + x.shape[1]].float() * kernel[i].float()
            for i in range(k))
    return y.to(x.dtype), xp[:, -(k - 1):]


def mamba_mix(params: Dict, x: torch.Tensor, cfg,
              state: Optional[Dict] = None
              ) -> Tuple[torch.Tensor, Optional[Dict]]:
    """Mamba2 mixer: in_proj -> conv -> SSD scan -> gated norm -> out_proj.

    x [B, S, D]. ``state`` (decode): {"conv": [B, K-1, C], "ssm":
    [B, H, P, N]} — pass None for training (zero initial state).
    """
    b, s, _ = x.shape
    di, n, p = cfg.d_inner, cfg.ssm_state, cfg.ssm_head_dim
    h = cfg.ssm_heads
    xn = rms_norm(x, params["ln"], cfg.norm_eps)
    proj = einsum("bsd,de->bse", xn, params["in_proj"])
    proj = shard(proj, "batch", None, "inner")
    z, xbc, dt_raw = torch.tensor_split(proj, [di, 2 * di + 2 * n], dim=-1)

    conv_state = state["conv"] if state is not None else None
    xbc, new_conv = _causal_conv(F.silu(xbc), params["conv_w"], conv_state)
    xs, bm, cm = torch.tensor_split(xbc, [di, di + n], dim=-1)
    xs = xs.reshape(b, s, h, p)

    dt = F.softplus(dt_raw.float() + params["dt_bias"])   # [B, S, H]
    log_a = -torch.exp(params["a_log"].float()) * dt

    ssm_state = state["ssm"] if state is not None else None
    y, new_ssm = batch_local(_ssd_chunked, xs, dt, log_a, bm.float(),
                             cm.float(), ssm_state, cfg.ssm_chunk,
                             batch=(0, 0, 0, 0, 0, 0, None))
    y = y + params["d_skip"][None, None, :, None] * xs.float()
    y = y.reshape(b, s, di)
    # the gate in f32, rounded once, as XLA fuses it
    y = (y.to(x.dtype).float() * F.silu(z.float())).to(x.dtype)
    y = rms_norm(y, params["gate_ln"], cfg.norm_eps)
    out = einsum("bse,ed->bsd", y, params["out_proj"])
    out = shard(out, "batch", None, "embed")
    new_state = ({"conv": new_conv.to(state["conv"].dtype),
                  "ssm": new_ssm} if state is not None else None)
    return out, new_state


def _ssd_chunked(x: torch.Tensor, dt: torch.Tensor, log_a: torch.Tensor,
                 bm: torch.Tensor, cm: torch.Tensor, s0: torch.Tensor,
                 chunk: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Chunked SSD scan.

    x [B, S, H, P]; dt/log_a [B, S, H]; bm/cm [B, S, N]; s0 [B, H, P, N]
    (None: zeros).
    y_t = C_t^T S_t,  S_t = alpha_t S_{t-1} + dt_t B_t (x_t)^T.
    Returns (y [B, S, H, P] f32, final state).

    JAX's scan body computes everything a chunk needs. Here only the
    state recurrence (``S' = exp(L_Q) S + increment``, one update a chunk)
    runs chunk by chunk; every other term is batched over the chunk axis,
    the inter-chunk output over each run of chunks from their incoming
    states. The same terms, in a few launches a chunk instead of a few
    dozen.
    """
    b, s, h, p = x.shape
    n = bm.shape[-1]
    if s0 is None:
        s0 = torch.zeros((b, h, p, n), dtype=torch.float32, device=x.device)
    q = min(chunk, s)
    assert s % q == 0, (s, q)
    nc = s // q

    def r(t, width):                     # [B, S, ...] -> [B, Nc, Q, ...]
        return t.reshape(b, nc, q, *width)

    xc, dtc, lac = r(x, (h, p)).float(), r(dt, (h,)), r(log_a, (h,))
    bc, cc = r(bm, (n,)), r(cm, (n,))
    mask = torch.tril(torch.ones((q, q), dtype=torch.bool,
                                 device=x.device))[None, None, :, :, None]
    lcum = torch.cumsum(lac, dim=2)                  # [B, Nc, Q, H]
    # intra: M[t, s'] = (C_t.B_s') exp(Lt - Ls') dt_s'  (s' <= t); the
    # exponent is masked, not the product (exp of a future pair's
    # difference overflows, and inf * 0 is NaN)
    cb = torch.einsum("bcqn,bcsn->bcqs", cc, bc)
    diff = lcum[:, :, :, None, :] - lcum[:, :, None, :, :]
    decay = torch.exp(diff.masked_fill(~mask, -torch.inf))
    m = cb[..., None] * decay * dtc[:, :, None, :, :]
    y_intra = torch.einsum("bcqsh,bcshp->bcqhp", m, xc)
    # inter: y += exp(Lt) C_t @ S_prev;
    # state: S' = exp(L_Q) S + sum_s exp(L_Q - L_s) dt_s B_s x_s^T
    growth = torch.exp(lcum)                          # [B, Nc, Q, H]
    tail = torch.exp(lcum[:, :, -1:, :] - lcum) * dtc
    add = torch.einsum("bcsn,bcshp->bchpn", bc, xc * tail[..., None])
    fall = torch.exp(lcum[:, :, -1])[..., None, None]  # [B, Nc, H, 1, 1]

    def run(st, inp):                    # chunk-major [n, B, ...]
        f, a, c, g = inp
        st, s_in = _carry(st, f, a)
        return st, torch.einsum("cbqn,cbhpn->cbqhp", c, s_in) * g[..., None]

    s_fin, y_inter = _scan_chunks(run, s0, tuple(
        t.movedim(1, 0) for t in (fall, add, cc, growth)), nc)
    y = y_intra + y_inter.movedim(0, 1)
    return y.reshape(b, s, h, p), s_fin


def mamba_decode_step(params: Dict, x: torch.Tensor, cfg,
                      state: Dict) -> Tuple[torch.Tensor, Dict]:
    """One-token recurrent step (S=1); exact recurrence, O(1) state."""
    return mamba_mix(params, x, cfg, state=state)


def init_mamba_state(cfg, batch: int, dtype=torch.float32,
                     device="cuda") -> Dict:
    c = cfg.d_inner + 2 * cfg.ssm_state      # conv acts on (x, B, C) only
    return {"conv": torch.zeros((batch, cfg.ssm_conv - 1, c), dtype=dtype,
                                device=device),
            "ssm": torch.zeros((batch, cfg.ssm_heads, cfg.ssm_head_dim,
                                cfg.ssm_state), dtype=torch.float32,
                               device=device)}


# =====================================================================
# RWKV6 (Finch)
# =====================================================================

def _token_shift(xn: torch.Tensor, state: Optional[Dict]) -> torch.Tensor:
    """The previous token's input: the carried ``shift`` for the first
    position (zeros without a state)."""
    first = (state["shift"][:, None].to(xn.dtype) if state is not None
             else torch.zeros_like(xn[:, :1]))
    return torch.cat([first, xn[:, :-1]], dim=1)


def rwkv_time_mix(params: Dict, x: torch.Tensor, cfg,
                  state: Optional[Dict] = None
                  ) -> Tuple[torch.Tensor, Optional[Dict]]:
    """RWKV6 time-mix block (WKV attention substitute).

    x [B, S, D]. ``state`` (decode): {"shift": [B, D] last input,
    "wkv": [B, H, K, V]} or None (training, zeros)."""
    b, s, d = x.shape
    h, hk = cfg.rwkv_heads, cfg.rwkv_head_dim
    xn = rms_norm(x, params["ln"], cfg.norm_eps)
    prev = _token_shift(xn, state)

    # data-dependent lerp for r, k, v, w, g
    xx = prev - xn
    xxx = xn + xx * params["mu_base"]
    lora = einsum("bsfl,fld->bsfd",
                  torch.tanh(einsum("bsd,dfl->bsfl", xxx, params["mix_wa"])),
                  params["mix_wb"])                    # [B, S, 5, D]
    mixed = xn[:, :, None] + xx[:, :, None] * (params["mu"] + lora)
    xr, xk, xv, xw, xg = [mixed[:, :, i] for i in range(5)]

    def heads(t):                        # [B, S, D] -> [B, S, H, K]
        if h % ways(t, 2):               # the mesh does not divide heads
            t = unshard_dim(t, 2)
        return t.reshape(b, s, h, hk)
    r = heads(einsum("bsd,de->bse", xr, params["wr"]))
    k = heads(einsum("bsd,de->bse", xk, params["wk"]))
    v = heads(einsum("bsd,de->bse", xv, params["wv"]))
    g = einsum("bsd,de->bse", xg, params["wg"])
    # per-channel log-decay, clamped (see module docstring)
    ww = (params["w0"]
          + einsum("bsl,ld->bsd",
                   torch.tanh(einsum("bsd,dl->bsl", xw, params["decay_wa"])),
                   params["decay_wb"]))
    logw = torch.clamp(-torch.exp(ww.float()), RWKV_LOGW_MIN, -1e-5)
    logw = heads(logw)
    u = params["u"].reshape(h, hk)

    wkv0 = state["wkv"] if state is not None else None
    y, wkv_fin = batch_local(_wkv_chunked, r.float(), k.float(), v.float(),
                             logw, u, wkv0, batch=(0, 0, 0, 0, None, 0))

    # per-head group norm (biased variance, as jnp.var), gate, out-proj
    y = y.reshape(b, s, h, hk)
    mean = y.mean(-1, keepdim=True)
    var = y.var(-1, keepdim=True, correction=0)
    y = (y - mean) * torch.rsqrt(var + 64e-5)
    y = (y * (1.0 + params["gn_g"].reshape(h, hk))
         + params["gn_b"].reshape(h, hk))
    y = y.reshape(b, s, d).to(x.dtype) * F.silu(heads(g).reshape(b, s, d))
    out = einsum("bsd,de->bse", y, params["wo"])
    out = shard(out, "batch", None, "embed")
    new_state = ({"shift": xn[:, -1].to(state["shift"].dtype),
                  "wkv": wkv_fin} if state is not None else None)
    return out, new_state


def _wkv_chunked(r, k, v, logw, u, s0
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Chunked WKV6: y_t = r_t.(diag(u) k_t v_t^T + S_{t-1});
    S_t = diag(w_t) S_{t-1} + k_t v_t^T (decays act on the K index).

    r/k/v [B, S, H, K]; logw same; u [H, K]; s0 [B, H, K, K(V)] (None:
    zeros).
    Returns (y [B, S, H, K], final state). f32 throughout. As in
    ``_ssd_chunked``, only the state recurrence runs chunk by chunk and
    every other term is batched over the chunk axis.
    """
    b, s, h, hk = r.shape
    if s0 is None:
        s0 = torch.zeros((b, h, hk, hk), dtype=torch.float32, device=r.device)
    q = min(RWKV_CHUNK, s)
    assert s % q == 0, (s, q)
    nc = s // q

    def rs(t):                           # [B, S, ...] -> [B, Nc, Q, ...]
        return t.reshape(b, nc, q, h, hk)

    rc, kc, vc, wc = rs(r), rs(k), rs(v), rs(logw)
    mask = torch.tril(torch.ones((q, q), dtype=torch.bool, device=r.device),
                      -1)
    uf = u.float()
    wcum = torch.cumsum(wc, dim=2)                    # inclusive
    wex = wcum - wc                                   # exclusive
    # inter-chunk: y_t += (r_t * exp(Wex_t)) @ S_prev
    rr = rc * torch.exp(wex)
    # intra: A[t,s'] = sum_k r_tk k_s'k exp(Wex_t - Wc_s'), s' < t
    kk = kc * torch.exp(-wcum)
    a = torch.einsum("bcqhk,bcshk->bchqs", rr, kk)
    a = a.masked_fill(~mask, 0.0)
    # bonus diagonal: r_t.(u * k_t) v_t
    diag = torch.einsum("bcqhk,bcqhk->bcqh", rc, kc * uf)
    av = torch.einsum("bchqs,bcshv->bcqhv", a, vc)
    dv = diag[..., None] * vc
    # state update: S' = exp(Wc_Q) S + sum_s exp(Wc_Q - Wc_s) k_s v_s^T
    tail = torch.exp(wcum[:, :, -1:] - wcum)          # [B, Nc, Q, H, K]
    add = torch.einsum("bcshk,bcshv->bchkv", kc * tail, vc)
    fall = torch.exp(wcum[:, :, -1])[..., None]       # [B, Nc, H, K, 1]

    def run(st, inp):                    # chunk-major [n, B, ...]
        f, a, rq = inp
        st, s_in = _carry(st, f, a)
        return st, torch.einsum("cbqhk,cbhkv->cbqhv", rq, s_in)

    s_fin, y_inter = _scan_chunks(run, s0, tuple(
        t.movedim(1, 0) for t in (fall, add, rr)), nc)
    y = y_inter.movedim(0, 1) + av + dv
    return y.reshape(b, s, h, hk), s_fin


def rwkv_channel_mix(params: Dict, x: torch.Tensor, cfg,
                     state: Optional[Dict] = None
                     ) -> Tuple[torch.Tensor, Optional[Dict]]:
    """RWKV6 channel-mix (FFN substitute): squared-ReLU keyed FFN with
    receptance gate and token shift."""
    xn = rms_norm(x, params["ln"], cfg.norm_eps)
    xx = _token_shift(xn, state) - xn
    xk = xn + xx * params["mu_k"]
    xr = xn + xx * params["mu_r"]
    kk = einsum("bsd,df->bsf", xk, params["wk"])
    kk = shard(torch.square(torch.relu(kk)), "batch", None, "ff")
    vv = einsum("bsf,fd->bsd", kk, params["wv"])
    rr = torch.sigmoid(einsum("bsd,de->bse", xr, params["wr"]))
    out = shard(rr * vv, "batch", None, "embed")
    new_state = ({"shift": xn[:, -1].to(state["shift"].dtype)}
                 if state is not None else None)
    return out, new_state


def rwkv_layer(params: Dict, x: torch.Tensor, cfg,
               state: Optional[Dict] = None
               ) -> Tuple[torch.Tensor, Optional[Dict]]:
    tm_state = state["tm"] if state is not None else None
    cm_state = state["cm"] if state is not None else None
    a, tm_new = rwkv_time_mix(params["tm"], x, cfg, tm_state)
    x = x + a
    m, cm_new = rwkv_channel_mix(params["cm"], x, cfg, cm_state)
    x = x + m
    new = ({"tm": tm_new, "cm": cm_new} if state is not None else None)
    return x, new


def init_rwkv_state(cfg, batch: int, dtype=torch.float32,
                    device="cuda") -> Dict:
    d, h, hk = cfg.d_model, cfg.rwkv_heads, cfg.rwkv_head_dim
    return {"tm": {"shift": torch.zeros((batch, d), dtype=dtype,
                                        device=device),
                   "wkv": torch.zeros((batch, h, hk, hk),
                                      dtype=torch.float32, device=device)},
            "cm": {"shift": torch.zeros((batch, d), dtype=dtype,
                                        device=device)}}
