"""Attention-free mixers: RWKV6 "Finch" (data-dependent decay) and Mamba2.

Port of ``repro/models/ssm.py``, with the recurrent states.  Over a whole
sequence with ``use_kernels`` (the loss and prefill forwards) RWKV6's
WKV recurrence goes through ``kernels/ops.py::routed_wkv6`` (a CUDA
kernel on the card, the sequential plain version on the CPU), as the
reference's does; ``wkv6_chunked``, the reference's chunked form in
plain torch, threads the state without ``use_kernels`` and is the CPU
statement of the algorithm the chunked CUDA kernel (``csrc/wkv6.cu``)
implements; a decode step is ``wkv6_step``.

Mamba2 (``mamba2_mixer``) is plain torch on every route, as the
reference's is plain ``jnp``: the SSD's chunked form (``_ssd_chunked``)
over a whole sequence, one recurrent step in a decode step.

Over the model axis's ranks (``sharding.ModelShards``) each mixer runs
on the rank's block of its heads or channels, as its leaves' shapes say:
the time mix and Mamba2 between the f and g that ``transformer`` puts
around them, the channel mix with its own (``rwkv6_channel_mix``).
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import ops
from repro_torch.models.layers import (Leaf, Params, normal, ones,
                                       rms_norm, zeros)

# Clamp on the per-step log decay (the reference's; w >= exp(-3.5)).
# With chunk 16 and the midpoint normalisation, |exponent| <= 3.5 * 16, so
# even the masked upper-triangle products stay finite (<= e^56) in f32.
_LOG_DECAY_MIN = -3.5
_RWKV_CHUNK = 16
_MAMBA_CHUNK = 64


def rwkv6_specs(cfg: ModelConfig) -> Params:
    d, ff = cfg.d_model, cfg.d_ff
    hd = cfg.ssm.head_dim
    h = d // hd
    sd = d ** -0.5
    lora = max(32, hd // 2)
    half = Leaf((d,), ("full", 0.5))
    return {
        # time-mix interpolation coefficients (token shift)
        "mu_r": half, "mu_k": half, "mu_v": half, "mu_g": half, "mu_w": half,
        "w_r": normal(sd, d, h, hd),
        "w_k": normal(sd, d, h, hd),
        "w_v": normal(sd, d, h, hd),
        "w_g": normal(sd, d, h, hd),
        "w_o": normal(sd, h, hd, d),
        # data-dependent decay: w = exp(-exp(w0 + tanh(x A) B))
        "w0": Leaf((h, hd), ("linspace", -6.0, -1.0)),
        "w_lora_a": normal(sd, d, lora),
        "w_lora_b": normal(lora ** -0.5, lora, h, hd),
        "u": normal(0.1, h, hd),
        "ln_out": ones(h, hd),
        # channel mix; the reference draws w_r_cm from w_r's key, so the
        # two start equal (transformer.init_params copies it)
        "mu_k_cm": half, "mu_r_cm": half,
        "w_k_cm": normal(sd, d, ff),
        "w_v_cm": normal(ff ** -0.5, ff, d),
        "w_r_cm": normal(sd, d, d),
    }


def wkv6_chunked(r, k, v, lw, u, chunk: int = _RWKV_CHUNK, s0=None):
    """Chunked-parallel WKV6 recurrence (the reference's, in torch).

    r, k, v: (B, T, H, K); lw: (B, T, H, K) per-channel log decay (<= 0,
    clipped to [_LOG_DECAY_MIN, -1e-6]); u: (H, K); s0: optional initial
    state (B, H, K, K).  T must be a multiple of ``chunk``.  Returns
    (o (B, T, H, K) in r's type, s_final (B, H, K, K) f32).

    Per step: o_t = r_t·(S_{t-1} + diag(u) k_t v_tᵀ);
    S_t = diag(w_t) S_{t-1} + k_t v_tᵀ.
    """
    b, t, h, kk = r.shape
    if t % chunk:
        raise ValueError(f"wkv6_chunked wants T a multiple of {chunk}, "
                         f"got {t}")
    nc = t // chunk
    f32 = torch.float32
    r_, k_, v_ = (a.to(f32).reshape(b, nc, chunk, h, kk) for a in (r, k, v))
    lw_ = torch.clamp(lw.to(f32), _LOG_DECAY_MIN, -1e-6)
    lw_ = lw_.reshape(b, nc, chunk, h, kk)

    L = torch.cumsum(lw_, dim=2)                  # inclusive Σ log w in a chunk
    # the midpoint normalisation keeps exp() in f32's range
    c = L[:, :, chunk // 2:chunk // 2 + 1]
    Lq = torch.cat([torch.zeros_like(L[:, :, :1]), L[:, :, :-1]], dim=2)
    rt = r_ * torch.exp(Lq - c)                   # r̃
    kt = k_ * torch.exp(c - L)                    # k̃

    # within-chunk token-token term: strictly lower triangle + u-diagonal
    m = torch.einsum("bnchk,bnshk->bnhcs", rt, kt)
    tri = torch.tril(torch.ones((chunk, chunk), dtype=f32, device=r.device),
                     diagonal=-1)
    m = m * tri
    diag = torch.einsum("bnchk,hk,bnchk->bnch", r_, u.to(f32), k_)
    o_intra = (torch.einsum("bnhcs,bnshv->bnchv", m, v_)
               + diag[..., None] * v_)

    # chunk-state contributions and the scan over chunks:
    #   S_end = exp(L_C)⊙S0 + Σ_τ exp(L_C - L_τ) k_τ v_τᵀ
    decay_full = torch.exp(L[:, :, -1])           # Π w over a chunk (B,nc,H,K)
    add = torch.einsum("bnshk,bnshv->bnhkv",
                       k_ * torch.exp(L[:, :, -1:] - L), v_)
    s = (torch.zeros((b, h, kk, kk), dtype=f32, device=r.device)
         if s0 is None else s0.to(f32))
    o_cross = []
    for n in range(nc):
        o_cross.append(torch.einsum("bchk,bhkv->bchv",
                                    rt[:, n] * torch.exp(c[:, n]), s))
        s = decay_full[:, n][..., None] * s + add[:, n]
    o = o_intra + torch.stack(o_cross, dim=1)
    return o.reshape(b, t, h, kk).to(r.dtype), s


def wkv6_step(r, k, v, lw, u, s):
    """One recurrent step.  r, k, v, lw: (B, H, K); s: (B, H, K, V) f32.
    Returns (o (B, H, V) in r's type, the new state f32)."""
    f32 = torch.float32
    r_, k_, v_, lw_ = (a.to(f32) for a in (r, k, v, lw))
    kv = k_[..., :, None] * v_[..., None, :]                 # (B,H,K,V)
    o = torch.einsum("bhk,bhkv->bhv", r_, s + u.to(f32)[..., None] * kv)
    s_new = torch.exp(lw_)[..., None] * s + kv
    return o.to(r.dtype), s_new


def _token_shift(x: torch.Tensor, shift_state=None) -> torch.Tensor:
    """x shifted one step later in time: zero at t = 0 over a whole
    sequence, the carried last input in a decode step."""
    if shift_state is None:
        return F.pad(x, (0, 0, 1, 0))[:, :-1]
    return shift_state[:, None, :]


def rwkv6_time_mix(x: torch.Tensor, p: Params, cfg: ModelConfig,
                   shift_state=None, wkv_state=None):
    """RWKV6 attention replacement.  x: (B, T, D); with states given, T is
    1 (a decode step).  Returns (y (B, T, D), (new_shift, new_wkv)).  The
    heads are ``p["w_r"]``'s (the rank's block over the model axis's
    ranks, whose ``y`` is its share of ``w_o``'s product).

    The WKV recurrence takes the reference's three routes: over a whole
    sequence with ``use_kernels``, ``ops.routed_wkv6`` (the kernel on the
    card), which gives no state, so a zero state is returned (the loss
    and prefill forwards discard it); over a whole sequence without,
    ``wkv6_chunked`` from a zero state; in a decode step, ``wkv6_step``
    from ``wkv_state``."""
    b, t, d = x.shape
    hd = cfg.ssm.head_dim
    h = p["w_r"].shape[1]
    delta = _token_shift(x, shift_state) - x
    x_r, x_k = x + delta * p["mu_r"], x + delta * p["mu_k"]
    x_v, x_g = x + delta * p["mu_v"], x + delta * p["mu_g"]
    x_w = x + delta * p["mu_w"]

    def heads(a, w):                           # (B,T,D) x (D,H,K) -> (B,T,H,K)
        return torch.matmul(a, w.reshape(d, h * hd)).view(b, t, h, hd)

    r = heads(x_r, p["w_r"])
    k = heads(x_k, p["w_k"])
    v = heads(x_v, p["w_v"])
    g = F.silu(heads(x_g, p["w_g"]))

    lora = torch.matmul(torch.tanh(torch.matmul(x_w, p["w_lora_a"])),
                        p["w_lora_b"].reshape(-1, h * hd)).view(b, t, h, hd)
    lw = -torch.exp(torch.clamp(p["w0"].to(torch.float32)
                                + lora.to(torch.float32), max=1.2528))
    lw = torch.clamp(lw, _LOG_DECAY_MIN, -1e-6)          # exp(1.2528) = 3.5

    if wkv_state is None:
        if cfg.use_kernels:
            o = ops.routed_wkv6(r, k, v, lw, p["u"])
            s_fin = torch.zeros((b, h, hd, hd), dtype=torch.float32,
                                device=x.device)
        else:
            o, s_fin = wkv6_chunked(r, k, v, lw, p["u"])
    else:
        o1, s_fin = wkv6_step(r[:, 0], k[:, 0], v[:, 0], lw[:, 0], p["u"],
                              wkv_state)
        o = o1[:, None]

    # per-head group norm, gate, out proj
    o32 = o.to(torch.float32)
    mu = torch.mean(o32, dim=-1, keepdim=True)
    var = torch.var(o32, dim=-1, keepdim=True, unbiased=False)
    o = ((o32 - mu) * torch.rsqrt(var + 64e-5)
         * p["ln_out"].to(torch.float32)).to(x.dtype)
    y = torch.matmul((o * g).reshape(b, t, h * hd),
                     p["w_o"].reshape(h * hd, d))
    return y, (x[:, -1, :], s_fin)


def rwkv6_channel_mix(x: torch.Tensor, p: Params, shift_state=None,
                      cfg: Optional[ModelConfig] = None, ctx=None):
    """RWKV6 FFN (relu² channel mix).  Returns (y, new_shift).  Where
    the rank holds a block of the hidden units (``w_v_cm``'s rows against
    ``cfg.d_ff``; ``ctx`` a ``transformer.ShardCtx``), Megatron's f wraps
    the k branch's input alone and g the ``w_v_cm`` product: the r branch
    (``w_r_cm``) is whole, and an f on ``x`` would sum its input's
    gradient M times."""
    delta = _token_shift(x, shift_state) - x
    x_k = x + delta * p["mu_k_cm"]
    x_r = x + delta * p["mu_r_cm"]
    cut = ctx is not None and p["w_v_cm"].shape[0] != cfg.d_ff
    if cut:
        x_k = ctx.model_in(x_k, True)
    k = torch.square(F.relu(torch.matmul(x_k, p["w_k_cm"])))
    kv = torch.matmul(k, p["w_v_cm"])
    if cut:
        kv = ctx.model_out(kv, True, False)
    r = torch.sigmoid(torch.matmul(x_r, p["w_r_cm"]))
    return r * kv, x[:, -1, :]


def rwkv6_state_shape(cfg: ModelConfig, batch: int):
    hd = cfg.ssm.head_dim
    h = cfg.d_model // hd
    return {
        "shift_tm": (batch, cfg.d_model),
        "shift_cm": (batch, cfg.d_model),
        "wkv": (batch, h, hd, hd),
    }


# ---------------------------------------------------------------------------
# Mamba2 (SSD)
# ---------------------------------------------------------------------------

def mamba2_specs(cfg: ModelConfig) -> Params:
    """The reference's ``init_mamba2``: the canonical fused in_proj and
    conv split into z / xs / BC / dt parts (a depthwise conv split per
    channel is the same conv).  ``a_log`` (log of linspace(1, 16, H)) and
    ``dt_bias`` are f32 whatever the model's type, as there."""
    s = cfg.ssm
    d = cfg.d_model
    d_in = s.expand * d
    h = d_in // s.head_dim
    bc_ch = 2 * s.n_groups * s.state_size
    sd = d ** -0.5
    return {
        "w_z": normal(sd, d, d_in),
        "w_xs": normal(sd, d, d_in),
        "w_bc": normal(sd, d, bc_ch),
        "w_dt": normal(sd, d, h),
        "conv_w_xs": normal(0.2, s.conv_width, d_in),
        "conv_b_xs": zeros(d_in),
        "conv_w_bc": normal(0.2, s.conv_width, bc_ch),
        "conv_b_bc": zeros(bc_ch),
        "a_log": Leaf((h,), ("log_linspace", 1.0, 16.0), torch.float32),
        "dt_bias": Leaf((h,), ("full", 0.0), torch.float32),
        "dd": ones(h),
        "norm": ones(d_in),
        "out_proj": normal(d_in ** -0.5, d_in, d),
    }


def _segsum(a: torch.Tensor) -> torch.Tensor:
    """a: (..., C) log decays -> (..., C, C) lower-triangular decay matrix
    exp(Σ_{s < τ ≤ t} a_τ); masked to -inf before the exp, as the
    reference (an exp of a large untaken entry would make gradients NaN)."""
    c = a.shape[-1]
    cs = torch.cumsum(a, dim=-1)
    seg = cs[..., :, None] - cs[..., None, :]
    mask = torch.tril(torch.ones((c, c), dtype=torch.bool, device=a.device))
    return torch.exp(seg.masked_fill(~mask, float("-inf")))


def _causal_conv(xbc: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                 state=None):
    """Depthwise causal conv.  xbc: (B, T, C); w: (W, C); state: the last
    W - 1 inputs (B, W - 1, C), zeros without.  Returns (silu(conv + b)
    in xbc's type, the new state).  The taps are summed in f32 and the
    result rounded once, as XLA's fusion of the reference's sum rounds it
    (eager torch would round every add in bf16); the W windows are one
    strided view, so the conv is a product and a sum, not W of each."""
    width = w.shape[0]
    if state is None:
        state = torch.zeros((xbc.shape[0], width - 1, xbc.shape[2]),
                            dtype=xbc.dtype, device=xbc.device)
    xp = torch.cat([state, xbc], dim=1)
    f32 = torch.float32
    windows = xp.to(f32).unfold(1, width, 1)            # (B, T, C, W)
    out = torch.sum(windows * w.t().to(f32), dim=-1)
    return F.silu(out + b.to(f32)).to(xbc.dtype), xp[:, -(width - 1):]


def mamba2_mixer(x: torch.Tensor, p: Params, cfg: ModelConfig, state=None,
                 ctx=None):
    """Mamba2 block.  x: (B, T, D).  ``state`` ({"conv_xs", "conv_bc":
    (B, W - 1, C), "ssm": (B, H, P, N) f32}) given: a decode step, T = 1.
    Returns (y (B, T, D), the new state: convs in x's type, ssm f32).

    The inner channels are ``p["w_z"]``'s: where they are the rank's block
    over the model axis's ranks (``ctx`` a ``transformer.ShardCtx``), its
    heads from head ``model_block`` × their count read their columns of
    ``w_dt`` and their entries of ``a_log`` / ``dt_bias`` / ``dd``, their
    groups' B and C, the RMS norm's sum of squares is summed over the
    model group (``ModelShards.stat``) and divided by the whole d_in, and
    ``y`` is the rank's share of ``out_proj``'s product."""
    s = cfg.ssm
    b, t, d = x.shape
    whole = s.expand * d
    d_in = p["w_z"].shape[1]
    g, n, pdim = s.n_groups, s.state_size, s.head_dim
    h, h_all = d_in // pdim, whole // pdim
    cut = d_in != whole
    head0 = ctx.model_block * h if cut else 0
    f32 = torch.float32

    def own(leaf, dim):                 # the rank's heads of a whole leaf
        return leaf.narrow(dim, head0, h) if cut else leaf

    z = torch.matmul(x, p["w_z"])
    xs_raw = torch.matmul(x, p["w_xs"])
    bc_raw = torch.matmul(x, p["w_bc"])
    dt_raw = torch.matmul(x, own(p["w_dt"], 1))
    # F.softplus returns x above 20, where log1p(exp(x)) and x are one f32
    # value: jax.nn.softplus, in f32
    dt = F.softplus(dt_raw.to(f32) + own(p["dt_bias"], 0))  # (B,T,H)

    st = state or {}
    xs_c, new_conv_xs = _causal_conv(xs_raw, p["conv_w_xs"], p["conv_b_xs"],
                                     st.get("conv_xs"))
    bc_c, new_conv_bc = _causal_conv(bc_raw, p["conv_w_bc"], p["conv_b_bc"],
                                     st.get("conv_bc"))
    xs = xs_c.reshape(b, t, h, pdim)
    # the groups' B and C broadcast over their heads (head j of the whole
    # model in group j // (H / G))
    bb = own(bc_c[..., :g * n].reshape(b, t, g, n).repeat_interleave(
        h_all // g, 2), 2)
    cc = own(bc_c[..., g * n:].reshape(b, t, g, n).repeat_interleave(
        h_all // g, 2), 2)

    a = -torch.exp(own(p["a_log"], 0))                      # (H,) negative
    la = dt * a                                             # (B,T,H) log decay
    xs32 = xs.to(f32) * dt[..., None]                       # dt folded into x

    if state is None:
        y, s_fin = _ssd_chunked(xs32, la, bb.to(f32), cc.to(f32))
    else:
        dec = torch.exp(la[:, 0])                           # (B,H)
        s_fin = (dec[..., None, None] * state["ssm"]
                 + xs32[:, 0, :, :, None] * bb[:, 0, :, None, :].to(f32))
        y = torch.matmul(s_fin, cc[:, 0, :, :, None].to(f32))[:, None, ..., 0]

    y = y + own(p["dd"], 0).to(f32)[:, None] * xs.to(f32)
    y = y.reshape(b, t, d_in).to(x.dtype) * F.silu(z)
    if cut:                             # the whole d_in's mean of squares
        y32 = y.to(f32)
        ss = ctx.ranks.stat(torch.sum(torch.square(y32), dim=-1,
                                      keepdim=True))
        y = (y32 * torch.rsqrt(ss / whole + 1e-5)
             * p["norm"].to(f32)).to(y.dtype)
    else:
        y = rms_norm(y, p["norm"], 1e-5)          # before the out projection
    out = torch.matmul(y, p["out_proj"])
    return out, {"conv_xs": new_conv_xs, "conv_bc": new_conv_bc,
                 "ssm": s_fin}


def _ssd_chunked(xs, la, bb, cc, chunk: int = _MAMBA_CHUNK):
    """Chunked SSD (the reference's form).  xs: (B, T, H, P) f32 with dt
    folded in; la: (B, T, H) log decay; bb / cc: (B, T, H, N).  T is padded
    to a multiple of ``chunk``.  Returns (y (B, T, H, P), the final state
    (B, H, P, N)).  The reference's three-operand contractions are each an
    elementwise product and one matrix product, so nothing of six
    dimensions is formed; its scan over chunks is a loop carrying the
    state, and the states entering the chunks are read back in one
    product."""
    b, t, h, pdim = xs.shape
    n = bb.shape[-1]
    pad = (-t) % chunk
    if pad:
        xs, bb, cc = (F.pad(u, (0, 0, 0, 0, 0, pad)) for u in (xs, bb, cc))
        la = F.pad(la, (0, 0, 0, pad))
    nc = (t + pad) // chunk
    xs = xs.reshape(b, nc, chunk, h, pdim)
    bb = bb.reshape(b, nc, chunk, h, n)
    cc = cc.reshape(b, nc, chunk, h, n)
    lam = la.reshape(b, nc, chunk, h).transpose(2, 3)       # (B,nc,H,C)

    # within a chunk: y_c = Σ_s (C_c·B_s) decay(s→c) x_s
    scores = torch.einsum("bnchk,bnshk->bnhcs", cc, bb)
    y_diag = torch.einsum("bnhcs,bnshp->bnchp", scores * _segsum(lam), xs)

    # each chunk's own final state, and the decay across a whole chunk
    cum = torch.cumsum(lam, dim=-1)                         # (B,nc,H,C)
    dec_to_end = torch.exp(cum[..., -1:] - cum)
    s_chunk = torch.einsum("bnshk,bnshp->bnhpk",
                           bb * dec_to_end.transpose(2, 3)[..., None], xs)
    dec_full = torch.exp(cum[..., -1])[..., None, None]     # (B,nc,H,1,1)

    state = torch.zeros((b, h, pdim, n), dtype=xs.dtype, device=xs.device)
    entering = []
    for i in range(nc):
        entering.append(state)
        state = torch.addcmul(s_chunk[:, i], dec_full[:, i], state)
    # from the state entering a chunk: exp(cum) decays from the chunk's
    # start (exclusive) to c (inclusive)
    y_off = torch.einsum("bnchk,bnhpk->bnchp", cc,
                         torch.stack(entering, dim=1))
    y_off = y_off * torch.exp(cum).transpose(2, 3)[..., None]
    y = (y_diag + y_off).reshape(b, nc * chunk, h, pdim)
    return y[:, :t], state


def mamba2_state_shape(cfg: ModelConfig, batch: int):
    s = cfg.ssm
    d_in = s.expand * cfg.d_model
    h = d_in // s.head_dim
    return {
        "conv_xs": (batch, s.conv_width - 1, d_in),
        "conv_bc": (batch, s.conv_width - 1, 2 * s.n_groups * s.state_size),
        "ssm": (batch, h, s.head_dim, s.state_size),
    }
