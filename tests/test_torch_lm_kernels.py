"""The port's flash_attention and wkv6 wrappers against the JAX package's.

Inputs come from a seeded numpy draw and go to both packages.  On the CPU
the port's ``ops.flash_attention`` / ``ops.wkv6`` take their plain
versions (``kernels/ref.py``), so these tests pin the function the CUDA
kernels are held to on the card (``chip_smoke.py`` does that comparison
there).  A few cases run the JAX Pallas kernels in interpret mode, as
tests/test_kernels.py runs them (slow); the rest hold the port against
``repro.kernels.ref``.

Tolerances are tests/test_kernels.py's: attention 2e-5 in f32 and 2e-2 in
bf16, wkv6 1e-4 in f32 and 5e-2 in bf16 (rtol and atol).  f32 differs
only in the order of the sums; in bf16 the reference rounds its scores
and probabilities to bf16 while the Pallas kernel keeps them f32, and
XLA's fused bf16 ops round in other places than eager torch.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.models.ssm import _LOG_DECAY_MIN
from repro_torch.kernels import ops, ref
from repro_torch.models import ssm

DTYPES = {"f32": (jnp.float32, torch.float32),
          "bf16": (jnp.bfloat16, torch.bfloat16)}
ATTN_TOL = {"f32": 2e-5, "bf16": 2e-2}
WKV_TOL = {"f32": 1e-4, "bf16": 5e-2}


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _both(x: np.ndarray, dtype: str):
    jdt, tdt = DTYPES[dtype]
    j = jnp.asarray(x).astype(jdt)
    t = torch.from_numpy(x).to(tdt)
    # both frameworks round f32 -> bf16 to nearest even: the same values
    assert np.array_equal(np.asarray(j.astype(jnp.float32)),
                          t.to(torch.float32).numpy())
    return j, t


def _close(got: torch.Tensor, want, tol: float):
    np.testing.assert_allclose(got.to(torch.float32).numpy(),
                               np.asarray(want, np.float32),
                               rtol=tol, atol=tol)


def _attn_inputs(b, s, hq, hkv, d, dtype, seed):
    rng = np.random.default_rng(seed)
    arrays = [rng.normal(size=(b, s, h, d)).astype(np.float32)
              for h in (hq, hkv, hkv)]
    return [_both(a, dtype) for a in arrays]


def _jax_ref_attention(q, k, v, causal, window):
    """The reference's routed CPU leg: repeat k/v per query head, then
    ``ref.attention_ref`` in (B, H, S, D)."""
    g = q.shape[2] // k.shape[2]
    kf, vf = jnp.repeat(k, g, axis=2), jnp.repeat(v, g, axis=2)
    out = jref.attention_ref(q.transpose(0, 2, 1, 3), kf.transpose(0, 2, 1, 3),
                             vf.transpose(0, 2, 1, 3), causal=causal,
                             window=window)
    return out.transpose(0, 2, 1, 3)


# -- attention against the Pallas kernel in interpret mode (few: slow) ----

@pytest.mark.parametrize("b,s,hq,hkv,d,dtype,causal,window", [
    (2, 256, 6, 2, 120, "f32", True, 0),      # danube's D with GQA
    (2, 256, 6, 2, 120, "bf16", True, 0),
    (2, 256, 4, 2, 64, "f32", True, 16),      # sliding window
    (1, 128, 4, 4, 64, "f32", False, 0),      # non-causal
])
def test_flash_attention_matches_pallas_kernel(b, s, hq, hkv, d, dtype,
                                               causal, window):
    (jq, tq), (jk, tk), (jv, tv) = _attn_inputs(b, s, hq, hkv, d, dtype,
                                                seed=s + hq + d + window)
    want = jops.flash_attention(jq, jk, jv, causal=causal, window=window,
                                interpret=True)
    got = ops.flash_attention(tq, tk, tv, causal=causal, window=window)
    assert got.dtype == tq.dtype and got.shape == tq.shape
    _close(got, want, ATTN_TOL[dtype])


# -- attention against the reference's plain version ----------------------

@pytest.mark.parametrize("b,s,hq,hkv,d", [
    (2, 32, 4, 2, 12),        # the danube smoke config's attention
    (1, 64, 8, 8, 128),
    (2, 48, 6, 2, 120),
])
@pytest.mark.parametrize("window", [0, 16])
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_flash_attention_matches_reference_ref(b, s, hq, hkv, d, window,
                                              dtype):
    (jq, tq), (jk, tk), (jv, tv) = _attn_inputs(b, s, hq, hkv, d, dtype,
                                                seed=b * s + d + window)
    want = _jax_ref_attention(jq, jk, jv, True, window)
    _close(ops.routed_attention(tq, tk, tv, causal=True, window=window),
           want, ATTN_TOL[dtype])


def test_flash_attention_takes_strided_views():
    """k and v as views into one fused projection (strides over heads and
    sequence that are not their own shape's): the wrapper reads strides."""
    (jq, tq), (jkv, tkv), _ = _attn_inputs(1, 40, 4, 4, 16, "f32", seed=5)
    tk, tv = tkv[:, :, :2], tkv[:, :, 2:]
    want = _jax_ref_attention(jq, jkv[:, :, :2], jkv[:, :, 2:], True, 8)
    _close(ops.flash_attention(tq, tk, tv, window=8), want, ATTN_TOL["f32"])


# -- wkv6 -----------------------------------------------------------------

def _wkv_inputs(b, t, h, kk, dtype, seed, lw_dtype=None):
    """r, k, v, u in ``dtype``; lw clipped to the model's range, in
    ``lw_dtype`` (default: ``dtype``, as tests/test_kernels.py makes it)
    for JAX and always f32 (the same values) for the port."""
    rng = np.random.default_rng(seed)
    r, k, v = (rng.normal(size=(b, t, h, kk)).astype(np.float32)
               for _ in range(3))
    lw = np.clip(-np.exp(rng.normal(size=(b, t, h, kk))), _LOG_DECAY_MIN,
                 -1e-6).astype(np.float32)
    u = (rng.normal(size=(h, kk)) * 0.1).astype(np.float32)
    jr, tr = zip(*(_both(a, dtype) for a in (r, k, v, u)))
    jlw, tlw = _both(lw, lw_dtype or dtype)
    return jr, tr, jlw, tlw.to(torch.float32)


@pytest.mark.parametrize("b,t,h,kk", [(2, 64, 2, 16), (1, 128, 4, 32),
                                      (2, 96, 3, 8)])
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_wkv6_matches_pallas_kernel(b, t, h, kk, dtype):
    (jr, jk, jv, ju), (tr, tk, tv, tu), jlw, tlw = _wkv_inputs(
        b, t, h, kk, dtype, seed=t * h + kk)
    want = jops.wkv6(jr, jk, jv, jlw, ju, chunk=32, interpret=True)
    got = ops.wkv6(tr, tk, tv, tlw, tu)
    assert got.dtype == tr.dtype and got.shape == tr.shape
    _close(got, want, WKV_TOL[dtype])
    want_ref, _ = jref.wkv6_ref(jr, jk, jv, jlw, ju)
    _close(got, want_ref, WKV_TOL[dtype])


@pytest.mark.parametrize("b,t,h,kk", [(2, 32, 4, 16), (1, 37, 2, 64),
                                      (1, 50, 3, 8)])
def test_wkv6_mixed_types_match_reference(b, t, h, kk):
    """The model's hand-over: bf16 r/k/v/u with f32 lw."""
    (jr, jk, jv, ju), (tr, tk, tv, tu), jlw, tlw = _wkv_inputs(
        b, t, h, kk, "bf16", seed=b + t + kk, lw_dtype="f32")
    assert jlw.dtype == jnp.float32
    want, _ = jref.wkv6_ref(jr, jk, jv, jlw, ju)
    got = ops.routed_wkv6(tr, tk, tv, tlw, tu)
    assert got.dtype == torch.bfloat16
    _close(got, want, WKV_TOL["bf16"])


def test_wkv6_ref_state_matches_reference():
    (jr, jk, jv, ju), (tr, tk, tv, tu), jlw, tlw = _wkv_inputs(
        1, 24, 2, 16, "f32", seed=3)
    _, s_want = jref.wkv6_ref(jr, jk, jv, jlw, ju)
    _, s_got = ref.wkv6_ref(tr, tk, tv, tlw, tu)
    _close(s_got, s_want, WKV_TOL["f32"])


def test_log_decay_clamp_is_the_reference_s():
    assert ssm._LOG_DECAY_MIN == _LOG_DECAY_MIN


# -- the wrappers' contract ------------------------------------------------

def test_cpu_routes_count_no_launch():
    """The plain versions are not kernel launches: the counts stay put."""
    before = (ops.flash_attention_launches, ops.wkv6_launches)
    x = torch.ones(1, 8, 2, 16)
    ops.flash_attention(x, x, x)
    ops.wkv6(x, x, x, -torch.ones(1, 8, 2, 16), torch.ones(2, 16))
    assert (ops.flash_attention_launches, ops.wkv6_launches) == before


_Q = torch.ones(1, 8, 4, 16)
_KV = torch.ones(1, 8, 2, 16)


@pytest.mark.parametrize("q,k,v,kw,err", [
    (_Q.double(), _KV.double(), _KV.double(), {}, TypeError),
    (_Q, _KV.bfloat16(), _KV, {}, TypeError),
    (_Q, torch.ones(1, 8, 3, 16), torch.ones(1, 8, 3, 16), {}, ValueError),
    (_Q, torch.ones(1, 9, 2, 16), torch.ones(1, 9, 2, 16), {}, ValueError),
    (torch.ones(1, 8, 4, 130), torch.ones(1, 8, 2, 130),
     torch.ones(1, 8, 2, 130), {}, ValueError),              # D > 128
    (torch.ones(1, 8, 16, 4).transpose(2, 3), _KV, _KV, {},
     ValueError),                                            # D strided
    (_Q, _KV, _KV, {"window": -1}, ValueError),
    (_Q[0], _KV[0], _KV[0], {}, ValueError),
    (_Q.to("meta"), _KV.to("meta"), _KV.to("meta"), {}, ValueError),
])
def test_flash_attention_wrapper_rejects(q, k, v, kw, err):
    with pytest.raises(err):
        ops.flash_attention(q, k, v, **kw)


_R = torch.ones(1, 8, 2, 16)


@pytest.mark.parametrize("r,lw,u,err", [
    (_R.bfloat16(), -_R.bfloat16(), torch.ones(2, 16).bfloat16(),
     TypeError),                                             # lw not f32
    (_R, -_R, torch.ones(2, 16).bfloat16(), TypeError),
    (_R, -_R, torch.ones(3, 16), ValueError),
    (torch.ones(1, 8, 2, 12), -torch.ones(1, 8, 2, 12), torch.ones(2, 12),
     ValueError),                                            # K not built
    (torch.ones(1, 0, 2, 16), -torch.ones(1, 0, 2, 16), torch.ones(2, 16),
     ValueError),
    (torch.ones(1, 2, 8, 16).transpose(1, 2), -_R, torch.ones(2, 16),
     ValueError),                                            # not contiguous
])
def test_wkv6_wrapper_rejects(r, lw, u, err):
    with pytest.raises(err):
        ops.wkv6(r, r, r, lw, u)
