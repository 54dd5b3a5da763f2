"""The attention wrapper's choice between its two CUDA kernels, and bf16
parity at each published head size the tensor-core variant serves.

``ops.flash_route`` is a pure function of type, shape, strides and
alignment, so it is pinned here on CPU tensors (the card sees the same
choice; ``chip_smoke.py`` checks it there beside each kernel).  The
wrapper refuses on the CPU what the chosen kernel would refuse on the
card.  Parity: the port's ``ops.flash_attention`` (its plain version on
the CPU) against the JAX Pallas kernel in interpret mode and against the
reference's plain version, at D = 80 (zamba2, hubert) and D = 128 (qwen2,
deepseek-coder, command-r+, chameleon, llama4); D = 120 (danube) is in
tests/test_torch_lm_kernels.py.  Tolerances are tests/test_kernels.py's:
2e-2 in bf16, 2e-5 in f32 (rtol and atol).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch.kernels import ops

BF16_TOL = 2e-2
F32_TOL = 2e-5


def _qkv(b, s, hq, hkv, d, dtype=torch.bfloat16):
    return (torch.zeros(b, s, hq, d, dtype=dtype),
            torch.zeros(b, s, hkv, d, dtype=dtype),
            torch.zeros(b, s, hkv, d, dtype=dtype))


# -- the route --------------------------------------------------------------

@pytest.mark.parametrize("d,want", [(12, "simt"), (64, "wgmma"),
                                    (80, "wgmma"), (120, "wgmma"),
                                    (128, "wgmma"), (8, "wgmma"),
                                    (100, "simt")])
def test_route_by_head_size_in_bf16(d, want):
    assert ops.flash_route(*_qkv(2, 16, 4, 2, d)) == want


@pytest.mark.parametrize("d", [12, 64, 80, 120, 128])
def test_f32_always_takes_simt(d):
    assert ops.flash_route(*_qkv(2, 16, 4, 2, d, torch.float32)) == "simt"


def test_head_stride_off_the_16_byte_grid_takes_simt():
    """k/v cut from a wider last axis: the head stride (124 elements) is no
    multiple of 8."""
    q, _, _ = _qkv(1, 16, 4, 2, 120)
    wide = torch.zeros(1, 16, 2, 124, dtype=torch.bfloat16)
    k = wide[..., :120]
    assert k.stride(2) == 124
    assert ops.flash_route(q, k, k) == "simt"
    wide8 = torch.zeros(1, 16, 2, 128, dtype=torch.bfloat16)[..., :120]
    assert ops.flash_route(q, wide8, wide8) == "wgmma"


def test_misaligned_offset_view_takes_simt():
    """A view that starts one element (2 bytes) into its storage."""
    q, k, v = _qkv(1, 16, 4, 2, 64)
    flat = torch.zeros(q.numel() + 8, dtype=torch.bfloat16)
    for off, want in ((1, "simt"), (8, "wgmma")):
        q_off = flat[off:off + q.numel()].view(q.shape)
        assert q_off.data_ptr() % 16 == (0 if off == 8 else 2)
        assert ops.flash_route(q_off, k, v) == want


def test_fused_kv_views_take_wgmma():
    """k and v as views into one fused projection: strides over heads and
    sequence that are not their own shape's, all on the 16-byte grid."""
    q, _, _ = _qkv(2, 16, 8, 2, 120)
    kv = torch.zeros(2, 16, 4, 120, dtype=torch.bfloat16)
    k, v = kv[:, :, :2], kv[:, :, 2:]
    assert v.data_ptr() - kv.data_ptr() == 2 * 120 * 2
    assert ops.flash_route(q, k, v) == "wgmma"


def test_extent_one_dims_ignore_their_stride():
    """A batch or head extent of 1 is never stepped: any stride there."""
    q = torch.zeros(1, 16, 1, 64, dtype=torch.bfloat16)
    q = q.as_strided(q.shape, (3, 64, 5, 1))
    k = torch.zeros(1, 16, 1, 64, dtype=torch.bfloat16)
    assert ops.flash_route(q, k, k) == "wgmma"


def test_zero_stride_takes_simt():
    """k/v broadcast over the sequence (stride 0) go to the SIMT kernel."""
    q, _, _ = _qkv(1, 16, 2, 1, 64)
    k = torch.zeros(1, 1, 1, 64, dtype=torch.bfloat16).expand(1, 16, 1, 64)
    assert k.stride(1) == 0
    assert ops.flash_route(q, k, k) == "simt"


# -- the wrapper refuses on the CPU what the card would refuse --------------

def test_wgmma_cannot_be_forced_on_inputs_it_does_not_take():
    """The private launcher (which chip_smoke.py uses to time the SIMT
    kernel) refuses the wgmma kernel where flash_route does not give it,
    before it looks at the device."""
    with pytest.raises(ValueError, match="wgmma"):
        ops._flash_launch(*_qkv(1, 8, 2, 2, 16, torch.float32), "wgmma",
                          causal=True, window=0)
    with pytest.raises(ValueError, match="wgmma"):
        ops._flash_launch(*_qkv(1, 8, 2, 2, 12), "wgmma", causal=True,
                          window=0)


def test_unknown_route_is_refused():
    with pytest.raises(ValueError, match="sdpa"):
        ops._flash_launch(*_qkv(1, 8, 2, 2, 16), "sdpa", causal=True,
                          window=0)


def test_simt_grid_limit_is_refused_on_the_cpu_too():
    """The SIMT kernel puts B·Hq on a grid axis of at most 65535."""
    q = torch.zeros(1, 1, 65536, 8)
    kv = torch.zeros(1, 1, 1, 8)
    with pytest.raises(ValueError, match="grid"):
        ops.flash_attention(q, kv, kv)
    out = ops.flash_attention(q[:, :, :65535], kv, kv)
    assert out.shape == (1, 1, 65535, 8)


def test_launcher_never_takes_the_plain_version():
    """On CPU tensors the launcher raises: only flash_attention takes the
    plain version, and only for CPU tensors."""
    for variant, dtype in (("wgmma", torch.bfloat16),
                           ("simt", torch.float32)):
        q, k, v = _qkv(1, 8, 2, 2, 64, dtype)
        assert variant == "simt" or ops.flash_route(q, k, v) == variant
        with pytest.raises(ValueError, match="CUDA"):
            ops._flash_launch(q, k, v, variant, causal=True, window=0)


def test_cpu_route_counts_no_variant_launch():
    before = (ops.flash_attention_launches,
              ops.flash_attention_wgmma_launches,
              ops.flash_attention_simt_launches)
    ops.flash_attention(*_qkv(1, 8, 2, 2, 64))
    ops.flash_attention(*_qkv(1, 8, 2, 2, 64, torch.float32))
    assert (ops.flash_attention_launches,
            ops.flash_attention_wgmma_launches,
            ops.flash_attention_simt_launches) == before


# -- bf16 parity at the published head sizes the wgmma variant serves -------

def _inputs(b, s, hq, hkv, d, dtype, seed):
    rng = np.random.default_rng(seed)
    out = []
    for h in (hq, hkv, hkv):
        a = rng.normal(size=(b, s, h, d)).astype(np.float32)
        jdt, tdt = ((jnp.bfloat16, torch.bfloat16) if dtype == "bf16"
                    else (jnp.float32, torch.float32))
        out.append((jnp.asarray(a).astype(jdt), torch.from_numpy(a).to(tdt)))
    return out


def _close(got, want, tol):
    np.testing.assert_allclose(got.to(torch.float32).numpy(),
                               np.asarray(want, np.float32),
                               rtol=tol, atol=tol)


@pytest.mark.parametrize("d", [80, 128])
@pytest.mark.parametrize("causal,window", [(True, 0), (True, 32),
                                           (False, 0)])
def test_bf16_matches_pallas_kernel(d, causal, window):
    (jq, tq), (jk, tk), (jv, tv) = _inputs(1, 128, 4, 2, d, "bf16",
                                           seed=d + window + causal)
    assert ops.flash_route(tq, tk, tv) == "wgmma"
    want = jops.flash_attention(jq, jk, jv, causal=causal, window=window,
                                interpret=True)
    got = ops.flash_attention(tq, tk, tv, causal=causal, window=window)
    assert got.dtype == torch.bfloat16 and got.shape == tq.shape
    _close(got, want, BF16_TOL)


@pytest.mark.parametrize("d", [80, 128])
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("s", [37, 130])
def test_matches_reference_plain_version(d, dtype, s):
    """Ragged S against the wgmma kernel's 128-row tiles, GQA 6 → 2."""
    (jq, tq), (jk, tk), (jv, tv) = _inputs(2, s, 6, 2, d, dtype,
                                           seed=s * d)
    g = 3
    want = jref.attention_ref(
        jq.transpose(0, 2, 1, 3),
        jnp.repeat(jk, g, axis=2).transpose(0, 2, 1, 3),
        jnp.repeat(jv, g, axis=2).transpose(0, 2, 1, 3),
        causal=True, window=0).transpose(0, 2, 1, 3)
    _close(ops.routed_attention(tq, tk, tv, causal=True), want,
           BF16_TOL if dtype == "bf16" else F32_TOL)
