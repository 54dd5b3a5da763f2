"""The wkv6 wrapper's choice between its two CUDA kernels, the port's
chunked form against the reference's, and the chunked kernel's arithmetic
against the gates ``chip_smoke.py`` holds it to on the card.

``ops.wkv6_route`` is a pure function of type, shape and alignment, so it
is pinned here on CPU tensors (the card sees the same choice;
``chip_smoke.py`` checks it there beside each kernel).  The chunked CUDA
kernel runs only on the card; what can be pinned here is its algorithm:
the port's ``models/ssm.py::wkv6_chunked`` against the reference's and
against the sequential ``wkv6_ref``, and ``_kernel_arithmetic`` below,
which repeats the kernel's arithmetic in torch (16-step chunks, the
midpoint factors, zero padding past T, the lw clip, and bf16 at the
kernel's MMA operands) so that the choice of where to round is tested.

Tolerances: the port's f32 chunked form against the reference's 1e-5
relative (the same sums in another order), bf16 2e-2 (the reference's
bf16 gate in tests/test_torch_lm_models.py); against ``wkv6_ref`` in f32
‖err‖/‖ref‖ ≤ 1e-5; the kernel's arithmetic against ``chip_smoke.py``'s
bf16 gates (5e-2 of max |ref|, ‖err‖/‖ref‖ ≤ 1e-2 over the tensor and
≤ 5e-2 over each output row).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.models import ssm as jssm
from repro_torch.kernels import ops, ref
from repro_torch.models import ssm

F32, BF16 = torch.float32, torch.bfloat16


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _args(b, t, h, kk, dtype=BF16, lw_dtype=F32):
    x = torch.zeros(b, t, h, kk, dtype=dtype)
    return x, x, x, torch.zeros(b, t, h, kk, dtype=lw_dtype), torch.zeros(
        h, kk, dtype=dtype)


# -- the route --------------------------------------------------------------

@pytest.mark.parametrize("kk,want", [(8, "serial"), (16, "chunked"),
                                     (32, "chunked"), (64, "chunked")])
def test_bf16_with_f32_decay_routes_by_head_size(kk, want):
    assert ops.wkv6_route(*_args(2, 16, 4, kk)) == want


@pytest.mark.parametrize("kk", [8, 16, 32, 64])
def test_f32_always_takes_serial(kk):
    assert ops.wkv6_route(*_args(2, 16, 4, kk, dtype=F32)) == "serial"


@pytest.mark.parametrize("kk", [16, 64])
def test_bf16_decay_takes_serial(kk):
    """lw in bf16 is not the kernels' contract (the wrapper refuses it);
    the route does not call it chunked."""
    assert ops.wkv6_route(*_args(1, 16, 2, kk, lw_dtype=BF16)) == "serial"


def test_one_f32_operand_takes_serial():
    r, k, v, lw, u = _args(1, 16, 2, 64)
    assert ops.wkv6_route(r, k, v.float(), lw, u) == "serial"
    assert ops.wkv6_route(r, k, v, lw, u.float()) == "serial"


def test_misaligned_view_takes_serial():
    """A view that starts one element (2 bytes) into its storage: the
    chunked kernel's 16-byte copies cannot read it."""
    r, k, v, lw, u = _args(1, 16, 2, 64)
    flat = torch.zeros(r.numel() + 8, dtype=BF16)
    for off, want in ((1, "serial"), (8, "chunked")):
        r_off = flat[off:off + r.numel()].view(r.shape)
        assert ops.wkv6_route(r_off, k, v, lw, u) == want


def test_route_is_the_wrappers_choice_on_the_card(monkeypatch):
    """On a CUDA tensor the wrapper launches the route's variant and no
    other; on the CPU it takes the plain version and counts nothing."""
    launched = []
    monkeypatch.setattr(ops, "_wkv6_launch",
                        lambda *a: launched.append(a[-1]) or a[0])

    class FakeCuda(torch.Tensor):
        @property
        def device(self):
            return torch.device("cuda")

    for dtype, kk, want in ((BF16, 64, "chunked"), (F32, 64, "serial"),
                            (BF16, 8, "serial")):
        args = [a.as_subclass(FakeCuda) for a in _args(1, 8, 2, kk, dtype)]
        ops.wkv6(*args)
        assert launched[-1] == want
    before = (ops.wkv6_launches, ops.wkv6_chunked_launches,
              ops.wkv6_serial_launches)
    r, k, v, lw, u = _args(1, 8, 2, 64)
    ops.wkv6(r, k, v, lw - 1.0, u)
    assert (ops.wkv6_launches, ops.wkv6_chunked_launches,
            ops.wkv6_serial_launches) == before


@pytest.mark.parametrize("variant", ["chunked", "serial", "wgmma"])
def test_private_launch_refuses_cpu_tensors_and_unknown_variants(variant):
    with pytest.raises(ValueError):
        ops._wkv6_launch(*_args(1, 8, 2, 64), variant)


def test_private_launch_refuses_chunked_for_f32():
    with pytest.raises(ValueError, match="chunked"):
        ops._wkv6_launch(*_args(1, 8, 2, 64, dtype=F32), "chunked")


# -- the port's wkv6_chunked against the reference's -----------------------

def _inputs(b, t, h, kk, seed, lw_const=None, with_s0=False):
    rng = np.random.default_rng(seed)
    r, k, v = (rng.normal(size=(b, t, h, kk)).astype(np.float32)
               for _ in range(3))
    if lw_const is None:
        lw = np.clip(-np.exp(rng.normal(size=(b, t, h, kk))), -3.5, -1e-6)
    else:
        lw = np.full((b, t, h, kk), lw_const)
    u = (rng.normal(size=(h, kk)) * 0.1).astype(np.float32)
    s0 = (rng.normal(size=(b, h, kk, kk)).astype(np.float32)
          if with_s0 else None)
    return r, k, v, lw.astype(np.float32), u, s0


def _rel(got: torch.Tensor, want) -> float:
    got = got.to(F32).numpy().astype(np.float64)
    want = np.asarray(want, np.float32).astype(np.float64)
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


@pytest.mark.parametrize("b,t,h,kk,with_s0", [(2, 64, 2, 16, False),
                                              (1, 96, 3, 64, True),
                                              (2, 32, 2, 32, True)])
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_chunked_matches_reference_chunked(b, t, h, kk, with_s0, dtype):
    r, k, v, lw, u, s0 = _inputs(b, t, h, kk, seed=t + kk, with_s0=with_s0)
    jdt, tdt = ((jnp.float32, F32) if dtype == "f32"
                else (jnp.bfloat16, BF16))
    j = [jnp.asarray(a).astype(jdt) for a in (r, k, v)]
    tt = [torch.from_numpy(a).to(tdt) for a in (r, k, v)]
    want_o, want_s = jssm.wkv6_chunked(
        *j, jnp.asarray(lw), jnp.asarray(u).astype(jdt),
        s0=None if s0 is None else jnp.asarray(s0))
    got_o, got_s = ssm.wkv6_chunked(
        *tt, torch.from_numpy(lw), torch.from_numpy(u).to(tdt),
        s0=None if s0 is None else torch.from_numpy(s0))
    tol = 1e-5 if dtype == "f32" else 2e-2
    assert got_o.dtype == tdt and got_s.dtype == F32
    assert _rel(got_o, want_o.astype(jnp.float32)) <= tol
    assert _rel(got_s, want_s) <= tol


@pytest.mark.parametrize("lw_const", [-3.5, -1.0, -1e-6])
def test_chunked_is_finite_and_exact_at_the_clamp_edges(lw_const):
    """Chunk 16 holds the midpoint factorisation at the clamp: the masked
    pairs reach e^{3.5 · 16}, finite in f32 (at chunk 32 the reference's
    form overflows there and its ``m * tri`` turns inf into NaN)."""
    r, k, v, lw, u, _ = _inputs(1, 128, 2, 16, seed=7, lw_const=lw_const)
    args = [torch.from_numpy(a) for a in (r, k, v, lw, u)]
    got_o, got_s = ssm.wkv6_chunked(*args, chunk=16)
    want_o, want_s = ref.wkv6_ref(*args)
    assert torch.isfinite(got_o).all() and torch.isfinite(got_s).all()
    assert _rel(got_o, want_o.numpy()) <= 1e-5
    assert _rel(got_s, want_s.numpy()) <= 1e-5


def test_chunked_refuses_a_ragged_t():
    r, k, v, lw, u, _ = _inputs(1, 20, 1, 16, seed=1)
    with pytest.raises(ValueError, match="multiple of 16"):
        ssm.wkv6_chunked(*(torch.from_numpy(a) for a in (r, k, v, lw, u)))


@pytest.mark.parametrize("b,t,h,kk", [(2, 64, 2, 64), (1, 48, 3, 16)])
def test_routed_chunked_inputs_match_the_pallas_kernel(b, t, h, kk):
    """The model's hand-over on the chunked route (bf16 r/k/v/u, f32 lw):
    on the CPU ``routed_wkv6`` is the plain version, held against the
    Pallas kernel in interpret mode."""
    r, k, v, lw, u, _ = _inputs(b, t, h, kk, seed=b * t + kk)
    tt = [torch.from_numpy(a).to(BF16) for a in (r, k, v, u)]
    tlw = torch.from_numpy(lw)
    assert ops.wkv6_route(*tt[:3], tlw, tt[3]) == "chunked"
    j = [jnp.asarray(a).astype(jnp.bfloat16) for a in (r, k, v, u)]
    want = jops.wkv6(*j[:3], jnp.asarray(lw), j[3], chunk=16, interpret=True)
    got = ops.routed_wkv6(*tt[:3], tlw, tt[3])
    assert got.dtype == BF16
    np.testing.assert_allclose(got.to(F32).numpy(),
                               np.asarray(want.astype(jnp.float32)),
                               rtol=5e-2, atol=5e-2)


# -- the chunked kernel's arithmetic -----------------------------------------

def _bf(x: torch.Tensor) -> torch.Tensor:
    return x.to(BF16).to(F32)


def _product(a, b, split: bool):
    """a @ b with both operands rounded to bf16, or split into a bf16 pair
    hi + lo and multiplied as hi·hi + hi·lo + lo·hi (the kernel's three
    MMAs)."""
    if not split:
        return _bf(a) @ _bf(b)
    a_hi, b_hi = _bf(a), _bf(b)
    a_lo, b_lo = _bf(a - a_hi), _bf(b - b_hi)
    return a_hi @ b_hi + a_hi @ b_lo + a_lo @ b_hi


def _kernel_arithmetic(r, k, v, lw, u, split: bool = True):
    """``csrc/wkv6.cu``'s chunked variant in torch: lw clipped, T padded
    to 16 with zeros, per chunk the midpoint factors in f32, the scores and
    the cross term from split (or plain) bf16 operands, A, the state's
    increment and the output rounded to bf16, S kept in f32."""
    b, t, h, kk = r.shape
    chunk = 16
    pad = -t % chunk
    r_, k_, v_ = (torch.nn.functional.pad(x.to(F32), (0, 0, 0, 0, 0, pad))
                  for x in (r, k, v))
    lw_ = torch.nn.functional.pad(torch.clamp(lw, -3.5, -1e-6),
                                  (0, 0, 0, 0, 0, pad))
    tri = torch.tril(torch.ones(chunk, chunk, dtype=torch.bool), -1)
    eye = torch.eye(chunk, dtype=torch.bool)
    s = torch.zeros(b, h, kk, kk)
    out = []
    for n in range(r_.shape[1] // chunk):
        rc, kc, vc, lc = (x[:, n * chunk:(n + 1) * chunk].transpose(1, 2)
                          for x in (r_, k_, v_, lw_))
        L = torch.cumsum(lc, 2)
        mid = L[:, :, chunk // 2:chunk // 2 + 1]
        Lq = torch.cat([torch.zeros_like(L[:, :, :1]), L[:, :, :-1]], 2)
        rt = rc * torch.exp(Lq - mid)
        kt = kc * torch.exp(mid - L)
        diag = (rc * u.to(F32)[None, :, None, :] * kc).sum(-1)
        p = _product(rt, kt.transpose(-1, -2), split)
        a = torch.where(tri, p, torch.where(eye, diag[..., None], 0.0))
        out.append(_product(rt * torch.exp(mid), s, split) + _bf(a) @ vc)
        s = (torch.exp(L[:, :, -1])[..., None] * s
             + _bf(kt * torch.exp(L[:, :, -1:] - mid)).transpose(-1, -2) @ vc)
    return torch.cat(out, 2)[:, :, :t].transpose(1, 2).to(r.dtype)


def _gates(got, want):
    """chip_smoke.py's three readings: max|err|/max|ref|, ‖err‖/‖ref‖ and
    the worst row's ‖err‖/‖ref‖."""
    diff = (got.to(F32) - want.to(F32)).flatten(0, -2)
    want = want.to(F32).flatten(0, -2)
    row = diff.norm(dim=-1) / want.norm(dim=-1).clamp_min(1e-30)
    return (float(diff.abs().max() / want.abs().max()),
            float(diff.norm() / want.norm()), float(row.max()))


@pytest.mark.parametrize("b,t,h,kk,lw_const", [
    (1, 256, 4, 64, -3.5), (1, 256, 4, 64, -1e-6), (1, 256, 4, 64, None),
    (2, 101, 2, 32, None), (2, 64, 2, 16, None)])
def test_kernel_arithmetic_meets_the_chip_gates(b, t, h, kk, lw_const):
    r, k, v, lw, u, _ = _inputs(b, t, h, kk, seed=t * kk, lw_const=lw_const)
    tt = [torch.from_numpy(a).to(BF16) for a in (r, k, v, u)]
    tlw = torch.from_numpy(lw)
    want = ref.wkv6_ref(*tt[:3], tlw, tt[3])[0]
    got = _kernel_arithmetic(*tt[:3], tlw, tt[3])
    assert torch.isfinite(got.to(F32)).all()
    top, norm, row = _gates(got, want)
    assert top <= 5e-2 and norm <= 1e-2 and row <= 5e-2


def test_one_bf16_rounding_of_the_factors_misses_the_row_gate():
    """Why the kernel splits r~, k~, r exp(Lq) and S into bf16 pairs: with
    one bf16 rounding, rows whose sums cancel lose their digits at the
    clamp."""
    r, k, v, lw, u, _ = _inputs(1, 256, 4, 64, seed=256 * 64, lw_const=-3.5)
    tt = [torch.from_numpy(a).to(BF16) for a in (r, k, v, u)]
    tlw = torch.from_numpy(lw)
    want = ref.wkv6_ref(*tt[:3], tlw, tt[3])[0]
    assert _gates(_kernel_arithmetic(*tt[:3], tlw, tt[3], split=False),
                  want)[2] > 5e-2
    assert _gates(_kernel_arithmetic(*tt[:3], tlw, tt[3]), want)[2] <= 5e-2


def test_kernel_arithmetic_clips_out_of_contract_decay():
    """lw far below the clamp and above 0: the clip keeps every factor
    finite, and inside the contract it changes nothing."""
    r, k, v, lw, u, _ = _inputs(1, 48, 2, 16, seed=3)
    tt = [torch.from_numpy(a).to(BF16) for a in (r, k, v, u)]
    wild = torch.from_numpy(lw) * 40.0 + 1.0
    assert torch.isfinite(_kernel_arithmetic(*tt[:3], wild, tt[3]).to(
        F32)).all()
    inside = torch.from_numpy(lw)
    assert torch.equal(_kernel_arithmetic(*tt[:3], inside, tt[3]),
                       _kernel_arithmetic(*tt[:3], inside.clamp(-3.5, -1e-6),
                                          tt[3]))
