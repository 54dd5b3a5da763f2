"""Checked wrappers around the port's CUDA kernels.

A wrapper takes its kernel's plain version (``kernels/ref.py``) only for
tensors on the CPU.  For a CUDA tensor it launches the kernel or raises:
nothing falls back.  Each wrapper counts its launches in a plain integer
(``gram_launches``, ``flash_attention_launches``, ``wkv6_launches``,
``row_mean_launches``; the attention and wkv6 launches also per variant), so a run can show that its
path went through the kernel.  A wrapper checks
what its kernel takes on both routes, so the CPU tests refuse what the
card would refuse.

The kernels have no backward (the reference's Pallas kernels define no
VJP), so every wrapper refuses, on both routes, a call that autograd
would record: grad enabled and an input that requires grad.  Training
runs ``use_kernels=False``, as the reference's launcher does.
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from repro_torch.kernels import build, ref

#: CTAs in the gram kernel's one thread-block cluster (1-16; above 8 is
#: Hopper's non-portable cluster size)
GRAM_CLUSTER = 16
#: threads of a gram CTA, elements of [X | y] a stage holds at most, most
#: rows per stage, most row groups (kThreads, kStageElems, kMaxGroups in
#: csrc/gram.cu)
GRAM_THREADS = 256
GRAM_STAGE_ELEMS = 8192
GRAM_MAX_STAGE_ROWS = 256
GRAM_MAX_GROUPS = 8
#: dynamic shared memory of a gram CTA the kernel sizes its rounds to
#: (kSmemBytes: sm_90's opt-in of 227 KB)
GRAM_SMEM_BYTES = 232_448

#: widest head the flash attention kernels take (kMaxD in
#: csrc/flash_attention.cu)
FLASH_MAX_D = 128
#: the largest grid each variant can launch: wgmma walks B·Hq·⌈S/128⌉ work
#: items (one per CTA, or several per CTA on a persistent grid), SIMT puts
#: B·Hq on a grid axis of at most 65535
_WGMMA_BLOCK_Q = 128
_WGMMA_MAX_ITEMS = 2**31 - 1
_SIMT_MAX_HEADS = 65535
#: head sizes the wkv6 kernels are built for (csrc/wkv6.cu): the serial
#: variant takes all, the chunked one all but 8
WKV6_HEAD_SIZES = (8, 16, 32, 64)
WKV6_CHUNKED_HEAD_SIZES = (16, 32, 64)

#: launches of each kernel since the process started (or the caller last
#: reset them)
gram_launches = 0
flash_attention_launches = 0          # both variants
flash_attention_wgmma_launches = 0
flash_attention_simt_launches = 0
wkv6_launches = 0                     # both variants
wkv6_chunked_launches = 0
wkv6_serial_launches = 0
row_mean_launches = 0

_TYPES = (torch.float32, torch.bfloat16)
_SUFFIX = {torch.float32: "f32", torch.bfloat16: "bf16"}

_GRAM_DTYPES = {torch.float32: "gram_f32", torch.bfloat16: "gram_bf16"}
_GRAM_ARGTYPES = ([ctypes.c_void_p] * 2 + [ctypes.c_int] * 5
                  + [ctypes.c_void_p] * 3)
_gram_fns = {}


def _gram_fn(dtype: torch.dtype):
    """The gram kernel's C entry point for ``dtype``, loaded and typed once."""
    fn = _gram_fns.get(dtype)
    if fn is None:
        fn = _gram_fns[dtype] = _kernel_fn("gram", _GRAM_DTYPES[dtype],
                                           _GRAM_ARGTYPES)
    return fn


def gram_stage_rows(c: int) -> int:
    """Rows of X the gram kernel stages at a time for c columns: as many
    as fill a stage's ``GRAM_STAGE_ELEMS`` elements of [X | y], at most
    ``GRAM_MAX_STAGE_ROWS``, and one where a row is wider."""
    return max(1, min(GRAM_MAX_STAGE_ROWS, GRAM_STAGE_ELEMS // (c + 1)))


class GramShape(NamedTuple):
    """What the gram kernel derives from c, the tile side and the cluster
    size (``make_shape`` in csrc/gram.cu)."""
    cols: int      # C = c + 1: columns of [X | y]
    pitch: int     # C rounded up to the tile side: a staged row's floats
    nt: int        # tiles per side
    slots: int     # (nt // 2 + 1) * nt folded tile slots
    groups: int    # copies of the slot map over interleaved rows
    passes: int    # walks over the rows in one round over all slots
    owned: int     # most slots a rank owns in a round (0: none fits)
    round: int     # slots per round: owned * cluster
    rounds: int    # rounds over the slots


def gram_shape(c: int, tile: int, cluster: int = GRAM_CLUSTER) -> GramShape:
    """The gram kernel's tile map and rounds for c columns: each round
    takes as many slots a rank as the shared memory beside the barrier,
    two stages of ``gram_stage_rows(c)`` rows and (with more than one
    group) every group's sums holds."""
    cols = c + 1
    pitch = -(-cols // tile) * tile
    nt = pitch // tile
    slots = (nt // 2 + 1) * nt
    fit = GRAM_THREADS // (-(-slots // 32) * 32)
    groups = 1 if fit < 1 else min(fit, GRAM_MAX_GROUPS)
    part = groups * slots if groups > 1 else 0
    room = ((GRAM_SMEM_BYTES - 16) // 4 - 2 * gram_stage_rows(c) * pitch
            - part * tile * tile)
    owned = min(-(-slots // cluster), max(room, 0) // (cluster * tile * tile))
    rounds = -(-slots // (owned * cluster)) if owned else 0
    return GramShape(cols, pitch, nt, slots, groups,
                     -(-slots // GRAM_THREADS), owned, owned * cluster, rounds)


def gram_tile(m: int, c: int, cluster: int = GRAM_CLUSTER) -> int:
    """Side of the square of sums each gram thread holds: 4 where one pass
    of 4 x 4 tiles covers the triangle and every rank's rows fit one stage
    (the call is latency-bound: smaller tiles, more threads on the rows),
    else 8 (the call streams rows: 8 x 8 tiles read shared memory half as
    often per FMA)."""
    nt = -(-(c + 1) // 4)
    one_pass = (nt // 2 + 1) * nt <= GRAM_THREADS
    return 4 if one_pass and m <= cluster * gram_stage_rows(c) else 8


def gram(x: torch.Tensor, y: torch.Tensor):
    """x: (m, c); y: (m,) -> (XᵀX (c,c), Xᵀy (c,)) in f32.

    x and y are f32 or bf16 (the same type), contiguous, on one device.
    CPU tensors take ``ref.gram_ref``; CUDA tensors take the kernel in
    ``csrc/gram.cu``: one launch of one ``GRAM_CLUSTER``-CTA cluster on the
    current stream, for any c whose one staged row leaves a CTA room for a
    round of one slot (c up to about 28,500).  G and r are views into one
    buffer.
    """
    if x.dim() != 2 or y.dim() != 1 or y.shape[0] != x.shape[0]:
        raise ValueError(f"gram wants x (m, c) and y (m,), got "
                         f"{tuple(x.shape)} and {tuple(y.shape)}")
    if x.dtype not in _GRAM_DTYPES or y.dtype != x.dtype:
        raise TypeError(f"gram takes f32 or bf16 x and y of one type, got "
                        f"{x.dtype} and {y.dtype}")
    if x.device != y.device:
        raise ValueError(f"x on {x.device}, y on {y.device}")
    if not (x.is_contiguous() and y.is_contiguous()):
        raise ValueError("gram wants contiguous x and y")
    _refuse_backward("gram", x, y)
    if x.device.type == "cpu":
        return ref.gram_ref(x, y)
    if x.device.type != "cuda":
        raise ValueError(f"gram runs on the CPU or a CUDA device, not "
                         f"{x.device}")
    m, c = x.shape
    if m < 1 or c < 1 or gram_shape(c, gram_tile(m, c)).owned < 1:
        raise ValueError(f"the gram kernel takes m ≥ 1 and c ≥ 1 with one "
                         f"staged row and a round of one slot in a CTA's "
                         f"shared memory, got x {tuple(x.shape)}")
    return _gram_launch(x, y, GRAM_CLUSTER)


def _gram_launch(x, y, cluster: int):
    """Launch the gram kernel as one cluster of ``cluster`` CTAs on CUDA x
    and y that ``gram`` has checked, and count the launch.  ``gram`` calls
    this with ``GRAM_CLUSTER``; ``chip_smoke.py`` also calls it to time
    another cluster size."""
    global gram_launches
    fn = _gram_fn(x.dtype)
    m, c = x.shape
    dev = x.device.index
    if dev == torch.cuda.current_device():
        err, out = _gram_call(fn, x, y, m, c, cluster, dev)
    else:
        with torch.cuda.device(dev):
            err, out = _gram_call(fn, x, y, m, c, cluster, dev)
    if err != 0:
        raise RuntimeError(f"gram kernel launch failed with CUDA error {err} "
                           f"at x {tuple(x.shape)} {x.dtype}")
    gram_launches += 1
    return out[:c * c].view(c, c), out[c * c:]


def _gram_call(fn, x, y, m, c, cluster, dev):
    """One launch into a fresh (c² + c) buffer; the raw stream handle is
    read without building a ``torch.cuda.Stream`` (a host cost per call)."""
    out = torch.empty(c * c + c, dtype=torch.float32, device=x.device)
    ptr = out.data_ptr()
    return fn(x.data_ptr(), y.data_ptr(), m, c, cluster, gram_stage_rows(c),
              gram_tile(m, c, cluster), ptr, ptr + 4 * c * c,
              torch._C._cuda_getCurrentRawStream(dev)), out


def _refuse_backward(what: str, *tensors) -> None:
    """Raise where autograd would record the call: a kernel's output has
    no ``grad_fn``, so a backward through it would stop there and give q,
    k, v and everything upstream no gradient, while the CPU route's plain
    version would differentiate.  The same on both routes."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        raise RuntimeError(
            f"{what} has no backward: its CUDA kernel defines none (nor "
            f"does the reference's Pallas kernel).  Training runs with "
            f"use_kernels=False, as the reference's launcher does; call the "
            f"kernel under torch.no_grad() or on tensors that do not "
            f"require grad")


def _kernel_fn(lib: str, name: str, argtypes):
    fn = getattr(build.load(lib), name)
    fn.argtypes = argtypes
    fn.restype = ctypes.c_int
    return fn


def _device_route(what: str, *tensors) -> bool:
    """True for CUDA tensors (the kernel), False for CPU ones (the plain
    version); raises for mixed or other devices."""
    dev = tensors[0].device
    if any(t.device != dev for t in tensors):
        raise ValueError(f"{what} wants all inputs on one device, got "
                         f"{[str(t.device) for t in tensors]}")
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"{what} runs on the CPU or a CUDA device, not "
                         f"{dev}")
    return dev.type == "cuda"


_FLASH_ARGTYPES = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 5
                   + [ctypes.c_void_p] * 3
                   + [ctypes.c_float, ctypes.c_int, ctypes.c_int,
                      ctypes.c_void_p])


def flash_route(q, k, v) -> str:
    """Which attention kernel takes (q, k, v) on the card: ``"wgmma"`` (the
    tensor-core variant: TMA loads and bf16 ``wgmma``) for bf16 with D a
    multiple of 8 up to 128, 16-byte-aligned data pointers and, for every
    batch, sequence and head extent above 1, a positive stride that is a
    multiple of 8 elements (TMA's 16-byte rule); ``"simt"`` (f32 on the
    CUDA cores) for everything else, f32 included.  Decided from type,
    shape, strides and alignment alone, the same for CPU and CUDA
    tensors."""
    d = q.shape[-1]
    if q.dtype != torch.bfloat16 or d % 8 or d > FLASH_MAX_D:
        return "simt"
    for t in (q, k, v):
        if t.data_ptr() % 16:
            return "simt"
        for size, stride in zip(t.shape[:3], t.stride()[:3]):
            if size > 1 and (stride <= 0 or stride % 8):
                return "simt"
    return "wgmma"


def flash_attention(q, k, v, *, causal: bool = True, window: int = 0):
    """q: (B, S, Hq, D); k/v: (B, S, Hkv, D) -> (B, S, Hq, D) in q's type.

    GQA: query head h reads kv head h // (Hq / Hkv).  ``window`` > 0 masks,
    with ``causal``, keys ``window`` or more positions before the query.
    q, k and v are f32 or bf16 (one type), D ≤ 128, unit stride over D
    (any other strides).  CPU tensors take ``ref.flash_attention_ref``
    (k/v repeated per query head, as the reference's routed path does);
    CUDA tensors take the kernel variant ``flash_route`` names in
    ``csrc/flash_attention.cu`` on the current stream, which reads k/v per
    kv head without repeating them.  Both routes refuse what the chosen
    kernel's grid cannot hold.
    """
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError(f"flash_attention wants (B, S, H, D) q, k, v, got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    b, s, hq, d = q.shape
    hkv = k.shape[2]
    if (tuple(k.shape) != (b, s, hkv, d) or v.shape != k.shape
            or hkv < 1 or hq % hkv):
        raise ValueError(f"flash_attention wants k/v (B, S, Hkv, D) with Hq "
                         f"a multiple of Hkv, got q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)}, v {tuple(v.shape)}")
    if q.dtype not in _TYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"flash_attention takes f32 or bf16 q, k, v of one "
                        f"type, got {q.dtype}, {k.dtype}, {v.dtype}")
    if not (1 <= d <= FLASH_MAX_D and s >= 1 and b >= 1):
        raise ValueError(f"flash_attention takes 1 ≤ D ≤ {FLASH_MAX_D} and "
                         f"a nonempty batch, got q {tuple(q.shape)}")
    if any(t.stride(-1) != 1 for t in (q, k, v)):
        raise ValueError("flash_attention wants unit stride over D")
    if window < 0:
        raise ValueError(f"window must be ≥ 0, got {window}")
    _refuse_backward("flash_attention", q, k, v)
    on_card = _device_route("flash_attention", q, k, v)
    variant = flash_route(q, k, v)
    _check_grid(variant, q)
    if not on_card:
        return ref.flash_attention_ref(q, k, v, causal=causal, window=window)
    return _flash_launch(q, k, v, variant, causal=causal, window=window)


def _check_grid(variant: str, q) -> None:
    b, s, hq, _ = q.shape
    items = b * hq * -(-s // _WGMMA_BLOCK_Q)
    if ((variant == "wgmma" and items > _WGMMA_MAX_ITEMS)
            or (variant == "simt" and b * hq > _SIMT_MAX_HEADS)):
        raise ValueError(f"the {variant} attention kernel's grid cannot hold "
                         f"q {tuple(q.shape)}")


def _flash_launch(q, k, v, variant: str, *, causal: bool, window: int):
    """Launch one attention kernel variant on CUDA q, k, v that
    ``flash_attention`` has checked, and count the launch.  ``"simt"``
    takes any such input; ``"wgmma"`` only what ``flash_route`` gives it.
    ``flash_attention`` calls this with ``flash_route``'s choice;
    ``chip_smoke.py`` also calls it to time the SIMT kernel on the inputs
    the wgmma kernel serves."""
    if variant not in ("wgmma", "simt") or (
            variant == "wgmma" and flash_route(q, k, v) != variant):
        raise ValueError(f"the {variant!r} attention kernel does not take q "
                         f"{tuple(q.shape)} {q.dtype}")
    if not _device_route("flash_attention", q, k, v):
        raise ValueError("_flash_launch launches a kernel: it takes CUDA "
                         "tensors only")
    _check_grid(variant, q)
    b, s, hq, d = q.shape
    fn = _kernel_fn("flash_attention",
                    f"flash_attention_{variant}_{_SUFFIX[q.dtype]}",
                    _FLASH_ARGTYPES)
    strides = [(ctypes.c_longlong * 3)(*t.stride()[:3]) for t in (q, k, v)]
    with torch.cuda.device(q.device):
        o = torch.empty((b, s, hq, d), dtype=q.dtype, device=q.device)
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), b, s,
                 hq, k.shape[2], d, *(ctypes.addressof(a) for a in strides),
                 d ** -0.5, int(causal), int(window),
                 torch.cuda.current_stream(q.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"flash_attention {variant} kernel launch failed "
                           f"with error {err} at q {tuple(q.shape)} k "
                           f"{tuple(k.shape)} {q.dtype}")
    global flash_attention_launches, flash_attention_wgmma_launches
    global flash_attention_simt_launches
    flash_attention_launches += 1
    if variant == "wgmma":
        flash_attention_wgmma_launches += 1
    else:
        flash_attention_simt_launches += 1
    return o


def routed_attention(q, k, v, *, causal: bool = True, window: int = 0):
    """The model's attention hot path (the reference's
    ``ops.routed_attention``).  The port routes by the tensors' device
    inside ``flash_attention``, so this is that call."""
    return flash_attention(q, k, v, causal=causal, window=window)


_WKV6_ARGTYPES = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 4 + [ctypes.c_void_p]


def wkv6_route(r, k, v, lw, u) -> str:
    """Which wkv6 kernel takes (r, k, v, lw, u) on the card: ``"chunked"``
    (the chunked form on the tensor cores) for bf16 r, k, v and u with f32
    lw, K in ``WKV6_CHUNKED_HEAD_SIZES`` and 16-byte-aligned data pointers
    (its 16-byte copies); ``"serial"`` (one step at a time on the CUDA
    cores) for everything else, f32 and K = 8 included.  Decided from type,
    shape and alignment alone, the same for CPU and CUDA tensors."""
    if (any(x.dtype != torch.bfloat16 for x in (r, k, v, u))
            or lw.dtype != torch.float32
            or r.shape[-1] not in WKV6_CHUNKED_HEAD_SIZES
            or any(x.data_ptr() % 16 for x in (r, k, v, lw, u))):
        return "serial"
    return "chunked"


def wkv6(r, k, v, lw, u):
    """r, k, v, lw: (B, T, H, K); u: (H, K) -> o (B, T, H, K) in r's type.

    The RWKV6 recurrence from a zero state, output only (the final state
    is not returned).  r, k, v and u are f32 or bf16 (one type), lw is f32
    (the model computes the decay in f32), all contiguous, K in
    ``WKV6_HEAD_SIZES``.  The lw contract is the model's: a log decay in
    [-3.5, -1e-6] (``models/ssm.py``'s clamp).  The chunked kernel clips lw
    to that range, as the reference's ``wkv6_chunked`` does, so inside it
    the clip changes nothing and outside it no input gives inf or NaN; the
    serial kernel and the plain version take lw as it is.  CPU tensors take
    ``ref.wkv6_ref``; CUDA tensors take the kernel variant ``wkv6_route``
    names in ``csrc/wkv6.cu`` on the current stream.
    """
    if r.dim() != 4 or u.dim() != 2:
        raise ValueError(f"wkv6 wants (B, T, H, K) r and (H, K) u, got "
                         f"{tuple(r.shape)} and {tuple(u.shape)}")
    b, t, h, kk = r.shape
    if (any(x.shape != r.shape for x in (k, v, lw))
            or tuple(u.shape) != (h, kk)):
        raise ValueError(f"wkv6 wants r, k, v, lw of one (B, T, H, K) shape "
                         f"and u (H, K), got {tuple(r.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}, "
                         f"{tuple(lw.shape)}, {tuple(u.shape)}")
    if (r.dtype not in _TYPES or any(x.dtype != r.dtype for x in (k, v, u))
            or lw.dtype != torch.float32):
        raise TypeError(f"wkv6 takes r, k, v, u in one type (f32 or bf16) "
                        f"and lw in f32, got {r.dtype}, {k.dtype}, "
                        f"{v.dtype}, {u.dtype} and {lw.dtype}")
    if kk not in WKV6_HEAD_SIZES or b < 1 or t < 1 or h < 1:
        raise ValueError(f"wkv6 takes K in {WKV6_HEAD_SIZES} and a nonempty "
                         f"(B, T, H), got {tuple(r.shape)}")
    if not all(x.is_contiguous() for x in (r, k, v, lw, u)):
        raise ValueError("wkv6 wants contiguous r, k, v, lw and u")
    _refuse_backward("wkv6", r, k, v, lw, u)
    if not _device_route("wkv6", r, k, v, lw, u):
        return ref.wkv6_ref(r, k, v, lw, u)[0]
    return _wkv6_launch(r, k, v, lw, u, wkv6_route(r, k, v, lw, u))


def _wkv6_launch(r, k, v, lw, u, variant: str):
    """Launch one wkv6 kernel variant on CUDA inputs that ``wkv6`` has
    checked, and count the launch.  ``"serial"`` takes any such input;
    ``"chunked"`` only what ``wkv6_route`` gives it.  ``wkv6`` calls this
    with ``wkv6_route``'s choice; ``chip_smoke.py`` also calls it to time
    the serial kernel on the inputs the chunked kernel serves."""
    if variant not in ("chunked", "serial") or (
            variant == "chunked" and wkv6_route(r, k, v, lw, u) != variant):
        raise ValueError(f"the {variant!r} wkv6 kernel does not take r "
                         f"{tuple(r.shape)} {r.dtype}")
    if not _device_route("wkv6", r, k, v, lw, u):
        raise ValueError("_wkv6_launch launches a kernel: it takes CUDA "
                         "tensors only")
    b, t, h, kk = r.shape
    fn = _kernel_fn("wkv6", f"wkv6_{variant}_{_SUFFIX[r.dtype]}",
                    _WKV6_ARGTYPES)
    with torch.cuda.device(r.device):
        o = torch.empty_like(r)
        err = fn(r.data_ptr(), k.data_ptr(), v.data_ptr(), lw.data_ptr(),
                 u.data_ptr(), o.data_ptr(), b, t, h, kk,
                 torch.cuda.current_stream(r.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"wkv6 {variant} kernel launch failed with CUDA "
                           f"error {err} at r {tuple(r.shape)} {r.dtype}")
    global wkv6_launches, wkv6_chunked_launches, wkv6_serial_launches
    wkv6_launches += 1
    if variant == "chunked":
        wkv6_chunked_launches += 1
    else:
        wkv6_serial_launches += 1
    return o


def routed_wkv6(r, k, v, lw, u):
    """The RWKV6 time mix's hot path (the reference's ``ops.routed_wkv6``):
    the mixed output only.  The port routes by the tensors' device inside
    ``wkv6``, so this is that call."""
    return wkv6(r, k, v, lw, u)


_ROW_MEAN_ARGTYPES = [ctypes.c_void_p, ctypes.c_longlong, ctypes.c_longlong,
                      ctypes.c_void_p, ctypes.c_void_p]


def row_mean(x: torch.Tensor) -> torch.Tensor:
    """x: contiguous (k, N) f32 -> (k,) f32 row means, each row summed in
    one fixed order, so a row's mean is a function of its own bytes and N
    alone, whatever k is or where the row sits (``csrc/row_mean.cu``).
    CPU tensors take ``ref.row_mean_ref``, which sums in the same order;
    CUDA tensors take the kernel, one CTA per row, on the current stream.
    """
    if x.dim() != 2 or x.dtype != torch.float32 or not x.is_contiguous():
        raise ValueError(f"row_mean wants a contiguous (k, N) f32 tensor, "
                         f"got {tuple(x.shape)} {x.dtype}")
    k, n = x.shape
    if n < 1 or k > 2**31 - 1:
        raise ValueError(f"row_mean takes N ≥ 1 and k < 2^31, got "
                         f"{tuple(x.shape)}")
    _refuse_backward("row_mean", x)
    if not _device_route("row_mean", x):
        return ref.row_mean_ref(x)
    fn = _kernel_fn("row_mean", "row_mean_f32", _ROW_MEAN_ARGTYPES)
    if k == 0:
        return torch.empty(0, dtype=torch.float32, device=x.device)
    with torch.cuda.device(x.device):
        out = torch.empty(k, dtype=torch.float32, device=x.device)
        err = fn(x.data_ptr(), k, n, out.data_ptr(),
                 torch.cuda.current_stream(x.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"row_mean kernel launch failed with CUDA error "
                           f"{err} at x {tuple(x.shape)}")
    global row_mean_launches
    row_mean_launches += 1
    return out
