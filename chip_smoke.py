#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port on one NVIDIA GPU and check what comes out.

    python3 chip_smoke.py

Phases, each printing its numbers and its wall; any failed check raises,
so the script exits non-zero and prints no result line:

1. card    the GPU's name and power limit (nvidia-smi), torch and CUDA
           versions; no CUDA device is an error;
2. build   nvcc builds every kernel in src/repro_torch/kernels/csrc/, one
           process per source, all started together;
3. gram    the gram kernel against its plain version on the card, at the
           main path's shapes, at tests/test_kernels.py's, with fewer rows
           than the cluster's ranks, at c = 1, at c + 1 = 256 and 257
           and at m = 100,000, f32 and bf16, max |err| / max |ref| ≤ 1e-5
           for G and r, G exactly symmetric, the same bits twice at
           (1000, 45) and (100000, 45); the wide c that sweep the slot map
           in rounds, f32: (1000, 276), (100000, 276), (2000, 1275) and
           (300, 8500), each within 1e-5, symmetric and the same bits
           twice; then at (1000, 45) and (100000, 45) f32 the kernel, the
           kernel as an 8-CTA cluster, the plain version, torch.matmul
           and a launch floor (a one-element add_) timed in turns from
           CUDA graphs and eagerly, beside the bound; then what the
           timing left allocated, by memory pool and stream, is freed;
4. fig2    paper Fig. 2 at paper scale (m = 1000, 100k stars, 20
           iterations) on stripe79 and stripe86; each must reach 90 % of
           the way to the truth by iteration 5 and end within 5e-3 of the
           reference's final fitness, through the gram kernel;
5. grid    the 4096-host batched grid on stripe79 (100k stars, m = 1000),
           pipelined and sync, which must commit bit-identical iterates;
6. flash   both attention kernels against their plain version, each case
           on the variant ops.flash_route picks for it: the wgmma variant
           at h2o-danube-3's full shape (2, 4096, 32/8 heads, D = 120,
           bf16, causal, window 8192 and 512), at D = 128 and 80, at
           S = 300 and 1001 (ragged against its 128-row tiles), D = 64,
           non-causal, and with k and v views into one fused tensor; the
           SIMT variant in f32 at D = 64 and 128, non-causal, and bf16 at
           the danube smoke config's D = 12; max |err| / max |ref| ≤ 2e-2
           (bf16) or 1e-5 (f32), and, since those scale with the largest
           output, ‖err‖ / ‖ref‖ over the tensor ≤ 1e-2 (bf16) or 1e-4
           (f32) and over each output row ≤ 5e-2 (bf16) or 1e-4 (f32);
           bitwise repeatable; at the full shape the
           wgmma kernel, the SIMT kernel on the same bf16 inputs, the plain
           version and scaled_dot_product_attention, timed in turns, beside
           the bound;
7. wkv6    both RWKV6 kernels against their plain version, each case on
           the variant ops.wkv6_route picks for it: the chunked variant at
           rwkv6-7b's full shape (2, 4096, 64 heads, K = 64; bf16 r/k/v/u
           with f32 lw), at K = 16, at a T that is no multiple of 16 and at
           both edges of the decay clamp (lw ≡ -3.5 and ≡ -1e-6); the
           serial variant in f32 at the full shape and K = 16, and bf16 at
           K = 8; max |err| / max |ref| ≤ 5e-2 (bf16) or 1e-4 (f32),
           ‖err‖ / ‖ref‖ over the tensor ≤ 1e-2 / 1e-4 and over each
           output row ≤ 5e-2 / 1e-4; bitwise repeatable; at the full shape
           the chunked kernel, the serial kernel on the same bf16 inputs
           and the plain version, timed in turns, beside the bound;
8. lm      act 1 of examples/anm_lm.py over the LM loss at published
           widths: h2o-danube-3-4b cut to 4 layers and rwkv6-7b cut to 2
           (the k = 6 f32 basis must fit), 2 x 4096 tokens; the θ0 loss
           against the same lane with the kernel swapped for its plain
           version (≤ 2e-2 relative), pipelined == sync bit-identical, a
           lane's loss the same bits in a bucket of 8 and of 32, a finite
           best ≤ the start, and exactly one launch of the arch's kernel
           per layer per lane evaluated (for danube, every one a wgmma
           launch; for rwkv6, every one a chunked launch);
           Then act 2 on both archs (2 searches each, coalesced == solo)
           and act 3 on rwkv6 (the work server crashed at 40 % of its
           messages and restored == uninterrupted), each launching the
           arch's kernel once per layer per lane evaluated;
9. rowmean the fixed-order row mean against its plain version (the same
           bits) and the float64 mean (≤ 1e-6 relative) at (k, 100000)
           and (k, 4096) for k = 1, 8, 16, 64, 1024, 4096 and at
           (8, 99999); a row's mean the same bits at every position of
           buckets of every width; device ms at (1000, 100000) beside
           torch.mean, the plain version and the bound;
10. fitness the paper-scale SDSS fitness (stripe79, 100k stars): 8 points
           the same bits in buckets of 8 ... 4096 at three positions each
           and alone;
11. server the FGDO work server at paper scale through its command line
           (100k stars, 4096 hosts, m = 1000, 2 iterations): an improving
           commit, gram launched twice per regression phase finish; the
           run with checkpoint and eval cache crashed at 40 % of the
           messages and restored == uninterrupted, with cache hits; at
           the smoke size (400 stars, m = 24, 192 hosts) TCP, 8 concurrent
           clients and the 4 chaos presets (8 concurrent TCP clients each)
           == loopback;
12. portfolio act 1 of examples/multi_search.py at paper scale (stripe79
           at 100k stars, 6 searches at m = 1000 / 500 on the 4096-host
           fleet, 2 iterations): every search coalesced == solo, fewer
           dispatches than per-search blocks;
13. the ``kernels`` JSON line, then the ``ok`` JSON line.
"""
from __future__ import annotations

import contextlib
import gc
import json
import math
import os
import subprocess
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

import torch.nn.functional as F  # noqa: E402

from repro_torch.core.engine import identical_trajectories  # noqa: E402
from repro_torch.core.substrates.batched_grid import \
    BatchedVolunteerGrid  # noqa: E402
from repro_torch.core.substrates.eval_backend import \
    InProcessEvalBackend  # noqa: E402
from repro_torch.core.substrates.lm_loss import \
    LmLossEvalBackend  # noqa: E402
from repro_torch.kernels import build, ops, ref  # noqa: E402
from repro_torch.data import sdss  # noqa: E402
from repro_torch.launch import (anm_lm, fig2, multi_search,  # noqa: E402
                                volunteer_grid)
from repro_torch.models import transformer  # noqa: E402
from repro_torch.server import sim  # noqa: E402

#: H100 SXM published peaks (NVIDIA data sheet; dense, at 700 W)
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS = 67e12
BF16_FLOPS = 989e12

#: (B, S, Hq, Hkv, D, type, causal, window, k/v fused, variant) of the
#: attention checks; the first is h2o-danube-3's full-width shape, the one
#: timed.  "k/v fused": k and v are views into one (B, S, 2·Hkv, D) tensor.
FLASH_CASES = [
    (2, 4096, 32, 8, 120, torch.bfloat16, True, 8192, False, "wgmma"),
    (2, 4096, 32, 8, 120, torch.bfloat16, True, 512, False, "wgmma"),
    (2, 2048, 16, 4, 128, torch.bfloat16, True, 0, False, "wgmma"),
    (2, 1024, 8, 8, 80, torch.bfloat16, True, 0, False, "wgmma"),
    (1, 300, 4, 2, 120, torch.bfloat16, False, 0, False, "wgmma"),
    (1, 1001, 8, 2, 128, torch.bfloat16, True, 256, False, "wgmma"),
    (1, 1001, 8, 8, 80, torch.bfloat16, False, 0, False, "wgmma"),
    (1, 1001, 4, 2, 64, torch.bfloat16, True, 100, False, "wgmma"),
    (2, 512, 8, 2, 120, torch.bfloat16, True, 0, True, "wgmma"),
    (2, 1024, 8, 2, 64, torch.float32, True, 0, False, "simt"),
    (1, 1024, 4, 4, 128, torch.float32, True, 0, False, "simt"),
    (1, 300, 4, 2, 64, torch.float32, False, 0, False, "simt"),
    (2, 256, 4, 2, 12, torch.bfloat16, True, 0, False, "simt"),
]
#: (B, T, H, K, type of r/k/v/u, lw, variant) of the wkv6 checks (lw is
#: f32: None draws it as the model's range, a number fills it); the first
#: is rwkv6-7b's full-width shape, the one timed
WKV6_CASES = [(2, 4096, 64, 64, torch.bfloat16, None, "chunked"),
              (2, 4096, 64, 64, torch.float32, None, "serial"),
              (2, 256, 4, 16, torch.float32, None, "serial"),
              (2, 256, 4, 16, torch.bfloat16, None, "chunked"),
              (2, 1001, 4, 32, torch.bfloat16, None, "chunked"),
              (2, 1024, 8, 64, torch.bfloat16, -3.5, "chunked"),
              (2, 1024, 8, 64, torch.bfloat16, -1e-6, "chunked"),
              (2, 256, 4, 8, torch.bfloat16, None, "serial")]
#: the LM phase: arch -> layers kept at published widths (a k = 6 f32
#: basis over the parameters must fit on one 80 GB card)
LM_DEPTH = {"h2o-danube-3-4b": 4, "rwkv6-7b": 2}
LM_SEQ_LEN = 4096

#: the reference's Fig. 2 run (JAX on a CPU, same seeds, 20 iterations):
#: start and truth fitness, final fitness, iteration reaching 90 %
REFERENCE_FIG2 = {
    "stripe79": dict(start=5.30919, truth=5.01094, final=4.98720, at90=1),
    "stripe86": dict(start=5.21282, truth=5.11153, final=5.09539, at90=2),
}

#: every launch counter in kernels/ops.py
LAUNCH_COUNTERS = ("gram_launches", "flash_attention_launches",
                   "flash_attention_wgmma_launches",
                   "flash_attention_simt_launches", "wkv6_launches",
                   "wkv6_chunked_launches", "wkv6_serial_launches",
                   "row_mean_launches")

GRAM_SHAPES = [(1000, 45), (2000, 45),                    # the main path
               (256, 45), (1024, 153), (300, 20), (512, 128),
               (1, 45), (7, 45),        # fewer rows than the cluster's ranks
               (1000, 1),               # c = 1
               (1000, 255), (777, 256),  # c + 1 = 256 and 257 augmented
               (100000, 45)]            # many stages per rank
#: the gram shapes checked for the same bits twice and timed
GRAM_MAIN, GRAM_TALL = (1000, 45), (100000, 45)
#: c above 256: the kernel sweeps its slot map in rounds (f32)
GRAM_WIDE = [(1000, 276), (100000, 276), (2000, 1275), (300, 8500)]

#: row-mean checks: bucket widths, row lengths (stars, quadrature points)
ROW_MEAN_WIDTHS = (1, 8, 16, 64, 1024, 4096)
ROW_MEAN_LENGTHS = (100_000, 4096)
ROW_MEAN_TIMED = (1000, 100_000)
#: the fitness phase's bucket widths
FITNESS_WIDTHS = tuple(2 ** i for i in range(3, 13))
#: the server phase's command line at paper scale (iterations cut to 2)
SERVER_FLAGS = ["--n-stars", "100000", "--n-hosts", "4096", "--m", "1000",
                "--iterations", "2", "--snapshot-every", "5000"]
#: the smoke-size legs that must equal loopback on the card
SERVER_LEGS = [["--transport", "tcp"], ["--concurrent", "8"]] + [
    ["--transport", "tcp", "--concurrent", "8", "--chaos", p]
    for p in ("drop_dup", "reorder_delay", "reset_torn", "degraded")]
#: the portfolio phase: searches, per-phase m of half of them, iterations
PORTFOLIO = dict(n_searches=6, m=1000, iterations=2)


def check(ok: bool, what: str) -> None:
    if not ok:
        raise SystemExit(f"chip_smoke: FAILED: {what}")


def phase_card(dev: torch.device) -> None:
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    card = smi.stdout.strip().splitlines()[dev.index or 0].strip()
    print(card)
    print(f"[card] {torch.cuda.get_device_name(dev)} x"
          f"{torch.cuda.device_count()} torch {torch.__version__} "
          f"cuda {torch.version.cuda} python {sys.version.split()[0]}")


def phase_build() -> None:
    report = build.build_all()
    for name, r in report.items():
        ptxas = [ln.strip() for ln in r["log"].splitlines()
                 if any(w in ln for w in ("registers", "spill", "arning"))]
        print(f"[build] {name}: {r['seconds']:.2f}s (nvcc sm_90a) "
              + " | ".join(ptxas))


def _time_ms(fn, iters: int = 500) -> float:
    """Per-call time of ``fn`` issued eagerly from Python, with CUDA events
    around ``iters`` calls: what a caller pays, host overhead included."""
    for _ in range(20):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def _graph_ms(fn, calls: int = 100, replays: int = 20) -> float:
    """Per-call device time of ``fn``: ``calls`` calls captured in one CUDA
    graph, replayed ``replays`` times between CUDA events, so no Python or
    launch overhead of the host is in the figure."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(calls):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (replays * calls)


def _events_ms(fn, iters: int = 3) -> float:
    """Per-call time of ``fn`` between CUDA events around ``iters`` eager
    calls, after one warm-up call (for calls too long to graph many)."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def _rel_err(got: torch.Tensor, want: torch.Tensor):
    """(max |got - want|, that over max |want|), in f32."""
    err = float((got.float() - want.float()).abs().max())
    return err, err / float(want.float().abs().max())


def _gram_bound(m: int, c: int):
    """(bound ms, what bounds it, bytes, FLOP) of one f32 gram call: X and
    y read once, G and r written once; the upper triangle and Xᵀy, FMA = 2
    FLOP, at the f32 peak."""
    moved = 4 * (m * c + m + c * c + c)
    flops = 2 * m * (c * (c + 1) // 2 + c)
    bound_ms, bound_by = _bound(moved, flops, F32_FLOPS)
    return bound_ms, bound_by, moved, flops


def phase_gram(dev: torch.device) -> dict:
    gen = torch.Generator(device=dev).manual_seed(1234)
    max_abs_err = 0.0
    inputs = {}
    for m, c in GRAM_SHAPES:
        for dtype in (torch.float32, torch.bfloat16):
            x = torch.randn(m, c, generator=gen, device=dev).to(dtype)
            y = torch.randn(m, generator=gen, device=dev).to(dtype)
            g, r = ops.gram(x, y)
            g_ref, r_ref = ref.gram_ref(x, y)
            torch.cuda.synchronize()
            for got, want, what in ((g, g_ref, "G"), (r, r_ref, "r")):
                err = float((got - want).abs().max())
                rel = err / float(want.abs().max())
                max_abs_err = max(max_abs_err, err)
                check(rel <= 1e-5, f"gram {what} at ({m}, {c}) {dtype}: "
                      f"max|err|/max|ref| = {rel:.3g} > 1e-5")
            check(torch.equal(g, g.T), f"gram G not symmetric at ({m}, {c})")
            if dtype == torch.float32 and (m, c) in (GRAM_MAIN, GRAM_TALL):
                inputs[m, c] = x, y
    for shape, (x, y) in inputs.items():
        g1, r1 = ops.gram(x, y)
        g2, r2 = ops.gram(x, y)
        check(torch.equal(g1, g2) and torch.equal(r1, r2),
              f"gram is not bitwise repeatable at {shape}")
    wide = []
    for m, c in GRAM_WIDE:
        x = torch.randn(m, c, generator=gen, device=dev)
        y = torch.randn(m, generator=gen, device=dev)
        ms = _events_ms(lambda: ops.gram(x, y), iters=2)
        g, r = ops.gram(x, y)
        g2, r2 = ops.gram(x, y)
        g_ref, r_ref = ref.gram_ref(x, y)
        torch.cuda.synchronize()
        errs = []
        for got, want, what in ((g, g_ref, "G"), (r, r_ref, "r")):
            err, rel = _rel_err(got, want)
            errs.append(rel)
            max_abs_err = max(max_abs_err, err)
            check(rel <= 1e-5, f"gram {what} at ({m}, {c}) f32: "
                  f"max|err|/max|ref| = {rel:.3g} > 1e-5")
        check(torch.equal(g, g.T), f"gram G not symmetric at ({m}, {c})")
        check(torch.equal(g, g2) and torch.equal(r, r2),
              f"gram is not bitwise repeatable at ({m}, {c})")
        sh = ops.gram_shape(c, ops.gram_tile(m, c))
        wide.append(f"({m}, {c}) {sh.rounds} round(s) of {sh.round} "
                    f"slots, G/r rel err {errs[0]:.2e}/{errs[1]:.2e}, "
                    f"{ms:.3f} ms")
        # got holds r, a view of the (c² + c) buffer G lives in
        del x, y, g, r, g2, r2, g_ref, r_ref, got, want
    print(f"[gram] wide c, f32, within 1e-5, symmetric, the same bits "
          f"twice: " + "; ".join(wide))
    lib = build.load("gram")
    room = {(m, c, n): lib.gram_max_active_clusters(
        c, n, ops.gram_stage_rows(c), ops.gram_tile(m, c, n))
        for m, c in (GRAM_MAIN, GRAM_TALL, (777, 256)) for n in (8, 16)}
    one = torch.zeros(1, device=dev)
    dev_ms, call_ms = {}, {}
    for shape in (GRAM_MAIN, GRAM_TALL):
        x, y = inputs[shape]
        fns = {"kernel": lambda: ops.gram(x, y),
               "cluster8": lambda: ops._gram_launch(x, y, 8),
               "plain": lambda: ref.gram_ref(x, y),
               "matmul": lambda: (torch.matmul(x.T, x), torch.matmul(x.T, y)),
               "floor": lambda: one.add_(1.0)}
        # in turns (plain, kernel, kernel, plain), each kept at its best
        order = ["plain", "kernel", "cluster8", "matmul", "floor", "floor",
                 "matmul", "cluster8", "kernel", "plain"]
        for name in order:
            key = (shape, name)
            dev_ms[key] = min(dev_ms.get(key, 1e9), _graph_ms(fns[name]))
            call_ms[key] = min(call_ms.get(key, 1e9), _time_ms(fns[name]))
    bounds = {shape: _gram_bound(*shape) for shape in (GRAM_MAIN, GRAM_TALL)}
    out = dict(max_abs_err=max_abs_err, ms=dev_ms[GRAM_MAIN, "kernel"],
               plain_ms=dev_ms[GRAM_MAIN, "plain"],
               library_ms=dev_ms[GRAM_MAIN, "matmul"],
               bound_ms=bounds[GRAM_MAIN][0], bound_by=bounds[GRAM_MAIN][1],
               floor_ms=dev_ms[GRAM_MAIN, "floor"],
               call_ms=call_ms[GRAM_MAIN, "kernel"],
               library_call_ms=call_ms[GRAM_MAIN, "matmul"],
               ms_100k=dev_ms[GRAM_TALL, "kernel"],
               library_ms_100k=dev_ms[GRAM_TALL, "matmul"],
               bound_ms_100k=bounds[GRAM_TALL][0], cluster=ops.GRAM_CLUSTER)
    print(f"[gram] {len(GRAM_SHAPES) * 2} shape/dtype cases within 1e-5 "
          f"(max abs err {max_abs_err:.3g}), G symmetric, the same bits "
          f"twice at {GRAM_MAIN} and {GRAM_TALL}; clusters that fit at once "
          f"(m, c, CTAs): {room}")
    for shape, (b_ms, b_by, b_moved, b_flops) in bounds.items():
        d = {name: dev_ms[shape, name] for name in
             ("kernel", "cluster8", "plain", "matmul", "floor")}
        e = {name: call_ms[shape, name] for name in
             ("kernel", "cluster8", "plain", "matmul", "floor")}
        tile = ops.gram_tile(*shape)
        print(f"[gram] at {shape} f32, device ms per call (CUDA graph): "
              f"kernel ({ops.GRAM_CLUSTER} CTAs, {tile} x {tile} tiles) "
              f"{d['kernel']:.5f}, 8 CTAs "
              f"{d['cluster8']:.5f}, plain {d['plain']:.5f}, matmul "
              f"{d['matmul']:.5f}, launch floor (one-element add_) "
              f"{d['floor']:.5f}; eager call ms: kernel {e['kernel']:.5f}, "
              f"8 CTAs {e['cluster8']:.5f}, plain {e['plain']:.5f}, matmul "
              f"{e['matmul']:.5f}, floor {e['floor']:.5f}; bound "
              f"{b_ms:.3g} ms ({b_by}: {b_moved} B, {b_flops} FLOP)")
    del inputs, fns, x, y
    _release_timing_memory("gram")
    return out


def _live_blocks() -> dict:
    """Bytes of live allocations by (memory pool, stream), from
    ``torch.cuda.memory_snapshot()``: pool (0, 0) is the default one, any
    other a CUDA graph's private pool."""
    held = {}
    for seg in torch.cuda.memory_snapshot():
        for blk in seg["blocks"]:
            if blk["state"] == "active_allocated":
                key = (tuple(seg.get("segment_pool_id", (0, 0))),
                       seg["stream"])
                held[key] = held.get(key, 0) + blk["size"]
    return held


def _release_timing_memory(phase: str) -> None:
    """Free what timing left allocated: graphs and their pools (collected
    with their Python objects), and the cuBLAS workspace torch.matmul
    allocates once for every new stream a graph was captured on.  Prints
    what held memory before and after."""
    gc.collect()
    torch.cuda.synchronize()
    before = _live_blocks()
    torch._C._cuda_clearCublasWorkspaces()   # every stream's workspace
    gc.collect()
    torch.cuda.empty_cache()
    after = _live_blocks()
    print(f"[{phase}] allocated after timing, bytes by (pool, stream): "
          f"{before or 'none'}; after clearing cuBLAS workspaces and "
          f"graph pools: {after or 'none'} "
          f"({torch.cuda.memory_allocated() / 2**30:.3f} GiB allocated)")


def phase_fig2(dev: torch.device) -> int:
    """Fig. 2 at paper scale; returns the gram launches of the run."""
    ops.gram_launches = 0
    results = fig2.run(paper_scale=True, device=dev, iters=20)
    launches = ops.gram_launches
    for name, r in results.items():
        want = REFERENCE_FIG2[name]
        print(f"[fig2] {name}: wall {r['wall_s']:.3f}s, iters_to_90pct "
              f"{r['iterations_to_90pct']} (reference {want['at90']}), "
              f"final {r['final_fitness']:.5f} (reference "
              f"{want['final']:.5f}), truth {r['truth_fitness']:.5f}, "
              f"start {r['start_fitness']:.5f}, evals {r['total_evals']}, "
              f"phase finish {r['phase_finish_ms_mean']:.2f} ms mean, "
              f"peak device memory {r['peak_device_bytes'] / 2**30:.2f} GiB")
        for key in ("start", "truth"):
            got = r[f"{key}_fitness"]
            check(abs(got - want[key]) <= 1e-4 * abs(want[key]),
                  f"{name} {key} fitness {got} vs reference {want[key]}")
        check(r["iterations_to_90pct"] is not None
              and r["iterations_to_90pct"] <= 5,
              f"{name} did not reach 90 % by iteration 5")
        check(abs(r["final_fitness"] - want["final"])
              <= 5e-3 * abs(want["final"]),
              f"{name} final fitness {r['final_fitness']} vs reference "
              f"{want['final']}")
    print(f"[fig2] gram launches {launches}")
    check(launches > 0, "the Fig. 2 run never launched the gram kernel")
    return launches


def phase_grid(dev: torch.device, iters: int = 3) -> None:
    f_batch, x0 = volunteer_grid.make_problem(n_stars=100_000, device=dev)
    backend = InProcessEvalBackend(f_batch, device=dev)
    backend.warm(8, min(volunteer_grid.FLEET.n_hosts,
                        BatchedVolunteerGrid.warm_max_bucket(1000)))
    torch.cuda.reset_peak_memory_stats(dev)
    out = {}
    for mode, pipelined in (("pipelined", True), ("sync", False)):
        ops.gram_launches = 0
        engine, stats, wall = volunteer_grid.run(
            f_batch, x0, m=1000, iters=iters, pipelined=pipelined,
            device=dev, backend=backend)
        out[mode] = dict(engine=engine, stats=stats, wall_s=wall,
                         launches=ops.gram_launches)
        print(f"[grid] {mode}: 4096 hosts, m=1000, {engine.iteration} "
              f"iterations, best {engine.best_fitness:.5f}, wall "
              f"{wall:.3f}s, device_blocked_s {stats.device_blocked_s:.3f}, "
              f"host_s {stats.host_s:.3f}, ticks {stats.ticks}, batches "
              f"{stats.batch_calls}, max in flight {stats.max_in_flight}, "
              f"bucket_hist {dict(sorted(stats.bucket_hist.items()))}, "
              f"gram launches {ops.gram_launches}")
    pipe, sync = out["pipelined"], out["sync"]
    check(identical_trajectories(pipe["engine"], sync["engine"]),
          "pipelined and sync grids committed different iterates")
    check(pipe["engine"].stats == sync["engine"].stats,
          "pipelined and sync grids ended with different engine stats")
    check(pipe["engine"].iteration == iters, "the grid run stopped early")
    check(pipe["launches"] > 0 and sync["launches"] > 0,
          "the grid run never launched the gram kernel")
    check(np.isfinite(pipe["engine"].best_fitness), "non-finite fitness")
    print(f"[grid] pipelined == sync: bit-identical iterates and engine "
          f"stats; peak device memory "
          f"{torch.cuda.max_memory_allocated(dev) / 2**30:.2f} GiB")


def _bound(moved: int, flops: float, peak: float):
    t_bytes = moved / HBM_BYTES_PER_S * 1e3
    t_ops = flops / peak * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                 else "operations")


def _attention_pairs(s: int, causal: bool, window: int) -> int:
    """(query, key) pairs the mask keeps for one (batch, head)."""
    if not causal:
        return s * s
    w = window if window > 0 else s
    return sum(min(i + 1, w) for i in range(s))


def _flash_inputs(b, s, hq, hkv, d, dtype, fused, gen, dev):
    q = torch.randn(b, s, hq, d, generator=gen, device=dev).to(dtype)
    if fused:
        kv = torch.randn(b, s, 2 * hkv, d, generator=gen, device=dev)
        kv = kv.to(dtype)
        return q, kv[:, :, :hkv], kv[:, :, hkv:]
    k = torch.randn(b, s, hkv, d, generator=gen, device=dev).to(dtype)
    v = torch.randn(b, s, hkv, d, generator=gen, device=dev).to(dtype)
    return q, k, v


def _norm_rel_err(got: torch.Tensor, want: torch.Tensor):
    """(‖got − want‖ / ‖want‖ over the whole tensor, the largest of that
    over each row of the last axis), in f32.  Unlike max|err|/max|ref|,
    these scale with the values compared: a row that averages many keys
    has a small output, and an error there still shows."""
    diff = (got.float() - want.float()).flatten(0, -2)
    want = want.float().flatten(0, -2)
    row = diff.norm(dim=-1) / want.norm(dim=-1).clamp_min(1e-30)
    return float(diff.norm() / want.norm()), float(row.max())


def phase_flash(dev: torch.device) -> dict:
    gen = torch.Generator(device=dev).manual_seed(4321)
    max_abs_err = {"wgmma": 0.0, "simt": 0.0}
    worst = {"wgmma": [0.0, 0.0], "simt": [0.0, 0.0]}   # [norm, row]
    for b, s, hq, hkv, d, dtype, causal, window, fused, variant in FLASH_CASES:
        q, k, v = _flash_inputs(b, s, hq, hkv, d, dtype, fused, gen, dev)
        route = ops.flash_route(q, k, v)
        check(route == variant, f"flash_route gives {route!r} for "
              f"({b}, {s}, {hq}/{hkv}, {d}) {dtype} fused={fused}, want "
              f"{variant!r}")
        before = getattr(ops, f"flash_attention_{variant}_launches")
        out = ops.flash_attention(q, k, v, causal=causal, window=window)
        again = ops.flash_attention(q, k, v, causal=causal, window=window)
        want = ref.flash_attention_ref(q, k, v, causal=causal, window=window)
        torch.cuda.synchronize()
        check(getattr(ops, f"flash_attention_{variant}_launches")
              == before + 2, f"flash_attention did not launch its {variant} "
              f"kernel")
        err, rel = _rel_err(out, want)
        norm_rel, row_rel = _norm_rel_err(out, want)
        bf16 = dtype == torch.bfloat16
        tol = 2e-2 if bf16 else 1e-5
        norm_tol, row_tol = (1e-2, 5e-2) if bf16 else (1e-4, 1e-4)
        max_abs_err[variant] = max(max_abs_err[variant], err)
        worst[variant] = [max(worst[variant][0], norm_rel),
                          max(worst[variant][1], row_rel)]
        case = (f"({b}, {s}, {hq}/{hkv}, {d}) {dtype} causal={causal} "
                f"window={window} fused_kv={fused}")
        print(f"[flash] {variant} {case}: max|err|/max|ref| {rel:.3g}, "
              f"‖err‖/‖ref‖ {norm_rel:.3g}, worst row ‖err‖/‖ref‖ "
              f"{row_rel:.3g}")
        check(rel <= tol, f"flash_attention {variant} at {case}: {rel:.3g} "
              f"> {tol}")
        check(norm_rel <= norm_tol, f"flash_attention {variant} at {case}: "
              f"‖err‖/‖ref‖ {norm_rel:.3g} > {norm_tol}")
        check(row_rel <= row_tol, f"flash_attention {variant} at {case}: "
              f"worst row ‖err‖/‖ref‖ {row_rel:.3g} > {row_tol}")
        check(torch.equal(out, again), f"flash_attention {variant} is not "
              f"bitwise repeatable at {case}")
        del q, k, v, out, again, want
    b, s, hq, hkv, d, dtype, causal, window, fused, _ = FLASH_CASES[0]
    q, k, v = _flash_inputs(b, s, hq, hkv, d, dtype, fused, gen, dev)
    # SDPA takes (B, H, S, D); the layout change is made once, untimed
    qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))
    fns = {"wgmma": lambda: ops.flash_attention(q, k, v, causal=causal,
                                                window=window),
           "simt": lambda: ops._flash_launch(q, k, v, "simt", causal=causal,
                                             window=window),
           "plain": lambda: ref.flash_attention_ref(q, k, v, causal=causal,
                                                    window=window),
           "sdpa": lambda: F.scaled_dot_product_attention(
               qt, kt, vt, is_causal=True, enable_gqa=True)}
    check(window >= s, "the timed case's window must cover the sequence "
          "(so SDPA's plain causal mask is the same function)")
    torch.cuda.synchronize()
    err, rel = _rel_err(fns["sdpa"]().transpose(1, 2), fns["plain"]())
    print(f"[flash] SDPA against the plain version: {rel:.3g}")
    dev_ms = {}
    for name in ["plain", "wgmma", "simt", "sdpa",
                 "sdpa", "simt", "wgmma", "plain"]:
        calls, replays = (2, 2) if name in ("plain", "simt") else (10, 5)
        dev_ms[name] = min(dev_ms.get(name, 1e9),
                           _graph_ms(fns[name], calls, replays))
    pairs = _attention_pairs(s, causal, window)
    flops = 4.0 * d * pairs * b * hq             # QKᵀ and PV, FMA = 2
    moved = (q.numel() + k.numel() + v.numel() + q.numel()) * q.element_size()
    bound_ms, bound_by = _bound(moved, flops, BF16_FLOPS)
    print(f"[flash] at ({b}, {s}, {hq}/{hkv}, {d}) {dtype}, device ms per "
          f"call (CUDA graph): wgmma {dev_ms['wgmma']:.4f}, simt "
          f"{dev_ms['simt']:.4f}, plain {dev_ms['plain']:.4f}, sdpa "
          f"{dev_ms['sdpa']:.4f}; bound {bound_ms:.4f} ms ({bound_by}: "
          f"{moved} B, {flops:.4g} FLOP at the bf16 tensor-core peak); "
          f"wgmma at {flops / dev_ms['wgmma'] / 1e9:.1f} TFLOP/s")
    return dict(variant="wgmma", max_abs_err=max_abs_err["wgmma"],
                ms=dev_ms["wgmma"], plain_ms=dev_ms["plain"],
                library_ms=dev_ms["sdpa"], bound_ms=bound_ms,
                bound_by=bound_by, norm_rel_err=worst["wgmma"][0],
                row_rel_err=worst["wgmma"][1], simt_ms=dev_ms["simt"],
                simt_max_abs_err=max_abs_err["simt"])


def _wkv6_inputs(b, t, h, kk, dtype, lw_fill, gen, dev):
    r, k, v = (torch.randn(b, t, h, kk, generator=gen, device=dev).to(dtype)
               for _ in range(3))
    if lw_fill is None:
        lw = (-torch.exp(torch.randn(b, t, h, kk, generator=gen, device=dev))
              ).clamp(-3.5, -1e-6)
    else:
        lw = torch.full((b, t, h, kk), lw_fill, device=dev)
    u = (torch.randn(h, kk, generator=gen, device=dev) * 0.1).to(dtype)
    return r, k, v, lw, u


def phase_wkv6(dev: torch.device) -> dict:
    gen = torch.Generator(device=dev).manual_seed(8765)
    max_abs_err = {"chunked": 0.0, "serial": 0.0}
    worst = {"chunked": [0.0, 0.0], "serial": [0.0, 0.0]}   # [norm, row]
    for b, t, h, kk, dtype, lw_fill, variant in WKV6_CASES:
        args = _wkv6_inputs(b, t, h, kk, dtype, lw_fill, gen, dev)
        route = ops.wkv6_route(*args)
        case = (f"({b}, {t}, {h}, {kk}) {dtype} lw "
                f"{'drawn' if lw_fill is None else lw_fill}")
        check(route == variant, f"wkv6_route gives {route!r} for {case}, "
              f"want {variant!r}")
        before = getattr(ops, f"wkv6_{variant}_launches")
        out = ops.wkv6(*args)
        again = ops.wkv6(*args)
        want = ref.wkv6_ref(*args)[0]
        torch.cuda.synchronize()
        check(getattr(ops, f"wkv6_{variant}_launches") == before + 2,
              f"wkv6 did not launch its {variant} kernel")
        err, rel = _rel_err(out, want)
        norm_rel, row_rel = _norm_rel_err(out, want)
        bf16 = dtype == torch.bfloat16
        tol = 5e-2 if bf16 else 1e-4
        norm_tol, row_tol = (1e-2, 5e-2) if bf16 else (1e-4, 1e-4)
        max_abs_err[variant] = max(max_abs_err[variant], err)
        worst[variant] = [max(worst[variant][0], norm_rel),
                          max(worst[variant][1], row_rel)]
        print(f"[wkv6] {variant} {case}: max|err|/max|ref| {rel:.3g}, "
              f"‖err‖/‖ref‖ {norm_rel:.3g}, worst row ‖err‖/‖ref‖ "
              f"{row_rel:.3g}")
        check(bool(torch.isfinite(out.float()).all()),
              f"wkv6 {variant} at {case}: non-finite output")
        check(rel <= tol, f"wkv6 {variant} at {case}: {rel:.3g} > {tol}")
        check(norm_rel <= norm_tol, f"wkv6 {variant} at {case}: "
              f"‖err‖/‖ref‖ {norm_rel:.3g} > {norm_tol}")
        check(row_rel <= row_tol, f"wkv6 {variant} at {case}: worst row "
              f"‖err‖/‖ref‖ {row_rel:.3g} > {row_tol}")
        check(torch.equal(out, again), f"wkv6 {variant} is not bitwise "
              f"repeatable at {case}")
        del args, out, again, want
    b, t, h, kk, dtype, lw_fill, _ = WKV6_CASES[0]
    args = _wkv6_inputs(b, t, h, kk, dtype, lw_fill, gen, dev)
    fns = {"chunked": lambda: ops.wkv6(*args),
           "serial": lambda: ops._wkv6_launch(*args, "serial"),
           "plain": lambda: ref.wkv6_ref(*args)[0]}
    dev_ms = {}
    for name in ["plain", "chunked", "serial", "serial", "chunked", "plain"]:
        calls, replays = (1, 2) if name == "plain" else (20, 5)
        dev_ms[name] = min(dev_ms.get(name, 1e9),
                           _graph_ms(fns[name], calls, replays))
    r, _, _, lw, u = args
    moved = (3 * r.numel() * r.element_size() + lw.numel() * 4
             + u.numel() * u.element_size() + r.numel() * r.element_size())
    # the chunked form's products per 16-step chunk and (b, h), FMA = 2:
    # scores and A v (2 C² K each), the cross term and the state's
    # increment (2 C K² each), at the bf16 tensor-core peak
    n_chunks = -(-t // 16)
    flops = (4.0 * 16 * 16 * kk + 4.0 * 16 * kk * kk) * n_chunks * b * h
    bound_ms, bound_by = _bound(moved, flops, BF16_FLOPS)
    # the sequential form's 5 K² f32 FLOP per step and (b, h): the bound
    # of the serial kernel, printed beside
    seq_ms, _ = _bound(moved, 5.0 * kk * kk * t * b * h, F32_FLOPS)
    print(f"[wkv6] at ({b}, {t}, {h}, {kk}) {dtype}, device ms per call "
          f"(CUDA graph): chunked {dev_ms['chunked']:.4f}, serial "
          f"{dev_ms['serial']:.4f}, plain {dev_ms['plain']:.4f}; bound "
          f"{bound_ms:.4f} ms ({bound_by}: {moved} B, {flops:.4g} FLOP at "
          f"the bf16 tensor-core peak; the sequential form at the f32 peak "
          f"{seq_ms:.4f}); chunked at {moved / dev_ms['chunked'] / 1e6:.1f} "
          f"GB/s")
    return dict(variant="chunked", max_abs_err=max_abs_err["chunked"],
                ms=dev_ms["chunked"], plain_ms=dev_ms["plain"],
                library_ms=None, bound_ms=bound_ms, bound_by=bound_by,
                norm_rel_err=worst["chunked"][0],
                row_rel_err=worst["chunked"][1], serial_ms=dev_ms["serial"],
                serial_max_abs_err=max_abs_err["serial"])


#: arch -> (the launch counter every launch of its kernel must show, the
#: ops function the model calls, the plain version in the model's layout);
#: danube's must all be launches of the wgmma variant, rwkv6's of the
#: chunked one
LM_KERNEL = {
    "h2o-danube-3-4b": ("flash_attention_wgmma_launches", "routed_attention",
                        lambda q, k, v, *, causal, window:
                        ref.flash_attention_ref(q, k, v, causal, window)),
    "rwkv6-7b": ("wkv6_chunked_launches", "routed_wkv6",
                 lambda r, k, v, lw, u: ref.wkv6_ref(r, k, v, lw, u)[0]),
}


@contextlib.contextmanager
def _plain_route(arch: str):
    """The model's kernel call swapped for its plain version (a check of
    the whole forward, outside the counted run)."""
    _, name, plain = LM_KERNEL[arch]
    kernel = getattr(ops, name)
    setattr(ops, name, plain)
    try:
        yield
    finally:
        setattr(ops, name, kernel)


def _lane_split_ms(backend: LmLossEvalBackend, c: torch.Tensor) -> dict:
    """Device ms, with CUDA events, of one whole lane (lift, forward, LM
    head and cross-entropy), of its lift alone and of its head alone (the
    final hidden states through the LM head and the cross-entropy)."""
    wl = backend.workload
    with torch.no_grad():
        params = wl.proj.lift(c)                 # a second working set
        hidden = transformer.forward(params, wl.cfg, wl.batch["tokens"])
        w_head = params["head"]["w"]
        return {
            "lane": _events_ms(lambda: backend.lane_loss(c)),
            "lift": _events_ms(lambda: wl.proj.lift(c, out=params)),
            "head": _events_ms(lambda: transformer.chunked_cross_entropy(
                hidden, w_head, wl.batch["labels"])),
        }


def phase_lm(dev: torch.device, arch: str, kernel_ms: float) -> int:
    """Act 1 over ``arch``'s loss at published widths; returns the arch's
    kernel launches in the two act-1 runs."""
    counter = LM_KERNEL[arch][0]
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    search, fleet, wl = anm_lm.lm_problem(
        arch=arch, device=dev, full_width=True, n_layers=LM_DEPTH[arch],
        seq_len=LM_SEQ_LEN)
    torch.cuda.synchronize()
    n_layers = wl.cfg.n_layers          # every layer runs the arch's kernel
    n_params = wl.proj.n_params
    basis_bytes = wl.proj.basis.numel() * wl.proj.basis.element_size()
    print(f"[lm] {arch}: {n_layers} layers at published widths, P = "
          f"{n_params}, basis {basis_bytes / 1e9:.2f} GB (k = {wl.k}, f32), "
          f"batch {tuple(wl.batch['tokens'].shape)}, built in "
          f"{time.perf_counter() - t0:.1f}s")
    backend = anm_lm.warmed_backend(wl, search.anm.m_regression)
    zero = torch.zeros(wl.k, device=dev)
    loss0 = float(backend.lane_loss(zero))
    with _plain_route(arch):
        loss0_plain = float(backend.lane_loss(zero))
    rel = abs(loss0 - loss0_plain) / abs(loss0_plain)
    print(f"[lm] {arch}: loss at θ0 {loss0:.6f} (ln vocab "
          f"{math.log(wl.cfg.vocab_size):.6f}); with the plain version in "
          f"place of the kernel {loss0_plain:.6f} (relative {rel:.3g})")
    check(math.isfinite(loss0), f"{arch}: non-finite loss at θ0")
    check(rel <= 2e-2, f"{arch}: θ0 loss through the kernel {loss0} vs the "
          f"plain version {loss0_plain}")

    for name in LAUNCH_COUNTERS:
        setattr(ops, name, 0)           # the main path, counted from 0
    out = {}
    for mode, pipelined in (("pipelined", True), ("sync", False)):
        engine, stats, wall = anm_lm.run(search, fleet, backend,
                                         pipelined=pipelined)
        lanes = sum(kp * n for kp, n in stats.bucket_hist.items())
        out[mode] = dict(engine=engine, stats=stats, lanes=lanes)
        print(f"[lm] {arch} {mode}: {engine.iteration} iterations, best "
              f"{engine.best_fitness:.6f} (start {loss0:.6f}), wall "
              f"{wall:.2f}s, {stats.batch_calls} buckets, {lanes} lanes, "
              f"device_blocked_s {stats.device_blocked_s:.2f}, host_s "
              f"{stats.host_s:.2f}, bucket_hist "
              f"{dict(sorted(stats.bucket_hist.items()))}")
    launches = getattr(ops, counter)
    pipe, sync = out["pipelined"], out["sync"]
    lanes = pipe["lanes"] + sync["lanes"]
    counts = {name: getattr(ops, name) for name in LAUNCH_COUNTERS}
    print(f"[lm] {arch}: {counter} {launches} for {lanes} lanes x "
          f"{n_layers} layers; all counts {counts}")
    check(launches == lanes * n_layers, f"{arch}: {launches} kernel "
          f"launches, want one per layer per lane ({lanes} x {n_layers})")
    check(counts["flash_attention_launches"]
          == counts["flash_attention_wgmma_launches"],
          f"{arch}: an attention launch took the SIMT variant")
    check(counts["wkv6_launches"] == counts["wkv6_chunked_launches"],
          f"{arch}: a wkv6 launch took the serial variant")
    check(launches > 0, f"{arch}: the act-1 runs never launched the kernel")
    check(identical_trajectories(pipe["engine"], sync["engine"]),
          f"{arch}: pipelined and sync committed different iterates")
    check(pipe["engine"].stats == sync["engine"].stats,
          f"{arch}: pipelined and sync ended with different engine stats")
    check(pipe["engine"].iteration == search.anm.max_iterations,
          f"{arch}: act 1 stopped early")
    best = pipe["engine"].best_fitness
    check(math.isfinite(best) and best <= loss0,
          f"{arch}: best {best} is not a finite loss ≤ the start {loss0}")

    rng = np.random.default_rng(11)
    pts = rng.uniform(-0.3, 0.3, (20, wl.k))
    narrow = backend(pts[:3])                   # a bucket of 8
    wide = backend(pts)                         # a bucket of 32
    check(np.array_equal(narrow, wide[:3]),
          f"{arch}: a lane's loss depends on its bucket's width")
    split = _lane_split_ms(backend, torch.from_numpy(pts[0]).float().to(dev))
    kernel_lane = kernel_ms * n_layers
    print(f"[lm] {arch}: a lane's loss is the same bits in buckets of 8 and "
          f"32; device ms per lane {split['lane']:.2f}: lift "
          f"{split['lift']:.2f}, kernel {kernel_lane:.2f} ({n_layers} x "
          f"{kernel_ms:.3f}), LM head + CE {split['head']:.2f}, the rest "
          f"(projections, MLP/channel mix, norms, elementwise) "
          f"{split['lane'] - split['lift'] - kernel_lane - split['head']:.2f}"
          f"; peak device memory "
          f"{torch.cuda.max_memory_allocated(dev) / 2**30:.2f} GiB; phase "
          f"wall {time.perf_counter() - t0:.1f}s")
    _lm_acts(dev, arch, search, fleet, backend, n_layers)
    torch.cuda.synchronize()
    del backend, wl, search, out, pipe, sync
    gc.collect()
    torch.cuda.empty_cache()
    return launches


def _row_mean_bound(k: int, n: int):
    """(bound ms, what bounds it) of one row_mean call: the (k, n) f32
    input read once, k f32 written; one f64 add per element at f32's
    peak (the f64 rate is lower, and still far below the bytes)."""
    return _bound(4 * (k * n + k), float(k * n), F32_FLOPS)


def phase_rowmean(dev: torch.device) -> dict:
    """The fixed-order row mean against its plain version and float64."""
    gen = torch.Generator(device=dev).manual_seed(77)
    max_abs_err, worst_rel, cases = 0.0, 0.0, 0
    shapes = [(k, n) for n in ROW_MEAN_LENGTHS for k in ROW_MEAN_WIDTHS]
    for k, n in shapes + [(8, 99_999)]:
        x = torch.rand(k, n, generator=gen, device=dev) * 4.0 - 1.0
        got = ops.row_mean(x)
        plain = ref.row_mean_ref(x)
        want = x.double().mean(dim=1)
        scale = x.double().abs().mean(dim=1)
        torch.cuda.synchronize()
        err = float((got - plain).abs().max())
        rel = float(((got.double() - want).abs() / scale).max())
        max_abs_err, worst_rel = max(max_abs_err, err), max(worst_rel, rel)
        check(rel <= 1e-6, f"row_mean at ({k}, {n}): {rel:.3g} of the mean "
              f"|x| from the float64 mean, > 1e-6")
        check(torch.equal(got, plain), f"row_mean at ({k}, {n}) is not its "
              f"plain version's bits (max |err| {err:.3g})")
        cases += 1
    # a row's mean is its own: every width, every position
    placed = 0
    for n in ROW_MEAN_LENGTHS:
        x = torch.randn(max(ROW_MEAN_WIDTHS), n, generator=gen, device=dev)
        full = ops.row_mean(x)
        for k in ROW_MEAN_WIDTHS:
            for start in sorted({0, (len(x) - k) // 2, len(x) - k}):
                part = ops.row_mean(x[start:start + k].contiguous())
                check(torch.equal(part, full[start:start + k]),
                      f"row_mean of rows {start}..{start + k} of ({len(x)}, "
                      f"{n}) depends on the bucket")
                placed += 1
        del x, full
    k, n = ROW_MEAN_TIMED
    x = torch.randn(k, n, generator=gen, device=dev)
    fns = {"kernel": lambda: ops.row_mean(x),
           "plain": lambda: ref.row_mean_ref(x),
           "mean": lambda: torch.mean(x, dim=1)}
    dev_ms = {}
    for name in ("plain", "kernel", "mean", "mean", "kernel", "plain"):
        calls = 5 if name == "plain" else 50
        dev_ms[name] = min(dev_ms.get(name, 1e9),
                           _graph_ms(fns[name], calls=calls, replays=5))
    bound_ms, bound_by = _row_mean_bound(k, n)
    print(f"[rowmean] {cases} shapes: the plain version's bits, within "
          f"{worst_rel:.2e} (≤ 1e-6) of the float64 mean relative to the "
          f"mean |x|; {placed} sub-buckets of widths {ROW_MEAN_WIDTHS} at "
          f"three positions each: the same bits as in the full batch")
    print(f"[rowmean] at {ROW_MEAN_TIMED} f32, device ms per call (CUDA "
          f"graph): kernel {dev_ms['kernel']:.5f}, torch.mean "
          f"{dev_ms['mean']:.5f}, plain {dev_ms['plain']:.5f}; bound "
          f"{bound_ms:.5f} ({bound_by}: {4 * (k * n + k)} B)")
    del x, fns
    _release_timing_memory("rowmean")
    return dict(max_abs_err=max_abs_err, ms=dev_ms["kernel"],
                plain_ms=dev_ms["plain"], bound_ms=bound_ms,
                bound_by=bound_by, library_ms=dev_ms["mean"],
                max_rel_err_f64=worst_rel)


def phase_fitness(dev: torch.device) -> None:
    """The contract itself: a lane's fitness is its own bytes' function."""
    f_batch, _ = sdss.make_fitness(sdss.stripe79(), dev)
    rng = np.random.default_rng(5)
    pts = rng.uniform(sdss.LO, sdss.HI,
                      (max(FITNESS_WIDTHS), 8)).astype(np.float32)
    probe = pts[:8].copy()
    base = f_batch(probe).cpu()
    check(bool(torch.isfinite(base).all()), "non-finite SDSS fitness")
    alone = torch.stack([f_batch(probe[i:i + 1]).cpu()[0] for i in range(8)])
    check(torch.equal(alone, base), "a point's fitness alone differs from "
          "its fitness in a bucket of 8")
    placed = 0
    for k in FITNESS_WIDTHS:
        for pos in sorted({0, (k - 8) // 2, k - 8}):
            block = pts[:k].copy()
            block[pos:pos + 8] = probe
            got = f_batch(block).cpu()[pos:pos + 8]
            check(torch.equal(got, base), f"fitness at position {pos} of a "
                  f"bucket of {k} differs from the bucket of 8 (max "
                  f"{float((got - base).abs().max()):.3g})")
            placed += 1
    print(f"[fitness] stripe79 at 100k stars: 8 points the same bits alone, "
          f"in a bucket of 8 and at {placed} positions of buckets "
          f"{FITNESS_WIDTHS[0]}..{FITNESS_WIDTHS[-1]}; fitness "
          f"{base.numpy().round(5).tolist()}")


def _improving_commits(res) -> int:
    prev, n = np.asarray(res.server.specs[0].x0), 0
    for rec in res.server.engines[0].history:
        n += int(not np.array_equal(rec.center, prev))
        prev = rec.center
    return n


def phase_server(dev: torch.device) -> int:
    """The FGDO work server through its command line; returns the row-mean
    launches of the uninterrupted paper-scale run."""
    flags = SERVER_FLAGS + ["--device", str(dev)]
    for name in LAUNCH_COUNTERS:
        setattr(ops, name, 0)           # this slice's path, counted from 0
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    _, res, doc = sim.run_cli(flags)
    wall = time.perf_counter() - t0
    counts = {name: getattr(ops, name) for name in LAUNCH_COUNTERS}
    engine = res.server.engines[0]
    finishes = len(engine.phase_finish_s)
    pool = doc["pool"]
    improving = _improving_commits(res)
    print(f"[server] paper scale ({' '.join(SERVER_FLAGS[:8])}): "
          f"{doc['iteration']} iterations ({improving} improving), best "
          f"{doc['best_fitness']:.5f}, wall {wall:.1f}s (setup and warm "
          f"included), {pool['messages']} messages "
          f"({pool['messages'] / wall:.0f}/s), request_p99_ms "
          f"{doc['request_p99_ms']:.3f}, {pool['evals']} evals in "
          f"{pool['eval_batches']} batches, peak device memory "
          f"{torch.cuda.max_memory_allocated(dev) / 2**30:.2f} GiB, "
          f"{finishes} regression finishes, launches {counts}")
    check(improving >= 1, "the server run committed no improving iteration")
    check(counts["gram_launches"] == 2 * finishes > 0,
          f"gram launched {counts['gram_launches']} times for {finishes} "
          f"regression finishes (two fits each)")
    check(counts["row_mean_launches"] > 0, "the server run never launched "
          "the row_mean kernel")
    row_mean_launches = counts["row_mean_launches"]

    crash_at = int(0.4 * pool["messages"])
    with tempfile.TemporaryDirectory(prefix="chip_smoke_server_") as ckpt:
        both = flags + ["--ckpt-dir", ckpt, "--cache"]
        t0 = time.perf_counter()
        try:
            sim.run_cli(both, max_messages=crash_at)
            check(False, "the server finished before its crash point")
        except sim.SimulatedCrash as e:
            crash = str(e)
        t1 = time.perf_counter()
        _, _, restored = sim.run_cli(both + ["--resume"])
        t2 = time.perf_counter()
    same = (restored["history"] == doc["history"]
            and restored["engine_stats"] == doc["engine_stats"])
    hits = restored["cache"]["hits"]
    print(f"[server] {crash} (snapshots every 5000 messages, eval cache "
          f"on) in {t1 - t0:.1f}s; restored: replayed {restored['replayed']} "
          f"log records, re-leased {restored['pool']['resumed_leases']}, "
          f"cache hits {hits} / misses {restored['cache']['misses']}, "
          f"{t2 - t1:.1f}s; bit-identical to uninterrupted: {same}")
    check(same, "the restored server run differs from the uninterrupted one")
    check(hits > 0, "the restored run's eval cache served no hits")

    _, _, loop = sim.run_cli(["--device", str(dev)])
    legs = []
    for extra in SERVER_LEGS:
        t0 = time.perf_counter()
        _, _, got = sim.run_cli(["--device", str(dev)] + extra)
        ok = (got["history"] == loop["history"]
              and got["engine_stats"] == loop["engine_stats"])
        legs.append(f"{' '.join(extra)}: {ok} ({time.perf_counter() - t0:.1f}"
                    f"s, {(got['chaos'] or {}).get('retries', 0)} retries)")
        check(ok, f"the smoke server over {' '.join(extra)} differs from "
              f"loopback")
    print(f"[server] smoke size on the card (loopback best "
          f"{loop['best_fitness']:.6f}, {loop['pool']['messages']} "
          f"messages); equal to loopback: " + "; ".join(legs))
    return row_mean_launches


def phase_portfolio(dev: torch.device) -> None:
    """Act 1 of examples/multi_search.py at paper scale."""
    f_batch, x0 = multi_search.make_problem(100_000, 4096, device=dev)
    backend = InProcessEvalBackend(f_batch, device=dev)
    grid = multi_search.fleet(4096)
    for name in LAUNCH_COUNTERS:
        setattr(ops, name, 0)
    res, wall_co = multi_search.coalesced(backend, grid, x0, **PORTFOLIO)
    co = res.coalesce_stats
    gram_co = ops.gram_launches
    parity, wall_solo = multi_search.solo_reruns(res, backend)
    print(f"[portfolio] {PORTFOLIO['n_searches']} searches (m = "
          f"{PORTFOLIO['m']} / {PORTFOLIO['m'] // 2}, "
          f"{PORTFOLIO['iterations']} iterations) on 4096 hosts, stripe79 "
          f"at 100k stars: coalesced {wall_co:.1f}s, {res.rounds} rounds, "
          f"{co.dispatches} dispatches for {co.lane_blocks} blocks, padded "
          f"lanes {co.padded_lanes} vs {co.solo_padded_lanes} solo; solo "
          f"re-runs {wall_solo:.1f}s; bit-identical: {parity}; best "
          f"{res.best.engine.best_fitness:.5f}; gram launches (warm-up "
          f"and coalesced) {gram_co}")
    check(parity, "a coalesced search differs from its solo re-run")
    check(co.dispatches < co.lane_blocks, "coalescing saved no dispatch")
    check(all(o.engine.iteration == PORTFOLIO["iterations"]
              for o in res.outcomes), "a portfolio search stopped early")


def _lm_acts(dev, arch, search, fleet, backend, n_layers) -> None:
    """Acts 2 (both archs) and 3 (rwkv6) on act 1's workload: the arch's
    kernel once per layer per lane evaluated."""
    counter = LM_KERNEL[arch][0]
    acts = [("act 2", lambda: anm_lm.portfolio(search, fleet, backend, 2))]
    if arch == "rwkv6-7b":
        acts.append(("act 3", lambda: anm_lm.crash_restore(search, fleet,
                                                           backend)))
    for act, run in acts:
        for name in LAUNCH_COUNTERS:
            setattr(ops, name, 0)
        lanes0 = backend.lanes_evaluated
        t0 = time.perf_counter()
        out = run()
        wall = time.perf_counter() - t0
        lanes = backend.lanes_evaluated - lanes0
        launches = getattr(ops, counter)
        if act == "act 2":
            res, wall_co, ok, wall_solo = out
            co = res.coalesce_stats
            what = (f"2 searches coalesced {wall_co:.1f}s ({co.dispatches} "
                    f"dispatches for {co.lane_blocks} blocks), solo re-runs "
                    f"{wall_solo:.1f}s, coalesced == solo: {ok}, best "
                    f"{res.best.engine.best_fitness:.6f}")
        else:
            base, restored, crash, ok = out
            what = (f"uninterrupted {base['pool']['messages']} messages, "
                    f"{crash}, restored after replaying "
                    f"{restored['replayed']} records, bit-identical: {ok}, "
                    f"best {restored['best_fitness']:.6f}")
        print(f"[lm] {arch} {act}: {what}; wall {wall:.1f}s, {lanes} lanes, "
              f"{counter} {launches}")
        check(ok, f"{arch} {act}: the bit-identity gate failed")
        check(launches == lanes * n_layers > 0, f"{arch} {act}: {launches} "
              f"kernel launches for {lanes} lanes x {n_layers} layers")


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device")
    dev = torch.device("cuda", torch.cuda.current_device())
    t0 = time.perf_counter()

    def timed(name, fn, *args):
        t = time.perf_counter()
        result = fn(*args)
        print(f"[wall] {name} {time.perf_counter() - t:.1f}s")
        return result

    timed("card", phase_card, dev)
    timed("build", phase_build)
    gram = timed("gram", phase_gram, dev)
    row_mean = timed("rowmean", phase_rowmean, dev)
    timed("fitness", phase_fitness, dev)
    launches = timed("fig2", phase_fig2, dev)   # the main path, from 0
    timed("grid", phase_grid, dev)
    row_mean_launches = timed("server", phase_server, dev)
    timed("portfolio", phase_portfolio, dev)
    flash = timed("flash", phase_flash, dev)
    wkv6 = timed("wkv6", phase_wkv6, dev)
    flash_launches = timed("lm danube", phase_lm, dev, "h2o-danube-3-4b",
                           flash["ms"])
    wkv6_launches = timed("lm rwkv6", phase_lm, dev, "rwkv6-7b", wkv6["ms"])
    print(f"[done] {time.perf_counter() - t0:.1f}s")
    print(json.dumps({"kernels": [
        {"name": "gram", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/gram.cu",
         "replaces": "src/repro/kernels/gram.py:44",
         "launches": launches, **gram},
        {"name": "flash_attention", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/flash_attention.cu",
         "replaces": "src/repro/kernels/flash_attention.py:81",
         "launches": flash_launches, **flash},
        {"name": "wkv6", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/wkv6.cu",
         "replaces": "src/repro/kernels/wkv6.py:50",
         "launches": wkv6_launches, **wkv6},
        {"name": "row_mean", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/row_mean.cu",
         "replaces": "src/repro/data/sdss.py:79 (jnp.mean, :79, :80, :85; "
                     "no TPU kernel: port-only)",
         "launches": row_mean_launches, **row_mean}]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
