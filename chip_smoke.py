#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port on one NVIDIA GPU and check what comes out.

    python3 chip_smoke.py

Phases, each printing one line of numbers; any failed check raises, so
the script exits non-zero and prints no result line:

1. card    the GPU's name and power limit (nvidia-smi), torch and CUDA
           versions; no CUDA device is an error;
2. build   nvcc builds every kernel in src/repro_torch/kernels/csrc/;
3. gram    the gram kernel against its plain version on the card, at the
           main path's shapes, at tests/test_kernels.py's and at the
           widest c it takes, f32 and bf16, max |err| / max |ref| ≤ 1e-5
           for G and r; then kernel, plain version and torch.matmul times
           at (1000, 45) f32 with CUDA events, beside the bound;
4. fig2    paper Fig. 2 at paper scale (m = 1000, 100k stars, 20
           iterations) on stripe79 and stripe86; each must reach 90 % of
           the way to the truth by iteration 5 and end within 5e-3 of the
           reference's final fitness, through the gram kernel;
5. grid    the 4096-host batched grid on stripe79 (100k stars, m = 1000),
           pipelined and sync, which must commit bit-identical iterates;
6. the ``kernels`` JSON line, then the ``ok`` JSON line.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from repro_torch.core.engine import identical_trajectories  # noqa: E402
from repro_torch.core.substrates.batched_grid import \
    BatchedVolunteerGrid  # noqa: E402
from repro_torch.core.substrates.eval_backend import \
    InProcessEvalBackend  # noqa: E402
from repro_torch.kernels import build, ops, ref  # noqa: E402
from repro_torch.launch import fig2, volunteer_grid  # noqa: E402

#: H100 SXM published peaks (NVIDIA data sheet; dense, at 700 W)
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS = 67e12

#: the reference's Fig. 2 run (JAX on a CPU, same seeds, 20 iterations):
#: start and truth fitness, final fitness, iteration reaching 90 %
REFERENCE_FIG2 = {
    "stripe79": dict(start=5.30919, truth=5.01094, final=4.98720, at90=1),
    "stripe86": dict(start=5.21282, truth=5.11153, final=5.09539, at90=2),
}

GRAM_SHAPES = [(1000, 45), (2000, 45),                    # the main path
               (256, 45), (1024, 153), (300, 20), (512, 128),
               (777, 256)]        # widest c: > 48 KB of dynamic shared memory


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
                 if "registers" in ln or "spill" in ln]
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


def phase_gram(dev: torch.device) -> dict:
    gen = torch.Generator(device=dev).manual_seed(1234)
    max_abs_err = 0.0
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
    m, c = 1000, 45
    x = torch.randn(m, c, generator=gen, device=dev)
    y = torch.randn(m, generator=gen, device=dev)
    g1, r1 = ops.gram(x, y)
    g2, r2 = ops.gram(x, y)
    check(torch.equal(g1, g2) and torch.equal(r1, r2),
          "gram is not bitwise repeatable")
    fns = {"kernel": lambda: ops.gram(x, y),
           "plain": lambda: ref.gram_ref(x, y),
           "matmul": lambda: (torch.matmul(x.T, x), torch.matmul(x.T, y))}
    # in turns (plain, kernel, kernel, plain), each kept at its best
    order = ["plain", "kernel", "matmul", "kernel", "plain", "matmul"]
    dev_ms, call_ms = {}, {}
    for name in order:
        dev_ms[name] = min(dev_ms.get(name, 1e9), _graph_ms(fns[name]))
        call_ms[name] = min(call_ms.get(name, 1e9), _time_ms(fns[name]))
    moved = 4 * (m * c + m + c * c + c)       # X, y read once; G, r written
    flops = 2 * m * (c * (c + 1) // 2 + c)    # upper triangle + Xᵀy, FMA=2
    t_bytes = moved / HBM_BYTES_PER_S * 1e3
    t_ops = flops / F32_FLOPS * 1e3
    bound_ms = max(t_bytes, t_ops)
    out = dict(max_abs_err=max_abs_err, ms=dev_ms["kernel"],
               plain_ms=dev_ms["plain"], library_ms=dev_ms["matmul"],
               bound_ms=bound_ms,
               bound_by="bytes" if t_bytes >= t_ops else "operations")
    print(f"[gram] {len(GRAM_SHAPES) * 2} shape/dtype cases within 1e-5 "
          f"(max abs err {max_abs_err:.3g}); at (1000, 45) f32, device ms "
          f"per call (CUDA graph): kernel {dev_ms['kernel']:.5f}, plain "
          f"{dev_ms['plain']:.5f}, matmul {dev_ms['matmul']:.5f}; eager "
          f"call ms: kernel {call_ms['kernel']:.5f}, plain "
          f"{call_ms['plain']:.5f}, matmul {call_ms['matmul']:.5f}; bound "
          f"{bound_ms:.3g} ms ({out['bound_by']}: {moved} B, {flops} FLOP)")
    return out


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


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device")
    dev = torch.device("cuda", torch.cuda.current_device())
    t0 = time.perf_counter()
    phase_card(dev)
    phase_build()
    gram = phase_gram(dev)
    launches = phase_fig2(dev)          # the main path, counted from 0
    phase_grid(dev)
    print(f"[done] {time.perf_counter() - t0:.1f}s")
    print(json.dumps({"kernels": [{
        "name": "gram", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/gram.cu",
        "replaces": "src/repro/kernels/gram.py:44",
        "launches": launches, **gram}]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
