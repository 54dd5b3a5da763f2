"""Where the time of a paper-scale Fig. 2 run goes, on the card.

Runs one stripe of ``launch/fig2.py`` at paper scale three times: two
iterations to warm up, the full run untraced (the wall time without
tracing), and the full run again under
``torch.profiler`` (CPU and CUDA activities), and prints both wall times,
the device's busy time (the sum of its kernels' and copies' times) with
the idle share of each wall, and the kernels that took the most device
time.

    PYTHONPATH=src python -m repro_torch.launch.profile_fig2 [--stripe S]
"""
from __future__ import annotations

import argparse
import time

import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

from repro_torch.launch import fig2


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--stripe", default="stripe86",
                    choices=[s[0] for s in fig2.STRIPES])
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("profile_fig2: no CUDA device")
    name, seed, start_seed, engine_seed = next(
        s for s in fig2.STRIPES if s[0] == args.stripe)
    kw = dict(n_stars=100_000, m=1000, device="cuda")
    fig2.run_stripe(name, seed, start_seed, engine_seed, **kw, iters=2)
    kw["iters"] = 20
    untraced = fig2.run_stripe(name, seed, start_seed, engine_seed, **kw)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        rec = fig2.run_stripe(name, seed, start_seed, engine_seed, **kw)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    # device-side events only: the CPU ops that launched them report the
    # same time again
    events = [e for e in prof.key_averages()
              if e.device_type == DeviceType.CUDA]
    busy = sum(e.self_device_time_total for e in events) / 1e6
    print(f"[profile] {name}: {kw['iters']} iterations; wall untraced "
          f"{untraced['wall_s']:.3f}s, traced {wall:.3f}s; device busy "
          f"{busy:.3f}s: idle share {1 - busy / untraced['wall_s']:.3f} "
          f"of the untraced wall, {1 - busy / wall:.3f} of the traced; "
          f"phase finish {untraced['phase_finish_ms_mean']:.2f} ms mean "
          f"untraced, {rec['phase_finish_ms_mean']:.2f} traced")
    gram = [e for e in events if "gram_" in e.key]
    print(f"[profile] gram kernel: "
          f"{sum(e.count for e in gram)} kernel runs (two per call), "
          f"{sum(e.self_device_time_total for e in gram) / 1e3:.3f} ms "
          f"device time")
    events.sort(key=lambda e: -e.self_device_time_total)
    for e in events[:12]:
        print(f"[profile]   {e.self_device_time_total / 1e3:9.3f} ms "
              f"{e.count:6d}x  {e.key[:90]}")


if __name__ == "__main__":
    main()
