"""Batched serving loop: prompt ingestion + autoregressive decode.

Port of ``repro/launch/serve.py``.  Prompts are consumed through the same
serve step as the decode (the cache fills token by token), then tokens
are sampled with temperature / top-k.  Continuous batching: a finished
sequence's slot is handed to the next queued request without stopping
the decode loop.  As in the reference, the slot's cache rows are not
cleared and the step's position is the loop's global ``t``, so a
request admitted into a reused slot attends to its predecessor's keys
(or carries its recurrent state) and starts at a position other than 0
(ROADMAP.md C).

``serve`` is the loop over given parameters, so a caller can serve any
configuration (``chip_smoke.py`` serves published widths cut in depth);
``main`` is the reference's command line, plus ``--device``.  The loop
reads nothing of the device on the host until the last step: the
control flow depends on lengths only, so the tokens stay on the device
and come back in one copy at the end.

    PYTHONPATH=src python -m repro_torch.launch.serve --device cpu \\
        [--arch qwen2-72b] [--batch 4] [--requests 8]
"""
from __future__ import annotations

import argparse
import dataclasses
import sys
import time
from typing import Callable, Dict, List, Sequence

import numpy as np
import torch

from repro_torch.configs import ARCH_NAMES, ModelConfig, get_smoke_config
from repro_torch.models.transformer import (Params, init_cache, init_params,
                                            make_serve_step)


def sample_logits(logits: torch.Tensor, generator: torch.Generator,
                  temperature: float = 1.0, top_k: int = 40) -> torch.Tensor:
    """(B, V) logits -> (B,) token ids drawn from softmax(logits / T) over
    the top k (ties at the k-th value stay in, as the reference's mask
    ``logits < vals[..., -1:]``).  A Gumbel-max draw, as
    ``jax.random.categorical``, with uniforms from ``generator``, which
    must lie on the logits' device."""
    logits = logits.to(torch.float32) / max(temperature, 1e-4)
    if 0 < top_k < logits.shape[-1]:
        vals = torch.topk(logits, top_k, dim=-1).values
        logits = logits.masked_fill(logits < vals[..., -1:], float("-inf"))
    u = torch.rand(logits.shape, generator=generator, device=logits.device)
    u = torch.clamp(u, min=torch.finfo(torch.float32).tiny)
    return torch.argmax(logits - torch.log(-torch.log(u)), dim=-1)


@dataclasses.dataclass
class ServeResult:
    outputs: Dict[int, List[int]]   # request id -> generated tokens
    steps: int                      # decode steps run
    wall_s: float                   # the loop, its last host copy included


def serve(params: Params, cfg: ModelConfig, queue: Sequence,
          sampler: Callable[[torch.Tensor], torch.Tensor], *, batch: int,
          gen_len: int, max_seq: int) -> ServeResult:
    """The reference's continuous-batching loop over ``queue`` (prompts of
    token ids), ``batch`` slots at a time: each request gets ``gen_len``
    tokens from ``sampler`` ((B, V) logits -> (B,) ids), while ``t <
    max_seq - 1``.  Runs on the parameters' device."""
    if cfg.is_encoder:
        raise ValueError("encoder-only arch has no decode path")
    device = params["final_norm"]["scale"].device
    serve_step = make_serve_step(cfg)
    queue = [torch.as_tensor(np.asarray(p), dtype=torch.long, device=device)
             for p in queue]
    n_req = len(queue)
    cache = init_cache(cfg, batch, max_seq, device=device)
    active = [queue.pop(0) if queue else None for _ in range(batch)]
    pos = [0] * batch
    outputs: Dict[int, list] = {i: [] for i in range(n_req)}
    req_ids = list(range(min(batch, n_req)))
    next_req = len(req_ids)
    done = 0
    t = 0
    steps = 0
    zero = torch.zeros((), dtype=torch.long, device=device)
    cur = [zero] * batch                 # each slot's next input, on device
    for b in range(batch):
        if active[b] is not None:
            cur[b] = active[b][0]
            pos[b] = 1

    t0 = time.perf_counter()
    while done < n_req and t < max_seq - 1:
        logits, cache = serve_step(params, cache,
                                   torch.stack(cur).view(batch, 1), t)
        steps += 1
        nxt = sampler(logits[:, 0])
        t += 1
        for b in range(batch):
            if active[b] is None:
                continue
            rid = req_ids[b]
            if pos[b] < len(active[b]):
                cur[b] = active[b][pos[b]]                  # still prefill
                pos[b] += 1
            else:
                outputs[rid].append(nxt[b])
                cur[b] = nxt[b]
                if len(outputs[rid]) >= gen_len:
                    done += 1
                    if queue:                               # continuous batching
                        active[b] = queue.pop(0)
                        req_ids[b] = next_req
                        next_req += 1
                        pos[b] = 1
                        cur[b] = active[b][0]
                    else:
                        active[b] = None
    flat = [tok for rid in range(n_req) for tok in outputs[rid]]
    values = torch.stack(flat).tolist() if flat else []
    wall = time.perf_counter() - t0
    out, i = {}, 0
    for rid in range(n_req):
        out[rid] = values[i:i + len(outputs[rid])]
        i += len(outputs[rid])
    return ServeResult(outputs=out, steps=steps, wall_s=wall)


def report(res: ServeResult, batch: int) -> List[str]:
    """The reference's closing lines."""
    lines = [f"[serve] req{rid}: {len(toks)} tokens -> {toks[:8]}..."
             for rid, toks in sorted(res.outputs.items())]
    lines.append(f"[serve] {res.steps} decode steps, "
                 f"{res.steps * batch / res.wall_s:.1f} tok/s (batched), "
                 f"{res.wall_s:.1f}s")
    return lines


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen2-72b", choices=ARCH_NAMES,
                    help="smoke-reduced config of this arch is served")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--gen-len", type=int, default=32)
    ap.add_argument("--max-seq", type=int, default=128)
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    cfg = get_smoke_config(args.arch)
    if cfg.is_encoder:
        print("encoder-only arch has no decode path", file=sys.stderr)
        return 1
    params = init_params(
        cfg, torch.Generator(device=args.device).manual_seed(args.seed),
        args.device)
    rng = np.random.default_rng(args.seed)
    queue = [rng.integers(1, cfg.vocab_size, args.prompt_len).astype(np.int32)
             for _ in range(args.requests)]
    print(f"[serve] {cfg.name}: {args.requests} requests, batch={args.batch}")
    gen = torch.Generator(device=args.device).manual_seed(args.seed + 1)
    res = serve(params, cfg, queue, lambda lg: sample_logits(lg, gen),
                batch=args.batch, gen_len=args.gen_len, max_seq=args.max_seq)
    for line in report(res, args.batch):
        print(line)
    return 0


if __name__ == "__main__":
    sys.exit(main())
