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
    PYTHONPATH=src python -m repro_torch.launch.serve --device cpu \\
        --arch h2o-danube-3-4b --ranks 2 --model-ranks 2

The model axis over ranks (``--ranks W --model-ranks M``, M dividing W,
``--dist-backend gloo|nccl``).  The reference only lowers this: its
dry-run's decode cells jit ``make_serve_step`` with the caches laid out
by ``cache_specs`` and its prefill cells ``make_prefill_step``, on a
mesh whose ``model`` axis cuts the parameters.  The port runs W ranks
of a ``torch.distributed`` group (``launch/ranks.py``, each a child
forked from ``launch/child.py``'s forkserver) on the (W/M, M) mesh of
``Mesh.over_ranks``, as ``launch/train.py --model-ranks`` does: each
rank draws the whole parameters from the seed, keeps its ``model``
block of every leaf (``sharding.tp_ctx``) and its block of each cache
(``ModelShards.init_cache``: the batch's rows over the data ranks where
they divide them, k/v's rows over ``model``, else over every rank).  A
decode step merges the cache blocks' attention over the ranks that hold
them, and the logits are gathered over the model group (and the rows
over the data group), so every rank samples the same tokens from the
same generator; rank 0 prints.  Serving over ranks runs the dense
attention decoders only: any other architecture is refused with its
ROADMAP item before a rank starts (``transformer.check_serve_model_cut``),
and never served in one process instead.  A rank that fails fails the
run.
"""
from __future__ import annotations

import argparse
import dataclasses
import gc
import hashlib
import os
import sys
import tempfile
import time
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np
import torch

from repro_torch.configs import ARCH_NAMES, ModelConfig, get_smoke_config
from repro_torch.configs.base import config_from_dict
from repro_torch.core.tree import leaves_with_paths
from repro_torch.kernels import ops
from repro_torch.launch import ranks
from repro_torch.models.sharding import tp_ctx
from repro_torch.models.transformer import (NULL_CTX, Params, ShardCtx,
                                            check_serve_model_cut,
                                            init_cache, init_params,
                                            make_prefill_step,
                                            make_serve_step)

#: the rank body ``--ranks`` runs (``launch/ranks.py``)
RANK_TARGET = "repro_torch.launch.serve:serve_rank"
#: a run over ranks past this is killed (its process group has a timeout
#: of its own for a rank waiting on a dead peer, ``ranks.PG_TIMEOUT_S``)
RANKS_TIMEOUT_S = 24 * 3600.0


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


def _step_and_cache(ctx: ShardCtx, cfg: ModelConfig, batch: int,
                    max_seq: int, device):
    """(the serve step of the whole batch, its empty cache): over the model
    axis's ranks the rank's block of the cache, and a step that feeds the
    rank its rows and returns every row's logits."""
    step = make_serve_step(cfg, ctx)
    shards = ctx.serving
    if shards is None:
        return step, init_cache(cfg, batch, max_seq, device=device)

    def rows_step(params, cache, tokens, t):
        logits, cache = step(params, cache, shards.own_rows(tokens), t)
        return shards.all_rows(logits, tokens.shape[0]), cache
    return rows_step, shards.init_cache(cfg, batch, max_seq, device)


def serve(params: Params, cfg: ModelConfig, queue: Sequence,
          sampler: Callable[[torch.Tensor], torch.Tensor], *, batch: int,
          gen_len: int, max_seq: int, ctx: ShardCtx = NULL_CTX
          ) -> ServeResult:
    """The reference's continuous-batching loop over ``queue`` (prompts of
    token ids), ``batch`` slots at a time: each request gets ``gen_len``
    tokens from ``sampler`` ((B, V) logits -> (B,) ids), while ``t <
    max_seq - 1``.  Runs on the parameters' device; over the model axis's
    ranks (``sharding.tp_ctx``) ``params`` are the rank's blocks, and the
    loop runs the same on every rank."""
    if cfg.is_encoder:
        raise ValueError("encoder-only arch has no decode path")
    device = params["final_norm"]["scale"].device
    serve_step, cache = _step_and_cache(ctx, cfg, batch, max_seq, device)
    queue = [torch.as_tensor(np.asarray(p), dtype=torch.long, device=device)
             for p in queue]
    n_req = len(queue)
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


def _parse(argv) -> argparse.Namespace:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen2-72b", choices=ARCH_NAMES,
                    help="smoke-reduced config of this arch is served")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--gen-len", type=int, default=32)
    ap.add_argument("--max-seq", type=int, default=128)
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu; no fallback between them")
    ap.add_argument("--ranks", type=int, default=0,
                    help="W>0 with --model-ranks M: the parameters and the "
                         "caches cut over the model axis across M of W "
                         "ranks of a torch.distributed group, one process "
                         "each, on a (W/M, M) mesh")
    ap.add_argument("--model-ranks", type=int, default=1,
                    help="M>1 with --ranks W: the ranks a model group cuts "
                         "the parameters over (Megatron tensor "
                         "parallelism)")
    ap.add_argument("--dist-backend", default="gloo", choices=ranks.BACKENDS,
                    help="the ranks' backend: gloo (ranks may share a "
                         "device) or nccl (a card a rank)")
    return ap.parse_args(argv)


def _config(args, cfg: Optional[dict]) -> ModelConfig:
    """``cfg`` (``dataclasses.asdict``) where given, else the smoke config
    of ``--arch``."""
    return config_from_dict(cfg) if cfg is not None \
        else get_smoke_config(args.arch)


def _check_ranks(args, cfg: ModelConfig) -> None:
    """``--ranks W --model-ranks M`` need M > 1 dividing W, and a dense
    attention decoder (``transformer.check_serve_model_cut``)."""
    m = args.model_ranks
    if m < 2 or args.ranks < 1 or args.ranks % m:
        raise ValueError(f"serving over ranks cuts the model axis: pass "
                         f"--ranks W with --model-ranks M > 1 dividing W "
                         f"(got --ranks {args.ranks} --model-ranks {m})")
    if cfg.is_encoder:
        raise ValueError("encoder-only arch has no decode path")
    check_serve_model_cut(cfg, m, "serving")


def _queue(args, cfg: ModelConfig) -> list:
    rng = np.random.default_rng(args.seed)
    return [rng.integers(1, cfg.vocab_size, args.prompt_len).astype(np.int32)
            for _ in range(args.requests)]


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else list(argv)
    args = _parse(argv)
    if args.ranks:
        return _main_over_ranks(args, argv)
    if get_smoke_config(args.arch).is_encoder:
        print("encoder-only arch has no decode path", file=sys.stderr)
        return 1
    run(argv)
    return 0


def run(argv, *, cfg: Optional[dict] = None) -> ServeResult:
    """The launcher's ``argv`` in this process (``cfg``: a configuration
    in place of ``--arch``'s smoke config), its lines printed."""
    args = _parse(argv)
    if args.ranks:
        raise ValueError("run() serves in this process; --ranks runs "
                         "through main() or over_ranks()")
    cfg = _config(args, cfg)
    params = init_params(
        cfg, torch.Generator(device=args.device).manual_seed(args.seed),
        args.device)
    queue = _queue(args, cfg)
    print(f"[serve] {cfg.name}: {args.requests} requests, batch={args.batch}")
    gen = torch.Generator(device=args.device).manual_seed(args.seed + 1)
    res = serve(params, cfg, queue, lambda lg: sample_logits(lg, gen),
                batch=args.batch, gen_len=args.gen_len, max_seq=args.max_seq)
    for line in report(res, args.batch):
        print(line)
    return res


def _main_over_ranks(args, argv) -> int:
    """``main`` with ``--ranks``: the run over the ranks, rank 0's lines
    printed; exit 1 where the configuration is refused or a rank fails."""
    try:
        res, lead_output = over_ranks(argv)
    except (ValueError, NotImplementedError, RuntimeError) as e:
        print(f"[serve] refused: {e}", file=sys.stderr)
        return 1
    sys.stdout.write(lead_output)
    sys.stdout.flush()
    if res.returncode == 0:
        return 0
    print(f"[serve] the run over {args.ranks} ranks failed: {res.failed}",
          file=sys.stderr)
    return 1


def over_ranks(argv: list, *, cfg: Optional[dict] = None,
               probe: Optional[dict] = None):
    """The launcher's ``argv`` (with ``--ranks W --model-ranks M``) over W
    ranks of ``--dist-backend`` on ``--device`` (gloo: every rank there;
    nccl: rank r on ``cuda:r``), each rank ``serve_rank`` (``cfg``: a
    configuration in place of ``--arch``'s smoke config; ``probe``:
    ``run_probe``'s arguments, run before the loop), in a temporary work
    directory.  Refuses before any rank starts.  Returns
    (``ranks.RanksResult`` with the ranks' docs in rank order, rank 0's
    standard output)."""
    args = _parse(argv)
    _check_ranks(args, _config(args, cfg))
    if torch.device(args.device).type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("--device cuda, and no CUDA device is "
                               "present; pass --device cpu to serve on the "
                               "CPU")
        devices = ranks.default_devices(args.dist_backend, args.ranks,
                                        args.device)
    else:
        devices = [torch.device(args.device)] * args.ranks
    with tempfile.TemporaryDirectory(prefix="serve_ranks_") as workdir:
        res = ranks.run(RANK_TARGET, {"argv": list(argv), "cfg": cfg,
                                      "probe": probe},
                        world=args.ranks, backend=args.dist_backend,
                        devices=devices, workdir=workdir,
                        timeout=RANKS_TIMEOUT_S)
        with open(os.path.join(workdir, "rank_0.out")) as f:
            return res, f.read()


def _digest(x: torch.Tensor) -> str:
    return hashlib.sha256(x.detach().cpu().contiguous().view(
        torch.uint8).numpy().tobytes()).hexdigest()


def _sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def run_probe(params: Params, cfg: ModelConfig, ctx: ShardCtx,
              tokens: torch.Tensor, *, decode_len: int, max_seq: int
              ) -> dict:
    """The serving steps on ``tokens`` (B, S) in ``ctx``: one prefill of
    all S, then the decode of the first ``decode_len`` positions from an
    empty cache of ``max_seq`` rows (over the model axis's ranks the
    rank's blocks, fed its rows, every row's logits gathered).  Returns
    the prefill's (B, S, V) and the decode's (B, decode_len, V) logits
    and, for each, the kernels' launches, the wall with the device
    synchronized, and over ranks the collectives a rank hands by kind
    (bytes, calls and seconds; the decode's first step's apart)."""
    shards = ctx.serving
    device = tokens.device

    def counted():
        if shards is None:
            return {}
        return {"bytes": dict(shards.model_bytes),
                "calls": dict(shards.model_calls),
                "seconds": dict(shards.model_seconds)}

    def since(before):
        now = counted()
        return {key: {k: now[key][k] - before[key][k] for k in now[key]}
                for key in now}

    def phase(fn):
        before, launches = counted(), ops.launch_counts()
        _sync(device)
        t0 = time.perf_counter()
        out = fn()
        _sync(device)
        wall = time.perf_counter() - t0
        after = ops.launch_counts()
        return out, dict(since(before), wall_s=wall, launches={
            k: after[k] - launches[k] for k in after})

    prefill = make_prefill_step(cfg, ctx)
    if shards is None:
        pre, pre_doc = phase(lambda: prefill(params, {"tokens": tokens}))
    else:
        pre, pre_doc = phase(lambda: shards.all_rows(prefill(
            params, {"tokens": shards.own_rows(tokens)}), tokens.shape[0]))
    step, cache = _step_and_cache(ctx, cfg, tokens.shape[0], max_seq, device)
    first = {}

    def decode():
        outs = []
        for t in range(decode_len):
            before = counted()
            logits, _ = step(params, cache, tokens[:, t:t + 1], t)
            outs.append(logits)
            if t == 0:
                first.update(since(before))
        return torch.cat(outs, dim=1)
    dec, dec_doc = phase(decode)
    dec_doc["first_step"] = first
    if shards is not None:
        dec_doc.update(seq_block=shards.seq_block,
                       seq_blocks=shards.seq_blocks,
                       rows_cut=shards.rows_cut(tokens.shape[0]),
                       cache_rows=[list(x.shape) for path, x in
                                   leaves_with_paths(cache)
                                   if path.endswith("/k")][0])
    return {"prefill": pre, "decode": dec, "prefill_doc": pre_doc,
            "decode_doc": dec_doc}


def serve_rank(group, *, argv: list, cfg: Optional[dict] = None,
               probe: Optional[dict] = None) -> dict:
    """One rank of a run over ranks (``launch/ranks.py``'s target): the
    launcher's ``argv`` on the group's device, the rank's model block of
    the parameters drawn from ``--seed`` on the (W/M, M) mesh over the
    group (``cfg`` in place of ``--arch``'s smoke config).  With
    ``probe`` ({"tokens": an .npy of (B, S) token ids, "decode_len",
    "max_seq", "use_kernels", "out": a path for rank 0's logits, ``{}``
    the phase}) it first runs ``run_probe``.  Then the serving loop over
    the seeded prompts, sampled from the same generator on every rank;
    rank 0 prints the reference's lines.  Returns the rank's doc: its
    tokens, steps, the loop's wall, the probe's digests, counts and
    walls, the collectives by kind, NaN logits seen, the kernels'
    launches and the device's peak memory (CUDA)."""
    args = _parse(argv)
    if args.ranks != group.world:
        raise ValueError(f"--ranks {args.ranks} in a group of {group.world}")
    cfg = _config(args, cfg)
    device = group.device
    lead = group.rank == 0
    m = args.model_ranks
    mesh = group.mesh((group.world // m, m), model_ranks=m)
    ctx = tp_ctx(mesh, cfg)
    params = init_params(cfg, torch.Generator(device=device).manual_seed(
        args.seed), device)
    params = ctx.ranks.shard(params)      # the rank's blocks; wholes freed
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(device)
    doc = {"rank": group.rank, "device": str(device)}
    if probe:
        tokens = torch.from_numpy(np.load(probe["tokens"])).long().to(device)
        pcfg = dataclasses.replace(cfg, use_kernels=probe.get(
            "use_kernels", cfg.use_kernels))
        res = run_probe(params, pcfg, ctx, tokens,
                        decode_len=probe["decode_len"],
                        max_seq=probe["max_seq"])
        for phase in ("prefill", "decode"):
            logits = res.pop(phase)
            doc[phase] = dict(res.pop(phase + "_doc"),
                              digest=_digest(logits),
                              finite=bool(torch.isfinite(logits).all()),
                              shape=list(logits.shape))
            if lead and probe.get("out"):
                torch.save(logits.cpu(), probe["out"].format(phase))
            del logits
        gc.collect()
    if lead:
        print(f"[serve] {cfg.name}: {args.requests} requests, "
              f"batch={args.batch}, over {group.world} ranks (model axis "
              f"over {m})", flush=True)
    before = dict(ctx.ranks.model_bytes)
    gen = torch.Generator(device=device).manual_seed(args.seed + 1)
    nans = []

    def sampler(logits):
        nans.append(torch.isnan(logits).any())
        return sample_logits(logits, gen)
    res = serve(params, cfg, _queue(args, cfg), sampler, batch=args.batch,
                gen_len=args.gen_len, max_seq=args.max_seq, ctx=ctx)
    if lead:
        for line in report(res, args.batch):
            print(line, flush=True)
    doc.update(
        outputs={str(k): v for k, v in res.outputs.items()},
        steps=res.steps, serve_wall_s=res.wall_s,
        nan_logits=int(torch.stack(nans).sum()) if nans else 0,
        serve_bytes={k: v - before[k]
                     for k, v in ctx.ranks.model_bytes.items()},
        model_bytes=ctx.ranks.model_bytes, model_calls=ctx.ranks.model_calls,
        kernel_launches=ops.launch_counts(),
        peak_bytes=(torch.cuda.max_memory_allocated(device)
                    if device.type == "cuda" else None))
    return doc


if __name__ == "__main__":
    sys.exit(main())
