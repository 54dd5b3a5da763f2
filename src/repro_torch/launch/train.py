"""End-to-end training launcher.

Port of ``repro/launch/train.py``, with its command line and presets plus
``--device`` (default ``cuda``; the CPU only when asked for): the
synthetic data pipeline, AdamW (optionally with int8 error-feedback
gradient compression), checkpoint/restart (a resumed run continues bit
for bit), and the paper's randomized parallel line search and subspace
Newton as training options.

    PYTHONPATH=src python -m repro_torch.launch.train --preset lm-100m --steps 200
    PYTHONPATH=src python -m repro_torch.launch.train --arch rwkv6-7b --steps 20
    PYTHONPATH=src python -m repro_torch.launch.train --preset tiny \\
        --optimizer subspace-newton
    PYTHONPATH=src python -m repro_torch.launch.train --preset tiny \\
        --steps 50 --crash-at 25 --ckpt-dir /tmp/ck && \\
        PYTHONPATH=src python -m repro_torch.launch.train --preset tiny \\
        --steps 50 --ckpt-dir /tmp/ck --resume   # fault-tolerant restart
    PYTHONPATH=src python -m repro_torch.launch.train --preset tiny \\
        --ranks 2 --dist-backend gloo --device cpu   # the data axis over ranks
    PYTHONPATH=src python -m repro_torch.launch.train --preset lm-100m \\
        --ranks 2 --fsdp        # the parameters cut over the ranks as well

The data axis (``--ranks W``, ``--dist-backend gloo|nccl``).  The
reference trains data-parallel on its production mesh with the batch
cut over ``data`` (``repro/launch/dryrun.py`` jits ``make_train_step``
with ``in_shardings``; GSPMD inserts the gradient all-reduce), each host
drawing its own rows (``data/pipeline.py``'s ``n_hosts`` / ``host_id``).
The port runs W ranks of a ``torch.distributed`` group
(``launch/ranks.py``: each a child forked from ``launch/child.py``'s
forkserver; gloo ranks may share a device, nccl takes one card a rank):
rank r holds data block r of a (W, 1) mesh (``Mesh.over_ranks``), draws
host r's rows, and steps in the ``ShardCtx`` of
``sharding.data_parallel_ctx``, where the loss's sums over the batch and
the gradients are summed over the ranks.  So every rank's loss and
update are the whole batch's, the reference's global view, and every
rank holds the same parameters bit for bit.  Rank 0 prints the
``[train]`` lines and writes the checkpoints behind a barrier; every
rank restores.  A simulated crash exits 42 from every rank and the run
exits 42; a rank that fails gets its survivors SIGKILLed (``ranks.run``).
A global batch that W does not divide is refused.

``--fsdp`` (with ``--ranks``) also cuts the parameters over the data
axis, as the reference's ``--fsdp`` dry-run cell does
(``param_specs(cfg, mesh, fsdp=True)``): each rank draws the whole
parameters from the seed as one process does, keeps its block of every
leaf the specs cut over ``data`` and frees the rest, so it holds only
those blocks and its blocks of their AdamW moments.  The step runs in
``sharding.fsdp_ctx``: a cut leaf is all-gathered where it is used and
its gradient reduce-scattered, the whole leaves' gradients all-reduced,
and the clip's norm summed over the ranks.  The reference runs fsdp only
in its AdamW train step, so ``--compress-grads``, ``--line-search`` and
``--optimizer subspace-newton`` (per-leaf scales, dot products and norms
that would need reductions of their own) are refused with it.  Rank 0's
checkpoint holds the whole tree, gathered leaf by leaf, and each rank
restores its blocks.

Where the reference folds each step into ``jax.random.fold_in(key(seed +
7), step)``, the port seeds a ``torch.Generator`` on the device from
(seed + 7, step) (``step_generator``); JAX's draws cannot be reproduced.

Determinism: the reference's contract is that a resumed run equals the
uninterrupted one bit for bit, and XLA's steps are deterministic.  On a
card the eager backward accumulates through atomics (the embedding's
``index_put`` with accumulate, ``gather``'s ``scatter_add``), so ``main``
sets ``CUBLAS_WORKSPACE_CONFIG=:4096:8`` before CUDA starts and runs with
``torch.use_deterministic_algorithms(True)``, restoring the previous
setting when it returns.  Every op the training path runs has a
deterministic CUDA version in torch.
"""
from __future__ import annotations

import argparse
import contextlib
import hashlib
import json
import os
import sys
import tempfile
import time
from typing import Callable, Optional

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.checkpoint import checkpoint as ckpt
from repro_torch.configs import ARCH_NAMES, get_smoke_config
from repro_torch.configs.base import ModelConfig, config_from_dict
from repro_torch.core import subspace_newton as subn
from repro_torch.core.parallel_line_search import (LineSearchConfig,
                                                   randomized_line_search)
from repro_torch.core.tree import leaves_with_paths, map_tree
from repro_torch.data.pipeline import DataConfig, SyntheticLM, SyntheticMasked
from repro_torch.launch import ranks
from repro_torch.models.sharding import data_parallel_ctx, fsdp_ctx
from repro_torch.models.transformer import (NULL_CTX, ShardCtx, count_params,
                                            init_params, make_loss_fn,
                                            make_train_step, value_and_grad)
from repro_torch.optim.adamw import AdamW, opt_state_specs
from repro_torch.optim.compression import compress_grads, init_error_state

PRESETS = {
    "tiny": ModelConfig(name="tiny-lm", family="dense", n_layers=2, d_model=64,
                        n_heads=4, n_kv_heads=2, d_ff=192, vocab_size=512,
                        head_dim=16, remat=False),
    "lm-100m": ModelConfig(name="lm-100m", family="dense", n_layers=10,
                           d_model=640, n_heads=10, n_kv_heads=5, d_ff=2560,
                           vocab_size=32000, head_dim=64, remat=False),
}


def build_config(args) -> ModelConfig:
    if args.preset:
        return PRESETS[args.preset]
    return get_smoke_config(args.arch)


def step_generator(seed: int, step: int, device) -> torch.Generator:
    """The step's draws (line-search scales, the subspace basis): a
    generator on ``device`` seeded from (seed + 7, step)."""
    return torch.Generator(device=device).manual_seed(
        (seed + 7) * 1_000_003 + step)


def host_data(cfg: ModelConfig, seq: int, batch: int, seed: int,
              n_hosts: int = 1, host_id: int = 0):
    """Host ``host_id``'s slice of the synthetic stream over ``n_hosts``
    data-parallel hosts (the reference's per-host pipeline): masked frames
    for the audio stub, tokens otherwise.  A global batch that
    ``n_hosts`` does not divide is refused."""
    if batch % n_hosts:
        raise ValueError(f"a global batch of {batch} does not divide over "
                         f"{n_hosts} data-parallel hosts (--batch, --ranks)")
    dcfg = DataConfig(vocab_size=cfg.vocab_size, seq_len=seq,
                      global_batch=batch, seed=seed, n_hosts=n_hosts,
                      host_id=host_id)
    if cfg.frontend == "audio_stub":
        return SyntheticMasked(dcfg, cfg.d_model)
    return SyntheticLM(dcfg)


def hosts_batch(sources: list, step: int) -> dict:
    """Step ``step``'s batch of each host in ``sources``, concatenated
    along the rows in host order (numpy): the global batch a run over
    ranks cuts into the hosts' slices."""
    parts = [src.batch(step) for src in sources]
    if len(parts) == 1:
        return parts[0]
    return {name: np.concatenate([p[name] for p in parts])
            for name in parts[0]}


def batch_to(batch: dict, cfg: ModelConfig, device) -> dict:
    """A pipeline batch (numpy) as tensors on ``device``: token ids and
    labels as int64, frame embeddings in the model's type, the mask as
    bool."""
    out = {}
    for name, value in batch.items():
        t = torch.from_numpy(value)
        if name in ("tokens", "labels"):
            t = t.long()
        elif name == "embeds":
            t = t.to({"bfloat16": torch.bfloat16,
                      "float32": torch.float32}[cfg.dtype])
        out[name] = t.to(device)
    return out


def make_full_step(cfg: ModelConfig, opt: AdamW, *, compress: bool = False,
                   line_search: int = 0, device="cuda",
                   ctx: ShardCtx = NULL_CTX) -> Callable:
    """The launcher's AdamW step: step(params, opt_state, err_state, batch,
    generator) -> (params, opt_state, err_state, metrics).  With
    ``compress`` the gradients go through ``compress_grads`` (``err_state``
    carries the residual); with ``line_search`` p > 0 the AdamW update is
    scaled by the randomized parallel line search over p candidates drawn
    from ``generator``.  Over ranks (``ctx.ranks``) every loss is the whole
    batch's and the gradients are summed over the ranks before they are
    compressed, so every rank compresses, searches and updates alike."""
    loss_fn = make_loss_fn(cfg, ctx)
    base_step = make_train_step(cfg, opt, ctx)

    def full_step(params, opt_state, err_state, batch, generator):
        if compress:
            grads, loss, metrics = value_and_grad(loss_fn, params, batch)
            grads, err_state = compress_grads(ctx.sum_grads(grads),
                                              err_state)
            params_new, opt_state = opt.update(grads, opt_state, params)
            metrics = dict(metrics, loss=loss)
        else:
            params_new, opt_state, metrics = base_step(params, opt_state,
                                                       batch)
        if line_search > 0:
            update = map_tree(lambda n, o: n.to(torch.float32)
                              - o.to(torch.float32), params_new, params)
            params_new, alpha, ls_loss = randomized_line_search(
                lambda p: loss_fn(p, batch)[0], params, update, generator,
                LineSearchConfig(p=line_search), device=device)
            metrics = dict(metrics, ls_alpha=alpha, ls_loss=ls_loss)
        return params_new, opt_state, err_state, metrics

    return full_step


def _state_tree(params, opt_state, err_state) -> dict:
    tree = {"params": params, "opt": opt_state}
    if err_state is not None:
        tree["err"] = err_state
    return tree


def state_digest(*trees) -> str:
    """SHA-256 over the bits of every leaf of ``trees`` (None skipped),
    path by path in leaf order: equal digests are equal states."""
    h = hashlib.sha256()
    for tree in trees:
        if tree is None:
            continue
        for path, x in leaves_with_paths(tree):
            h.update(path.encode())
            h.update(x.detach().reshape(-1).view(torch.uint8).cpu()
                     .numpy().tobytes())
    return h.hexdigest()


#: the rank body ``--ranks`` runs (``launch/ranks.py``)
RANK_TARGET = "repro_torch.launch.train:train_rank"
#: a run over ranks past this is killed (its process group has a timeout
#: of its own for a rank waiting on a dead peer, ``ranks.PG_TIMEOUT_S``)
RANKS_TIMEOUT_S = 24 * 3600.0


def _parse(argv) -> argparse.Namespace:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None, choices=ARCH_NAMES)
    ap.add_argument("--preset", default=None, choices=list(PRESETS))
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--optimizer", default="adamw",
                    choices=["adamw", "subspace-newton"])
    ap.add_argument("--compress-grads", action="store_true",
                    help="int8 + error-feedback gradient compression")
    ap.add_argument("--line-search", type=int, default=0,
                    help="p>0: randomized parallel line search every step")
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--crash-at", type=int, default=0,
                    help="simulate a node failure at this step (exit 42)")
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--log-file", default=None)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu; no fallback between them")
    ap.add_argument("--ranks", type=int, default=0,
                    help="W>0: the data axis over W ranks of a "
                         "torch.distributed group, one process each")
    ap.add_argument("--dist-backend", default="gloo", choices=ranks.BACKENDS,
                    help="the ranks' backend: gloo (ranks may share a "
                         "device) or nccl (a card a rank)")
    ap.add_argument("--fsdp", action="store_true",
                    help="with --ranks: every parameter of 2^20 elements or "
                         "more cut over the ranks too (the reference's "
                         "--fsdp), gathered where it is used")
    args = ap.parse_args(argv)
    _check_fsdp(args)
    return args


def _check_fsdp(args) -> None:
    """``--fsdp`` needs ``--ranks``, and runs only the AdamW step, as the
    reference's."""
    if not args.fsdp:
        return
    if not args.ranks:
        raise ValueError("--fsdp cuts the parameters over the ranks of "
                         "--ranks W: pass --ranks")
    for flag, given in (("--compress-grads", args.compress_grads),
                        ("--line-search", args.line_search > 0),
                        ("--optimizer subspace-newton",
                         args.optimizer == "subspace-newton")):
        if given:
            raise ValueError(
                f"--fsdp with {flag} is not supported: its per-leaf scales, "
                f"dot products or norms would need reductions of their own "
                f"over the cut leaves, and the reference runs fsdp only in "
                f"its AdamW train step")


@contextlib.contextmanager
def _deterministic(device: torch.device):
    """Deterministic algorithms while training on ``device``, the previous
    setting restored after; on CUDA the cuBLAS workspace setting they
    need, set before cuBLAS starts."""
    if device.type == "cuda":
        os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
        if not torch.cuda.is_available():
            raise RuntimeError("--device cuda, and no CUDA device is present; "
                               "pass --device cpu to train on the CPU")
    was_deterministic = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True)
    try:
        yield
    finally:
        torch.use_deterministic_algorithms(was_deterministic)


def main(argv=None):
    argv = sys.argv[1:] if argv is None else list(argv)
    args = _parse(argv)
    if args.ranks:
        return _main_over_ranks(args, argv)
    run(argv)
    return 0


def run(argv, *, hosts: int = 1, measure: bool = False,
        cfg: Optional[dict] = None, params_out: Optional[str] = None
        ) -> dict:
    """The launcher's run of ``argv`` in this process; returns its doc
    (``_run``).  ``hosts``: the global batch drawn as the concatenation of
    that many hosts' slices, as a run over that many ranks draws it.
    ``cfg``: a configuration (``dataclasses.asdict``) in place of
    ``--preset`` / ``--arch``'s, as the reference's ``lower_cell(
    cfg_override=)``; ``params_out``: a path the final parameters are
    saved to (``torch.save``)."""
    args = _parse(argv)
    if args.ranks:
        raise ValueError("run() trains in this process; --ranks runs "
                         "through main() or over_ranks()")
    device = torch.device(args.device)
    with _deterministic(device):
        return _run(args, device, hosts=hosts, measure=measure, cfg=cfg,
                    params_out=params_out)


def train_rank(group, *, argv: list, measure: bool = False,
               cfg: Optional[dict] = None,
               params_out: Optional[str] = None) -> dict:
    """One rank of a run over ranks (``launch/ranks.py``'s target): the
    launcher's ``argv`` on the group's device, its data block of the
    (W, 1) mesh over the group; returns the rank's doc (``_run``).
    ``cfg`` and ``params_out`` as ``run``'s, ``{rank}`` in the path
    replaced by the rank (its blocks under ``--fsdp``)."""
    args = _parse(argv)
    if args.ranks != group.world:
        raise ValueError(f"--ranks {args.ranks} in a group of {group.world}")
    with _deterministic(group.device):
        return _run(args, group.device, group=group, measure=measure,
                    cfg=cfg, params_out=params_out)


def over_ranks(argv: list, *, measure: bool = False,
               cfg: Optional[dict] = None, params_out: Optional[str] = None):
    """The launcher's ``argv`` (with ``--ranks W --dist-backend B``) over
    W ranks of backend B on ``--device`` (gloo: every rank there; nccl:
    rank r on ``cuda:r``), each rank ``train_rank`` (``cfg`` and
    ``params_out`` handed on), in a temporary work directory.  Returns
    (``ranks.RanksResult``, with the ranks' docs in rank order; rank 0's
    standard output)."""
    args = _parse(argv)
    if args.ranks < 1:
        raise ValueError("over_ranks needs --ranks W >= 1")
    if args.batch % args.ranks:
        raise ValueError(f"a global batch of {args.batch} does not divide "
                         f"over {args.ranks} ranks (--batch, --ranks)")
    if torch.device(args.device).type == "cuda":
        devices = ranks.default_devices(args.dist_backend, args.ranks,
                                        args.device)
        os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    else:             # every rank on the CPU (nccl refuses it: run's check)
        devices = [torch.device(args.device)] * args.ranks
    with tempfile.TemporaryDirectory(prefix="train_ranks_") as workdir:
        res = ranks.run(RANK_TARGET, {"argv": list(argv), "measure": measure,
                                      "cfg": cfg, "params_out": params_out},
                        world=args.ranks, backend=args.dist_backend,
                        devices=devices, workdir=workdir,
                        timeout=RANKS_TIMEOUT_S)
        with open(os.path.join(workdir, "rank_0.out")) as f:
            return res, f.read()


def _main_over_ranks(args, argv) -> int:
    """``main`` with ``--ranks``: the run over the ranks, rank 0's lines
    printed; exit 0, 42 where a rank crashed as asked, else 1."""
    res, lead_output = over_ranks(argv)
    sys.stdout.write(lead_output)
    sys.stdout.flush()
    if res.returncode == 0:
        return 0
    if args.crash_at and 42 in res.exitcodes:
        return 42
    print(f"[train] the run over {args.ranks} ranks failed: {res.failed}",
          file=sys.stderr)
    return 1


def _run(args, device: torch.device, *, group=None, hosts: int = 1,
         measure: bool = False, cfg: Optional[dict] = None,
         params_out: Optional[str] = None) -> dict:
    """Train as ``args`` say (or on the configuration ``cfg``) on
    ``device``: in one process (``group`` None; the batch the
    concatenation of ``hosts`` hosts' slices) or as one rank of ``group``
    over the (W, 1) mesh (its own host's slice; under ``--fsdp`` its
    blocks of the cut leaves).  Returns the doc: the device and rank,
    each step's loss, the all-reduces' bytes and calls (over ranks), under
    ``--fsdp`` the gathers' and reduce-scatters' bytes and calls and each
    step's clip norm, the device's peak memory (CUDA), the walls of the
    set-up before the first step and of the whole run; with ``measure``
    also the wall clock at the run's start and end (``clock``, to hold
    against a caller's own) and, step by step, the wall with the device
    synchronized at the step's end, the seconds of its gradient
    all-reduce (and of its gathers and reduce-scatters), and the digest
    of the parameters and error state (``state_digest``; under
    ``--fsdp`` of the leaves held whole).  With ``params_out`` the final parameters this process holds
    are saved there (``torch.save``, ``{rank}`` replaced by the rank)."""
    t_run, clock = time.perf_counter(), time.time()
    if not args.preset and not args.arch:
        args.preset = "tiny"
    cfg = build_config(args) if cfg is None else config_from_dict(cfg)
    lead = group is None or group.rank == 0
    say = print if lead else (lambda *_, **__: None)
    params = init_params(cfg, torch.Generator(device=device).manual_seed(
        args.seed), device)
    say(f"[train] config={cfg.name} params={count_params(params):,}")

    if group is None:
        mesh, ctx = None, NULL_CTX
        sources = [host_data(cfg, args.seq, args.batch, args.seed, hosts, h)
                   for h in range(hosts)]
    else:
        mesh = group.mesh((group.world, 1))
        ctx = fsdp_ctx(mesh, cfg) if args.fsdp else data_parallel_ctx(mesh)
        sources = [host_data(cfg, args.seq, args.batch, args.seed,
                             group.world, group.rank)]
    shards = ctx.ranks if args.fsdp else None
    specs = None
    if shards is not None:        # the rank's blocks; the wholes freed
        params = shards.shard(params)
        specs = {"params": shards.specs, "opt": opt_state_specs(shards.specs)}

    opt = AdamW(lr=args.lr, weight_decay=0.01)
    opt_state = opt.init(params)
    err_state = init_error_state(params) if args.compress_grads else None
    loss_fn = make_loss_fn(cfg, ctx)
    start_step = 0

    if args.resume and args.ckpt_dir:
        tree, start_step, _ = ckpt.restore(
            args.ckpt_dir, _state_tree(params, opt_state, err_state),
            shardings=specs, mesh=mesh)
        params, opt_state = tree["params"], tree["opt"]
        err_state = tree.get("err", err_state)
        say(f"[train] resumed from step {start_step}")

    if args.optimizer == "subspace-newton":
        sn_cfg = subn.SubspaceNewtonConfig(k=6, sample_scale=0.02)
        sn_state = subn.init_state(params)
    full_step = make_full_step(cfg, opt, compress=args.compress_grads,
                               line_search=args.line_search, device=device,
                               ctx=ctx)

    doc = {"device": str(device),
           "rank": 0 if group is None else group.rank}
    if measure:
        doc.update(step_s=[], all_reduce_s=[], digests=[])
        if shards is not None:
            doc.update(gather_s=[], scatter_s=[])
    losses = []
    doc["setup_s"] = time.perf_counter() - t_run
    logf = open(args.log_file, "a") if args.log_file and lead else None
    t0 = last_t = time.time()
    last_step = start_step
    for step in range(start_step, args.steps):
        t_step = time.perf_counter()
        ar0 = ctx.ranks.gradient_seconds if ctx.ranks is not None else 0.0
        if shards is not None:
            ga0, sc0 = shards.gather_seconds, shards.scatter_seconds
        batch = batch_to(hosts_batch(sources, step), cfg, device)
        gen = step_generator(args.seed, step, device)
        if args.optimizer == "subspace-newton":
            params, sn_state, info = subn.subspace_newton_step(
                lambda p, batch=batch: loss_fn(p, batch)[0], params,
                sn_state, sn_cfg, gen, device=device)
            metrics = {"loss": info["loss_after"], "alpha": info["alpha"]}
        else:
            params, opt_state, err_state, metrics = full_step(
                params, opt_state, err_state, batch, gen)
        losses.append(metrics["loss"])
        if measure:
            if device.type == "cuda":
                torch.cuda.synchronize(device)
            doc["step_s"].append(time.perf_counter() - t_step)
            doc["all_reduce_s"].append(
                ctx.ranks.gradient_seconds - ar0 if ctx.ranks is not None
                else 0.0)
            if shards is not None:
                doc["gather_s"].append(shards.gather_seconds - ga0)
                doc["scatter_s"].append(shards.scatter_seconds - sc0)
                doc["digests"].append(state_digest(
                    shards.whole_leaves(params)))
            else:
                doc["digests"].append(state_digest(params, err_state))
        if args.crash_at and step + 1 == args.crash_at:
            # checkpoint written for every completed multiple of ckpt_every
            say(f"[train] simulated crash at step {step + 1}", flush=True)
            if group is not None:
                dist.barrier()        # rank 0's line is out first
            sys.exit(42)
        if (step + 1) % args.ckpt_every == 0 and args.ckpt_dir:
            ckpt.save(args.ckpt_dir, step + 1,
                      _state_tree(params, opt_state, err_state),
                      extras={"config": cfg.name}, mesh=mesh,
                      shardings=specs)
        if lead and ((step + 1) % args.log_every == 0
                     or step == args.steps - 1):
            loss = float(metrics["loss"])
            now = time.time()
            line = {"step": step + 1, "loss": round(loss, 5),
                    "elapsed_s": round(now - t0, 1),
                    "ms_per_step": round(1e3 * (now - last_t)
                                         / (step + 1 - last_step), 3)}
            last_t, last_step = now, step + 1
            if "ls_alpha" in metrics:
                line["ls_alpha"] = round(float(metrics["ls_alpha"]), 3)
            print(f"[train] {json.dumps(line)}", flush=True)
            if logf:
                logf.write(json.dumps(line) + "\n")
                logf.flush()
    if logf:
        logf.close()
    if args.ckpt_dir:
        ckpt.save(args.ckpt_dir, args.steps,
                  _state_tree(params, opt_state, err_state),
                  extras={"config": cfg.name}, mesh=mesh, shardings=specs)
    say(f"[train] done in {time.time() - t0:.1f}s")
    doc["losses"] = [float(x) for x in losses]
    if ctx.ranks is not None:
        r = ctx.ranks
        doc.update(gradient_bytes=r.gradient_bytes,
                   gradient_all_reduces=r.gradient_all_reduces,
                   loss_bytes=r.loss_bytes,
                   loss_all_reduces=r.loss_all_reduces)
    if shards is not None:
        doc.update(gather_bytes=shards.gather_bytes, gathers=shards.gathers,
                   scatter_bytes=shards.scatter_bytes,
                   scatters=shards.scatters,
                   gnorms=[float(g) for g in shards.gnorms])
    if params_out:
        torch.save({path: x.detach().cpu()
                    for path, x in leaves_with_paths(params)},
                   params_out.format(rank=doc["rank"]))
    doc["peak_bytes"] = (torch.cuda.max_memory_allocated(device)
                         if device.type == "cuda" else None)
    doc["run_s"] = time.perf_counter() - t_run
    if measure:
        doc["clock"] = [clock, time.time()]
    return doc


if __name__ == "__main__":
    sys.exit(main())
