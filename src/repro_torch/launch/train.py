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
import json
import os
import sys
import time
from typing import Callable

import torch

from repro_torch.checkpoint import checkpoint as ckpt
from repro_torch.configs import ARCH_NAMES, get_smoke_config
from repro_torch.configs.base import ModelConfig
from repro_torch.core import subspace_newton as subn
from repro_torch.core.parallel_line_search import (LineSearchConfig,
                                                   randomized_line_search)
from repro_torch.core.tree import map_tree
from repro_torch.data.pipeline import DataConfig, SyntheticLM, SyntheticMasked
from repro_torch.models.transformer import (count_params, init_params,
                                            make_loss_fn, make_train_step,
                                            value_and_grad)
from repro_torch.optim.adamw import AdamW
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
                   line_search: int = 0, device="cuda") -> Callable:
    """The launcher's AdamW step: step(params, opt_state, err_state, batch,
    generator) -> (params, opt_state, err_state, metrics).  With
    ``compress`` the gradients go through ``compress_grads`` (``err_state``
    carries the residual); with ``line_search`` p > 0 the AdamW update is
    scaled by the randomized parallel line search over p candidates drawn
    from ``generator``."""
    loss_fn = make_loss_fn(cfg)
    base_step = make_train_step(cfg, opt)

    def full_step(params, opt_state, err_state, batch, generator):
        if compress:
            grads, loss, metrics = value_and_grad(loss_fn, params, batch)
            grads, err_state = compress_grads(grads, err_state)
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


def main(argv=None):
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
    args = ap.parse_args(argv)

    device = torch.device(args.device)
    if device.type == "cuda":
        os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
        if not torch.cuda.is_available():
            raise RuntimeError("--device cuda, and no CUDA device is present; "
                               "pass --device cpu to train on the CPU")
    was_deterministic = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True)
    try:
        return _run(args, device)
    finally:
        torch.use_deterministic_algorithms(was_deterministic)


def _run(args, device: torch.device) -> int:
    if not args.preset and not args.arch:
        args.preset = "tiny"
    cfg = build_config(args)
    params = init_params(cfg, torch.Generator(device=device).manual_seed(
        args.seed), device)
    print(f"[train] config={cfg.name} params={count_params(params):,}")

    dcfg = DataConfig(vocab_size=cfg.vocab_size, seq_len=args.seq,
                      global_batch=args.batch, seed=args.seed)
    if cfg.frontend == "audio_stub":
        data = SyntheticMasked(dcfg, cfg.d_model)
    else:
        data = SyntheticLM(dcfg)

    opt = AdamW(lr=args.lr, weight_decay=0.01)
    opt_state = opt.init(params)
    err_state = init_error_state(params) if args.compress_grads else None
    loss_fn = make_loss_fn(cfg)
    start_step = 0

    if args.resume and args.ckpt_dir:
        tree, start_step, _ = ckpt.restore(
            args.ckpt_dir, _state_tree(params, opt_state, err_state))
        params, opt_state = tree["params"], tree["opt"]
        err_state = tree.get("err", err_state)
        print(f"[train] resumed from step {start_step}")

    if args.optimizer == "subspace-newton":
        sn_cfg = subn.SubspaceNewtonConfig(k=6, sample_scale=0.02)
        sn_state = subn.init_state(params)
    full_step = make_full_step(cfg, opt, compress=args.compress_grads,
                               line_search=args.line_search, device=device)

    logf = open(args.log_file, "a") if args.log_file else None
    t0 = last_t = time.time()
    last_step = start_step
    for step in range(start_step, args.steps):
        batch = batch_to(data.batch(step), cfg, device)
        gen = step_generator(args.seed, step, device)
        if args.optimizer == "subspace-newton":
            params, sn_state, info = subn.subspace_newton_step(
                lambda p, batch=batch: loss_fn(p, batch)[0], params,
                sn_state, sn_cfg, gen, device=device)
            metrics = {"loss": info["loss_after"], "alpha": info["alpha"]}
        else:
            params, opt_state, err_state, metrics = full_step(
                params, opt_state, err_state, batch, gen)
        if args.crash_at and step + 1 == args.crash_at:
            # checkpoint written for every completed multiple of ckpt_every
            print(f"[train] simulated crash at step {step + 1}", flush=True)
            sys.exit(42)
        if (step + 1) % args.ckpt_every == 0 and args.ckpt_dir:
            ckpt.save(args.ckpt_dir, step + 1,
                      _state_tree(params, opt_state, err_state),
                      extras={"config": cfg.name})
        if (step + 1) % args.log_every == 0 or step == args.steps - 1:
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
                  extras={"config": cfg.name})
    print(f"[train] done in {time.time() - t0:.1f}s")
    return 0


if __name__ == "__main__":
    sys.exit(main())
