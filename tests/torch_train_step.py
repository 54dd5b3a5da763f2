"""One training step of an arch's smoke config, the port against the JAX
package: the check ``tests/test_torch_train_archs.py`` (f32) and
``tests/test_torch_train_archs_bf16.py`` (bf16) run, split in two files
so that the two dtypes run on two test workers.  The tolerances are
stated in ``test_torch_train_archs.py``."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.configs import ARCH_NAMES as J_ARCH_NAMES
from repro.configs import get_smoke_config as j_smoke
from repro.models import transformer as JT
from repro.optim.adamw import AdamW as JAdamW
from repro_torch.configs import ARCH_NAMES, config_from_dict
from repro_torch.core.tree import leaves_with_paths, map_tree
from repro_torch.models import layers as L
from repro_torch.models import transformer as T
from repro_torch.optim.adamw import AdamW

LR, WD, EPS = 1e-3, 0.01, 1e-8
LOSS_TOL = {"float32": 1e-5, "bfloat16": 2e-2}
GRAD_TOL = 1e-4
AS_ACCURATE = 1.25
ROUTE_MARGIN = 1e-3
MOE_TIE_GRAD_TOL = 0.15
B, S = 2, 32


def _path(kp) -> str:
    return "/".join(str(getattr(e, "key", getattr(e, "idx", e))) for e in kp)


def _flat(tree) -> dict:
    return {_path(kp): np.asarray(x, np.float32)
            for kp, x in jax.tree_util.tree_leaves_with_path(tree)}


def _batch(cfg, seed=5):
    rng = np.random.default_rng(seed)
    if cfg.frontend == "audio_stub":
        return {"embeds": rng.normal(size=(B, S, cfg.d_model)).astype(
                    np.float32),
                "labels": rng.integers(0, cfg.vocab_size, (B, S)).astype(
                    np.int32),
                "mask": rng.random((B, S)) < 0.3}
    toks = rng.integers(0, cfg.vocab_size, (B, S + 1)).astype(np.int32)
    return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}


def _jax_batch(batch, dtype):
    out = {k: jnp.asarray(v) for k, v in batch.items()}
    if "embeds" in out:
        out["embeds"] = out["embeds"].astype(dtype)
    return out


def _torch_batch(batch, dtype):
    out = {}
    for k, v in batch.items():
        t = torch.from_numpy(np.asarray(v))
        out[k] = (t.long() if k in ("tokens", "labels")
                  else t.to(dtype) if k == "embeds" else t)
    return out


def _ref_step(cfg, params, batch):
    """(loss, metrics, grads, new params) of one reference step."""
    opt = JAdamW(lr=LR, weight_decay=WD)

    def step(params, batch):
        (loss, metrics), grads = jax.value_and_grad(
            JT.make_loss_fn(cfg), has_aux=True)(params, batch)
        new, _ = opt.update(grads, opt.init(params), params)
        return loss, metrics, grads, new
    return jax.jit(step)(params, batch)


def _spy_ties():
    """Wrap the port's MoE routing; returns the list of each routing's
    smallest margin (k-th minus (k+1)-th probability)."""
    margins, route = [], L._route

    def spy(x, router, k):
        out = route(x, router, k)
        top = torch.topk(out[0], k + 1, dim=-1).values
        margins.append(float((top[..., k - 1] - top[..., k]).min().detach()))
        return out
    return margins, spy


class _Recording:
    """An optimizer that keeps a copy of the gradients the train step
    hands it (``update`` scales them for the clip in place)."""

    def __init__(self, opt):
        self.opt, self.grads = opt, None

    def init(self, params):
        return self.opt.init(params)

    def update(self, grads, state, params):
        self.grads = map_tree(torch.clone, grads)
        return self.opt.update(grads, state, params)


def check_train_step(arch: str, dtype: str, monkeypatch) -> None:
    """One step of ``arch``'s smoke config in ``dtype`` in both packages,
    held to the tolerances above."""
    assert list(ARCH_NAMES) == list(J_ARCH_NAMES)
    cfg = dataclasses.replace(j_smoke(arch), dtype=dtype)
    jdtype = jnp.dtype(dtype)
    params = jax.jit(JT.init_params, static_argnums=0)(cfg,
                                                       jax.random.key(0))
    batch = _batch(cfg)
    loss_ref, metrics_ref, grads_ref, new_ref = _ref_step(
        cfg, params, _jax_batch(batch, jdtype))

    pcfg = config_from_dict(dataclasses.asdict(cfg))
    pparams = T.params_from_leaves(pcfg, _flat(params), device="cpu")
    margins, spy = _spy_ties()
    monkeypatch.setattr(L, "_route", spy)
    opt = _Recording(AdamW(lr=LR, weight_decay=WD))
    new, state, metrics = T.make_train_step(pcfg, opt)(
        pparams, opt.init(pparams), _torch_batch(batch, T.param_dtype(pcfg)))
    grads = opt.grads
    assert int(state["step"]) == 1

    # the loss and its parts
    tol = LOSS_TOL[dtype]
    np.testing.assert_allclose(float(metrics["loss"]), float(loss_ref),
                               rtol=tol)
    np.testing.assert_allclose(float(metrics["ce"]), float(metrics_ref["ce"]),
                               rtol=tol)
    assert abs(float(metrics["aux"]) - float(metrics_ref["aux"])) <= tol * \
        float(metrics_ref["ce"])

    # the gradients
    g_ref = _flat(grads_ref)
    g = {path: x.float().numpy() for path, x in leaves_with_paths(grads)}
    assert list(g) == list(g_ref)
    if dtype == "float32":
        for path in g:
            assert np.linalg.norm(g[path] - g_ref[path]) <= GRAD_TOL * max(
                np.linalg.norm(g_ref[path]), 1e-30), path
    else:
        f32 = dataclasses.replace(cfg, dtype="float32")
        g32 = _flat(_ref_step(f32, jax.tree.map(
            lambda x: x.astype(jnp.float32), params),
            _jax_batch(batch, jnp.float32))[2])

        def dist(a):
            return np.sqrt(sum(np.sum((a[p] - g32[p]) ** 2) for p in g32)
                           / sum(np.sum(g32[p] ** 2) for p in g32))
        if margins and min(margins) < ROUTE_MARGIN:
            assert dist(g) <= MOE_TIE_GRAD_TOL, (min(margins), dist(g))
        else:
            assert dist(g) <= AS_ACCURATE * dist(g_ref), (dist(g),
                                                          dist(g_ref))

    # the new parameters
    gnorm = np.sqrt(sum(np.sum(x ** 2) for x in g_ref.values()))
    scale = min(1.0, 1.0 / gnorm)
    p_ref = _flat(new_ref)
    kept = total = 0
    dtypes = {path: x.dtype for path, x in leaves_with_paths(pparams)}
    for path, x in leaves_with_paths(new):
        assert x.dtype == dtypes[path], path
        got, want = x.float().numpy(), p_ref[path]
        ulp = (np.abs(want) * 2.0 ** -7 if dtype == "bfloat16"
               else np.zeros_like(want))
        assert np.all(np.abs(got - want) <= 2.2 * LR + ulp + 1e-7), path
        keep = ((np.abs(g_ref[path]) > 10 * np.abs(g[path] - g_ref[path]))
                & (np.abs(g_ref[path]) * scale > 1e3 * EPS))
        bound = (1e-5 * np.max(np.abs(want)) if dtype == "float32"
                 else ulp[keep]) + 1e-4 * LR
        assert np.all(np.abs(got - want)[keep] <= bound), path
        kept += int(keep.sum())
        total += keep.size
    assert kept >= 0.5 * total, (kept, total)
