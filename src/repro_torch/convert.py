"""Carries data and state from the reference package into the port.

Both conversions take plain numpy and python values, never a reference
object's code, so the port imports nothing of the reference:

* ``stripe_tensors`` — a stripe's star and quadrature arrays (a reference
  ``Stripe`` or the port's; ``make_stripe`` is byte-identical in both) as
  f32 tensors on a device;
* ``engine_from_state`` — a port ``AnmEngine`` that continues a search
  from an ``AnmEngine.state_dict()`` of either package (same keys, same
  numpy rng state), so a reference search can be resumed in the port;
* ``lm_workload_from_reference`` — the port's ``LmWorkload`` from a
  reference workload's arrays (θ0 leaves by path, the flat basis, the
  batch) and fields: the function that carries weights across;
* ``search_spec_from_reference`` — the port's ``SearchSpec`` from a
  reference one's fields, so both packages run the same search;
* ``cache_from_reference`` — the port's decode cache (KV, MLA latent or
  RWKV6 states) from a reference cache's arrays, int8 kept as int8 with
  its f32 scales, so a decode continues from the reference's state;
* ``subspace_state_from_reference`` — the port's subspace-Newton state
  from a reference state's (P,) f32 momentum (JAX's leaf order, which is
  the port's) and step, so a reference run continues in the port;
* ``opt_state_from_reference`` / ``error_state_from_reference`` — the
  port's AdamW state (f32 moments, int32 step) and int8-compression
  residuals from a reference state's arrays, leaf by leaf onto the
  parameters' devices, so a reference training run continues in the
  port.

A reference parameter tree carries across through
``transformer.params_from_leaves`` (leaf path -> array), for every
configuration the port's models run, each leaf in its own type (a MoE
router stays f32 in a bf16 model).

A reference work server's checkpoint directory (snapshot and
``replay.jsonl``) needs no conversion: the port's ``server/checkpoint.py``
reads the same files, and the engine state inside is the reference's,
key for key.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Tuple

import numpy as np
import torch

from repro_torch.configs import config_from_dict
from repro_torch.core.engine import AnmConfig, AnmEngine
from repro_torch.core.grid import GridConfig
from repro_torch.core.orchestrator.director import SearchSpec
from repro_torch.core.subspace import SubspaceProjection
from repro_torch.core.substrates.lm_loss import LmWorkload, batch_tensors
from repro_torch.core.tree import leaves_with_paths, map_with_paths
from repro_torch.models import transformer as T


def stripe_tensors(stripe, device="cuda") -> Tuple[torch.Tensor, torch.Tensor]:
    """(stars (N, 3), quad (Q, 3)) f32 tensors on ``device``."""
    stars = torch.as_tensor(np.asarray(stripe.stars, np.float32),
                            device=device)
    quad = torch.as_tensor(np.asarray(stripe.quad, np.float32), device=device)
    return stars, quad


def engine_from_state(state: dict, device="cuda") -> AnmEngine:
    """A port engine built from the constructor arguments a state records
    and loaded with it: its next ``generate``/``generate_block`` is the one
    the engine that produced ``state`` would have made."""
    engine = AnmEngine(state["center"], state["lo"], state["hi"],
                       state["step"], AnmConfig(**state["cfg"]),
                       validation_quorum=int(state["quorum"]),
                       validation_rtol=float(state["vrtol"]), device=device)
    engine.load_state(state)
    return engine


def lm_workload_from_reference(*, arch: str, cfg: dict,
                               theta0: Dict[str, np.ndarray],
                               basis: np.ndarray,
                               batch: Dict[str, np.ndarray], k: int,
                               coeff_bound: float, seed: int,
                               device="cuda") -> LmWorkload:
    """The port's workload holding the reference's values.

    ``cfg``: the reference's ``dataclasses.asdict(workload.cfg)``;
    ``theta0``: leaf path ("segments/0/0/attn/wq", JAX's key path joined
    with "/") -> array, in f32 (which holds bf16 values exactly: numpy has
    no bf16 that torch takes) and cast here to the configuration's type;
    ``basis``: the flat (k, P) f32 basis in JAX's leaf order; ``batch``:
    ``tokens`` and ``labels`` (B, S).
    """
    config = config_from_dict(cfg)
    params = T.params_from_leaves(config, theta0, device)
    basis = np.asarray(basis, np.float32)
    if not basis.flags.writeable:       # a view of a JAX array: copy it
        basis = basis.copy()
    basis_t = torch.as_tensor(basis, device=device)
    if tuple(basis_t.shape) != (k, T.count_params(params)):
        raise ValueError(f"basis {tuple(basis_t.shape)}, want (k={k}, "
                         f"P={T.count_params(params)})")
    return LmWorkload(arch=arch, cfg=config,
                      batch=batch_tensors(batch, device),
                      proj=SubspaceProjection.from_basis(params, basis_t),
                      k=k, coeff_bound=coeff_bound, seed=seed)


def search_spec_from_reference(spec, device="cuda") -> SearchSpec:
    """The port's ``SearchSpec`` with a reference spec's fields: its
    arrays, seeds and quorum, its ``AnmConfig`` and ``GridConfig`` field
    by field, the engine on ``device``."""
    return SearchSpec(
        name=spec.name, x0=np.asarray(spec.x0, np.float64),
        lo=np.asarray(spec.lo, np.float64),
        hi=np.asarray(spec.hi, np.float64),
        step=np.asarray(spec.step, np.float64),
        anm=AnmConfig(**dataclasses.asdict(spec.anm)),
        grid=GridConfig(**dataclasses.asdict(spec.grid)),
        engine_seed=int(spec.engine_seed),
        validation_quorum=int(spec.validation_quorum), device=str(device))


def cache_from_reference(cfg, cache: Any, batch: int, max_seq: int,
                         device="cuda"):
    """The port's ``init_cache(cfg, batch, max_seq)`` tree holding a
    reference cache's values.

    ``cache``: the reference's nested list (per segment, per unit block)
    of dicts of numpy arrays (``jax.tree.map(np.asarray, cache)``).  Each
    leaf takes the type the port's ``init_cache`` gives it: int8 stores
    and f32 scales and states as they are, bf16 leaves from f32 arrays
    (numpy has no bf16 that torch takes; f32 holds bf16 values exactly).
    The tree's structure and every shape must be exactly the port's."""
    want = T.init_cache(cfg, batch, max_seq, as_shape=True)

    def leaf(x, path: str, spec) -> torch.Tensor:
        x = np.asarray(x)
        if (tuple(x.shape) != spec.shape
                or (spec.dtype == torch.int8) != (x.dtype == np.int8)):
            raise ValueError(f"cache leaf {path}: {x.dtype} {x.shape}, want "
                             f"{spec.dtype} {spec.shape}")
        x = np.array(x, np.int8 if x.dtype == np.int8 else np.float32)
        return torch.from_numpy(x).to(device=device, dtype=spec.dtype)

    if [len(seg) for seg in cache] != [len(seg) for seg in want]:
        raise ValueError("the cache's segments or blocks differ from "
                         "init_cache's")
    out = []
    for si, (seg, want_seg) in enumerate(zip(cache, want)):
        blocks = []
        for ui, (block, want_block) in enumerate(zip(seg, want_seg)):
            if set(block) != set(want_block):
                raise ValueError(f"cache block {si}/{ui}: leaves "
                                 f"{sorted(block)}, want {sorted(want_block)}")
            blocks.append({name: leaf(block[name], f"{si}/{ui}/{name}", spec)
                           for name, spec in want_block.items()})
        out.append(blocks)
    return out


def subspace_state_from_reference(state: Dict[str, Any],
                                  device="cuda") -> Dict[str, torch.Tensor]:
    """The port's ``subspace_newton.init_state``-shaped state holding a
    reference state's values: ``momentum`` (P,) f32 and ``step`` int32.
    ``state``: the reference's dict, as arrays (``jax.tree.map(np.asarray,
    state)``) or as they are."""
    momentum = np.array(state["momentum"], np.float32)
    if momentum.ndim != 1:
        raise ValueError(f"momentum of shape {momentum.shape}, want (P,)")
    return {"momentum": torch.from_numpy(momentum).to(device),
            "step": torch.tensor(int(np.asarray(state["step"])),
                                 dtype=torch.int32, device=device)}


def _f32_like(params: Any, tree: Any, what: str) -> Any:
    """``tree`` (a reference tree of arrays shaped like the parameters) as
    f32 tensors in the port's parameter structure, each on its parameter's
    device.  Paths and shapes must be exactly the parameters'."""
    src = dict(leaves_with_paths(tree))
    want = dict(leaves_with_paths(params))
    if set(src) != set(want):
        raise ValueError(f"{what}: leaf paths differ: missing "
                         f"{sorted(set(want) - set(src))[:5]}, unexpected "
                         f"{sorted(set(src) - set(want))[:5]}")

    def leaf(path: str, p: torch.Tensor) -> torch.Tensor:
        x = np.array(src[path], np.float32)
        if tuple(x.shape) != tuple(p.shape):
            raise ValueError(f"{what} leaf {path}: shape {x.shape}, want "
                             f"{tuple(p.shape)}")
        return torch.from_numpy(x).to(p.device)

    return map_with_paths(leaf, params)


def opt_state_from_reference(state: Dict[str, Any],
                             params: Any) -> Dict[str, Any]:
    """The port's ``AdamW.init(params)``-shaped state holding a reference
    AdamW state's values: ``mu`` and ``nu`` in f32 and ``step`` a 0-d
    int32 tensor, on the parameters' devices.  ``state``: the reference's
    dict as arrays (``jax.tree.map(np.asarray, state)``)."""
    device = leaves_with_paths(params)[0][1].device
    return {"mu": _f32_like(params, state["mu"], "mu"),
            "nu": _f32_like(params, state["nu"], "nu"),
            "step": torch.tensor(int(np.asarray(state["step"])),
                                 dtype=torch.int32, device=device)}


def error_state_from_reference(error_state: Any, params: Any) -> Any:
    """The port's ``init_error_state(params)``-shaped residuals holding a
    reference error state's f32 values (``jax.tree.map(np.asarray,
    error_state)``), on the parameters' devices."""
    return _f32_like(params, error_state, "error state")
