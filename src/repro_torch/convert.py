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
  reference one's fields, so both packages run the same search.

A reference work server's checkpoint directory (snapshot and
``replay.jsonl``) needs no conversion: the port's ``server/checkpoint.py``
reads the same files, and the engine state inside is the reference's,
key for key.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Tuple

import numpy as np
import torch

from repro_torch.configs import config_from_dict
from repro_torch.core.engine import AnmConfig, AnmEngine
from repro_torch.core.grid import GridConfig
from repro_torch.core.orchestrator.director import SearchSpec
from repro_torch.core.subspace import SubspaceProjection
from repro_torch.core.substrates.lm_loss import LmWorkload, batch_tensors
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
