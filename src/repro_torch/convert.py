"""Carries data and state from the reference package into the port.

Both conversions take plain numpy and python values, never a reference
object's code, so the port imports nothing of the reference:

* ``stripe_tensors`` — a stripe's star and quadrature arrays (a reference
  ``Stripe`` or the port's; ``make_stripe`` is byte-identical in both) as
  f32 tensors on a device;
* ``engine_from_state`` — a port ``AnmEngine`` that continues a search
  from an ``AnmEngine.state_dict()`` of either package (same keys, same
  numpy rng state), so a reference search can be resumed in the port.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from repro_torch.core.engine import AnmConfig, AnmEngine


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
