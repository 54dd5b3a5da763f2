# The paper's primary contribution, ported: the asynchronous Newton method
# (ANM) with regression-based gradient+Hessian estimation, the randomized
# line search and quorum validation.  Every substrate drives the one
# AnmEngine state machine in core/engine.py (DESIGN.md §1).
from repro_torch.core.anm import AnmConfig, AnmState, anm_minimize  # noqa: F401
from repro_torch.core.engine import (AnmEngine, EvalRequest,  # noqa: F401
                                     EvalResult)
from repro_torch.core.grid import GridConfig, VolunteerGrid  # noqa: F401
from repro_torch.core.substrates.batched_grid import BatchedVolunteerGrid  # noqa: F401
