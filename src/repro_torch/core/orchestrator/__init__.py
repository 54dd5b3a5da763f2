"""Multi-search orchestrator: N concurrent ANM engines, one shared fleet
(DESIGN.md §8).

Port of ``repro/core/orchestrator/__init__.py``.

Three layers, innermost first:

  * ``coalesce``  — ``CoalescingSubmitter`` folds tick blocks from every
                    live search into ONE shared, search-id-tagged backend
                    bucket per scheduling round (dispatch + padding
                    amortization — the speed story);
  * ``scheduler`` — ``FleetScheduler`` partitions the shared fleet's host
                    capacity into fixed per-search sub-fleets and steps
                    every live search one tick per round;
  * ``director``  — ``SearchDirector`` owns the portfolio: multi-start
                    specs, heterogeneous configs, and the fixed /
                    portfolio-kill / restart policies.

The hard contract: orchestration changes WHEN lanes are evaluated, never
what any engine sees — every orchestrated search commits bit-identical
iterates to the same spec run alone (tests/test_torch_orchestrator.py
and ``chip_smoke.py``'s portfolio phase).
"""
from repro_torch.core.orchestrator.coalesce import (  # noqa: F401
    CoalesceStats, CoalescingSubmitter, LaneSlice)
from repro_torch.core.orchestrator.director import (  # noqa: F401
    MultiSearchResult, SearchDirector, SearchSpec, multi_start_specs)
from repro_torch.core.orchestrator.scheduler import (  # noqa: F401
    DONE, KILLED, RUNNING, FleetScheduler, FleetSchedulerStats, LiveSearch)
