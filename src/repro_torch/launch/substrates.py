"""THE substrate-smoke registry: one dict, every consumer derives from it.

Port of ``repro/launch/substrates.py``.  ``repro_torch.launch.dryrun
--substrate X`` takes its argparse ``choices`` from this dict (an unknown
name fails at parse time) and ``--list-substrates`` prints it, so adding
a substrate smoke is ONE entry here.  The eight names and descriptions
are the reference's; the runners are the port's, in
``repro_torch.launch.dryrun``.  The four server smokes (``server``,
``chaos_server``, ``obs_server``, ``postmortem``) are registered under
their names but not ported yet: the dry-run refuses them by name
(``NOT_PORTED``) before it resolves a runner.

Import-side-effect free on purpose: runners are referenced by dotted
path and resolved lazily, so a reader of the names imports neither the
dry-run nor the port's model stack.
"""
from __future__ import annotations

import dataclasses
import importlib
from typing import Callable, Dict


@dataclasses.dataclass(frozen=True)
class SubstrateSmoke:
    name: str
    description: str
    runner: str                       # "module:function", resolved lazily

    def resolve(self) -> Callable:
        mod, fn = self.runner.split(":")
        return getattr(importlib.import_module(mod), fn)


SUBSTRATES: Dict[str, SubstrateSmoke] = {
    "pod_mesh": SubstrateSmoke(
        "pod_mesh",
        "batched grid sync + pipelined + shard_map pod-mesh backend on the "
        "forced 512-device mesh; bit-identical iterates across all three",
        "repro_torch.launch.dryrun:run_substrate_smoke"),
    "multi_search": SubstrateSmoke(
        "multi_search",
        "coalesced multi-search portfolio over one shared backend, "
        "in-process AND pod mesh; every search bit-identical to its solo "
        "run",
        "repro_torch.launch.dryrun:run_multi_search_smoke"),
    "cached_portfolio": SubstrateSmoke(
        "cached_portfolio",
        "persistent eval cache under a coalesced portfolio, in-process "
        "AND pod mesh: cache-on cold and warm runs bit-identical to "
        "cache-off, warm rerun fully served (zero new misses)",
        "repro_torch.launch.dryrun:run_cached_portfolio_smoke"),
    "lm_subspace": SubstrateSmoke(
        "lm_subspace",
        "LM-loss workload: the models/ stack as the fitness function, "
        "parameters perturbed along a shared subspace basis; sync + "
        "pipelined + model/data-sharded pod backend bit-identical, same "
        "backend under the coalescing orchestrator and the work server",
        "repro_torch.launch.dryrun:run_lm_subspace_smoke"),
    "server": SubstrateSmoke(
        "server",
        "fault-tolerant work server: seeded search over loopback and TCP "
        "transports, SIGKILLed mid-search and restored from snapshot + "
        "replay log; restored run bit-identical to uninterrupted",
        "repro_torch.launch.dryrun:run_server_smoke"),
    "chaos_server": SubstrateSmoke(
        "chaos_server",
        "chaos-hardened work service: concurrent TCP clients behind the "
        "sequenced intake under seeded fault plans (drops, duplicates, "
        "delays, resets, torn writes) incl. SIGKILL mid-chaos restore "
        "and the production-mesh backend; every run bit-identical to the "
        "fault-free serial baseline",
        "repro_torch.launch.dryrun:run_chaos_server_smoke"),
    "obs_server": SubstrateSmoke(
        "obs_server",
        "live observability plane: metrics hub + subscribe_stats stream "
        "over concurrent TCP (live subscriber), under chaos, and through "
        "a SIGKILL restore — all bit-identical to the unobserved "
        "baseline; injected fleet silence paged out by the anomaly "
        "defense, replayed bit-identically from its recorded schedule",
        "repro_torch.launch.dryrun:run_obs_server_smoke"),
    "postmortem": SubstrateSmoke(
        "postmortem",
        "flight recorder: durable snapshot/trace retention under chaotic "
        "concurrent TCP, SIGKILLed mid-run; the post-mortem CLI "
        "reconstructs the dead server's timeline read-only, the restored "
        "run appends under a new epoch bit-identically, replay logs stay "
        "byte-compatible with retention on/off, and a recorded stall-kill "
        "schedule replays bit-identically through the director seam",
        "repro_torch.launch.dryrun:run_postmortem_smoke"),
}

#: the registered smokes whose runners are not ported yet, and the
#: roadmap item that ports them
NOT_PORTED = {name: "ROADMAP A.7 (ii)"
              for name in ("server", "chaos_server", "obs_server",
                           "postmortem")}


def list_substrates() -> str:
    width = max(len(n) for n in SUBSTRATES)
    return "\n".join(f"{s.name:<{width}}  {s.description}"
                     for s in SUBSTRATES.values())
