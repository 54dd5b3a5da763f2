"""The fault-tolerant FGDO service layer end to end, on the port.

Port of ``examples/fgdo_service.py``: four acts over one seeded
8-parameter SDSS-stream search (``server/sim.py::smoke_problem`` at 400
stars, 128 hosts, m = 24, 3 iterations, 10 % malicious hosts), the
fitness and the engine on ``--device``:

  1. serve it: a loopback work server (framed protocol messages, host
     registry, deadline leases) drives the simulated fleet to completion
     and reports the registry's view of the fleet;
  2. crash it: the same search with checkpoints and the persistent eval
     cache on, crashed in process after a third of act 1's messages,
     restored from snapshot + replay log + the surviving cache store and
     run to completion: its iterates and engine stats must equal act 1's,
     and it must come back warm (cache hits);
  3. go over TCP: the same search through sockets on 127.0.0.1, equal to
     act 1;
  4. break the network: 8 concurrent TCP client threads behind the
     sequenced intake under a composite seeded ``FaultPlan`` (drops,
     duplicates, delays, resets, torn writes), equal to act 1.

It ends with the status frame of act 1's server.  ``--act`` runs act 1
and one other (0: all); ``--out`` writes each act's gates, iterations,
best fitness, wall and kernel launches.

    PYTHONPATH=src python -m repro_torch.launch.fgdo_service --device cpu
    PYTHONPATH=src python -m repro_torch.launch.fgdo_service --act 4
"""
from __future__ import annotations

import argparse
import tempfile

from repro_torch.core.engine import identical_trajectories
from repro_torch.core.substrates.eval_backend import InProcessEvalBackend
from repro_torch.core.substrates.eval_cache import EvalCache, JsonlCacheStore
from repro_torch.data import sdss
from repro_torch.launch.acts import ActLog, fit_elements, record_search
from repro_torch.server import protocol
from repro_torch.server.chaos import FaultPlan
from repro_torch.server.checkpoint import eval_cache_path
from repro_torch.server.sim import ServerSubstrate, SimulatedCrash, smoke_problem
from repro_torch.server.transport import LoopbackTransport

#: the example's problem: 10 % malicious hosts, so that the quorum has
#: liars to reject (the smoke default of 2 % draws none at this fleet seed)
PROBLEM = dict(n_stars=400, n_hosts=128, m=24, iterations=3, malicious=0.1)
#: act 4's composite fault schedule: every category the transport injects
PLAN = FaultPlan(seed=4242, drop_request=0.06, drop_reply=0.04,
                 duplicate=0.08, delay=0.15, delay_ms=1.5, torn_write=0.03,
                 reset=0.03)
#: the eval cache's fingerprint in act 2
FINGERPRINT = "fgdo_service"


def same_run(a, b) -> bool:
    """Two runs' committed trajectories and engine stats are equal."""
    ea, eb = a.engines[0], b.engines[0]
    return identical_trajectories(ea, eb) and ea.stats == eb.stats


def _record(rec: dict, res) -> None:
    record_search(rec, res.engines[0])
    rec["evaluations"] = res.pool.evals
    rec["messages"] = res.pool.messages
    rec["fit_elements"] = fit_elements(PROBLEM["m"], sdss.N_PARAMS)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--act", type=int, default=0, choices=[0, 1, 2, 3, 4],
                    help="run one act (0 = all)")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out", default=None, help="result JSON path")
    args = ap.parse_args(argv)
    log = ActLog("fgdo_service", args.device)
    spec, fleet, f_batch = smoke_problem(**PROBLEM, device=args.device)
    backend = InProcessEvalBackend(f_batch, device=args.device)

    print("== act 1: a volunteer fleet served over the wire protocol ==")
    with log.act("loopback") as rec:
        base = ServerSubstrate(spec, fleet, backend).run()
        _record(rec, base)
        p = base.pool
        rec["pool"] = {"messages": p.messages, "leases": p.work_received,
                       "results": p.results_reported, "lost": p.failed,
                       "corrupted": p.corrupted, "no_work": p.no_work}
        rec["gates"]["committed_every_iteration"] = (
            base.engines[0].iteration == PROBLEM["iterations"])
    eng = base.engines[0]
    print(f"  {eng.iteration} iterations, best {eng.best_fitness:.6f} "
          f"in {rec['wall_s']:.1f}s wall ({args.device})")
    print(f"  {p.messages} messages: {p.work_received} leases, "
          f"{p.results_reported} results ({p.failed} lost to vanishing "
          f"hosts, {p.corrupted} corrupted), {p.no_work} no-work backoffs")
    print(f"  {p.evals} fitness evals in {p.eval_batches} lazy batches; "
          f"{eng.stats.candidates_rejected} lying candidates rejected by "
          f"quorum")
    reg = base.server.registry.summary()
    print(f"  registry: {reg['hosts']} hosts {reg['states']}, "
          f"{reg['returned']}/{reg['issued']} returned "
          f"({reg['stale_returns']} stale), "
          f"{reg['excluded_by_return_rate']} gated as black holes")
    c = base.server.counters
    print(f"  leases: {c.leases_issued} issued, {c.leases_lapsed} lapsed, "
          f"{c.leases_abandoned} abandoned, {c.late_returns} late returns")

    if args.act in (0, 2):
        print("== act 2: kill the server mid-search, restore WARM, "
              "compare ==")
        with log.act("crash_restore") as rec, \
                tempfile.TemporaryDirectory(prefix="fgdo_service_") as ckpt:
            crash_at = p.messages // 3
            try:
                ServerSubstrate(
                    spec, fleet, backend, ckpt_dir=ckpt, snapshot_every=200,
                    max_messages=crash_at,
                    cache=EvalCache(JsonlCacheStore(eval_cache_path(ckpt)),
                                    fingerprint=FINGERPRINT)).run()
                raise RuntimeError("expected the simulated crash")
            except SimulatedCrash:
                print(f"  server 'crashed' after {crash_at} messages "
                      f"(snapshot + replay log + cache store on disk)")
            # a fresh cache instance, warmed only from the surviving store
            cache = EvalCache(JsonlCacheStore(eval_cache_path(ckpt)),
                              fingerprint=FINGERPRINT)
            res = ServerSubstrate(spec, fleet, backend, ckpt_dir=ckpt,
                                  snapshot_every=200,
                                  cache=cache).run(resume=True)
            same = same_run(base, res)
            cc = res.cache
            _record(rec, res)
            rec.update(crash_at=crash_at, replayed=res.replayed,
                       resumed_leases=res.pool.resumed_leases, cache=cc)
            rec["gates"].update(restored_bit_identical=same,
                                warm_after_restore=cc["hits"] > 0)
        print(f"  restored: replayed {res.replayed} logged messages, "
              f"re-leased {res.pool.resumed_leases} in-flight workunits")
        print(f"  eval cache: {cc['hits']} hits / {cc['misses']} misses "
              f"(hit rate {cc['hit_rate']:.2f}), {cc['lanes_saved']} "
              f"evaluations never re-run, store {cc['store_size']} entries")
        print(f"  restored run bit-identical to uninterrupted: {same}")

    if args.act in (0, 3):
        print("== act 3: the same search over TCP sockets ==")
        with log.act("tcp") as rec:
            tcp = ServerSubstrate(spec, fleet, backend, transport="tcp").run()
            same = same_run(base, tcp)
            _record(rec, tcp)
            rec["gates"]["bit_identical_to_loopback"] = same
        print(f"  {tcp.pool.messages} frames over 127.0.0.1 in "
              f"{rec['wall_s']:.1f}s; bit-identical to loopback: {same}")

    if args.act in (0, 4):
        print("== act 4: 8 concurrent clients through a hostile network ==")
        with log.act("concurrent_chaos") as rec:
            res = ServerSubstrate(spec, fleet, backend, transport="tcp",
                                  concurrent=8, chaos=PLAN).run()
            same = same_run(base, res)
            _record(rec, res)
            rec.update(chaos=res.chaos, intake=res.intake)
            rec["gates"]["bit_identical_to_clean_serial"] = same
        ch, ik = res.chaos, res.intake
        print(f"  faults injected: {ch['drops_request']}+"
              f"{ch['drops_reply']} drops, {ch['duplicates']} dups, "
              f"{ch['delays']} delays, {ch['resets']} resets, "
              f"{ch['torn_writes']} torn writes -> {ch['retries']} "
              f"retries in {rec['wall_s']:.1f}s")
        print(f"  intake: {ik['next_seq']} stamps admitted in canonical "
              f"order, {ik['parked']} early arrivals parked, "
              f"{ik['out_of_band']} late duplicates absorbed")
        c = res.server.counters
        print(f"  idempotency: {c.duplicates_suppressed} replies served "
              f"from cache, {c.stale_duplicates} stale dups refused, "
              f"{c.duplicate_reports} lapsed-lease re-reports ignored")
        print(f"  trajectory bit-identical to the clean serial run: {same}")

    # a peek through the protocol's monitoring message
    status = LoopbackTransport().start(base.server.handle).connect().call(
        protocol.status())
    s = status["searches"][0]
    log.doc["status"] = s
    print(f"status frame: search {s['name']!r} {s['status']} at iteration "
          f"{s['iteration']}, best {s['best']:.6f}")
    return log.finish(args.out)


if __name__ == "__main__":
    raise SystemExit(main())
