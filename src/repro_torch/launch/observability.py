"""The live observability plane end to end, on the port.

Port of ``examples/observability.py``: three acts over one seeded
SDSS-stream search served to a simulated volunteer fleet
(``server/sim.py::smoke_problem`` at 200 stars, 96 hosts, m = 16, 3
iterations), the fitness and the engine on ``--device``:

  1. watch without touching: the search run unobserved and then with the
     metrics hub and a live ``subscribe_stats`` subscriber; the committed
     iterates and engine stats must be equal, and the subscriber must
     receive at least 2 stamped snapshots;
  2. break the fleet: a quarter of the hosts go silent at t = 150; the
     anomaly detector sees the cohort flip from alive to suspect and
     quarantines it out of the registry's reliable set, recording its
     verdict schedule;
  3. replay the defense: a fresh run applies the recorded schedule with
     the detectors off and must commit act 2's trajectory bit for bit.

``--out`` writes each act's gates, iterations, best fitness, wall and
kernel launches.

    PYTHONPATH=src python -m repro_torch.launch.observability --device cpu
"""
from __future__ import annotations

import argparse

from repro_torch.core.substrates.eval_backend import InProcessEvalBackend
from repro_torch.data import sdss
from repro_torch.launch.acts import ActLog, fit_elements, record_search
from repro_torch.launch.fgdo_service import same_run
from repro_torch.server.sim import ServerSubstrate, smoke_problem

#: the example's problem
PROBLEM = dict(n_stars=200, n_hosts=96, m=16, iterations=3)
#: act 2's churn: the lowest quarter of host ids go silent at t = 150
SILENCE = dict(silence_at=150.0, silence_frac=0.25)


def _record(rec: dict, *runs) -> None:
    record_search(rec, runs[-1].engines[0])
    rec["evaluations"] = sum(r.pool.evals for r in runs)
    rec["fit_elements"] = fit_elements(PROBLEM["m"], sdss.N_PARAMS)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out", default=None, help="result JSON path")
    args = ap.parse_args(argv)
    log = ActLog("observability", args.device)
    spec, fleet, f_batch = smoke_problem(**PROBLEM, device=args.device)
    backend = InProcessEvalBackend(f_batch, device=args.device)

    print("== act 1: observe without perturbing ==")
    with log.act("observe") as rec:
        base = ServerSubstrate(spec, fleet, backend).run()
        observed = ServerSubstrate(spec, fleet, backend, obs=True,
                                   subscribe=True, stats_interval=10.0).run()
        sub = observed.subscriber
        ok = same_run(base, observed)
        _record(rec, base, observed)
        rec.update(snapshots=observed.obs["snapshots"], subscriber=sub)
        rec["gates"].update(
            observed_bit_identical=ok,
            subscriber_stamped=sub["snapshots"] >= 2 and sub["stamped_ok"])
    print(f"  unobserved + observed runs in {rec['wall_s']:.1f}s wall "
          f"({args.device})")
    print(f"  {observed.obs['snapshots']} snapshots sampled at virtual-"
          f"time boundaries; live subscriber received {sub['snapshots']} "
          f"(seqs {sub['first_seq']}..{sub['last_seq']}, "
          f"stamped_ok={sub['stamped_ok']})")
    print(f"  bit-identical to the unobserved run: {ok}")

    print("== act 2: a quarter of the fleet goes dark; the defense "
          "pages it out ==")
    with log.act("defense") as rec:
        dark = ServerSubstrate(spec, fleet, backend, **SILENCE).run()
        defended = ServerSubstrate(spec, fleet, backend, defense=True,
                                   stats_interval=10.0, **SILENCE).run()
        d = defended.defense
        undefended = dark.server.registry.summary()["reliable_set"]
        kept = defended.server.registry.summary()["reliable_set"]
        _record(rec, dark, defended)
        rec.update(events=d["events"], by_action=d["by_action"],
                   quarantined_now=d["quarantined_now"],
                   reliable_set_undefended=undefended,
                   reliable_set_defended=kept)
        rec["gates"]["silenced_cohort_paged"] = d["quarantined_now"] > 0
    print(f"  anomalies: {d['events']} events {d['by_action']}, "
          f"{d['quarantined_now']} hosts quarantined now")
    print(f"  reliable set: {undefended} undefended -> {kept} defended")

    print("== act 3: replay the recorded verdict schedule ==")
    with log.act("replay") as rec:
        replayed = ServerSubstrate(spec, fleet, backend,
                                   defense_schedule=d["schedule"],
                                   stats_interval=10.0, **SILENCE).run()
        ok = same_run(defended, replayed)
        _record(rec, replayed)
        rec["events"] = replayed.defense["events"]
        rec["gates"]["replay_bit_identical"] = ok
    print(f"  replay applied {replayed.defense['events']} recorded events "
          f"with detectors off")
    print(f"  replayed trajectory bit-identical to the live defense: {ok}")
    return log.finish(args.out)


if __name__ == "__main__":
    raise SystemExit(main())
