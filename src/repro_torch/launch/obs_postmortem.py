"""Post-mortem timeline reconstruction from the §14 retention store.

Port of ``repro/launch/obs_postmortem.py``, read-only on the store and the
replay log as the reference is.

A SIGKILLed observed run leaves behind its snapshot/trace store
(``obs_store.jsonl`` / ``.sqlite`` in the checkpoint dir) and the §9
replay log.  This CLI reopens both **read-only** — no epoch marker is
appended, nothing is mutated — and reconstructs the dead server's
timeline:

  * per-epoch extent (which run wrote what: the killed run's records are
    separable from any restored run's by the epoch markers);
  * per-search phase/status transitions with virtual-time stamps;
  * fleet cohort churn (alive/suspect/dead counts over time);
  * every anomaly verdict the defense recorded (quarantines, pages,
    stall kills) at its snapshot seq;
  * per-workunit critical paths: the slowest traced spans end-to-end
    (issued→[lapsed]→reported), with host/search/phase tags;
  * turnaround percentiles over all completed spans, split by outcome;
  * the replay log's extent (records, last applied message) — the §9
    ground truth of where the dead server actually stopped.

    PYTHONPATH=src python -m repro_torch.launch.obs_postmortem DIR
    PYTHONPATH=src python -m repro_torch.launch.obs_postmortem --ckpt-dir DIR
    PYTHONPATH=src python -m repro_torch.launch.obs_postmortem --store PATH \\
        --json --out report.json
"""
from __future__ import annotations

import argparse
import json
import os
import sys
from typing import List, Optional, Sequence

from repro_torch.obs.retention import (OBS_STORE_DB, OBS_STORE_NAME,
                                 open_snapshot_store)
from repro_torch.server.checkpoint import LOG_NAME


def find_store(ckpt_dir: str) -> str:
    """The §10 convention: JSONL preferred, sqlite fallback."""
    for name in (OBS_STORE_NAME, OBS_STORE_DB):
        p = os.path.join(ckpt_dir, name)
        if os.path.exists(p):
            return p
    raise FileNotFoundError(
        f"no retention store ({OBS_STORE_NAME} or {OBS_STORE_DB}) "
        f"in {ckpt_dir}")


def _percentile(sorted_vals: List[float], q: float) -> Optional[float]:
    if not sorted_vals:
        return None
    i = min(len(sorted_vals) - 1, max(0, round(q * (len(sorted_vals) - 1))))
    return float(sorted_vals[int(i)])


def _phase_timeline(snaps: List[dict]) -> List[dict]:
    """Per-search (phase, status) transitions across the snapshot run."""
    out: List[dict] = []
    last: dict = {}
    for s in snaps:
        for e in s.get("groups", {}).get("server", {}).get("searches", []):
            sid = int(e["search_id"])
            cur = (e.get("phase"), e.get("status"))
            if last.get(sid) != cur:
                last[sid] = cur
                out.append({"seq": int(s["seq"]), "now": float(s["now"]),
                            "search": sid, "phase": e.get("phase"),
                            "status": e.get("status"),
                            "iteration": e.get("iteration"),
                            "best": e.get("best")})
    return out


def _cohort_timeline(snaps: List[dict]) -> List[dict]:
    """Fleet state-count transitions (alive/suspect/dead/warming)."""
    out: List[dict] = []
    last = None
    for s in snaps:
        reg = s.get("groups", {}).get("registry")
        if reg is None:
            continue
        st = dict(reg.get("states", {}))
        cur = (tuple(sorted(st.items())), int(reg.get("quarantined", 0)))
        if cur != last:
            last = cur
            out.append({"seq": int(s["seq"]), "now": float(s["now"]),
                        "states": st,
                        "quarantined": reg.get("quarantined", 0),
                        "reliable_set": reg.get("reliable_set"),
                        "churn": reg.get("churn")})
    return out


def _span_report(spans: List[dict], top: int = 10) -> dict:
    done = [sp for sp in spans if sp.get("turnaround") is not None]
    ts = sorted(float(sp["turnaround"]) for sp in done)
    by_outcome: dict = {}
    for sp in done:
        by_outcome[sp.get("outcome", "?")] = \
            by_outcome.get(sp.get("outcome", "?"), 0) + 1
    crit = sorted(done, key=lambda sp: -float(sp["turnaround"]))[:top]
    return {
        "spans": len(done),
        "late": sum(1 for sp in done if sp.get("late")),
        "by_outcome": by_outcome,
        "turnaround": {
            "p50": _percentile(ts, 0.50), "p90": _percentile(ts, 0.90),
            "p99": _percentile(ts, 0.99),
            "max": ts[-1] if ts else None,
        },
        "critical_paths": [{
            "search": sp.get("search"), "wu": sp.get("wu"),
            "host": sp.get("host"), "phase": sp.get("phase"),
            "issued_at": sp.get("issued_at"),
            "lapsed_at": sp.get("lapsed_at"),
            "reported_at": sp.get("reported_at"),
            "turnaround": sp.get("turnaround"),
            "outcome": sp.get("outcome"), "late": sp.get("late"),
        } for sp in crit],
    }


def _replay_log_extent(path: str) -> Optional[dict]:
    if not os.path.exists(path):
        return None
    records = 0
    last = None
    with open(path) as f:
        for line in f:
            if not line.endswith("\n"):
                break                      # SIGKILL-torn tail
            try:
                last = json.loads(line)
            except ValueError:
                break
            records += 1
    if last is None:
        return {"records": 0}
    msg = last.get("msg", {})
    return {"records": records, "last_seq": last.get("seq"),
            "last_kind": msg.get("kind"), "last_now": msg.get("now"),
            "last_host": msg.get("host_id")}


def reconstruct(store_path: str, replay_log: Optional[str] = None,
                epoch: Optional[int] = None, top: int = 10) -> dict:
    """The timeline doc — pure data, shared by terminal and JSON modes."""
    store = open_snapshot_store(store_path, read_only=True)
    epochs_doc = []
    for ep in store.epochs():
        snaps = store.snapshots(epoch=ep)
        seqs = [int(s["seq"]) for s in snaps]
        nows = [float(s["now"]) for s in snaps]
        epochs_doc.append({
            "epoch": ep, "snapshots": len(snaps),
            "seq_range": [min(seqs), max(seqs)] if seqs else None,
            "now_range": [min(nows), max(nows)] if nows else None,
            "spans": len(store.records("span", epoch=ep)),
            "anomalies": len(store.records("anomaly", epoch=ep)),
        })
    snaps = store.snapshots(epoch=epoch)
    spans = [r["doc"] for r in store.records("span", epoch=epoch)]
    anomalies = [dict(r["doc"], epoch=r["epoch"])
                 for r in store.records("anomaly", epoch=epoch)]
    doc = {
        "store": store.summary(),
        "epoch_filter": epoch,
        "epochs": epochs_doc,
        "phases": _phase_timeline(snaps),
        "cohorts": _cohort_timeline(snaps),
        "anomalies": anomalies,
        **_span_report(spans, top=top),
    }
    if replay_log is not None:
        doc["replay_log"] = _replay_log_extent(replay_log)
    return doc


def render(doc: dict, out=sys.stdout) -> None:
    p = lambda s: print(s, file=out)   # noqa: E731
    st = doc["store"]
    p(f"== post-mortem: {st['path']}")
    p(f"   {st['records']} records, epochs {st['epochs']} "
      f"(by type: {st['by_type']})")
    for ep in doc["epochs"]:
        sr, nr = ep["seq_range"], ep["now_range"]
        p(f"   epoch {ep['epoch']}: {ep['snapshots']} snapshots"
          + (f" seq {sr[0]}..{sr[1]} t {nr[0]:.0f}..{nr[1]:.0f}"
             if sr else "")
          + f", {ep['spans']} spans, {ep['anomalies']} anomalies")
    rl = doc.get("replay_log")
    if rl is not None:
        p(f"-- replay log: {rl.get('records')} applied records"
          + ("" if rl.get("last_kind") is None else
             f", last {rl['last_kind']!r} at t={rl.get('last_now')}"))
    p(f"-- phase transitions ({len(doc['phases'])}):")
    for t in doc["phases"]:
        best = t.get("best")
        p(f"   seq {t['seq']:>4} t={t['now']:>8.1f} search {t['search']}: "
          f"phase={t['phase']} status={t['status']} "
          f"iter={t['iteration']} best="
          + ("?" if best is None else f"{best:.6f}"))
    p(f"-- cohort churn ({len(doc['cohorts'])} transitions):")
    for c in doc["cohorts"]:
        p(f"   seq {c['seq']:>4} t={c['now']:>8.1f} states={c['states']} "
          f"quarantined={c['quarantined']} reliable={c['reliable_set']}")
    p(f"-- anomaly verdicts ({len(doc['anomalies'])}):")
    for a in doc["anomalies"]:
        p(f"   seq {a['seq']:>4} t={a['now']:>8.1f} [{a['action']}] "
          f"{a['kind']} hosts={a['hosts']} detail={a.get('detail')}")
    tr = doc["turnaround"]
    p(f"-- workunit spans: {doc['spans']} completed "
      f"({doc['late']} late; by outcome {doc['by_outcome']})")
    if tr["p50"] is not None:
        p(f"   turnaround p50={tr['p50']:.1f} p90={tr['p90']:.1f} "
          f"p99={tr['p99']:.1f} max={tr['max']:.1f} (virtual s)")
    p("-- critical paths (slowest spans):")
    for sp in doc["critical_paths"]:
        lap = ("" if sp.get("lapsed_at") is None
               else f" lapsed@{sp['lapsed_at']:.0f}")
        p(f"   s{sp['search']}/wu{sp['wu']} host {sp['host']} "
          f"phase {sp['phase']}: {sp['turnaround']:.1f}s "
          f"[{sp['outcome']}{' late' if sp.get('late') else ''}]{lap}")


def main(argv: Optional[Sequence[str]] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("dir", nargs="?", default=None,
                    help="checkpoint dir (the same as --ckpt-dir)")
    ap.add_argument("--ckpt-dir", default=None,
                    help="checkpoint dir holding the retention store "
                         "(+ replay log, used when present)")
    ap.add_argument("--store", default=None,
                    help="explicit retention store path (overrides the "
                         "--ckpt-dir convention)")
    ap.add_argument("--replay-log", default=None,
                    help="explicit replay log path")
    ap.add_argument("--epoch", type=int, default=None,
                    help="restrict the timeline to one epoch "
                         "(default: all)")
    ap.add_argument("--top", type=int, default=10,
                    help="critical paths listed")
    ap.add_argument("--json", action="store_true",
                    help="emit the timeline doc as JSON")
    ap.add_argument("--out", default=None, help="write the report here")
    args = ap.parse_args(argv)
    if args.ckpt_dir is None:
        args.ckpt_dir = args.dir

    if args.store is None and args.ckpt_dir is None:
        ap.error("need --store or --ckpt-dir")
    store_path = args.store or find_store(args.ckpt_dir)
    replay_log = args.replay_log
    if replay_log is None and args.ckpt_dir is not None:
        replay_log = os.path.join(args.ckpt_dir, LOG_NAME)
    doc = reconstruct(store_path, replay_log=replay_log, epoch=args.epoch,
                      top=args.top)
    if args.out:
        with open(args.out, "w") as f:
            if args.json:
                json.dump(doc, f, indent=2)
            else:
                render(doc, out=f)
        print(f"[postmortem] wrote {args.out}")
    elif args.json:
        json.dump(doc, sys.stdout, indent=2)
        print()
    else:
        render(doc)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
