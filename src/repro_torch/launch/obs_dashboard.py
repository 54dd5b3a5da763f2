"""Terminal/JSON dashboard over the ``subscribe_stats`` stream (§13).

Port of ``repro/launch/obs_dashboard.py``; the demo serves the port's
smoke fleet on ``--device`` (the card unless ``cpu`` is asked for).

A read-only monitoring client: it connects to a running work server (TCP
host:port), long-polls the metrics ring with a cursor, and renders each
stamped snapshot — fleet states, reliable set, service pressure, per-
search phase/iteration/best, message rate with a sparkline.  Because the
stream is served by the same unstamped/unlogged path as ``status``,
watching a run CANNOT perturb it: the committed iterates are bit-identical
with or without a dashboard attached (the obs_server dryrun smoke gates
exactly this).

    # against a live server
    PYTHONPATH=src python -m repro_torch.launch.obs_dashboard --host H --port P

    # self-contained demo (the default without --port): serves a seeded
    # smoke fleet in-process and watches it live through a real framed
    # connection; its fitness and engine run on --device
    PYTHONPATH=src python -m repro_torch.launch.obs_dashboard --device cpu

``--json`` emits one JSON line per snapshot instead of the terminal view
(the machine-readable mode CI and scripts consume).
"""
from __future__ import annotations

import argparse
import collections
import json
import sys
import threading
import time
from typing import Optional, Sequence

_SPARK = "▁▂▃▄▅▆▇█"


def sparkline(values: Sequence[float], width: int = 24) -> str:
    """Unicode mini-chart of the last ``width`` values."""
    vs = [float(v) for v in values][-width:]
    if not vs:
        return ""
    lo, hi = min(vs), max(vs)
    span = (hi - lo) or 1.0
    return "".join(_SPARK[int((v - lo) / span * (len(_SPARK) - 1))]
                   for v in vs)


def render(snap: dict, rate_history: Sequence[float] = (),
           dropped: int = 0) -> str:
    """One snapshot as a compact terminal block (pure function: testable
    without a terminal or a server).  ``dropped`` is the ring-gap count
    the stats reply carried for this batch — rendered loudly rather than
    letting seqs silently skip (§14 satellite)."""
    g = snap.get("groups", {})
    srv = g.get("server", {})
    reg = g.get("registry", {})
    lines = [f"-- obs snapshot seq={snap['seq']} t={snap['now']:.1f} "
             f"(stream v{snap['stream_v']})"]
    if dropped:
        lines.append(f"   !! gap: {dropped} snapshots fell off the ring "
                     f"before this one")
    rate = srv.get("messages_per_s")
    rate_s = "" if rate is None else f" ({rate:.1f} msg/s)"
    lines.append(
        f"   server: {srv.get('messages', '?')} messages{rate_s} "
        f"{sparkline(rate_history)}")
    lines.append(
        f"   pressure: {srv.get('lease_depth', '?')} leases, "
        f"{srv.get('lapsed_depth', '?')} lapsed"
        + ("" if "intake" not in g else
           f", intake parked {g['intake'].get('parked')}"))
    if reg:
        st = reg.get("states", {})
        lines.append(
            f"   fleet: {reg.get('hosts', '?')} hosts "
            f"(alive {st.get('alive', 0)} / suspect {st.get('suspect', 0)} "
            f"/ dead {st.get('dead', 0)}), warming {reg.get('warming', 0)}, "
            f"reliable {reg.get('reliable_set', '?')}, "
            f"quarantined {reg.get('quarantined', 0)}")
        ch = reg.get("churn", {})
        lines.append(
            f"   churn: →suspect {ch.get('to_suspect', 0)}, "
            f"→dead {ch.get('to_dead', 0)}, revived {ch.get('revived', 0)}")
    if "cache" in g and g["cache"]:
        c = g["cache"]
        lines.append(f"   cache: {c.get('hits', 0)} hits / "
                     f"{c.get('misses', 0)} misses "
                     f"(rate {c.get('hit_rate', 0.0):.2f})")
    for s in srv.get("searches", []):
        best = s.get("best")
        best_s = "?" if best is None else f"{best:.6f}"
        lines.append(f"   search {s.get('search_id')}: {s.get('status')} "
                     f"phase={s.get('phase')} iter={s.get('iteration')} "
                     f"best={best_s}")
    return "\n".join(lines)


def watch(connect, *, as_json: bool = False, poll_s: float = 0.25,
          max_snapshots: Optional[int] = None,
          stop: Optional[threading.Event] = None,
          out=None) -> int:
    """Poll ``subscribe_stats`` on the connection ``connect()`` returns and
    render every snapshot until the stream goes quiet (server shut down),
    ``max_snapshots`` arrive, or ``stop`` is set.  Returns the number of
    snapshots rendered.  ``out`` defaults to the ``sys.stdout`` of the
    call, not of the import."""
    out = sys.stdout if out is None else out
    from repro_torch.obs import StatsSubscriber
    from repro_torch.server.protocol import ProtocolError

    conn = connect()
    sub = StatsSubscriber(conn)
    rates: collections.deque = collections.deque(maxlen=64)
    shown = 0
    try:
        while stop is None or not stop.is_set():
            try:
                snaps = sub.poll()
            except (ProtocolError, OSError) as e:
                print(f"[obs] stream ended: {e}", file=out)
                break
            gap = sub.last_dropped
            if gap and as_json:
                # a distinct record kind, so snapshot consumers that key
                # on ``seq`` can skip it while gap-aware ones alert
                print(json.dumps({"kind": "gap", "dropped": int(gap)}),
                      file=out, flush=True)
            for i, snap in enumerate(snaps):
                r = snap.get("groups", {}).get("server", {}) \
                    .get("messages_per_s")
                if isinstance(r, (int, float)):
                    rates.append(float(r))
                if as_json:
                    print(json.dumps(snap), file=out, flush=True)
                else:
                    print(render(snap, rates, dropped=gap if i == 0 else 0),
                          file=out, flush=True)
                shown += 1
                if max_snapshots is not None and shown >= max_snapshots:
                    return shown
            if not snaps:
                time.sleep(poll_s)
    finally:
        try:
            conn.close()
        except Exception:
            pass
    return shown


def _demo(args) -> int:
    """Serve a seeded smoke fleet in-process (loopback transport, metrics
    hub attached) and watch it live — the zero-setup way to see the
    stream."""
    from repro_torch.core.substrates.eval_backend import InProcessEvalBackend
    from repro_torch.obs import MetricsHub
    from repro_torch.server.server import WorkServer
    from repro_torch.server.sim import SimClientPool, smoke_problem
    from repro_torch.server.transport import LoopbackTransport

    spec, fleet, f_batch = smoke_problem(n_stars=120, n_hosts=64, m=12,
                                         iterations=3, device=args.device)
    server = WorkServer([spec], lease_timeout=8.0 * fleet.base_eval_time,
                        idle_retry=fleet.idle_retry)
    hub = MetricsHub(interval=args.interval)
    server.attach_hub(hub)
    lock = threading.Lock()          # dashboard polls race the fleet

    def handler(msg):
        with lock:
            return server.handle(msg)

    transport = LoopbackTransport().start(handler)
    pool = SimClientPool(fleet, InProcessEvalBackend(f_batch,
                                                     device=args.device))
    done = threading.Event()

    def drive():
        try:
            pool.run(transport.connect())
        finally:
            done.set()

    fleet_thread = threading.Thread(target=drive, daemon=True,
                                    name="obs-demo")
    fleet_thread.start()
    shown = watch(transport.connect, as_json=args.json, poll_s=0.05,
                  max_snapshots=args.max_snapshots, stop=done)
    # let the fleet finish before teardown — a device call interrupted
    # by interpreter exit aborts uncleanly
    fleet_thread.join(timeout=600.0)
    eng = server.engines[0]
    print(f"[obs] demo done: {shown} snapshots, {pool.stats.messages} "
          f"messages, best {eng.best_fitness:.6f}")
    return 0


def main(argv: Optional[Sequence[str]] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--port", type=int, default=None,
                    help="TCP port of a running work server")
    ap.add_argument("--demo", action="store_true",
                    help="serve + watch a seeded in-process smoke fleet "
                         "(what runs when no --port is given)")
    ap.add_argument("--device", default="cuda",
                    help="demo: where the fitness and the engine run (the "
                         "card unless 'cpu' is asked for)")
    ap.add_argument("--json", action="store_true",
                    help="one JSON line per snapshot (machine-readable)")
    ap.add_argument("--interval", type=float, default=10.0,
                    help="demo: virtual seconds between snapshots")
    ap.add_argument("--poll-s", type=float, default=0.25,
                    help="wall-clock long-poll spacing")
    ap.add_argument("--max-snapshots", type=int, default=None,
                    help="stop after this many snapshots")
    args = ap.parse_args(argv)

    if args.demo or args.port is None:
        return _demo(args)

    def connect():
        from repro_torch.server.transport import TcpConnection
        return TcpConnection(args.host, args.port)

    watch(connect, as_json=args.json, poll_s=args.poll_s,
          max_snapshots=args.max_snapshots)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
