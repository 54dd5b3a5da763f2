"""The port's flight recorder (DESIGN.md §14): durable retention, workunit
lifecycle tracing, and the windowed drift defense.

The reference's tests/test_obs_retention.py, port against port on the CPU,
every test of it (its JAX quadratic written as elementwise torch); then
the port against the reference: ``wu_sampled`` picks the same workunits,
a store written by either package (JSONL and sqlite) opens in the other
with equal records and epochs, the post-mortem ``reconstruct`` gives the
same timeline from either package on one store, and the CLIs read a store
and a replay log the other package's observed server wrote.

The §14 contract under test: the post-mortem plane writes everything it
sees into the §10 store family without ever entering the recovery
contract — snapshots/spans/anomalies are retained durably (epoch-marked
across restarts, torn-tail tolerant, size-bounded by compaction), trace
sampling is a pure function of (seed, search, wu) so observed runs stay
bit-identical, the stall detector's kills flow through the director seam
into the recorded anomaly schedule and replay bit-identically, and the
``subscribe_stats`` reply reports ring gaps explicitly (optionally
backfilled from the store) instead of silently skipping seqs.
"""
import functools
import hashlib
import io
import json
import os
import threading

import numpy as np
import pytest
import torch

from repro_torch.core.anm import AnmConfig
from repro_torch.core.engine import identical_trajectories
from repro_torch.core.grid import GridConfig
from repro_torch.core.orchestrator import (FleetScheduler, SearchDirector,
                                           multi_start_specs)
from repro_torch.core.substrates.eval_backend import InProcessEvalBackend
from repro_torch.launch.obs_dashboard import watch
from repro_torch.launch.obs_postmortem import reconstruct
from repro_torch.obs import (OBS_STORE_DB, OBS_STORE_NAME, STREAM_VERSION,
                             BackgroundSubscriber, MetricsHub, RetentionSink,
                             SnapshotStore, SqliteSnapshotStore,
                             WorkUnitTracer, obs_store_path,
                             open_snapshot_store, wu_sampled)
from repro_torch.server import protocol
from repro_torch.server.sim import (ServerSubstrate, SimulatedCrash,
                                    smoke_problem)

pytestmark = pytest.mark.obs

#: the port's constructors with the fitness and the engines on the CPU
InProcessEvalBackend = functools.partial(InProcessEvalBackend, device="cpu")
smoke_problem = functools.partial(smoke_problem, device="cpu")


# -- shared small workload -----------------------------------------------------

@pytest.fixture(scope="module")
def problem():
    return smoke_problem(n_stars=120, n_hosts=40, m=10, iterations=2)


@pytest.fixture(scope="module")
def backend(problem):
    _, _, f_batch = problem
    return InProcessEvalBackend(f_batch)


@pytest.fixture(scope="module")
def baseline(problem, backend):
    spec, fleet, _ = problem
    return ServerSubstrate(spec, fleet, backend).run()


def _same(a, b):
    ea, eb = a.engines[0], b.engines[0]
    return identical_trajectories(ea, eb) and ea.stats == eb.stats


# -- the snapshot store family -------------------------------------------------

class TestSnapshotStore:
    def test_roundtrip_epochs_and_read_only(self, tmp_path):
        p = str(tmp_path / "obs.jsonl")
        s1 = SnapshotStore(p)
        assert s1.epoch == 1
        s1.append("snap", {"seq": 0, "x": 1}, seq=0, now=10.0)
        s1.append("span", {"wu": 7}, now=11.0)
        s1.close()
        # a restored server reopens the SAME file under a fresh epoch
        s2 = SnapshotStore(p)
        assert s2.epoch == 2
        s2.append("snap", {"seq": 5}, seq=5, now=20.0)
        s2.close()
        # the post-mortem CLI opens read-only: NO new epoch marker
        ro = open_snapshot_store(p, read_only=True)
        assert ro.epoch == 2
        assert ro.epochs() == [1, 2]
        assert len(ro.records("snap", epoch=1)) == 1
        assert len(ro.records("span", epoch=1)) == 1
        assert [r["doc"]["seq"] for r in ro.records("snap", epoch=2)] == [5]
        assert ro.snapshots() == [{"seq": 0, "x": 1}, {"seq": 5}]
        with pytest.raises(RuntimeError, match="read-only"):
            ro.append("snap", {})
        # and because it never wrote, a THIRD append-open gets epoch 3
        assert SnapshotStore(p).epoch == 3

    def test_torn_tail_truncated_on_reopen(self, tmp_path):
        p = str(tmp_path / "obs.jsonl")
        s = SnapshotStore(p, flush_every=1)
        s.append("snap", {"seq": 0}, seq=0)
        s.append("snap", {"seq": 1}, seq=1)
        s.close()
        with open(p, "a") as f:
            f.write('{"t": "snap", "epoch": 1, "se')     # SIGKILL mid-write
        s2 = SnapshotStore(p)
        assert [r["doc"]["seq"] for r in s2.records("snap")] == [0, 1]
        s2.append("snap", {"seq": 2}, seq=2)
        s2.close()
        # the torn fragment is gone from disk, not just skipped in memory
        lines = open(p).read().splitlines()
        assert all(json.loads(ln) for ln in lines)

    def test_compaction_bounds_records_and_keeps_epoch_markers(self,
                                                               tmp_path):
        p = str(tmp_path / "obs.jsonl")
        s = SnapshotStore(p, max_records=20, flush_every=1)
        for i in range(30):               # > 1.25 * 20 triggers compaction
            s.append("snap", {"seq": i}, seq=i, now=float(i))
        assert len(s) <= 25
        kept = [r["doc"]["seq"] for r in s.records("snap")]
        assert kept == sorted(kept)
        assert kept[-1] == 29             # newest window survives
        s.close()
        # survivors still carry a marker for every surviving epoch
        reopened = open_snapshot_store(p, read_only=True)
        assert reopened.epochs() == [1]
        assert [r["doc"]["seq"] for r in reopened.records("snap")] == kept

    def test_max_age_drops_stale_window(self, tmp_path):
        s = SnapshotStore(str(tmp_path / "obs.jsonl"), max_records=10,
                          max_age=5.0)
        for i in range(40):
            s.append("snap", {"seq": i}, seq=i, now=float(i))
        s.compact()                       # age bound applies at compaction
        ages = [float(r["now"]) for r in s.records("snap")]
        assert ages and max(ages) - min(ages) <= 5.0
        assert max(ages) == 39.0          # newest record always survives
        s.close()

    def test_sqlite_store_same_contract(self, tmp_path):
        p = str(tmp_path / "obs.sqlite")
        s1 = open_snapshot_store(p)
        assert isinstance(s1, SqliteSnapshotStore) and s1.epoch == 1
        s1.append("snap", {"seq": 0}, seq=0, now=1.0)
        s1.append("anomaly", {"kind": "k"}, seq=0, now=1.0)
        s1.close()
        s2 = open_snapshot_store(p)
        assert s2.epoch == 2
        s2.append("snap", {"seq": 9}, seq=9, now=2.0)
        s2.close()
        ro = open_snapshot_store(p, read_only=True)
        assert ro.epochs() == [1, 2]
        assert ro.snapshots(epoch=2) == [{"seq": 9}]
        assert ro.summary()["by_type"] == {"snap": 2, "anomaly": 1}
        assert open_snapshot_store(p).epoch == 3

    def test_store_path_convention(self, tmp_path):
        d = str(tmp_path)
        assert obs_store_path(d).endswith(OBS_STORE_NAME)
        assert obs_store_path(d, "sqlite").endswith(OBS_STORE_DB)


# -- deterministic trace sampling + span lifecycle -----------------------------

class TestWorkUnitTracer:
    def test_sampling_is_a_pure_function_of_ids(self):
        picks = [wu_sampled(7, s, w, 0.5)
                 for s in range(4) for w in range(200)]
        assert picks == [wu_sampled(7, s, w, 0.5)
                         for s in range(4) for w in range(200)]
        frac = sum(picks) / len(picks)
        assert 0.35 < frac < 0.65         # keyed hash, roughly the rate
        assert all(wu_sampled(0, 0, w, 1.0) for w in range(10))
        assert not any(wu_sampled(0, 0, w, 0.0) for w in range(10))
        # a different seed picks a different population
        other = [wu_sampled(8, s, w, 0.5)
                 for s in range(4) for w in range(200)]
        assert other != picks

    def test_span_lifecycle_fields(self):
        tr = WorkUnitTracer(sample_rate=1.0)
        tr.on_issue(0, 3, host=5, now=10.0, phase=2, validates=None)
        tr.on_lapse(0, 3, now=40.0)
        tr.on_lapse(0, 3, now=50.0)       # only the FIRST lapse stamps
        tr.on_settle(0, 3, now=55.0, outcome="committed", late=True)
        tr.on_settle(0, 99, now=56.0, outcome="stale")   # unknown: ignored
        (span,) = tr.drain()
        assert span == {"trace_v": 1, "search": 0, "wu": 3, "host": 5,
                        "phase": 2, "validates": None, "issued_at": 10.0,
                        "lapsed_at": 40.0, "reported_at": 55.0,
                        "outcome": "committed", "late": True,
                        "turnaround": 45.0}
        assert tr.drain() == []           # drain pops
        assert tr.summary()["completed"] == 1

    def test_ring_bounds_completed_spans(self):
        tr = WorkUnitTracer(ring=4)
        for w in range(10):
            tr.on_issue(0, w, host=0, now=0.0, phase=0, validates=None)
            tr.on_settle(0, w, now=1.0, outcome="assimilated")
        spans = tr.drain()
        assert [s["wu"] for s in spans] == [6, 7, 8, 9]
        assert tr.ring_dropped == 6


# -- the retention sink --------------------------------------------------------

class TestRetentionSink:
    def test_sink_spills_snapshots_spans_and_anomalies(self, tmp_path):
        hub = MetricsHub(interval=1.0)
        store = SnapshotStore(str(tmp_path / "obs.jsonl"))
        tracer = WorkUnitTracer()
        sink = RetentionSink(hub, store, tracer=tracer)
        tracer.on_issue(0, 0, host=1, now=0.5, phase=0, validates=None)
        tracer.on_settle(0, 0, now=0.9, outcome="committed")
        hub.sample(1.0)                   # sample boundary drains the ring
        tracer.on_issue(0, 1, host=2, now=1.5, phase=0, validates=None)
        hub.sample(2.0)                   # span 1 still open: nothing new
        assert sink.snapshots_stored == 2
        assert sink.spans_stored == 1
        tracer.on_settle(0, 1, now=2.5, outcome="stale")
        sink.drain_remaining()            # end-of-run sweep
        assert sink.spans_stored == 2
        assert store.summary()["by_type"] == {"snap": 2, "span": 2}
        snaps = store.records("snap")
        assert [int(r["seq"]) for r in snaps] == [0, 1]
        store.close()


# -- ring gaps on the wire + retention backfill --------------------------------

class TestDroppedAndBackfill:
    def _server(self, problem, tmp_path, ring=4):
        from repro_torch.server.server import WorkServer
        spec, fleet, _ = problem
        srv = WorkServer([spec], lease_timeout=8.0 * fleet.base_eval_time,
                         idle_retry=fleet.idle_retry)
        hub = MetricsHub(interval=5.0, ring=ring)
        srv.attach_hub(hub)
        store = SnapshotStore(str(tmp_path / "obs.jsonl"))
        sink = RetentionSink(hub, store)
        srv.attach_retention(store)
        return srv, hub, store, sink

    def test_reply_reports_ring_gap_explicitly(self, problem, tmp_path):
        srv, hub, store, _ = self._server(problem, tmp_path)
        for t in range(12):
            hub.sample(float(t))          # ring=4 retains seqs 8..11
        rep = srv.handle(protocol.subscribe_stats(-1))
        assert rep["kind"] == "stats"
        assert [s["seq"] for s in rep["snapshots"]] == [8, 9, 10, 11]
        assert rep["dropped"] == 8
        # a cursor INSIDE the retained window: no gap, no false alarm
        rep2 = srv.handle(protocol.subscribe_stats(9))
        assert [s["seq"] for s in rep2["snapshots"]] == [10, 11]
        assert rep2["dropped"] == 0
        store.close()

    def test_from_store_backfills_the_gap(self, problem, tmp_path):
        srv, hub, store, _ = self._server(problem, tmp_path)
        for t in range(12):
            hub.sample(float(t))
        rep = srv.handle(protocol.subscribe_stats(-1, from_store=True))
        # the store held what the ring dropped: the full history comes
        # back and the residual gap is zero
        assert [s["seq"] for s in rep["snapshots"]] == list(range(12))
        assert rep["dropped"] == 0
        assert rep["cursor"] == 11
        # mid-gap cursor backfills only the missing middle
        rep2 = srv.handle(protocol.subscribe_stats(3, from_store=True))
        assert [s["seq"] for s in rep2["snapshots"]] == list(range(4, 12))
        assert rep2["dropped"] == 0
        store.close()

    def test_status_surfaces_ring_and_interval(self, problem, tmp_path):
        srv, hub, store, _ = self._server(problem, tmp_path, ring=4)
        hub.sample(0.0)
        obs = srv.handle(protocol.status())["obs"]
        assert obs["ring"] == 4
        assert obs["interval"] == 5.0
        assert obs["snapshots"] == 1
        assert obs["retention"]["records"] == 1
        store.close()

    def test_tiny_ring_cursor_contract_via_construction_path(
            self, problem, backend, baseline, tmp_path):
        # satellite (c): ring size + cadence flow through the server
        # construction path; a ring of 2 still yields a gap-accounted,
        # strictly-increasing subscribed stream AND an untouched run
        spec, fleet, _ = problem
        # a tiny throttle (which rides the checkpointed handler) keeps the
        # warm-jit run from finishing before the subscriber's first
        # wall-clock poll lands
        res = ServerSubstrate(spec, fleet, backend, obs=True,
                              subscribe=True, stats_interval=10.0,
                              stats_ring=2, throttle_s=0.002,
                              ckpt_dir=str(tmp_path / "ckpt"),
                              snapshot_every=10_000).run()
        assert _same(baseline, res)
        assert res.obs["ring"] == 2
        sub = res.subscriber
        # the cursor contract survives a 2-slot ring: seqs strictly
        # increasing, every wrap accounted in ``dropped`` — nothing
        # silently vanished mid-stream
        assert sub["stamped_ok"]
        assert sub["snapshots"] > 0
        # every seq up to the last one received was either delivered or
        # counted in a gap: delivered + dropped == last_seq + 1
        assert sub["snapshots"] + sub["dropped"] == sub["last_seq"] + 1


# -- BackgroundSubscriber shutdown (satellite b) -------------------------------

class _BlockingConn:
    """A connection whose long-poll blocks until close() — the TCP recv
    stall the shutdown fix targets."""

    def __init__(self):
        self.closed = threading.Event()
        self.polled = threading.Event()

    def call(self, msg):
        self.polled.set()
        self.closed.wait(timeout=30.0)
        raise OSError("connection closed")

    def close(self):
        self.closed.set()


class TestBackgroundSubscriberShutdown:
    def test_stop_unblocks_a_thread_stuck_in_long_poll(self, capsys):
        conn = _BlockingConn()
        sub = BackgroundSubscriber(lambda: conn, poll_s=0.01).start()
        assert conn.polled.wait(timeout=10.0)   # thread is inside call()
        sub.stop()
        assert not sub._thread.is_alive()
        # the provoked teardown error is the EXPECTED shutdown path:
        # nothing recorded, nothing printed
        assert sub.summary()["errors"] == []
        assert capsys.readouterr().err == ""

    def test_stop_before_any_reply_is_clean(self):
        conn = _BlockingConn()
        sub = BackgroundSubscriber(lambda: conn, poll_s=0.01).start()
        conn.polled.wait(timeout=10.0)
        sub.stop()
        s = sub.summary()
        assert s["snapshots"] == 0 and s["errors"] == []


# -- dashboard JSON golden shape (satellite d) ---------------------------------

class _ScriptedConn:
    def __init__(self, replies):
        self._replies = list(replies)

    def call(self, msg):
        assert msg["kind"] == "subscribe_stats"
        if self._replies:
            return self._replies.pop(0)
        raise OSError("stream drained")

    def close(self):
        pass


class TestDashboardJsonMode:
    def _snaps(self, n=3):
        hub = MetricsHub(interval=1.0)
        hub.register_probe("server", lambda: {"messages": 10,
                                              "searches": []})
        return [hub.sample(float(t)) for t in range(n)]

    def test_json_lines_golden_shape(self):
        snaps = self._snaps()
        conn = _ScriptedConn([protocol.stats_reply(snaps, 2, 1.0,
                                                   STREAM_VERSION)])
        out = io.StringIO()
        shown = watch(lambda: conn, as_json=True, max_snapshots=3, out=out)
        assert shown == 3
        lines = [json.loads(ln) for ln in out.getvalue().splitlines()]
        assert len(lines) == 3
        for doc, snap in zip(lines, snaps):
            # the golden shape: exactly the hub's snapshot keys, stamped
            assert set(doc) == {"stream_v", "seq", "now", "counters",
                                "groups"}
            assert doc["stream_v"] == STREAM_VERSION
            assert doc == snap            # stamp-neutral passthrough

    def test_json_mode_emits_distinct_gap_record(self):
        snaps = self._snaps(2)
        conn = _ScriptedConn([protocol.stats_reply(snaps, 1, 1.0,
                                                   STREAM_VERSION,
                                                   dropped=7)])
        out = io.StringIO()
        watch(lambda: conn, as_json=True, max_snapshots=2, out=out)
        lines = [json.loads(ln) for ln in out.getvalue().splitlines()]
        assert lines[0] == {"kind": "gap", "dropped": 7}
        assert [ln["seq"] for ln in lines[1:]] == [0, 1]


# -- observed parity with the full §14 plane on (the tentpole gate) ------------

class TestRetainedRunParity:
    def test_retained_traced_run_is_bit_identical_and_durable(
            self, problem, backend, baseline, tmp_path):
        spec, fleet, _ = problem
        res = ServerSubstrate(spec, fleet, backend, stats_interval=10.0,
                              retain_dir=str(tmp_path),
                              trace_rate=1.0).run()
        assert _same(baseline, res)
        assert res.retention["snapshots_stored"] >= 2
        assert res.retention["spans_stored"] > 0
        assert res.trace["sampled"] > 0 and res.trace["skipped"] == 0
        store = open_snapshot_store(obs_store_path(str(tmp_path)),
                                    read_only=True)
        assert store.epochs() == [1]
        assert len(store.records("span")) == res.retention["spans_stored"]

    def test_sampled_tracing_traces_the_same_population_twice(
            self, problem, backend, baseline, tmp_path):
        spec, fleet, _ = problem
        runs = []
        for leg in ("a", "b"):
            d = str(tmp_path / leg)
            res = ServerSubstrate(spec, fleet, backend,
                                  stats_interval=10.0, retain_dir=d,
                                  trace_rate=0.5, trace_seed=11).run()
            assert _same(baseline, res)
            store = open_snapshot_store(obs_store_path(d), read_only=True)
            runs.append([r["doc"] for r in store.records("span")])
        # keyed sampling: both runs traced the exact same workunits
        assert runs[0] == runs[1]
        assert 0 < len(runs[0])

    def test_stall_kill_recorded_and_replayed_bit_identically(
            self, problem, backend, baseline):
        spec, fleet, _ = problem
        defended = ServerSubstrate(spec, fleet, backend,
                                   stats_interval=10.0,
                                   stall_window=3).run()
        d = defended.defense
        assert d["searches_killed"] == [0]
        assert d["by_action"]["kill_search"] >= 1
        # the kill truncated the search — NOT parity with the baseline
        assert defended.engines[0].iteration \
            < baseline.engines[0].iteration
        replayed = ServerSubstrate(spec, fleet, backend,
                                   stats_interval=10.0,
                                   defense_schedule=d["schedule"]).run()
        assert _same(defended, replayed)
        assert replayed.defense["mode"] == "replay"
        assert replayed.defense["searches_killed"] == [0]


# -- director-level kill schedule ----------------------------------------------

def _quad_backend(n=6, seed=3):
    rng = np.random.default_rng(seed)
    A = rng.normal(size=(n, n)).astype(np.float32)
    H = torch.from_numpy(A @ A.T + n * np.eye(n, dtype=np.float32))

    def f_batch(xs):
        # ½ xᵀHx in elementwise steps, each row on its own: a torch matrix
        # product may block its rows by the batch's width, and the kill
        # schedule's replay needs a lane's value to be its own
        hx = sum(xs[:, j, None] * H[j][None, :] for j in range(n))
        return 0.5 * sum(hx[:, i] * xs[:, i] for i in range(n))

    return InProcessEvalBackend(f_batch), n


def _mini_portfolio(n_searches=3, **director_kw):
    backend, n = _quad_backend()
    fleet = GridConfig(n_hosts=64, failure_prob=0.1, malicious_prob=0.02,
                       seed=3)
    sched = FleetScheduler(backend, fleet)
    anm = AnmConfig(m_regression=8, m_line_search=8, max_iterations=2)
    specs = multi_start_specs(sched, np.ones(n), -10 * np.ones(n),
                              10 * np.ones(n), 0.5 * np.ones(n), anm,
                              n_searches, seed=0, jitter=0.3)
    return SearchDirector(sched, specs, **director_kw).run()


class TestDirectorKillSchedule:
    def test_scheduled_kill_retires_and_logs(self):
        base = _mini_portfolio()
        res = _mini_portfolio(kill_schedule={"search-1": 1})
        killed = next(o for o in res.outcomes if o.spec.name == "search-1")
        assert killed.status == "killed"
        assert killed.engine.iteration <= 1
        survivors = [o for o in res.outcomes if o.spec.name != "search-1"]
        for o, b in zip(survivors,
                        [o for o in base.outcomes if o.spec.name != "search-1"]):
            assert identical_trajectories(o.engine, b.engine)

    def test_kill_log_roundtrip(self):
        director_log = {}

        def run(schedule):
            backend, n = _quad_backend()
            fleet = GridConfig(n_hosts=64, failure_prob=0.1,
                               malicious_prob=0.02, seed=3)
            sched = FleetScheduler(backend, fleet)
            anm = AnmConfig(m_regression=8, m_line_search=8,
                            max_iterations=2)
            specs = multi_start_specs(sched, np.ones(n), -10 * np.ones(n),
                                      10 * np.ones(n), 0.5 * np.ones(n),
                                      anm, 3, seed=0, jitter=0.3)
            d = SearchDirector(sched, specs, kill_schedule=schedule)
            res = d.run()
            director_log[id(res)] = list(d.kill_log)
            return res

        first = run({"search-1": 1})
        log = director_log[id(first)]
        assert log == [{"name": "search-1", "round": 1}]
        # the recorded log IS a schedule: replaying it reproduces the run
        second = run({k["name"]: k["round"] for k in log})
        assert director_log[id(second)] == log
        for a, b in zip(first.outcomes, second.outcomes):
            assert a.status == b.status
            assert identical_trajectories(a.engine, b.engine)
            assert a.engine.stats == b.engine.stats


# -- post-mortem reconstruction ------------------------------------------------

class TestPostmortemReconstruct:
    def _store(self, tmp_path):
        p = str(tmp_path / "obs.jsonl")
        s = SnapshotStore(p)

        def snap(seq, now, phase, status, it, states):
            return {"stream_v": 1, "seq": seq, "now": now, "counters": {},
                    "groups": {
                        "server": {"searches": [
                            {"search_id": 0, "phase": phase,
                             "status": status, "iteration": it,
                             "best": 1.0}]},
                        "registry": {"states": states, "quarantined": 0,
                                     "reliable_set": sum(states.values()),
                                     "churn": {}}}}

        s.append("snap", snap(0, 10.0, 0, "running", 0,
                              {"alive": 4}), seq=0, now=10.0)
        s.append("snap", snap(1, 20.0, 0, "running", 0,
                              {"alive": 4}), seq=1, now=20.0)
        s.append("snap", snap(2, 30.0, 1, "running", 1,
                              {"alive": 3, "suspect": 1}), seq=2, now=30.0)
        for wu, ta in ((0, 5.0), (1, 25.0), (2, 15.0)):
            s.append("span", {"search": 0, "wu": wu, "host": wu,
                              "phase": 0, "issued_at": 0.0,
                              "lapsed_at": None, "reported_at": ta,
                              "outcome": "committed", "late": False,
                              "turnaround": ta}, now=ta)
        s.append("anomaly", {"seq": 2, "now": 30.0, "action": "page",
                             "kind": "stale_spike", "hosts": [],
                             "detail": {}}, seq=2, now=30.0)
        s.close()
        return p

    def test_reconstruct_is_read_only_and_complete(self, tmp_path):
        p = self._store(tmp_path)
        doc = reconstruct(p, top=2)
        # phase timeline: one entry per (phase, status, ...) transition
        assert [(t["seq"], t["phase"]) for t in doc["phases"]] == \
            [(0, 0), (2, 1)]
        assert [(c["seq"], c["states"]) for c in doc["cohorts"]] == \
            [(0, {"alive": 4}), (2, {"alive": 3, "suspect": 1})]
        assert doc["spans"] == 3
        assert doc["turnaround"]["max"] == 25.0
        assert [sp["wu"] for sp in doc["critical_paths"]] == [1, 2]
        assert len(doc["anomalies"]) == 1
        assert doc["epochs"][0]["snapshots"] == 3
        # reconstructing did NOT mark an epoch
        assert open_snapshot_store(p, read_only=True).epochs() == [1]

    def test_epoch_filter_separates_runs(self, tmp_path):
        p = self._store(tmp_path)
        s = SnapshotStore(p)              # "restored run" appends epoch 2
        s.append("snap", {"stream_v": 1, "seq": 7, "now": 70.0,
                          "counters": {}, "groups": {}}, seq=7, now=70.0)
        s.close()
        doc = reconstruct(p, epoch=1)
        assert {e["epoch"]: e["snapshots"] for e in doc["epochs"]} == \
            {1: 3, 2: 1}
        assert all(t["seq"] <= 2 for t in doc["phases"])
        doc2 = reconstruct(p, epoch=2)
        assert doc2["spans"] == 0


# -- across packages -------------------------------------------------------------

from repro.core.substrates.eval_backend import \
    InProcessEvalBackend as JInProcessEvalBackend  # noqa: E402
from repro.launch import obs_postmortem as j_obs_postmortem  # noqa: E402
from repro.obs import WorkUnitTracer as JWorkUnitTracer  # noqa: E402
from repro.obs import open_snapshot_store as j_open_snapshot_store  # noqa: E402
from repro.obs import wu_sampled as j_wu_sampled  # noqa: E402
from repro.server.sim import ServerSubstrate as JServerSubstrate  # noqa: E402
from repro.server.sim import SimulatedCrash as JSimulatedCrash  # noqa: E402
from repro.server.sim import smoke_problem as j_smoke_problem  # noqa: E402
from repro_torch.launch import obs_dashboard, obs_postmortem  # noqa: E402


@pytest.mark.parametrize("rate", [0.1, 0.5])
@pytest.mark.parametrize("seed", [0, 11])
def test_wu_sampled_picks_the_reference_ids(rate, seed):
    """Over 10,000 (search, wu) ids the port's keyed sampling picks exactly
    the reference's workunits, at about the rate."""
    ids = [(s, w) for s in range(4) for w in range(2500)]
    mine = [wu_sampled(seed, s, w, rate) for s, w in ids]
    theirs = [j_wu_sampled(seed, s, w, rate) for s, w in ids]
    assert mine == theirs
    assert abs(sum(mine) / len(ids) - rate) < 0.02


def test_tracer_spans_equal_the_reference_for_one_hook_sequence():
    """The same seeded issue / lapse / settle hooks give both packages'
    tracers the same drained spans and summaries, through a bounded ring."""
    rng = np.random.default_rng(31)
    tracers = [WorkUnitTracer(sample_rate=0.5, ring=64, seed=5),
               JWorkUnitTracer(sample_rate=0.5, ring=64, seed=5)]
    open_wus, now, drained = [], 0.0, ([], [])
    for step in range(3000):
        now += float(rng.exponential(1.0))
        kind = rng.choice(["issue", "lapse", "settle"], p=[0.5, 0.1, 0.4])
        if kind == "issue" or not open_wus:
            wu = step
            open_wus.append(wu)
            args = (int(rng.integers(0, 2)), wu, int(rng.integers(0, 40)),
                    now, int(rng.integers(0, 9)),
                    None if rng.random() < 0.8 else int(rng.integers(0, wu + 1)))
            for tr in tracers:
                tr.on_issue(*args)
            continue
        wu = open_wus[int(rng.integers(0, len(open_wus)))]
        for search in (0, 1):
            for tr in tracers:
                if kind == "lapse":
                    tr.on_lapse(search, wu, now)
                else:
                    tr.on_settle(search, wu, now, "committed", late=True)
        if kind == "settle":
            open_wus.remove(wu)
        if step % 400 == 0:
            for out, tr in zip(drained, tracers):
                out.extend(tr.drain())
    for out, tr in zip(drained, tracers):
        out.extend(tr.drain())
    assert drained[0] == drained[1] and len(drained[0]) > 100
    assert tracers[0].summary() == tracers[1].summary()
    assert tracers[0].ring_dropped > 0


def _write_store(opener, path, epochs, first_seq=0):
    """Append ``epochs`` runs of snapshots, spans and an anomaly each."""
    seq = first_seq
    for _ in range(epochs):
        s = opener(path, flush_every=3)
        for i in range(5):
            s.append("snap", {"stream_v": 1, "seq": seq, "now": 10.0 * seq,
                              "counters": {}, "groups": {"x": {"i": i}}},
                     seq=seq, now=10.0 * seq)
            s.append("span", {"wu": seq, "turnaround": 1.5 * i,
                              "outcome": "committed"}, now=10.0 * seq + 1)
            seq += 1
        s.append("anomaly", {"seq": seq - 1, "now": 0.0, "action": "page",
                             "kind": "stale_spike", "hosts": [],
                             "detail": {}}, seq=seq - 1, now=10.0 * seq)
        s.close()
    return seq


def _store_view(store):
    return (store.epochs(), store.records(), store.summary()["by_type"],
            len(store))


@pytest.mark.parametrize("name", ["obs.jsonl", "obs.sqlite"])
def test_stores_open_across_packages(tmp_path, name):
    """A store the reference wrote opens in the port with equal records
    and epochs; the port appends the next epoch; the reference reads that
    back equally — for the JSONL and the sqlite store alike."""
    p = str(tmp_path / name)
    seq = _write_store(j_open_snapshot_store, p, epochs=2)
    mine = open_snapshot_store(p, read_only=True)
    theirs = j_open_snapshot_store(p, read_only=True)
    assert _store_view(mine) == _store_view(theirs)
    assert mine.epochs() == [1, 2] and mine.epoch == 2
    if name.endswith(".sqlite"):
        mine.close()
        theirs.close()
    _write_store(open_snapshot_store, p, epochs=1, first_seq=seq)
    mine = open_snapshot_store(p, read_only=True)
    theirs = j_open_snapshot_store(p, read_only=True)
    assert _store_view(mine) == _store_view(theirs)
    assert theirs.epochs() == [1, 2, 3]
    assert [r["doc"]["seq"] for r in theirs.records("snap", epoch=3)] == \
        list(range(seq, seq + 5))


def _digest(path):
    with open(path, "rb") as f:
        return hashlib.sha256(f.read()).hexdigest()


@pytest.mark.parametrize("writer", ["port", "reference"])
def test_reconstruct_equal_from_either_package(problem, backend, tmp_path,
                                               writer):
    """An observed, defended, traced and retained server run crashed
    mid-search (the port's, or the reference's on the same seeds): both
    packages' ``reconstruct`` give the same timeline of the store and the
    replay log, and both CLIs the same JSON, leaving the store's bytes as
    they were."""
    d = str(tmp_path / "ckpt")
    kw = dict(ckpt_dir=d, snapshot_every=50, retain=True, trace_rate=1.0,
              stats_interval=10.0, defense=True, silence_at=120.0,
              silence_frac=0.25, max_messages=600)
    if writer == "port":
        spec, fleet, _ = problem
        crash, run = SimulatedCrash, ServerSubstrate(spec, fleet, backend,
                                                     **kw).run
    else:
        spec, fleet, f_batch = j_smoke_problem(n_stars=120, n_hosts=40,
                                               m=10, iterations=2)
        crash, run = JSimulatedCrash, JServerSubstrate(
            spec, fleet, JInProcessEvalBackend(f_batch), **kw).run
    with pytest.raises(crash):
        run()
    store = obs_store_path(d)
    log = os.path.join(d, "replay.jsonl")
    before = (_digest(store), _digest(log))
    mine = obs_postmortem.reconstruct(store, replay_log=log, top=5)
    theirs = j_obs_postmortem.reconstruct(store, replay_log=log, top=5)
    assert json.dumps(mine, sort_keys=True) == \
        json.dumps(theirs, sort_keys=True)
    assert mine["store"]["epochs"] == [1] and mine["spans"] > 0
    assert len(mine["phases"]) > 0 and mine["replay_log"]["records"] > 0
    assert mine["anomalies"], "the silenced cohort was never paged"
    for one, main in (("port", obs_postmortem.main),
                      ("ref", j_obs_postmortem.main)):
        main(["--ckpt-dir", d, "--json", "--out",
              str(tmp_path / f"{one}.json")])
    with open(tmp_path / "port.json") as a, open(tmp_path / "ref.json") as b:
        assert json.load(a) == json.load(b)
    obs_postmortem.main([d, "--out", str(tmp_path / "port.txt")])
    assert "== post-mortem:" in (tmp_path / "port.txt").read_text()
    assert (_digest(store), _digest(log)) == before


def test_dashboard_demo_streams_json_lines(capsys):
    """The dashboard's demo on the CPU: the port's smoke fleet served in
    process, watched live through a framed connection, one JSON line per
    stamped snapshot with strictly increasing seqs."""
    assert obs_dashboard.main(["--device", "cpu", "--json", "--interval",
                               "10", "--max-snapshots", "4"]) == 0
    out = capsys.readouterr().out.splitlines()
    docs = [json.loads(ln) for ln in out if ln.startswith("{")]
    snaps = [d for d in docs if "seq" in d]
    assert len(snaps) == 4
    assert all(set(d) == {"stream_v", "seq", "now", "counters", "groups"}
               for d in snaps)
    seqs = [d["seq"] for d in snaps]
    assert seqs == sorted(set(seqs))
    assert out[-1].startswith("[obs] demo done: 4 snapshots")


def test_dashboard_demo_defaults_to_the_card():
    """With no arguments the dashboard serves its demo on ``cuda``: on a
    machine without one it raises instead of running on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises((AssertionError, RuntimeError)):
        obs_dashboard.main([])
