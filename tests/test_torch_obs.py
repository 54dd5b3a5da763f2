"""The port's observability plane (DESIGN.md §13): metrics hub, the
``subscribe_stats`` stream and the anomaly-driven fleet defense.

The reference's tests/test_obs.py, port against port on the CPU, every
test of it; then the port against the reference on the same inputs: equal
snapshot dicts for the same pushes and probe values, equal defense
schedules for one registry event sequence (and a reference schedule
replayed in the port), byte-identical ``subscribe_stats`` and
``stats_reply`` frames, and the observed smoke server run at the
reference's committed centers.  Last, a guard that no probe, sample hook
or stats reply reads a tensor: a probe runs on whichever thread applies a
message or serves a poll, and a tensor read there would wait on the
evaluation backend's CUDA stream.

The §13 contract under test: attaching the metrics hub, a live
``subscribe_stats`` subscriber, or the anomaly-driven fleet defense must
never change what the engines commit — observed runs (including under
chaos fault plans) are bit-identical to unobserved ones, monitoring
messages are stamp-free and never logged, and a defended run is
solo-reproducible from its recorded anomaly schedule.  The supporting
layers get their own pins: hub ring/cursor semantics, probe rates,
registry churn counters + cold-start "warming" accounting, quarantine
gates, one-page-per-cohort-transition, and the rate-detector latches.
"""
import functools
import json
import threading

import numpy as np
import pytest
import torch

from repro_torch.core.engine import identical_trajectories
from repro_torch.core.substrates.eval_backend import InProcessEvalBackend
from repro_torch.obs import (PAGE, QUARANTINE, RELEASE, STREAM_VERSION,
                             FleetDefense, MetricsHub)
from repro_torch.obs import metrics as obs_metrics
from repro_torch.server import protocol
from repro_torch.server import registry as p_registry
from repro_torch.server.registry import DEAD, SUSPECT, HostRegistry
from repro_torch.server.server import SequencedIntake, WorkServer
from repro_torch.server.sim import ServerSubstrate, smoke_problem

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


# -- MetricsHub ----------------------------------------------------------------

class TestMetricsHub:
    def test_counters_and_probe_groups(self):
        hub = MetricsHub(interval=5.0)
        hub.inc("widgets")
        hub.inc("widgets", 2)
        assert hub.counter("widgets") == 3
        hub.register_probe("layer", lambda: {"depth": np.int64(4),
                                             17: "int-key"})
        snap = hub.sample(0.0)
        assert snap["stream_v"] == STREAM_VERSION
        assert snap["counters"]["widgets"] == 3
        # codec-proofing: numpy scalars become python ints, dict keys
        # become strings (msgpack would keep int keys, JSON would not)
        assert snap["groups"]["layer"]["depth"] == 4
        assert type(snap["groups"]["layer"]["depth"]) is int
        assert snap["groups"]["layer"]["17"] == "int-key"

    def test_maybe_sample_interval_is_virtual_time(self):
        hub = MetricsHub(interval=10.0)
        assert hub.maybe_sample(3.0) is not None    # first call samples
        assert hub.maybe_sample(5.0) is None
        assert hub.maybe_sample(12.9) is None
        assert hub.maybe_sample(13.0) is not None
        assert hub.seq == 2

    def test_rates_derived_from_snapshot_deltas(self):
        hub = MetricsHub(interval=1.0)
        state = {"messages": 0}
        hub.register_probe("srv", lambda: dict(state), rates=("messages",))
        hub.sample(0.0)
        state["messages"] = 50
        snap = hub.sample(10.0)
        assert snap["groups"]["srv"]["messages_per_s"] == pytest.approx(5.0)

    def test_ring_bounds_memory_and_cursor_resumes(self):
        hub = MetricsHub(interval=1.0, ring=8)
        for t in range(20):
            hub.sample(float(t))
        assert hub.seq == 20
        snaps, cursor, dropped = hub.since(-1)
        # fell off the ring: resume at the oldest retained snapshot, and
        # the reply SAYS how many were lost rather than silently skipping
        assert [s["seq"] for s in snaps] == list(range(12, 20))
        assert cursor == 19
        assert dropped == 12
        again, cursor2, d2 = hub.since(cursor)
        assert again == [] and cursor2 == 19 and d2 == 0
        hub.sample(20.0)
        fresh, cursor3, d3 = hub.since(cursor2)
        assert [s["seq"] for s in fresh] == [20] and cursor3 == 20
        assert d3 == 0

    def test_series_and_on_sample_callbacks(self):
        hub = MetricsHub(interval=1.0)
        depth = {"v": 0}
        hub.register_probe("g", lambda: {"depth": depth["v"]})
        seen = []
        hub.on_sample(lambda s: seen.append(s["seq"]))
        for t in range(3):
            depth["v"] = t * t
            hub.sample(float(t))
        assert hub.series("g", "depth") == [(0.0, 0.0), (1.0, 1.0),
                                            (2.0, 4.0)]
        assert seen == [0, 1, 2]


# -- registry churn, warming, quarantine ---------------------------------------

class TestRegistryChurn:
    def test_transition_counters_count_each_edge(self):
        reg = HostRegistry(suspect_after=10.0, dead_after=100.0)
        for h in range(3):
            reg.touch(h, 0.0)
        reg.sweep(50.0)                   # all alive -> suspect
        assert reg.churn_to_suspect == 3 and reg.churn_to_dead == 0
        reg.sweep(60.0)                   # still suspect: NOT recounted
        assert reg.churn_to_suspect == 3
        reg.sweep(200.0)                  # suspect -> dead
        assert reg.churn_to_dead == 3
        reg.touch(1, 201.0)               # any contact revives
        assert reg.churn_revived == 1
        assert reg.hosts[1].state == "alive"
        reg.sweep(300.0)                  # host 1 decays again
        assert reg.churn_to_suspect == 4
        d = reg.summary()["churn"]
        assert d == {"to_suspect": 4, "to_dead": 3, "revived": 1}

    def test_churn_counters_survive_state_roundtrip(self):
        reg = HostRegistry(suspect_after=1.0, dead_after=10.0)
        reg.touch(0, 0.0)
        reg.sweep(5.0)
        reg.quarantine(0)
        clone = HostRegistry()
        clone.load_state(reg.state_dict())
        assert clone.churn_to_suspect == 1
        assert clone.hosts[0].quarantined
        assert not clone.reliable(0)

    def test_pre_obs_snapshot_loads_with_default_quarantine(self):
        reg = HostRegistry()
        reg.touch(3, 1.0)
        state = reg.state_dict()
        del state["churn"]                # pre-obs snapshots have neither
        del state["hosts"]["3"]["quarantined"]
        clone = HostRegistry()
        clone.load_state(state)
        assert clone.churn_to_suspect == 0
        assert not clone.hosts[3].quarantined

    def test_warming_hosts_counted_not_omitted(self):
        reg = HostRegistry(min_latency_samples=2)
        for h in range(4):
            reg.touch(h, 0.0)
        reg.on_result(0, 1.0, turnaround=5.0)
        s = reg.summary()
        # the cold-start fix: hosts with no EWMA yet are "warming" and
        # still inside the reliable-set gauge (benefit of the doubt),
        # not silently dropped from it
        assert s["warming"] == 3
        assert s["reliable_set"] == 4

    def test_reliable_set_matches_per_host_gate(self):
        rng = np.random.default_rng(5)
        reg = HostRegistry(min_latency_samples=3)
        for h in range(12):
            reg.touch(h, 0.0)
            for _ in range(int(rng.integers(0, 4))):
                reg.on_issue(h, 1.0)
            if rng.random() < 0.7:
                reg.on_result(h, 2.0, turnaround=float(rng.uniform(1, 50)))
        reg.quarantine(5)
        expect = sorted(h for h in reg.hosts if reg.reliable(h))
        assert reg.reliable_set() == expect

    def test_quarantine_gates_reliable_and_is_idempotent(self):
        reg = HostRegistry()
        reg.touch(0, 0.0)
        assert reg.reliable(0)
        assert reg.quarantine(0) is True
        assert reg.quarantine(0) is False      # re-page is a no-op
        assert not reg.reliable(0)
        assert reg.release(0) is True
        assert reg.release(0) is False
        assert reg.reliable(0)


# -- anomaly detection + paging ------------------------------------------------

def _registry_hub(reg, interval=1.0, hub_cls=MetricsHub, suspect=SUSPECT,
                  dead=DEAD):
    hub = hub_cls(interval=interval)
    hub.register_probe("registry", lambda: {
        **reg.summary(), "suspect_ids": reg.ids(suspect),
        "dead_ids": reg.ids(dead)})
    return hub


class TestFleetDefense:
    def test_pages_exactly_once_per_cohort_transition(self):
        reg = HostRegistry(suspect_after=10.0, dead_after=1000.0)
        hub = _registry_hub(reg)
        defense = FleetDefense(reg, hub)
        for h in range(4):
            reg.touch(h, 0.0)
        reg.sweep(20.0)
        hub.sample(20.0)
        assert [e.action for e in defense.events] == [QUARANTINE]
        assert defense.events[0].hosts == [0, 1, 2, 3]
        assert all(not reg.reliable(h) for h in range(4))
        hub.sample(21.0)                  # cohort still down: no re-page
        hub.sample(22.0)
        assert len(defense.events) == 1
        reg.touch(0, 23.0)                # revival
        hub.sample(23.0)
        assert [e.action for e in defense.events] == [QUARANTINE, RELEASE]
        assert defense.events[1].hosts == [0]
        assert reg.reliable(0)
        hub.sample(24.0)                  # no double-release
        assert len(defense.events) == 2
        reg.sweep(40.0)                   # host 0 decays AGAIN
        hub.sample(40.0)                  # fresh transition: pages again
        assert [e.action for e in defense.events] == \
            [QUARANTINE, RELEASE, QUARANTINE]
        assert defense.events[2].hosts == [0]

    def test_rate_detectors_latch_on_edges(self):
        reg_doc = {"returned": 0, "stale_returns": 0}
        srv_doc = {"duplicate_reports": 0}
        cache_doc = {"hit_rate": 0.9}
        hub = MetricsHub(interval=1.0)
        hub.register_probe("registry", lambda: {**reg_doc,
                                                "suspect_ids": [],
                                                "dead_ids": []})
        hub.register_probe("server", lambda: dict(srv_doc))
        hub.register_probe("cache", lambda: dict(cache_doc))
        defense = FleetDefense(HostRegistry(), hub, stale_rate_spike=0.5,
                               dup_spike=3, hit_rate_floor=0.2)
        hub.sample(0.0)                   # baseline window
        reg_doc.update(returned=10, stale_returns=8)
        hub.sample(1.0)
        kinds = [e.kind for e in defense.events]
        assert kinds == ["stale_spike"]
        reg_doc.update(returned=20, stale_returns=16)
        hub.sample(2.0)                   # sustained spike: still latched
        assert [e.kind for e in defense.events] == ["stale_spike"]
        reg_doc.update(returned=30, stale_returns=16)
        hub.sample(3.0)                   # clears -> re-arms
        reg_doc.update(returned=40, stale_returns=26)
        srv_doc["duplicate_reports"] = 10
        cache_doc["hit_rate"] = 0.05      # collapse after having been high
        hub.sample(4.0)
        kinds = sorted(e.kind for e in defense.events)
        assert kinds == ["cache_collapse", "dup_spike", "stale_spike",
                         "stale_spike"]
        assert all(e.action == PAGE and e.hosts == []
                   for e in defense.events)

    def test_cache_collapse_needs_prior_health(self):
        hub = MetricsHub(interval=1.0)
        cache_doc = {"hit_rate": 0.0}
        hub.register_probe("cache", lambda: dict(cache_doc))
        defense = FleetDefense(HostRegistry(), hub, hit_rate_floor=0.2)
        hub.sample(0.0)
        hub.sample(1.0)
        # a cache that was NEVER healthy (cold start) is not a collapse
        assert defense.events == []

    def test_schedule_roundtrips_and_replay_applies_gate_actions(self):
        reg = HostRegistry(suspect_after=10.0, dead_after=1000.0)
        hub = _registry_hub(reg)
        live = FleetDefense(reg, hub)
        for h in range(3):
            reg.touch(h, 0.0)
        reg.sweep(20.0)
        hub.sample(20.0)
        doc = live.schedule_doc()
        assert doc["v"] == 1 and len(doc["events"]) == 1

        reg2 = HostRegistry(suspect_after=10.0, dead_after=1000.0)
        hub2 = _registry_hub(reg2)
        replay = FleetDefense.replay(reg2, hub2, doc)
        assert not replay.live
        for h in range(3):
            reg2.touch(h, 0.0)
        hub2.sample(5.0)                  # seq 0: the recorded event fires
        assert [e.action for e in replay.events] == [QUARANTINE]
        assert all(not reg2.reliable(h) for h in range(3))
        assert replay.summary()["mode"] == "replay"

    def test_replay_rejects_wrong_schedule_version(self):
        hub = MetricsHub(interval=1.0)
        with pytest.raises(ValueError, match="version"):
            FleetDefense.replay(HostRegistry(), hub,
                                {"v": 99, "events": []})


# -- the wire extension + stamp neutrality -------------------------------------

class TestSubscribeStats:
    def _server(self, problem, with_hub=True):
        spec, fleet, _ = problem
        srv = WorkServer([spec], lease_timeout=8.0 * fleet.base_eval_time,
                         idle_retry=fleet.idle_retry)
        hub = None
        if with_hub:
            hub = MetricsHub(interval=5.0)
            srv.attach_hub(hub)
        return srv, hub

    def test_error_reply_without_hub(self, problem):
        srv, _ = self._server(problem, with_hub=False)
        rep = srv.handle(protocol.subscribe_stats())
        assert rep["kind"] == "error"

    def test_cursor_long_poll_over_the_handler(self, problem):
        srv, hub = self._server(problem)
        srv.handle(protocol.register(0, 1.0, cs=0))
        srv.handle(protocol.request_work(0, 1.0, cs=1))
        rep = srv.handle(protocol.subscribe_stats(-1))
        assert rep["kind"] == "stats" and rep["stream_v"] == STREAM_VERSION
        assert len(rep["snapshots"]) >= 1
        assert rep["snapshots"][0]["groups"]["server"]["messages"] >= 1
        assert "lease_depth" in rep["snapshots"][0]["groups"]["server"]
        cursor = rep["cursor"]
        again = srv.handle(protocol.subscribe_stats(cursor))
        assert again["snapshots"] == [] and again["cursor"] == cursor

    def test_monitoring_is_unstamped_uncounted_unlogged(self, problem,
                                                        tmp_path):
        from repro_torch.server.checkpoint import CheckpointManager
        srv, hub = self._server(problem)
        mgr = CheckpointManager(str(tmp_path / "ckpt"), snapshot_every=10)
        msg = protocol.register(0, 1.0, cs=0)
        srv.handle(msg)
        mgr.record(msg, srv)
        before_messages = srv.counters.messages
        before_seq = hub.seq
        rep = srv.handle(protocol.subscribe_stats(-1))
        mgr.record({"kind": "subscribe_stats", "since": -1}, srv)
        assert rep["kind"] == "stats"
        # a monitoring poll consumes nothing: no message count, no log
        # record, no extra hub sample, and last_applied stays False so
        # even the fallback logging path would skip it
        assert srv.counters.messages == before_messages
        assert hub.seq == before_seq
        assert srv.last_applied is False
        assert mgr.seq == 1               # only the register was logged
        mgr.close()

    def test_sequenced_intake_handles_unstamped_poll_inline(self, problem):
        srv, hub = self._server(problem)
        intake = SequencedIntake(srv.handle)
        srv.attach_intake(intake)
        rep = intake.submit(protocol.subscribe_stats(-1))
        assert rep["kind"] == "stats"
        assert intake.next_seq == 0       # no stamp consumed
        # the status satellite: service pressure rides the status reply
        status = intake.submit(protocol.status())
        assert status["intake"] == {"next_seq": 0, "parked": 0,
                                    "out_of_band": 0}
        assert "leases" in status

    def test_status_intake_is_none_without_intake(self, problem):
        srv, _ = self._server(problem)
        assert srv.handle(protocol.status())["intake"] is None


# -- observed-run parity (the tentpole gate) -----------------------------------

class TestObservedParity:
    def test_observed_serial_run_is_bit_identical(self, problem, backend,
                                                  baseline):
        spec, fleet, _ = problem
        res = ServerSubstrate(spec, fleet, backend, obs=True,
                              stats_interval=10.0).run()
        assert _same(baseline, res)
        assert res.obs["snapshots"] >= 2

    @pytest.mark.parametrize("preset", ["drop_dup", "reset_torn"])
    def test_observed_subscribed_chaos_run_is_bit_identical(
            self, problem, backend, baseline, preset):
        spec, fleet, _ = problem
        res = ServerSubstrate(spec, fleet, backend, obs=True,
                              subscribe=True, stats_interval=10.0,
                              transport="tcp", concurrent=4,
                              chaos=preset).run()
        assert _same(baseline, res)
        assert res.subscriber["snapshots"] >= 2
        assert res.subscriber["stamped_ok"]
        assert not res.subscriber["errors"]

    def test_defense_shrinks_reliable_set_and_replays_identically(
            self, problem, backend):
        spec, fleet, _ = problem
        silence = dict(silence_at=120.0, silence_frac=0.25)
        undefended = ServerSubstrate(spec, fleet, backend, **silence).run()
        defended = ServerSubstrate(spec, fleet, backend, defense=True,
                                   stats_interval=10.0, **silence).run()
        d = defended.defense
        assert d["mode"] == "live" and d["quarantined_now"] > 0
        assert (defended.server.registry.summary()["reliable_set"]
                < undefended.server.registry.summary()["reliable_set"])
        replayed = ServerSubstrate(spec, fleet, backend,
                                   defense_schedule=d["schedule"],
                                   stats_interval=10.0, **silence).run()
        assert _same(defended, replayed)
        assert replayed.defense["mode"] == "replay"
        assert (replayed.defense["quarantined_now"]
                == d["quarantined_now"])


# -- dashboard rendering -------------------------------------------------------

class TestDashboard:
    def test_render_is_pure_and_complete(self):
        from repro_torch.launch.obs_dashboard import render, sparkline
        snap = {"stream_v": 1, "seq": 7, "now": 123.4, "counters": {},
                "groups": {
                    "server": {"messages": 99, "messages_per_s": 4.5,
                               "lease_depth": 3, "lapsed_depth": 1,
                               "searches": [{"search_id": 0,
                                             "status": "running",
                                             "phase": "regression",
                                             "iteration": 2,
                                             "best": 1.25}]},
                    "registry": {"hosts": 8,
                                 "states": {"alive": 6, "suspect": 2,
                                            "dead": 0},
                                 "warming": 1, "reliable_set": 5,
                                 "quarantined": 2,
                                 "churn": {"to_suspect": 2, "to_dead": 0,
                                           "revived": 0}}}}
        out = render(snap, [1.0, 2.0, 4.5])
        for needle in ("seq=7", "99 messages", "4.5 msg/s", "3 leases",
                       "suspect 2", "quarantined 2", "phase=regression",
                       "best=1.250000"):
            assert needle in out, needle
        assert sparkline([]) == ""
        assert len(sparkline(list(range(100)), width=24)) == 24
        assert sparkline([5.0, 5.0]) == "▁▁"    # flat series: no div-by-0


# -- no probe reads a tensor ---------------------------------------------------

#: tensor methods that read a value back to the host (each waits on the
#: tensor's stream when it lies on the card)
_TENSOR_READS = ("item", "cpu", "numpy", "tolist", "to", "__float__",
                 "__int__", "__bool__", "__index__", "__array__")


@pytest.fixture
def no_tensor_reads_in_obs(monkeypatch):
    """Make every tensor read raise while the current thread is inside a
    hub sample (probes, the defense and the retention sink) or serving a
    ``subscribe_stats`` / ``status`` poll; everywhere else (the fleet's
    evaluations, the engine's phase finish) tensors read as usual."""
    local = threading.local()
    caught = []

    def guard(name, orig):
        @functools.wraps(orig)
        def read(*args, **kwargs):
            if getattr(local, "depth", 0):
                caught.append(name)
                raise AssertionError(f"the obs plane read a tensor "
                                     f"(torch.Tensor.{name})")
            return orig(*args, **kwargs)
        return read

    for name in _TENSOR_READS:
        monkeypatch.setattr(torch.Tensor, name,
                            guard(name, getattr(torch.Tensor, name)))
    monkeypatch.setattr(torch.cuda, "synchronize",
                        guard("synchronize", torch.cuda.synchronize))

    def inside(fn):
        @functools.wraps(fn)
        def run(*args, **kwargs):
            local.depth = getattr(local, "depth", 0) + 1
            try:
                return fn(*args, **kwargs)
            finally:
                local.depth -= 1
        return run

    monkeypatch.setattr(MetricsHub, "sample", inside(MetricsHub.sample))
    for name in ("_subscribe_stats", "_status"):
        monkeypatch.setattr(WorkServer, name,
                            inside(getattr(WorkServer, name)))
    return caught


def test_no_probe_reads_a_tensor(problem, backend, baseline,
                                 no_tensor_reads_in_obs, tmp_path):
    """The whole plane on (hub, subscriber, defense, retention, tracing,
    the cache probe, the intake probe), over concurrent TCP: every sample
    and every poll runs with tensor reads forbidden on its thread, and the
    run still equals the unobserved one."""
    from repro_torch.core.substrates.eval_cache import EvalCache
    spec, fleet, _ = problem
    res = ServerSubstrate(spec, fleet, backend, obs=True, subscribe=True,
                          defense=True, stats_interval=10.0,
                          retain_dir=str(tmp_path), trace_rate=1.0,
                          cache=EvalCache(), transport="tcp",
                          concurrent=4).run()
    assert no_tensor_reads_in_obs == []
    assert _same(baseline, res)
    assert res.obs["snapshots"] >= 2 and res.subscriber["snapshots"] >= 1
    assert not res.subscriber["errors"]
    assert res.retention["snapshots_stored"] == res.obs["snapshots"]


def test_the_tensor_guard_catches_a_probe_that_reads_one(
        no_tensor_reads_in_obs):
    """The guard above is not vacuous: a probe that reads a tensor's value
    fails the sample, and the read is recorded."""
    hub = MetricsHub(interval=1.0)
    depth = torch.tensor([3.0])
    hub.register_probe("bad", lambda: {"depth": depth.sum().item()})
    with pytest.raises(AssertionError, match="read a tensor"):
        hub.sample(0.0)
    assert no_tensor_reads_in_obs == ["item"]
    assert depth.sum().item() == 3.0      # outside a sample: reads as usual


# -- across packages -------------------------------------------------------------

from repro.core.substrates.eval_backend import \
    InProcessEvalBackend as JInProcessEvalBackend  # noqa: E402
from repro.obs import FleetDefense as JFleetDefense  # noqa: E402
from repro.obs import MetricsHub as JMetricsHub  # noqa: E402
from repro.obs import metrics as j_obs_metrics  # noqa: E402
from repro.server import protocol as j_protocol  # noqa: E402
from repro.server import registry as j_registry  # noqa: E402
from repro.server.sim import ServerSubstrate as JServerSubstrate  # noqa: E402
from repro.server.sim import result_doc as j_result_doc  # noqa: E402
from repro.server.sim import smoke_problem as j_smoke_problem  # noqa: E402
from repro_torch.server.sim import result_doc  # noqa: E402


def test_same_pushes_and_probe_values_give_equal_snapshots():
    """One seeded stream of counter pushes and probe values, sampled on one
    virtual clock, gives the same snapshot dicts in both packages: seqs,
    times, counters, groups and the derived rates, exactly; and the same
    ``since`` replies once the ring has dropped the oldest."""
    rng = np.random.default_rng(23)
    hubs = [MetricsHub(interval=7.5, ring=16),
            JMetricsHub(interval=7.5, ring=16)]
    state = {"messages": 0, "leases": 0, "depth": 0.0, "ids": []}
    for hub in hubs:
        hub.register_probe("server", lambda: dict(state),
                           rates=("messages", "leases"))
        hub.register_probe("numpy", lambda: {
            "depth": np.float32(state["depth"]), 3: np.int64(7)})
    assert obs_metrics.STREAM_VERSION == j_obs_metrics.STREAM_VERSION
    now = 0.0
    for _ in range(400):
        now += float(rng.exponential(2.0))
        state["messages"] += int(rng.integers(0, 40))
        state["leases"] += int(rng.integers(0, 5))
        state["depth"] = float(rng.normal())
        state["ids"] = sorted(int(h) for h in rng.integers(0, 50, 3))
        name = str(rng.choice(["drops", "resets", "retries"]))
        n = int(rng.integers(1, 3))
        for hub in hubs:
            hub.inc(name, n)
            hub.maybe_sample(now)
    mine, theirs = hubs
    assert mine.seq == theirs.seq > 16
    assert list(mine._snapshots) == list(theirs._snapshots)
    for cursor in (-1, 3, mine.seq - 5, mine.seq - 1):
        assert mine.since(cursor) == theirs.since(cursor)
    assert mine.series("server", "messages_per_s") == \
        theirs.series("server", "messages_per_s")
    assert json.dumps(mine.latest()) == json.dumps(theirs.latest())


def _churn_events(seed=29):
    """A seeded registry event stream with a silenced cohort that later
    revives, and the sample times between events."""
    rng = np.random.default_rng(seed)
    now, out = 0.0, []
    for step in range(1500):
        host = int(rng.integers(0, 30))
        if 20 <= host and 300.0 < now < 900.0:
            continue                      # a cohort silent for a while
        now += float(rng.exponential(1.0))
        out.append((host, now, float(rng.lognormal(2.0, 0.5)),
                    bool(step % 11 == 0)))
    return out


def _defended(reg_mod, hub_cls, defense_cls, events, schedule=None):
    reg = reg_mod.HostRegistry(suspect_after=30.0, dead_after=300.0)
    hub = _registry_hub(reg, interval=10.0, hub_cls=hub_cls,
                        suspect=reg_mod.SUSPECT, dead=reg_mod.DEAD)
    defense = defense_cls(reg, hub, schedule=schedule)
    for host, now, turnaround, stale in events:
        reg.on_issue(host, now)
        reg.on_result(host, now, turnaround, stale=stale)
        reg.sweep(now)
        hub.maybe_sample(now)
    return reg, defense


def test_defense_schedules_match_and_cross_replay():
    """The same registry event stream gives both packages' live defenses
    the same schedule, JSON for JSON; the reference's schedule replayed in
    the port quarantines the same hosts; a wrong version is refused by
    both."""
    events = _churn_events()
    j_reg, j_def = _defended(j_registry, JMetricsHub, JFleetDefense, events)
    p_reg, p_def = _defended(p_registry, MetricsHub, FleetDefense, events)
    doc = json.loads(json.dumps(j_def.schedule_doc()))
    assert {e["action"] for e in doc["events"]} >= {QUARANTINE, RELEASE}
    assert json.dumps(p_def.schedule_doc()) == json.dumps(j_def.schedule_doc())
    assert p_def.summary() == j_def.summary()
    r_reg, r_def = _defended(p_registry, MetricsHub, FleetDefense, events,
                             schedule=doc)
    assert not r_def.live
    assert r_reg.summary() == p_reg.summary() == j_reg.summary()
    assert [h for h in sorted(r_reg.hosts) if not r_reg.reliable(h)] == \
        [h for h in sorted(j_reg.hosts) if not j_reg.reliable(h)]
    for defense_cls, hub_cls, reg_cls in (
            (FleetDefense, MetricsHub, HostRegistry),
            (JFleetDefense, JMetricsHub, j_registry.HostRegistry)):
        with pytest.raises(ValueError, match="version"):
            defense_cls.replay(reg_cls(), hub_cls(interval=1.0),
                               dict(doc, v=2))


def test_stats_frames_are_byte_identical_across_packages():
    """``subscribe_stats`` (with and without ``from_store``) and
    ``stats_reply`` carrying real hub snapshots frame to the same bytes in
    both packages under every codec, and each decoder reads the other's."""
    hub = MetricsHub(interval=1.0)
    hub.register_probe("server", lambda: {"messages": 12, "best": 1.5,
                                          "searches": [{"search_id": 0}]})
    snaps = [hub.sample(float(t)) for t in range(3)]
    msgs = [protocol.subscribe_stats(), protocol.subscribe_stats(7),
            protocol.subscribe_stats(4, from_store=True),
            protocol.stats_reply(snaps, 2, 1.0, STREAM_VERSION),
            protocol.stats_reply(snaps[1:], 2, 1.0, STREAM_VERSION,
                                 dropped=5),
            protocol.stats_reply([], -1, 25.0, STREAM_VERSION)]
    j_msgs = [j_protocol.subscribe_stats(), j_protocol.subscribe_stats(7),
              j_protocol.subscribe_stats(4, from_store=True),
              j_protocol.stats_reply(snaps, 2, 1.0, STREAM_VERSION),
              j_protocol.stats_reply(snaps[1:], 2, 1.0, STREAM_VERSION,
                                     dropped=5),
              j_protocol.stats_reply([], -1, 25.0, STREAM_VERSION)]
    assert msgs == j_msgs
    codecs = [protocol.CODEC_JSON]
    if protocol.msgpack is not None:
        codecs.append(protocol.CODEC_MSGPACK)
    for codec in codecs:
        mine = b"".join(protocol.frame(protocol.encode_message(m, codec))
                        for m in msgs)
        theirs = b"".join(j_protocol.frame(j_protocol.encode_message(m, codec))
                          for m in j_msgs)
        assert mine == theirs
        for dec_mod, stream in ((protocol, theirs), (j_protocol, mine)):
            dec = dec_mod.FrameDecoder()
            got = [dec_mod.decode_message(p) for p in dec.feed(stream)]
            assert [dict(g, v=None) for g in got] == \
                [dict(m, v=None) for m in msgs]


def test_observed_smoke_server_run_tracks_the_reference(tmp_path):
    """The seeded smoke server (400 stars, m = 24, 192 hosts, 4
    iterations) observed with the whole plane in both packages: hub,
    retention and full tracing.  Each package's observed run equals its
    unobserved one (in the port, here; the reference's own tests hold
    it); the two commit different first iterates at this size (ROADMAP
    C), so the port's fitness is held at the reference's committed
    centers, within 1e-3, and it commits as many iterations, each no
    worse than the one before."""
    obs = dict(obs=True, stats_interval=10.0, trace_rate=1.0)
    spec, fleet, f_batch = j_smoke_problem()
    ref = JServerSubstrate(spec, fleet, JInProcessEvalBackend(f_batch),
                           retain_dir=str(tmp_path / "ref"), **obs).run()
    ref_doc = j_result_doc(ref)
    p_spec, p_fleet, p_f = smoke_problem()
    backend = InProcessEvalBackend(p_f)
    mine = ServerSubstrate(p_spec, p_fleet, backend,
                           retain_dir=str(tmp_path / "port"), **obs).run()
    plain = ServerSubstrate(p_spec, p_fleet, backend).run()
    assert _same(plain, mine)
    doc = result_doc(mine)
    assert doc["iteration"] == ref_doc["iteration"] == 4
    assert doc["obs"]["snapshots"] >= 2 and ref_doc["obs"]["snapshots"] >= 2
    assert doc["retention"]["spans_stored"] > 0
    assert doc["trace"]["skipped"] == 0 == ref_doc["trace"]["skipped"]
    centers = torch.tensor(ref_doc["history"]["centers"], dtype=torch.float32)
    got = p_f(centers).numpy().astype(np.float64)
    np.testing.assert_allclose(got, ref_doc["history"]["best_fitness"],
                               rtol=0, atol=1e-3)
    best = doc["history"]["best_fitness"]
    assert all(b <= a for a, b in zip(best, best[1:]))
    assert np.isfinite(doc["best_fitness"])
