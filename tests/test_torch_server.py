"""The port's service layer: wire protocol, host registry, engine
checkpoints, and the crash-recoverable work server (DESIGN.md §9).

The reference's tests/test_server.py, port against port on the CPU, less
``test_crash_restore_pod_mesh_backend`` (the port has no pod-mesh backend
yet: ROADMAP A.6) and ``test_substrate_registry_names`` (it checks the
reference's ``launch/substrates.py``, which is not ported: ROADMAP A.7).
Then the port against the reference on the same seeds: protocol frames
byte-identical and each decoder reading the other's, ``HostRegistry``
summaries equal for one event sequence, a reference checkpoint restoring
into the port's ``WorkServer``, and the seeded smoke server run.

The load-bearing contract here is bit-identical resume: a server killed at
ANY message boundary and restored from snapshot + replay log must commit
exactly the trajectory (and final engine stats) of an uninterrupted run —
on the loopback AND TCP transports, through the in-process AND pod-mesh
evaluation paths, with snapshots landing mid-bootstrap, mid-validation
and with speculative blocks in flight.
"""
import dataclasses
import functools
import json
import os

import numpy as np
import pytest
import torch

from repro_torch.core.anm import AnmConfig
from repro_torch.core.engine import (AnmEngine, EvalResult, identical_trajectories)
from repro_torch.core.grid import GridConfig
from repro_torch.core.orchestrator.director import SearchSpec
from repro_torch.core.substrates.eval_backend import InProcessEvalBackend
from repro_torch.server import protocol
from repro_torch.server.checkpoint import (CheckpointManager, ReplayLog,
                                     from_jsonable, to_jsonable)
from repro_torch.server.registry import ALIVE, DEAD, SUSPECT, HostRegistry
from repro_torch.server.sim import ServerSubstrate, SimulatedCrash, smoke_problem
from repro_torch.server.transport import LoopbackTransport
from repro_torch import convert

pytestmark = pytest.mark.server

#: the port's constructors with the fitness and the engines on the CPU
InProcessEvalBackend = functools.partial(InProcessEvalBackend, device="cpu")
AnmEngine = functools.partial(AnmEngine, device="cpu")
smoke_problem = functools.partial(smoke_problem, device="cpu")


def _quad_fitness(n=4, seed=3):
    rng = np.random.default_rng(seed)
    A = rng.normal(size=(n, n)).astype(np.float32)
    H = torch.from_numpy(A @ A.T + n * np.eye(n, dtype=np.float32))
    x_opt = torch.from_numpy(rng.uniform(-0.5, 0.5, n).astype(np.float32))

    def f_batch(xs):
        # ½ dᵀHd in elementwise steps, each row on its own: a torch matrix
        # product may block its rows by the batch's width, and every
        # contract here needs a lane's value to be its own (as the SDSS
        # fitness's fixed-order row means make it)
        d = xs - x_opt[None, :]
        hd = sum(d[:, j, None] * H[j][None, :] for j in range(n))
        return 0.5 * sum(hd[:, i] * d[:, i] for i in range(n))

    return f_batch


def _spec(n=4, m=8, iterations=2, engine_seed=11, grid_seed=5, n_hosts=24,
          failure=0.1, malicious=0.05, name="t"):
    fleet = GridConfig(n_hosts=n_hosts, failure_prob=failure,
                       malicious_prob=malicious, seed=grid_seed)
    spec = SearchSpec(
        name=name, x0=np.full(n, 1.0), lo=np.full(n, -10.0),
        hi=np.full(n, 10.0), step=np.full(n, 0.5),
        anm=AnmConfig(m_regression=m, m_line_search=m,
                      max_iterations=iterations),
        grid=fleet, engine_seed=engine_seed, device="cpu")
    return spec, fleet


@pytest.fixture(scope="module")
def f_batch():
    return _quad_fitness()


@pytest.fixture(scope="module")
def backend(f_batch):
    return InProcessEvalBackend(f_batch, n_dims=4, max_bucket=32)


# -- wire protocol ------------------------------------------------------------

def _codecs():
    cs = [protocol.CODEC_JSON]
    if protocol.msgpack is not None:
        cs.append(protocol.CODEC_MSGPACK)
    return cs


@pytest.mark.parametrize("codec", _codecs())
def test_protocol_roundtrip_exact(codec):
    pt = np.random.default_rng(0).uniform(-1, 1, 8)
    msgs = [
        protocol.register(3, 1.25),
        protocol.request_work(3, 2.5),
        protocol.report_result(3, 0, 17, -0.1234567890123456789, 3.75),
        protocol.heartbeat(3, 4.0),
        protocol.work_reply(1, 42, 7, pt, float("nan"), None, 99.5),
        protocol.work_reply(0, 43, 8, pt, 0.5, 42, 100.0),
        protocol.no_work_reply(5.0, False),
        protocol.ack_reply(True, 3, 1e-12),
    ]
    for msg in msgs:
        out = protocol.decode_message(protocol.encode_message(msg, codec))
        out.pop("v")
        for k, v in msg.items():
            got = out[k]
            if isinstance(v, float) and np.isnan(v):
                assert np.isnan(got)
            elif isinstance(v, list):
                # float64 must round-trip exactly — the resume contract
                assert [float(x) for x in got] == [float(x) for x in v]
            else:
                assert got == v


def test_protocol_version_mismatch_rejected():
    raw = protocol.encode_message(protocol.heartbeat(1, 0.0),
                                  protocol.CODEC_JSON)
    body = json.loads(raw[1:])
    body["v"] = 999
    bad = bytes([protocol.CODEC_JSON]) + json.dumps(body).encode()
    with pytest.raises(protocol.ProtocolError):
        protocol.decode_message(bad)
    with pytest.raises(protocol.ProtocolError):
        protocol.decode_message(bytes([77]) + b"{}")


def test_frame_decoder_reassembles_partial_feeds():
    payloads = [protocol.encode_message(protocol.heartbeat(i, float(i)))
                for i in range(3)]
    stream = b"".join(protocol.frame(p) for p in payloads)
    dec = protocol.FrameDecoder()
    got = []
    for i in range(0, len(stream), 5):     # drip-feed 5 bytes at a time
        got.extend(dec.feed(stream[i:i + 5]))
    assert [protocol.decode_message(p)["host_id"] for p in got] == [0, 1, 2]


# -- host registry ------------------------------------------------------------

def test_registry_cold_start_grace():
    """A brand-new host must not be excluded by the return-rate gate
    before it ever had a chance to report: the gate engages only after
    ``min_issued_for_rate`` issues (the satellite fix, pinned)."""
    reg = HostRegistry(min_return_rate=0.5, min_issued_for_rate=4)
    reg.on_issue(0, 0.0)
    assert reg.returns_work(0)            # 1 issued / 0 returned: grace
    reg.on_issue(0, 1.0)
    reg.on_issue(0, 2.0)
    assert reg.returns_work(0)            # 3 issued / 0 returned: grace
    reg.on_issue(0, 3.0)
    assert not reg.returns_work(0)        # 4 issued / 0 returned: excluded
    # returning work re-admits it once the rate clears the bar
    for t in (4.0, 5.0, 6.0, 7.0):
        reg.on_result(0, t, 1.0)
    assert reg.returns_work(0)


def test_registry_churn_states_and_revival():
    reg = HostRegistry(suspect_after=10.0, dead_after=50.0)
    reg.register(1, 0.0)
    reg.sweep(5.0)
    assert reg.hosts[1].state == ALIVE
    reg.sweep(20.0)
    assert reg.hosts[1].state == SUSPECT
    reg.sweep(100.0)
    assert reg.hosts[1].state == DEAD
    reg.touch(1, 101.0)                   # any contact revives
    assert reg.hosts[1].state == ALIVE
    assert reg.counts() == {ALIVE: 1, SUSPECT: 0, DEAD: 0}


def test_registry_latency_gate_prefers_fast_hosts():
    reg = HostRegistry(min_latency_samples=4)
    for h, ta in enumerate([1.0, 2.0, 3.0, 100.0]):
        reg.on_issue(h, 0.0)
        reg.on_result(h, ta, ta)
    assert reg.reliable(0) and reg.reliable(1)
    assert not reg.reliable(3)            # above-median turnaround
    assert reg.reliable(99)               # unknown host: benefit of doubt


def test_registry_state_roundtrip():
    reg = HostRegistry()
    reg.on_issue(4, 1.0)
    reg.on_result(4, 3.0, 2.0)
    reg.on_no_work(9, 4.0, 5.0)
    blob = json.dumps(to_jsonable(reg.state_dict()))
    reg2 = HostRegistry()
    reg2.load_state(from_jsonable(json.loads(blob)))
    assert reg2.state_dict() == reg.state_dict()
    assert reg2.hosts[9].nowork_streak == 1


# -- engine checkpoints (satellite: mid-phase snapshot edge cases) ------------

def _f_scalar(x):
    return float(np.sum(np.asarray(x, np.float64) ** 2))


def _drive(engine, steps=None):
    """Deterministic synchronous driver: the continuation is a pure
    function of engine state, so two engines in equal state must commit
    equal futures."""
    n = 0
    while not engine.done:
        reqs = engine.generate(4)
        if not reqs:
            break
        engine.assimilate([EvalResult(r, _f_scalar(r.point)) for r in reqs])
        n += 1
        if steps is not None and n >= steps:
            break
    return engine


def _engine():
    return AnmEngine(np.ones(3), -5 * np.ones(3), 5 * np.ones(3),
                     0.4 * np.ones(3),
                     AnmConfig(m_regression=10, m_line_search=10,
                               max_iterations=3), seed=2)


def _capture_until(predicate, max_steps=500):
    """Drive a fresh engine until ``predicate(engine)`` holds, then return
    (engine, json-round-tripped state)."""
    eng = _engine()
    for _ in range(max_steps):
        if predicate(eng):
            state = json.loads(json.dumps(to_jsonable(eng.state_dict())))
            return eng, from_jsonable(state)
        reqs = eng.generate(1)
        if not reqs:
            break
        eng.assimilate([EvalResult(r, _f_scalar(r.point)) for r in reqs])
    raise AssertionError("predicate never held")


@pytest.mark.parametrize("predicate, label", [
    (lambda e: e.phase == "validating" and e.bootstrapping,
     "mid_bootstrap_validation"),
    (lambda e: e.phase == "validating" and not e.bootstrapping
     and len(e._votes) == 2, "mid_linesearch_validation"),
    (lambda e: e.phase == "linesearch" and e._res_count == 5,
     "mid_linesearch"),
])
def test_engine_snapshot_restore_bit_identical(predicate, label):
    original, state = _capture_until(predicate)
    restored = _engine()
    restored.load_state(state)
    _drive(original)
    _drive(restored)
    assert identical_trajectories(original, restored)
    assert original.stats == restored.stats
    assert original.phase_id == restored.phase_id
    assert original._next_ticket == restored._next_ticket


def test_engine_snapshot_composes_with_block_speculation():
    """A snapshot taken with a speculative block in flight must restore
    the peek's rewind snapshot too: cancel_block() on the restored engine
    rewinds exactly like on the original (PR-3 seam)."""
    def mid_regression(e):
        return e.phase == "regression" and e._res_count == 4

    original, _ = _capture_until(mid_regression)
    block = original.peek_block(3)
    assert block is not None
    state = from_jsonable(json.loads(json.dumps(
        to_jsonable(original.state_dict()))))
    restored = _engine()
    restored.load_state(state)
    # both cancel: the rewind must land both engines on the same rng
    # stream, ticket counter and issuance stats
    original.cancel_block()
    restored.cancel_block()
    assert original._next_ticket == restored._next_ticket
    assert original.stats == restored.stats
    b1 = original.generate_block(3)
    b2 = restored.generate_block(3)
    np.testing.assert_array_equal(b1[2], b2[2])
    np.testing.assert_array_equal(b1[0], b2[0])
    _drive(original)
    _drive(restored)
    assert identical_trajectories(original, restored)


def test_engine_load_state_rejects_mismatch():
    eng = _engine()
    state = eng.state_dict()
    other = AnmEngine(np.ones(5), -np.ones(5), np.ones(5), 0.1 * np.ones(5))
    with pytest.raises(ValueError):
        other.load_state(state)
    cfg_changed = AnmEngine(np.ones(3), -np.ones(3), np.ones(3),
                            0.1 * np.ones(3),
                            AnmConfig(m_regression=99))
    with pytest.raises(ValueError):
        cfg_changed.load_state(state)


# -- crash/restore through the work server ------------------------------------

@pytest.fixture(scope="module")
def baseline(backend):
    spec, fleet = _spec()
    res = ServerSubstrate(spec, fleet, backend, warm=False).run()
    return spec, fleet, res


@pytest.mark.parametrize("frac", [0.05, 0.3, 0.6, 0.9])
def test_crash_restore_bit_identical(tmp_path, backend, baseline, frac):
    """Killed at an arbitrary message boundary (snapshot cadence of 25
    puts snapshots inside bootstrap, validation and line-search phases),
    the restored run must replay the uninterrupted future exactly."""
    spec, fleet, base = baseline
    crash_at = max(10, int(frac * base.pool.messages))
    d = str(tmp_path / f"ckpt_{crash_at}")
    with pytest.raises(SimulatedCrash):
        ServerSubstrate(spec, fleet, backend, warm=False, ckpt_dir=d,
                        snapshot_every=25, max_messages=crash_at).run()
    res = ServerSubstrate(spec, fleet, backend, warm=False, ckpt_dir=d,
                          snapshot_every=25).run(resume=True)
    assert not res.recovered_done
    assert identical_trajectories(base.engines[0], res.engines[0])
    assert base.engines[0].stats == res.engines[0].stats


def test_recovery_ignores_truncated_log_tail(tmp_path, backend, baseline):
    spec, fleet, base = baseline
    d = str(tmp_path / "ckpt_trunc")
    with pytest.raises(SimulatedCrash):
        ServerSubstrate(spec, fleet, backend, warm=False, ckpt_dir=d,
                        snapshot_every=25, max_messages=300).run()
    log = os.path.join(d, "replay.jsonl")
    with open(log, "a") as f:                 # the kill's half-append
        f.write('{"seq": 99999, "msg": {"kind": "report_')
    res = ServerSubstrate(spec, fleet, backend, warm=False, ckpt_dir=d,
                          snapshot_every=25).run(resume=True)
    assert identical_trajectories(base.engines[0], res.engines[0])
    assert base.engines[0].stats == res.engines[0].stats


def test_double_crash_with_torn_log_line(tmp_path, backend, baseline):
    """A resumed run must not append onto the previous kill's torn
    half-line: recovery repairs the log tail, so even a SECOND crash and
    recovery replays every durable record and stays bit-identical."""
    spec, fleet, base = baseline
    d = str(tmp_path / "ckpt_double")
    with pytest.raises(SimulatedCrash):
        ServerSubstrate(spec, fleet, backend, warm=False, ckpt_dir=d,
                        snapshot_every=1000, max_messages=150).run()
    log = os.path.join(d, "replay.jsonl")
    with open(log, "a") as f:
        f.write('{"seq": 150, "msg": {"kind": "request_')  # torn append
    with pytest.raises(SimulatedCrash):
        ServerSubstrate(spec, fleet, backend, warm=False, ckpt_dir=d,
                        snapshot_every=1000,
                        max_messages=200).run(resume=True)
    res = ServerSubstrate(spec, fleet, backend, warm=False, ckpt_dir=d,
                          snapshot_every=1000).run(resume=True)
    # snapshot_every=1000 means NO snapshot ever landed: the final state
    # is rebuilt purely from the replay log across both crash epochs, so
    # a lost durable suffix would show up as a diverged trajectory here
    assert res.replayed > 150
    assert identical_trajectories(base.engines[0], res.engines[0])
    assert base.engines[0].stats == res.engines[0].stats


def test_tcp_malformed_frame_gets_error_reply(backend):
    """A well-formed frame missing required fields must produce an error
    REPLY on a still-usable connection, not a dead socket (untrusted
    clients are the whole point of a wire server)."""
    from repro_torch.server.server import WorkServer
    from repro_torch.server.transport import TcpTransport

    spec, _ = _spec(n_hosts=8, m=4, iterations=1)
    t = TcpTransport().start(WorkServer([spec]).handle)
    try:
        conn = t.connect()
        rep = conn.call({"kind": "register"})          # no host_id/now
        assert rep["kind"] == "error"
        assert "KeyError" in rep["error"]
        rep = conn.call(protocol.register(0, 0.0))     # connection lives
        assert rep["kind"] == "registered"
        conn.close()
    finally:
        t.stop()


def test_recovery_rejects_changed_server_knobs(tmp_path, backend):
    """Behavior-affecting server parameters are part of the checkpoint
    fingerprint: resuming under a different lease timeout must fail
    loudly instead of continuing plausibly-but-wrong."""
    spec, fleet = _spec()
    d = str(tmp_path / "ckpt_knobs")
    with pytest.raises(SimulatedCrash):
        ServerSubstrate(spec, fleet, backend, warm=False, ckpt_dir=d,
                        snapshot_every=10, max_messages=60).run()
    with pytest.raises(ValueError, match="fingerprint"):
        ServerSubstrate(spec, fleet, backend, warm=False, ckpt_dir=d,
                        lease_timeout=1.0).run(resume=True)


def test_recovery_rejects_wrong_spec(tmp_path, backend):
    spec, fleet = _spec()
    d = str(tmp_path / "ckpt_fp")
    with pytest.raises(SimulatedCrash):
        ServerSubstrate(spec, fleet, backend, warm=False, ckpt_dir=d,
                        snapshot_every=10, max_messages=60).run()
    other, _ = _spec(engine_seed=999)
    with pytest.raises(ValueError, match="fingerprint"):
        ServerSubstrate(other, fleet, backend, warm=False,
                        ckpt_dir=d).run(resume=True)


def test_replay_log_tolerates_corrupt_tail(tmp_path):
    path = str(tmp_path / "log.jsonl")
    log = ReplayLog(path)
    for i in range(3):
        log.append({"seq": i + 1, "msg": {"kind": "heartbeat"}})
    log.close()
    with open(path, "a") as f:
        f.write("not json at all\n")
    assert [r["seq"] for r in ReplayLog.replay(path)] == [1, 2, 3]


def test_tcp_transport_matches_loopback(backend):
    spec, fleet = _spec(n_hosts=16, m=6, iterations=1)
    a = ServerSubstrate(spec, fleet, backend, warm=False).run()
    b = ServerSubstrate(spec, fleet, backend, warm=False,
                        transport="tcp").run()
    assert identical_trajectories(a.engines[0], b.engines[0])
    assert a.engines[0].stats == b.engines[0].stats
    assert b.pool.messages == a.pool.messages


def test_lease_lapse_and_late_return_bookkeeping(backend):
    """Slow hosts outlive a tight lease deadline: their leases lapse, the
    eventual result is still assimilated (counted as a late return), and
    the run stays deterministic."""
    spec, fleet = _spec(n_hosts=16, m=6, iterations=1, failure=0.3)
    runs = [ServerSubstrate(spec, fleet, backend, warm=False,
                            lease_timeout=0.5 * fleet.base_eval_time).run()
            for _ in range(2)]
    c = runs[0].server.counters
    assert c.leases_lapsed > 0
    assert c.late_returns > 0
    assert identical_trajectories(runs[0].engines[0], runs[1].engines[0])
    assert dataclasses.asdict(c) == dataclasses.asdict(
        runs[1].server.counters)


def test_portfolio_server_routes_and_kills(backend, tmp_path):
    """One server fronting a 2-search portfolio: round-robin work routing,
    the orchestrator's dominated_cut kill rule, and crash/restore across
    the whole portfolio state."""
    good, fleet = _spec(name="good")
    bad, _ = _spec(name="bad", engine_seed=13)
    bad = dataclasses.replace(bad, x0=np.full(4, 8.0), step=np.full(4, 0.05))
    kw = dict(policy="portfolio", kill_margin=0.05, probation_iterations=1)
    base = ServerSubstrate([good, bad], fleet, backend, warm=False,
                           **kw).run()
    statuses = [e.status for e in base.server.searches]
    assert "killed" in statuses           # the bad start gets retired
    assert base.server.counters.dropped_results >= 0
    d = str(tmp_path / "ckpt_portfolio")
    with pytest.raises(SimulatedCrash):
        ServerSubstrate([good, bad], fleet, backend, warm=False,
                        ckpt_dir=d, snapshot_every=25, max_messages=300,
                        **kw).run()
    res = ServerSubstrate([good, bad], fleet, backend, warm=False,
                          ckpt_dir=d, snapshot_every=25, **kw).run(
                              resume=True)
    for e_base, e_res in zip(base.engines, res.engines):
        assert identical_trajectories(e_base, e_res)
        assert e_base.stats == e_res.stats
    assert [e.status for e in res.server.searches] == statuses


def test_malicious_clients_corrupt_and_get_rejected(backend):
    """Malicious sim clients lie through the same sign-safe on-device
    corruption lanes as the grid substrates, and the engine's quorum
    validation catches the winners — through the full protocol stack."""
    spec, fleet = _spec(n_hosts=32, m=10, iterations=2, malicious=0.3)
    res = ServerSubstrate(spec, fleet, backend, warm=False).run()
    eng = res.engines[0]
    assert res.pool.corrupted > 0
    assert eng.stats.validations_failed >= 1
    assert eng.stats.candidates_rejected >= 1
    assert np.isfinite(eng.best_fitness)


def test_server_status_message_is_read_only(backend):
    spec, fleet = _spec(n_hosts=8, m=4, iterations=1)
    from repro_torch.server.server import WorkServer
    srv = WorkServer([spec])
    t = LoopbackTransport().start(srv.handle)
    conn = t.connect()
    conn.call(protocol.register(0, 0.0))
    before = json.dumps(to_jsonable(srv.state_dict()), sort_keys=True)
    rep = conn.call(protocol.status())
    assert rep["kind"] == "status"
    assert rep["searches"][0]["phase"] == "bootstrap"
    after = json.dumps(to_jsonable(srv.state_dict()), sort_keys=True)
    assert before == after


# -- across packages ------------------------------------------------------------

from repro.core.substrates.eval_backend import \
    InProcessEvalBackend as JInProcessEvalBackend  # noqa: E402
from repro.server import protocol as j_protocol  # noqa: E402
from repro.server import registry as j_registry  # noqa: E402
from repro.server.checkpoint import \
    CheckpointManager as JCheckpointManager  # noqa: E402
from repro.server.server import WorkServer as JWorkServer  # noqa: E402
from repro.server.sim import ServerSubstrate as JServerSubstrate  # noqa: E402
from repro.server.sim import SimulatedCrash as JSimulatedCrash  # noqa: E402
from repro.server.sim import result_doc as j_result_doc  # noqa: E402
from repro.server.sim import smoke_problem as j_smoke_problem  # noqa: E402
from repro_torch.server.server import WorkServer  # noqa: E402
from repro_torch.server.sim import result_doc  # noqa: E402


def _wire_messages():
    """One of every message kind either side sends, numpy payloads
    included."""
    pt = np.array([0.1, -2.5, 1e-7, 3.0])
    return [protocol.register(3, 1.5, cs=0),
            protocol.request_work(3, 2.0, cs=1, seq=7),
            protocol.report_result(3, 0, 12, 5.25, 9.0, cs=2),
            protocol.heartbeat(3, 10.0, cs=3), protocol.shutdown(11.0),
            protocol.status(), protocol.subscribe_stats(4, True),
            protocol.work_reply(1, 12, 2, pt, 0.375, None, 960.0),
            protocol.work_reply(0, 13, 3, pt, 0.5, 12, 990.0),
            protocol.no_work_reply(5.0, False),
            protocol.ack_reply(False, 2, 5.125),
            protocol.error_reply("bad")]


@pytest.mark.parametrize("codec", _codecs())
def test_protocol_frames_are_byte_identical_across_packages(codec):
    """Every message the port frames is the reference's frame byte for
    byte, and each package's decoder reads the other's stream."""
    msgs = _wire_messages()
    mine = b"".join(protocol.frame(protocol.encode_message(m, codec))
                    for m in msgs)
    theirs = b"".join(j_protocol.frame(j_protocol.encode_message(m, codec))
                      for m in msgs)
    assert mine == theirs
    for dec_mod, stream in ((protocol, theirs), (j_protocol, mine)):
        dec = dec_mod.FrameDecoder()
        got = [dec_mod.decode_message(p) for p in dec.feed(stream)]
        want = [dict(json.loads(json.dumps(protocol._py(m))),
                     v=protocol.PROTOCOL_VERSION) for m in msgs]
        assert [json.loads(json.dumps(g)) for g in got] == want


def test_registry_summaries_equal_the_reference_for_one_event_sequence():
    """One seeded stream of registry events (registration, issue, results
    fast and slow, stale returns, no-work backoffs, silence and revival
    across the churn sweeps) drives both packages' ``HostRegistry`` to
    equal summaries, reliability gates and states."""
    rng = np.random.default_rng(17)
    mine, theirs = HostRegistry(), j_registry.HostRegistry()
    now = 0.0
    for step in range(3000):
        host = int(rng.integers(0, 40))
        if host >= 32 and now < 2000.0:       # a cohort silent for a while
            continue
        kind = rng.choice(["register", "issue", "result", "nowork"],
                          p=[0.05, 0.45, 0.4, 0.1])
        now += float(rng.exponential(1.5))
        turnaround = float(rng.lognormal(3.0, 1.0))
        for reg in (mine, theirs):
            if kind == "register":
                reg.register(host, now)
            elif kind == "issue":
                reg.on_issue(host, now)
            elif kind == "result":
                reg.on_result(host, now, turnaround,
                              stale=bool(step % 7 == 0))
            else:
                reg.on_no_work(host, now, 5.0)
            if step % 50 == 0:
                reg.sweep(now)
        if step % 250 == 0:
            assert mine.summary(include_ids=True) == theirs.summary(
                include_ids=True)
            assert ([mine.reliable(h) for h in range(40)]
                    == [theirs.reliable(h) for h in range(40)])
    assert mine.summary(include_ids=True) == theirs.summary(include_ids=True)
    assert json.dumps(to_jsonable(mine.state_dict()), sort_keys=True) == \
        json.dumps(to_jsonable(theirs.state_dict()), sort_keys=True)


@pytest.mark.parametrize("frac,every", [(0.05, None), (0.4, None),
                                        (0.05, 25), (0.4, 25)])
def test_reference_checkpoint_restores_into_the_port(tmp_path, frac, every):
    """A reference work server crashed mid-search leaves a snapshot and a
    replay log; the port's ``WorkServer`` (its spec carried across by
    ``convert.search_spec_from_reference``) recovers from that directory
    to the reference recovery's ``world_view()``: the same leases, points,
    registry and engine phase.  With a snapshot at the crash point
    nothing is replayed: the state is the snapshot's, read by the port;
    with one every 25 messages the port re-handles the log's tail."""
    spec, fleet, f_batch = j_smoke_problem(n_stars=120, n_hosts=64, m=12,
                                           iterations=3)
    backend = JInProcessEvalBackend(f_batch)
    base = JServerSubstrate(spec, fleet, backend).run()
    crash_at = max(10, int(frac * base.pool.messages))
    every = every or crash_at
    d = str(tmp_path / "ckpt")
    with pytest.raises(JSimulatedCrash):
        JServerSubstrate(spec, fleet, backend, ckpt_dir=d,
                         snapshot_every=every, max_messages=crash_at).run()
    kw = dict(lease_timeout=8.0 * fleet.base_eval_time,
              idle_retry=fleet.idle_retry)
    j_srv, j_mgr, j_replayed = JCheckpointManager.recover(
        d, lambda: JWorkServer([spec], **kw), snapshot_every=every)
    j_mgr.close()
    port_spec = convert.search_spec_from_reference(spec, device="cpu")
    srv, mgr, replayed = CheckpointManager.recover(
        d, lambda: WorkServer([port_spec], **kw), snapshot_every=every)
    mgr.close()
    assert replayed == j_replayed
    mine = json.dumps(to_jsonable(srv.world_view()), sort_keys=True)
    theirs = json.dumps(to_jsonable(j_srv.world_view()), sort_keys=True)
    assert mine == theirs
    assert srv.engines[0].phase == j_srv.engines[0].phase
    assert srv.engines[0].iteration == j_srv.engines[0].iteration
    assert srv.fingerprint() == j_srv.fingerprint()


def test_smoke_server_run_tracks_the_reference():
    """The seeded smoke server run (400 stars, m = 24, 192 hosts, 4
    iterations) in both packages.  m = 24 fits 45 coefficients, so the
    first direction rests on last-place f32 differences and the two runs
    commit different line-search winners; the port is therefore held at
    the reference's committed centers: its fitness there is the
    reference's committed fitness within 1e-3, and it commits as many
    iterations, each no worse than the one before."""
    spec, fleet, f_batch = j_smoke_problem()
    ref = j_result_doc(JServerSubstrate(spec, fleet,
                                        JInProcessEvalBackend(f_batch)).run())
    p_spec, p_fleet, p_f = smoke_problem()
    mine = result_doc(ServerSubstrate(p_spec, p_fleet,
                                      InProcessEvalBackend(p_f)).run())
    assert dataclasses.asdict(p_fleet) == dataclasses.asdict(fleet)
    assert mine["iteration"] == ref["iteration"] == 4
    centers = torch.tensor(ref["history"]["centers"], dtype=torch.float32)
    got = p_f(centers).numpy().astype(np.float64)
    np.testing.assert_allclose(got, ref["history"]["best_fitness"],
                               rtol=0, atol=1e-3)
    best = mine["history"]["best_fitness"]
    assert all(b <= a for a, b in zip(best, best[1:]))
    assert np.isfinite(mine["best_fitness"])


@pytest.mark.parametrize("refused", [
    dict(obs=True), dict(subscribe=True), dict(defense=True),
    dict(defense_schedule={}), dict(retain=True), dict(retain_dir="x"),
    dict(trace_rate=0.5), dict(stall_window=3), dict(turnaround_drift=0.2)])
def test_obs_knobs_are_refused_not_ignored(backend, refused):
    """The reference's observability plane is not ported yet: each of its
    switches raises, naming the slice, rather than running without it."""
    spec, fleet = _spec()
    with pytest.raises(ValueError, match="obs plane"):
        ServerSubstrate(spec, fleet, backend, warm=False, **refused)


def test_obs_attach_points_and_pod_mesh_are_refused():
    spec, _ = _spec()
    srv = WorkServer([spec])
    for attach in (srv.attach_hub, srv.attach_tracer, srv.attach_retention):
        with pytest.raises(ValueError, match="obs plane"):
            attach(object())
    rep = srv.handle(protocol.subscribe_stats())
    assert rep["kind"] == "error" and "obs plane" in rep["error"]
    from repro_torch.server import sim
    with pytest.raises(ValueError, match="ROADMAP A.6"):
        sim.main(["--device", "cpu", "--backend", "pod_mesh"])
