"""The port's chaos-hardened work service (DESIGN.md §12).

The reference's tests/test_chaos.py, port against port on the CPU (it has
no pod-mesh case), then the port's fault plans against the reference's:
the same presets and the same seeded fault draws.

The robustness claim under test: N concurrent TCP clients, each behind a
seeded fault injector (drops, duplicates, delays, resets, torn writes),
commit BIT-IDENTICAL iterates and identical engine stats to a fault-free
serial loopback baseline — including across a simulated kill + restore
mid-chaos.  The supporting layers get their own pins: the sequenced
intake's reorder buffer, (host, cs) idempotency (no double votes, no
leaked leases), the duplicate-report-after-lapse accounting fix, the
malformed-frame fuzz survival contract, and sqlite eval-cache recovery
when the cache ran AHEAD of the replay log at the kill.
"""
import functools
import json
import os
import socket
import struct
import threading

import numpy as np
import pytest

from repro_torch.core.engine import identical_trajectories
from repro_torch.core.substrates.eval_backend import InProcessEvalBackend
from repro_torch.core.substrates.eval_cache import EvalCache, SqliteCacheStore
from repro_torch.server import protocol
from repro_torch.server.chaos import PRESETS, ChaosStats, FaultPlan
from repro_torch.server.server import SequencedIntake, WorkServer
from repro_torch.server.sim import ServerSubstrate, SimulatedCrash, smoke_problem
from repro_torch.server.transport import TcpConnection, TcpTransport

from repro.server import chaos as j_chaos

pytestmark = pytest.mark.chaos

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


def _run(problem, backend, **kw):
    spec, fleet, _ = problem
    return ServerSubstrate(spec, fleet, backend, **kw).run(
        resume=kw.pop("resume", False) if "resume" in kw else False)


# -- the sequenced intake ------------------------------------------------------

def test_sequenced_intake_replays_canonical_order():
    handled = []
    intake = SequencedIntake(lambda m: handled.append(m["intake_seq"]) or
                             {"kind": "ack"})
    order = [3, 0, 4, 1, 2]
    threads = [threading.Thread(
        target=intake.submit, args=({"intake_seq": s},)) for s in order]
    for th in threads:
        th.start()
    for th in threads:
        th.join(timeout=30.0)
    assert handled == [0, 1, 2, 3, 4]
    assert intake.next_seq == 5
    assert intake.parked > 0


def test_sequenced_intake_unstamped_is_stamp_neutral():
    """A status probe (no stamp) mid-stream must be handled immediately
    and never consume a stamp — otherwise one monitoring poll would park
    the entire stamped stream forever."""
    handled = []
    intake = SequencedIntake(lambda m: handled.append(
        m.get("intake_seq", "probe")) or {"kind": "ack"})
    intake.submit({"intake_seq": 0})
    intake.submit({"kind": "status"})           # unstamped
    intake.submit({"intake_seq": 1})
    assert handled == [0, "probe", 1]
    assert intake.next_seq == 2


def test_sequenced_intake_late_duplicate_out_of_band():
    handled = []
    intake = SequencedIntake(lambda m: handled.append(m["intake_seq"]) or
                             {"kind": "ack"})
    intake.submit({"intake_seq": 0})
    intake.submit({"intake_seq": 1})
    intake.submit({"intake_seq": 0})            # a retry racing its ack
    assert handled == [0, 1, 0]
    assert intake.next_seq == 2
    assert intake.out_of_band == 1


# -- fault plans ---------------------------------------------------------------

def test_fault_plan_roundtrip_and_determinism():
    for name, plan in PRESETS.items():
        assert plan.name == name
        assert FaultPlan.from_doc(plan.to_doc()) == plan
    p = PRESETS["drop_dup"]
    assert p.draws(3, 7, 1) == p.draws(3, 7, 1)
    assert p.draws(3, 7, 1) != p.draws(3, 7, 2)
    assert p.draws(3, 7, 1) != p.draws(4, 7, 1)


# -- the tentpole gates: chaos parity ------------------------------------------

def test_concurrent_clean_parity(problem, backend, baseline):
    eb = baseline.engines[0]
    res = _run(problem, backend, transport="loopback", concurrent=8)
    assert identical_trajectories(eb, res.engines[0])
    assert eb.stats == res.engines[0].stats
    assert res.intake["parked"] > 0             # reordering actually happened


@pytest.mark.parametrize("preset,expect", [
    ("drop_dup", ("drops_request", "drops_reply", "duplicates")),
    ("reorder_delay", ("delays", "duplicates")),
    ("reset_torn", ("resets", "torn_writes", "drops_reply")),
])
def test_chaos_tcp_parity(problem, backend, baseline, preset, expect):
    """≥8 concurrent TCP clients under a seeded fault schedule commit the
    serial fault-free baseline's exact trajectory — and the schedule must
    have actually injected every fault class it advertises."""
    eb = baseline.engines[0]
    res = _run(problem, backend, transport="tcp", concurrent=8,
               chaos=preset)
    assert identical_trajectories(eb, res.engines[0])
    assert eb.stats == res.engines[0].stats
    for field in expect:
        assert res.chaos[field] > 0, f"{preset} never injected {field}"
    assert res.chaos["plan"] == PRESETS[preset].to_doc()


def test_chaos_crash_resume_parity(problem, backend, baseline, tmp_path):
    """Kill the run mid-chaos (message budget), restore from snapshot +
    replay log, finish under the SAME fault plan: still bit-identical."""
    eb = baseline.engines[0]
    kw = dict(transport="tcp", concurrent=8, chaos="reset_torn",
              ckpt_dir=str(tmp_path), snapshot_every=150)
    spec, fleet, _ = problem
    with pytest.raises(SimulatedCrash):
        ServerSubstrate(spec, fleet, backend,
                        max_messages=baseline.pool.messages // 2,
                        **kw).run()
    res = ServerSubstrate(spec, fleet, backend, **kw).run(resume=True)
    assert res.resumed
    assert identical_trajectories(eb, res.engines[0])
    assert eb.stats == res.engines[0].stats


# -- idempotency pins (the unit-level contracts behind the parity gate) --------

def _mini_server(problem):
    spec, fleet, _ = problem
    return WorkServer([spec], lease_timeout=8.0 * fleet.base_eval_time,
                      idle_retry=fleet.idle_retry)


def test_duplicate_request_work_leaks_no_second_lease(problem):
    srv = _mini_server(problem)
    srv.handle(protocol.register(0, 0.0, cs=0))
    rep1 = srv.handle(protocol.request_work(0, 1.0, cs=1))
    assert rep1["kind"] == "work"
    rep2 = srv.handle(protocol.request_work(0, 1.0, cs=1))  # duplicated frame
    assert rep2 == rep1                         # cached reply, same wu
    assert srv.counters.leases_issued == 1
    assert len(srv.leases) == 1
    assert srv.counters.duplicates_suppressed == 1


def test_retried_report_casts_one_vote(problem):
    srv = _mini_server(problem)
    srv.handle(protocol.register(0, 0.0, cs=0))
    rep = srv.handle(protocol.request_work(0, 1.0, cs=1))
    msg = protocol.report_result(0, rep["search"], rep["wu"], 1.5, 2.0,
                                 cs=2)
    before = srv.counters.messages
    ack1 = srv.handle(msg)
    ack2 = srv.handle(dict(msg))                # the retry after a lost reply
    assert ack2 == ack1
    assert srv.counters.messages == before + 1  # applied exactly once
    assert srv.registry.hosts[0].returned == 1
    assert srv.counters.duplicates_suppressed == 1


def test_stale_duplicate_is_refused_with_echo(problem):
    srv = _mini_server(problem)
    srv.handle(protocol.register(0, 0.0, cs=0))
    srv.handle(protocol.request_work(0, 1.0, cs=1))
    rep = srv.handle(protocol.request_work(0, 6.0, cs=0))  # below the window
    assert rep["kind"] == "error"
    assert rep["cs"] == 0 and rep["host_id"] == 0   # reply-matching keys
    assert srv.counters.stale_duplicates == 1


def test_duplicate_report_after_lapse_not_counted_twice(problem):
    """Satellite fix: a host re-reporting work whose lease records are
    already gone (first report raced a lapse, or the ack was lost beyond
    the cs window) is a benign retransmit — it must be classified as
    ``duplicate_reports``, not protocol misuse, and must NEVER inflate
    the registry's ``returned`` reliability numerator."""
    srv = _mini_server(problem)
    srv.handle(protocol.register(0, 0.0, cs=0))
    rep = srv.handle(protocol.request_work(0, 1.0, cs=1))
    report = protocol.report_result(0, rep["search"], rep["wu"], 1.5, 2.0)
    srv.handle({**report, "cs": 2})
    assert srv.registry.hosts[0].returned == 1
    # the same result again under a NEW cs: the (host, cs) window has
    # moved on, the lease tables no longer know the wu — only the
    # settled-work memory can recognize it
    srv.handle({**report, "cs": 3, "now": 3.0})
    assert srv.counters.duplicate_reports == 1
    assert srv.counters.unknown_results == 0
    assert srv.registry.hosts[0].returned == 1  # counted at most once


def test_unknown_result_still_flagged(problem):
    """The lapse fix must not swallow real protocol misuse: a result for
    work this server never leased to anyone stays ``unknown_results``."""
    srv = _mini_server(problem)
    srv.handle(protocol.register(0, 0.0, cs=0))
    srv.handle(protocol.report_result(0, 0, 999999, 1.5, 1.0, cs=1))
    assert srv.counters.unknown_results == 1
    assert srv.counters.duplicate_reports == 0


# -- malformed-frame fuzz (satellite a) ----------------------------------------

def _recv_reply(sock):
    buf = b""
    while len(buf) < 4:
        chunk = sock.recv(4 - len(buf))
        if not chunk:
            return None                         # clean disconnect
        buf += chunk
    (n,) = struct.unpack(">I", buf)
    payload = b""
    while len(payload) < n:
        chunk = sock.recv(n - len(payload))
        if not chunk:
            return None
        payload += chunk
    return protocol.decode_message(payload)


def test_malformed_frame_fuzz_survival(problem):
    """Seeded garbage into the TCP server: every frame must yield either
    an ``error`` reply or a clean disconnect — never a hang, never a
    crash — and the server must keep serving well-formed traffic after."""
    srv = _mini_server(problem)
    transport = TcpTransport().start(srv.handle)
    rng = np.random.default_rng(0xF022)
    try:
        # well-framed garbage bodies: random codec byte + random bytes —
        # the handler must answer every one with an error reply
        sock = socket.create_connection((transport.host, transport.port),
                                        timeout=30.0)
        for _ in range(32):
            body = bytes(rng.integers(0, 256, int(rng.integers(1, 64)),
                                      dtype=np.uint8))
            sock.sendall(struct.pack(">I", len(body)) + body)
            rep = _recv_reply(sock)
            assert rep is not None and rep["kind"] == "error"
        # valid JSON codec, garbage JSON — still an error reply
        sock.sendall(struct.pack(">I", 9) + bytes([protocol.CODEC_JSON])
                     + b"not json")
        assert _recv_reply(sock)["kind"] == "error"
        # valid JSON, wrong protocol version — error reply
        body = bytes([protocol.CODEC_JSON]) + json.dumps(
            {"kind": "status", "v": 999}).encode()
        sock.sendall(struct.pack(">I", len(body)) + body)
        assert _recv_reply(sock)["kind"] == "error"
        sock.close()
        # an oversized length prefix is unframeable: the stream cannot be
        # resynced, so the contract is a clean disconnect
        sock = socket.create_connection((transport.host, transport.port),
                                        timeout=30.0)
        sock.sendall(struct.pack(">I", protocol.MAX_FRAME + 1) + b"junk")
        assert _recv_reply(sock) is None
        sock.close()
        # a truncated frame followed by close: server-side decoder just
        # discards the fragment
        sock = socket.create_connection((transport.host, transport.port),
                                        timeout=30.0)
        sock.sendall(struct.pack(">I", 1000) + b"\x01partial")
        sock.close()
        # after all of that, a well-formed request succeeds
        conn = TcpConnection(transport.host, transport.port)
        rep = conn.call(protocol.status())
        assert rep["kind"] == "status"
        rep = conn.call(protocol.register(7, 0.0, cs=0))
        assert rep["kind"] == "registered"
        conn.close()
    finally:
        transport.stop()


# -- sqlite eval-cache crash coverage (satellite c) ----------------------------

def test_sqlite_cache_ahead_of_log_restores_warm_and_identical(
        problem, backend, baseline, tmp_path):
    """Kill between a cache commit and the replay-log flush: the cache is
    AHEAD of the log.  Recovery must still be bit-identical (bit-exact
    serving is value-neutral) and warm (the survivor cache serves)."""
    eb = baseline.engines[0]
    spec, fleet, _ = problem
    db = str(tmp_path / "cache.sqlite")
    ckpt = str(tmp_path / "ckpt")
    kw = dict(ckpt_dir=ckpt, snapshot_every=150)
    with pytest.raises(SimulatedCrash):
        ServerSubstrate(
            spec, fleet, backend,
            cache=EvalCache(SqliteCacheStore(db, flush_every=1),
                            fingerprint="chaos_sqlite"),
            max_messages=baseline.pool.messages // 2, **kw).run()
    # simulate the log losing its unflushed suffix while the per-insert-
    # committed sqlite cache kept everything: chop the last replay lines
    log = os.path.join(ckpt, "replay.jsonl")
    with open(log) as f:
        lines = f.readlines()
    assert len(lines) > 8
    with open(log, "w") as f:
        f.writelines(lines[:-5])
    res = ServerSubstrate(
        spec, fleet, backend,
        cache=EvalCache(SqliteCacheStore(db), fingerprint="chaos_sqlite"),
        **kw).run(resume=True)
    assert res.cache["hits"] > 0                # warmed from the survivor
    assert identical_trajectories(eb, res.engines[0])
    assert eb.stats == res.engines[0].stats


# -- chaos over a cached run ---------------------------------------------------

def test_chaos_stats_shared_across_connections():
    stats = ChaosStats()
    assert stats.sent == 0
    p = PRESETS["degraded"]
    assert p.drop_request == 0.10 and p.duplicate == 0.05


# -- across packages ------------------------------------------------------------

@pytest.mark.parametrize("name", sorted(PRESETS))
def test_fault_plans_draw_the_reference_faults(name):
    """Each preset is the reference's, and a plan draws the same faults
    and backoffs as the reference's for every (host, cs, attempt)."""
    mine, theirs = PRESETS[name], j_chaos.PRESETS[name]
    assert mine.to_doc() == theirs.to_doc()
    for host in range(5):
        for cs in range(6):
            for attempt in range(3):
                assert (mine.draws(host, cs, attempt)
                        == theirs.draws(host, cs, attempt))
    for attempt in range(5):
        assert mine.backoff_s(attempt, 0.3) == theirs.backoff_s(attempt, 0.3)
