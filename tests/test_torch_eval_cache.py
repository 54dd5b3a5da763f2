"""The port's persistent cross-search evaluation cache (DESIGN.md §10).

The reference's tests/test_eval_cache.py, port against port on the CPU,
less its pod_mesh case (the port has no pod-mesh backend yet: ROADMAP
A.6); then the port against the reference: ``canonical_block`` keys are
byte-identical and a JSONL store written by either package serves the
other.  The contracts under test:

  * bit-exact-only serving — cache-on runs commit bit-identical iterates
    and identical final ``EngineStats`` to cache-off runs, solo and in a
    coalesced multi-search portfolio, on both evaluation backends;
  * key canonicalization — NaN payloads and -0.0 collapse to one key,
    float64 points share the key of their staged f32 row, and the
    objective fingerprint isolates caches sharing one store;
  * malicious lanes are NEVER cached and NEVER served (quorum validation
    must keep re-evaluating suspect results);
  * persistence — JSONL/sqlite stores round-trip float64 exactly, survive
    a SIGKILL-torn tail, and compose with the checkpoint layer so a
    crashed-and-restored server comes back warm AND bit-identical;
  * the coalescer's intra-bucket dedup evaluates identical honest lanes
    once without changing what any search observes.
"""
import dataclasses
import functools
import struct

import numpy as np
import pytest
import torch

from repro_torch.core.anm import AnmConfig
from repro_torch.core.engine import AnmEngine, identical_trajectories
from repro_torch.core.grid import GridConfig
from repro_torch.core.orchestrator import (CoalescingSubmitter, FleetScheduler,
                                     SearchDirector, multi_start_specs)
from repro_torch.core.substrates.batched_grid import BatchedVolunteerGrid
from repro_torch.core.substrates.eval_backend import InProcessEvalBackend
from repro_torch.core.substrates.eval_cache import (CachingSubmitter, EvalCache,
                                              JsonlCacheStore,
                                              MemoryCacheStore,
                                              SqliteCacheStore,
                                              canonical_block)
from repro.core.substrates import eval_cache as j_eval_cache

pytestmark = pytest.mark.cache

#: the port's constructors with the fitness and the engines on the CPU
InProcessEvalBackend = functools.partial(InProcessEvalBackend, device="cpu")
AnmEngine = functools.partial(AnmEngine, device="cpu")


def _quad_fitness(n=8, seed=3):
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

    return f_batch, n


def _f32(bits: int) -> np.float32:
    return np.frombuffer(struct.pack("<I", bits), np.float32)[0]


# -- key canonicalization -----------------------------------------------------

def test_negative_zero_and_zero_share_a_key():
    c = EvalCache(fingerprint="z")
    assert c.key(np.array([0.0, 1.0])) == c.key(np.array([-0.0, 1.0]))


def test_nan_payloads_collapse_to_one_key():
    """Quiet NaN, payload-carrying NaN and negative NaN canonicalize to
    the same staged bytes — the objective cannot distinguish them, so the
    cache must not either."""
    nans = [_f32(0x7FC00000), _f32(0x7FC00ABC), _f32(0xFFC00000)]
    rows = [np.array([v, np.float32(1.0)], np.float32) for v in nans]
    blocks = [canonical_block(r).tobytes() for r in rows]
    assert blocks[0] == blocks[1] == blocks[2]


def test_float64_points_key_on_their_staged_f32_row():
    """The backend stages float32 (``buf[:k] = pts``), so two float64
    points that round to the same f32 row are the SAME evaluation —
    and two that round differently are not."""
    c = EvalCache(fingerprint="f")
    assert c.key(np.array([0.1])) == \
        c.key(np.array([float(np.float32(0.1))]))
    next_f32 = float(np.nextafter(np.float32(0.1), np.float32(2.0)))
    assert c.key(np.array([0.1])) != c.key(np.array([next_f32]))


def test_fingerprint_isolates_objectives_sharing_one_store():
    store = MemoryCacheStore()
    a = EvalCache(store, fingerprint="objective-a")
    b = EvalCache(store, fingerprint="objective-b")
    pt = np.ones(4)
    store.put(a.key(pt), 42.0)
    assert store.get(a.key(pt)) == 42.0
    assert store.get(b.key(pt)) is None


# -- the memo layer ------------------------------------------------------------

def test_hits_strip_lanes_shrink_buckets_and_splice_back():
    f_batch, n = _quad_fitness()
    be = InProcessEvalBackend(f_batch, n_dims=n, max_bucket=64)
    ref_be = InProcessEvalBackend(f_batch, n_dims=n, max_bucket=64)
    dispatched = []
    orig = be.submit
    be.submit = lambda *a, **k: (dispatched.append(len(a[0])),
                                 orig(*a, **k))[1]
    cs = CachingSubmitter(be, EvalCache(fingerprint="t"))
    pts = np.random.default_rng(0).normal(size=(24, n))
    y1 = cs(pts)
    assert np.array_equal(y1, ref_be(pts))
    assert np.array_equal(y1, cs(pts))
    # third submit is fully served: no dispatch at all, handle width 0
    h = cs.submit(pts)
    assert h.inner is None and h.kp == 0
    assert np.array_equal(cs.collect(h), y1)
    # a half-new bucket dispatches ONLY the misses, at the smaller width
    mixed = np.concatenate([pts[:20], pts[:4] + 100.0])
    hm = cs.submit(mixed)
    assert dispatched[-1] == 4 and hm.kp == 8   # 24 lanes -> 4, bucket 8
    ym = cs.collect(hm)
    assert np.array_equal(ym, ref_be(mixed))
    st = cs.cache.stats
    assert st.hits == 24 + 24 + 20 and st.full_buckets == 2
    assert st.hit_rate() > 0.5


def test_malicious_lanes_are_never_cached_and_never_served():
    """THE quorum pin: a mal_u lane must bypass the cache both ways —
    its corrupted value never lands in the store, and a stored honest
    value is never served in its place."""
    f_batch, n = _quad_fitness()
    be = InProcessEvalBackend(f_batch, n_dims=n, max_bucket=16)
    cache = EvalCache(fingerprint="mal")
    cs = CachingSubmitter(be, cache)
    pts = np.random.default_rng(1).normal(size=(8, n))
    honest = cs(pts)                       # seeds the cache honestly
    size0 = len(cache)
    mal_u = np.full(8, np.nan)
    mal_u[3] = 0.5
    served = cs(pts, mal_u)
    # the mal lane carries the on-device lie, not the cached honest value
    ref = be(pts, mal_u)
    assert np.array_equal(served, ref)
    assert served[3] != honest[3]
    # ... and the lie was not stored
    assert len(cache) == size0
    assert cache.stats.mal_bypassed == 1


def test_status_doc_reports_the_satellite_counters():
    cache = EvalCache(fingerprint="doc")
    doc = cache.status()
    assert {"hits", "misses", "lanes_saved", "store_size",
            "hit_rate"} <= set(doc)
    assert doc["lanes_saved"] == doc["hits"] == 0


# -- run-level parity: cache-on == cache-off ----------------------------------

def _solo(backend, anm, grid_cfg, n, seed=7):
    engine = AnmEngine(np.ones(n), -10 * np.ones(n), 10 * np.ones(n),
                       0.5 * np.ones(n), anm, seed=seed)
    BatchedVolunteerGrid(None, grid_cfg, backend=backend,
                         pipelined=True).run(engine)
    return engine


def test_cached_solo_run_matches_uncached_bit_identically():
    f_batch, n = _quad_fitness()
    be = InProcessEvalBackend(f_batch)
    anm = AnmConfig(m_regression=24, m_line_search=24, max_iterations=3)
    grid_cfg = GridConfig(n_hosts=256, failure_prob=0.1,
                          malicious_prob=0.02, seed=5)
    e_off = _solo(be, anm, grid_cfg, n)
    cs = CachingSubmitter(be, EvalCache(fingerprint="solo"))
    e_on = _solo(cs, anm, grid_cfg, n)
    assert identical_trajectories(e_off, e_on)
    assert e_off.stats == e_on.stats
    # the warm rerun serves (nearly) everything and STILL matches
    misses0 = cs.cache.stats.misses
    e_warm = _solo(cs, anm, grid_cfg, n)
    assert identical_trajectories(e_off, e_warm)
    assert e_off.stats == e_warm.stats
    assert cs.cache.stats.misses == misses0     # zero new evaluations
    assert cs.cache.stats.hits > 0


@pytest.mark.parametrize("make_backend", [
    lambda f: InProcessEvalBackend(f),
], ids=["in_process"])
def test_cached_portfolio_matches_uncached_on_both_backends(make_backend):
    """8-search coalesced portfolio, cache below the coalescer: every
    search must commit bit-identical iterates and identical final stats
    to the cache-off portfolio on the same backend."""
    f_batch, n = _quad_fitness()
    backend = make_backend(f_batch)
    fleet = GridConfig(n_hosts=512, failure_prob=0.1,
                       malicious_prob=0.02, seed=3)
    anm = AnmConfig(m_regression=16, m_line_search=16, max_iterations=2)

    def portfolio(cache):
        sched = FleetScheduler(backend, fleet, cache=cache)
        specs = multi_start_specs(sched, np.ones(n), -10 * np.ones(n),
                                  10 * np.ones(n), 0.5 * np.ones(n), anm,
                                  8, seed=0, jitter=0.3)
        return SearchDirector(sched, specs).run()

    off = portfolio(None)
    cache = EvalCache(fingerprint="portfolio")
    on = portfolio(cache)
    for a, b in zip(off.outcomes, on.outcomes):
        assert identical_trajectories(a.engine, b.engine)
        assert a.engine.stats == b.engine.stats
    # warm rerun: the whole portfolio replays out of the cache
    misses0 = cache.stats.misses
    warm = portfolio(cache)
    for a, b in zip(off.outcomes, warm.outcomes):
        assert identical_trajectories(a.engine, b.engine)
        assert a.engine.stats == b.engine.stats
    assert cache.stats.misses == misses0
    assert cache.stats.hits > 0 and cache.stats.full_buckets > 0


def test_uncoalesced_cached_scheduler_matches_solo():
    """The cache also rides the uncoalesced path (shared ring guard over
    the caching submitter)."""
    f_batch, n = _quad_fitness()
    be = InProcessEvalBackend(f_batch)
    fleet = GridConfig(n_hosts=256, failure_prob=0.1,
                       malicious_prob=0.02, seed=3)
    anm = AnmConfig(m_regression=16, m_line_search=16, max_iterations=2)
    sched = FleetScheduler(be, fleet, coalesce=False,
                           cache=EvalCache(fingerprint="unco"))
    specs = multi_start_specs(sched, np.ones(n), -10 * np.ones(n),
                              10 * np.ones(n), 0.5 * np.ones(n), anm,
                              4, seed=0, jitter=0.3)
    res = SearchDirector(sched, specs).run()
    for o in res.outcomes:
        solo = o.spec.solo_run(be)
        assert identical_trajectories(o.engine, solo)
        assert o.engine.stats == solo.stats


# -- intra-bucket dedup (coalescer satellite) ---------------------------------

def test_coalescer_dedups_identical_honest_lanes_across_searches():
    f_batch, n = _quad_fitness()
    be = InProcessEvalBackend(f_batch, n_dims=n, max_bucket=64)
    co = CoalescingSubmitter(be)
    pts = np.random.default_rng(2).normal(size=(6, n))
    s0, s1 = co.lane_submitter(0), co.lane_submitter(1)
    l0 = s0.submit(pts)
    l1 = s1.submit(pts.copy())             # identical points, other search
    co.flush()
    y0, y1 = s0.collect(l0), s1.collect(l1)
    ref = be(pts)
    assert np.array_equal(y0, ref) and np.array_equal(y1, ref)
    assert co.stats.lanes_deduped == 6
    assert l0.kp == 8                      # 12 lanes dispatched as 6


def test_dedup_never_merges_malicious_lanes():
    f_batch, n = _quad_fitness()
    be = InProcessEvalBackend(f_batch, n_dims=n, max_bucket=64)
    co = CoalescingSubmitter(be)
    pts = np.random.default_rng(4).normal(size=(4, n))
    mal = np.full(4, np.nan)
    mal[0] = 0.5
    s0, s1 = co.lane_submitter(0), co.lane_submitter(1)
    l0 = s0.submit(pts, mal)               # lane 0 malicious
    l1 = s1.submit(pts.copy())             # all honest duplicates
    co.flush()
    y0, y1 = s0.collect(l0), s1.collect(l1)
    # the mal lane keeps its own lie; its honest twin gets the true value
    assert np.array_equal(y0, be(pts, mal))
    assert np.array_equal(y1, be(pts))
    assert y0[0] != y1[0]
    assert co.stats.lanes_deduped == 3     # the mal pair never merged


def test_deduped_portfolio_still_matches_solo_runs():
    """Two searches with the SAME engine seed and start submit identical
    early blocks — dedup fires, and both searches still commit exactly
    their solo trajectories."""
    f_batch, n = _quad_fitness()
    be = InProcessEvalBackend(f_batch)
    fleet = GridConfig(n_hosts=256, failure_prob=0.1,
                       malicious_prob=0.02, seed=3)
    anm = AnmConfig(m_regression=16, m_line_search=16, max_iterations=2)
    sched = FleetScheduler(be, fleet)
    specs = multi_start_specs(sched, np.ones(n), -10 * np.ones(n),
                              10 * np.ones(n), 0.5 * np.ones(n), anm,
                              2, seed=0, jitter=0.0)
    specs = [dataclasses.replace(s, engine_seed=7) for s in specs]
    res = SearchDirector(sched, specs).run()
    assert res.coalesce_stats.lanes_deduped > 0
    for o in res.outcomes:
        solo = o.spec.solo_run(be)
        assert identical_trajectories(o.engine, solo)
        assert o.engine.stats == solo.stats


# -- persistence --------------------------------------------------------------

def _fill(store, cache, values):
    for i, v in enumerate(values):
        store.put(cache.key(np.full(3, float(i))), v)


def test_jsonl_store_round_trips_exact_float64(tmp_path):
    path = str(tmp_path / "cache.jsonl")
    cache = EvalCache(fingerprint="p")
    values = [0.1, -1.0 / 3.0, 1e-300, 4503599627370497.0]
    store = JsonlCacheStore(path, flush_every=2)
    _fill(store, cache, values)
    store.close()
    loaded = JsonlCacheStore(path)
    for i, v in enumerate(values):
        got = loaded.get(cache.key(np.full(3, float(i))))
        assert got == v and np.float64(got).tobytes() == \
            np.float64(v).tobytes()
    assert len(loaded) == len(values)
    loaded.close()


def test_jsonl_store_tolerates_and_repairs_a_torn_tail(tmp_path):
    path = str(tmp_path / "cache.jsonl")
    cache = EvalCache(fingerprint="torn")
    store = JsonlCacheStore(path)
    _fill(store, cache, [1.0, 2.0, 3.0])
    store.close()
    with open(path, "a") as f:
        f.write('{"k": "dead')           # the kill's half-append
    survivor = JsonlCacheStore(path)
    assert len(survivor) == 3
    # the torn fragment was truncated: new appends start on a fresh line
    survivor.put(cache.key(np.full(3, 9.0)), 9.0)
    survivor.close()
    assert len(JsonlCacheStore(path)) == 4


def test_sqlite_store_round_trips(tmp_path):
    path = str(tmp_path / "cache.sqlite")
    cache = EvalCache(fingerprint="sq")
    store = SqliteCacheStore(path, flush_every=2)
    _fill(store, cache, [0.1, 7.0])
    assert store.put(cache.key(np.full(3, 0.0)), 99.0) is False  # absent-only
    store.close()
    loaded = SqliteCacheStore(path)
    assert loaded.get(cache.key(np.full(3, 0.0))) == 0.1
    assert len(loaded) == 2
    loaded.close()


# -- server composition: warm cache after crash + restore ---------------------

@pytest.mark.server
def test_crashed_server_restores_warm_and_bit_identical(tmp_path):
    """The §10 recovery contract: a crashed run's cache store survives in
    the checkpoint dir; the restored process warms from it, serves the
    re-leased in-flight points it already paid for, and still commits
    bit-identical iterates to an uninterrupted cache-off run."""
    from repro_torch.server import protocol
    from repro_torch.server.checkpoint import eval_cache_path
    from repro_torch.server.server import WorkServer
    from repro_torch.server.sim import (ServerSubstrate, SimulatedCrash,
                                  smoke_problem)

    spec, fleet, f_batch = smoke_problem(n_stars=120, n_hosts=64, m=12,
                                         iterations=3, device="cpu")
    be = InProcessEvalBackend(f_batch)
    base = ServerSubstrate(spec, fleet, be).run()

    ckpt = str(tmp_path / "ckpt")
    fp = "smoke-cache"
    crashed = EvalCache(JsonlCacheStore(eval_cache_path(ckpt)),
                        fingerprint=fp)
    sub = ServerSubstrate(
        spec, fleet, be, ckpt_dir=ckpt, snapshot_every=50,
        max_messages=int(0.4 * base.pool.messages), cache=crashed)
    with pytest.raises(SimulatedCrash):
        sub.run()
    assert crashed.stats.stores > 0

    # a fresh process: reload the surviving store from the checkpoint dir
    warm = EvalCache(JsonlCacheStore(eval_cache_path(ckpt)),
                     fingerprint=fp)
    assert len(warm.store) > 0
    sub2 = ServerSubstrate(spec, fleet, be, ckpt_dir=ckpt,
                           snapshot_every=50, cache=warm)
    res = sub2.run(resume=True)
    assert identical_trajectories(res.engines[0], base.engines[0])
    assert res.engines[0].stats == base.engines[0].stats
    assert warm.stats.hits > 0              # the warm cache actually served
    assert res.cache["hits"] == warm.stats.hits

    # ... and the wire status surfaces the counters (satellite)
    srv = WorkServer([spec])
    assert srv.handle(protocol.status())["cache"] is None
    srv.attach_cache(warm)
    assert srv.handle(protocol.status())["cache"] == warm.status()


# -- across packages ------------------------------------------------------------

@pytest.mark.parametrize("seed", [0, 1, 2])
def test_canonical_keys_are_byte_identical_across_packages(seed):
    """The same points (float64, f32, NaN payloads, -0.0) give the same
    staged bytes and the same cache keys in both packages."""
    rng = np.random.default_rng(seed)
    pts = rng.normal(size=(16, 8))
    pts[0, 0], pts[1, 1], pts[2, 2] = -0.0, np.nan, float(np.float32(0.1))
    pts[3] = np.frombuffer(struct.pack("<I", 0x7FC00ABC), np.float32)[0]
    assert (canonical_block(pts).tobytes()
            == j_eval_cache.canonical_block(pts).tobytes())
    mine = EvalCache(fingerprint="across")
    theirs = j_eval_cache.EvalCache(fingerprint="across")
    assert mine.key_block(pts) == theirs.key_block(pts)
    assert [mine.key(p) for p in pts] == [theirs.key(p) for p in pts]


@pytest.mark.parametrize("writer", ["reference", "port"])
def test_jsonl_store_is_read_across_packages(tmp_path, writer):
    """A JSONL store one package writes serves the other the same exact
    float64 values under the same keys."""
    path = str(tmp_path / "cache.jsonl")
    pkgs = {"reference": j_eval_cache, "port": None}
    w = pkgs[writer]
    w_store = (w.JsonlCacheStore(path) if w is not None
               else JsonlCacheStore(path))
    w_cache = (w.EvalCache(w_store, fingerprint="x") if w is not None
               else EvalCache(w_store, fingerprint="x"))
    pts = np.random.default_rng(5).normal(size=(6, 3))
    values = [0.1, -1.0 / 3.0, 1e-300, 4503599627370497.0, 2.5, -7.0]
    for p, v in zip(pts, values):
        w_store.put(w_cache.key(p), v)
    w_store.close()
    r_store = (JsonlCacheStore(path) if w is not None
               else j_eval_cache.JsonlCacheStore(path))
    r_cache = (EvalCache(r_store, fingerprint="x") if w is not None
               else j_eval_cache.EvalCache(r_store, fingerprint="x"))
    for p, v in zip(pts, values):
        got = r_store.get(r_cache.key(p))
        assert np.float64(got).tobytes() == np.float64(v).tobytes()
    r_store.close()
