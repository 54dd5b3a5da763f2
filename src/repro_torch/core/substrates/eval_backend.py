"""Evaluation backends for the batched-grid substrate (DESIGN.md §6–§7).

Port of ``repro/core/substrates/eval_backend.py``.  The batched grid
decides WHICH points a tick evaluates; a backend decides HOW that block of
points turns into fitness values, through an asynchronous two-call
protocol:

    handle = backend.submit(pts, mal_u)    # frame + enqueue, returns now
    ys = backend.collect(handle)           # wait for the device, unpad

On a CUDA device ``submit`` stages the block in a pinned host buffer,
copies it to the device without blocking on the backend's own CUDA
stream, runs ``f_batch`` and the finalization there, copies the bucket's
results back into a pinned host buffer and records an event; ``collect``
waits on that event.  The host overlaps fleet physics and speculative
work generation with the evaluation in between.  On the CPU the same
calls run synchronously.  ``backend(pts, mal_u)`` is
``collect(submit(...))``.

Framing.  Every block of ``k`` points is written into a PERSISTENT
per-bucket staging buffer padded up to a power-of-two bucket (pad lanes
repeat the last real point), so the steady state pays one buffer fill per
tick and no allocation.  The asynchronous host-to-device copy reads the
pinned buffer while the host moves on, so the buffers form a RING
(``STAGING_RING`` deep) per bucket size: consecutive submits of one shape
rotate through distinct buffers, and a ``submit`` that would restage a
slot whose handle is still uncollected raises instead of silently
corrupting it (per-slot ownership tokens, so out-of-order or double
collects cannot defeat the check).  Bucket shapes depend only on the
block size, so a run sees O(log k_max) distinct shapes; ``warm()`` runs
that whole ladder up front, and ``compile_count`` counts the bucket
shapes first run — a warmed backend does not grow it mid-run.

Results come back FINAL (DESIGN.md §7): the finalization applies the
sign-safe malicious corruption ``grid.malicious_lie`` to the lanes whose
``mal_u`` draw is non-NaN and masks the pad lanes to NaN on the device,
so ``collect`` never patches values on the host.
"""
from __future__ import annotations

from typing import Any, Callable, NamedTuple, Optional

import numpy as np
import torch

from repro_torch.core.grid import malicious_lie

#: THE bucket floor: blocks smaller than this are padded up to it so tiny
#: phases (the bootstrap probe, quorum replicas) share one small shape.
DEFAULT_MIN_BUCKET = 8

#: staging buffers per bucket shape.  An asynchronous host-to-device copy
#: reads its pinned buffer after ``submit`` returns, so a buffer must not
#: be restaged while its bucket is in flight; a ring this deep supports up
#: to STAGING_RING simultaneously in-flight buckets of one shape.
STAGING_RING = 8


def bucket_size(k: int, min_bucket: int = DEFAULT_MIN_BUCKET) -> int:
    """Smallest power of two ≥ max(k, min_bucket).  ``min_bucket`` must be
    a power of two."""
    if min_bucket & (min_bucket - 1):
        raise ValueError(f"min_bucket must be a power of two, got {min_bucket}")
    return max(min_bucket, 1 << max(k - 1, 0).bit_length())


class EvalHandle(NamedTuple):
    """An in-flight bucket evaluation returned by ``EvalBackend.submit``.

    ``ys`` is the (kp,) f32 host tensor the bucket's results land in (the
    staging slot's output buffer, written asynchronously on CUDA until
    ``event`` has completed).  ``k`` is the number of real lanes, ``kp``
    the padded bucket width, ``slot`` the staging-ring slot the bucket
    owns until collected, and ``seq`` the submission's ownership token for
    that slot (a stale or double ``collect`` must not free a slot now
    owned by a newer submission).  ``event`` is the CUDA event recorded
    after the copy back, ``None`` on the CPU; on a mesh over ranks, the
    all-gather in flight (``pod_mesh.Gathered``).  ``collect`` calls its
    ``synchronize()``.  ``tags`` is the per-lane
    submitter-id array shipped with a coalesced multi-search bucket
    (DESIGN.md §8): host-side framing metadata saying which search owns
    each lane, never read by the device computation and not the demux
    mechanism either (consumers slice by lane offsets).  ``None`` for
    single-submitter buckets.  ``kept`` holds the values once collected:
    the slot is free from then on and a newer bucket may overwrite ``ys``,
    so a second collect (the orchestrator's ring guard drains a handle
    early, its grid collects it again later) reads them from here.
    """
    ys: Any
    k: int
    kp: int
    slot: int
    seq: int
    event: Any = None
    tags: Any = None
    kept: Optional[list] = None


class _Slot(NamedTuple):
    """One staging-ring entry: host tensors (pinned on CUDA) and numpy
    views of the two inputs for filling them."""
    pts: torch.Tensor                 # (kp, n) f32
    u: torch.Tensor                   # (kp,) f32, NaN == honest lane
    out: torch.Tensor                 # (kp,) f32 results
    pts_np: np.ndarray
    u_np: np.ndarray


class EvalBackend:
    """Base class: persistent-buffer bucket framing + on-device result
    finalization around a subclass evaluation.

    Subclasses implement ``_raw_eval((kp, n) f32 device tensor) -> (kp,)
    fitness`` for ``kp`` already padded to a power of two.  This class
    owns padding, the copies, the malicious-corruption lanes and pad-lane
    NaN masking, so every backend frames and finalizes blocks identically
    (the same engine seed must commit the same iterates, pipelined or
    not).
    """

    def __init__(self, min_bucket: int = DEFAULT_MIN_BUCKET, device="cuda"):
        if min_bucket < 1 or (min_bucket & (min_bucket - 1)):
            raise ValueError(
                f"min_bucket must be a power of two >= 1, got {min_bucket}")
        self.min_bucket = min_bucket
        self.device = torch.device(device)
        self._cuda = self.device.type == "cuda"
        # the dedicated stream buckets are copied and evaluated on
        self._stream = torch.cuda.Stream(self.device) if self._cuda else None
        self._bufs: dict = {}            # kp -> ring of _Slot
        self._ring: dict = {}            # kp -> next ring slot
        self._slot_owner: dict = {}      # kp -> per-slot owning seq (or None)
        self._submit_seq = 0             # ownership tokens for ring slots
        self._ran: set = set()           # (n_dims, kp) already run once
        #: lanes evaluated, pad lanes and the warm-up included (each one
        #: ``_raw_eval`` row): what a kernel count per lane is held to
        self.lanes_evaluated = 0
        #: number of bucket shapes first run — a warmed backend must not
        #: grow this mid-run (the zero-compile probe in the tests)
        self.compile_count = 0

    # -- subclass seam -------------------------------------------------------

    def _raw_eval(self, pts: torch.Tensor) -> torch.Tensor:
        """(kp, n) f32 bucket on the device -> (kp,) fitness."""
        raise NotImplementedError

    def _own_lanes(self, kp: int) -> tuple:
        """The lanes [lo, hi) of a bucket of ``kp`` this process evaluates:
        all of them, but on a mesh over ranks (``pod_mesh.OverRanks``)."""
        return 0, kp

    def _deliver(self, ys: torch.Tensor, out: torch.Tensor, stream):
        """Put the evaluated lanes ``ys`` into the slot's host buffer
        ``out`` (on ``stream``, None on the CPU).  Returns what marks
        them there: a CUDA event, or None where the copy is done."""
        if stream is None:
            out.copy_(ys)
            return None
        out.copy_(ys, non_blocking=True)
        event = torch.cuda.Event()
        event.record(stream)
        return event

    def _finalize(self, pts: torch.Tensor, u: torch.Tensor,
                  k: int) -> torch.Tensor:
        ys = self._raw_eval(pts).to(torch.float32)
        # malicious corruption as mask lanes: NaN u == honest lane
        ys = torch.where(torch.isnan(u), ys, malicious_lie(ys, u))
        # pad lanes come back NaN from the device — results are final on
        # arrival, never patched on the host
        ys[k:] = float("nan")
        return ys

    def _run_bucket(self, slot: _Slot, k: int):
        """Evaluate this process's lanes of a staged slot into its output
        buffer.  Returns what ``_deliver`` returns: the CUDA event that
        marks the results ready (None on the CPU, where the call is
        synchronous)."""
        key = tuple(slot.pts.shape[::-1])            # (n_dims, kp)
        if key not in self._ran:
            self._ran.add(key)
            self.compile_count += 1
        lo, hi = self._own_lanes(key[1])
        self.lanes_evaluated += hi - lo
        real = max(k - lo, 0)                        # own lanes before pads
        if not self._cuda:
            return self._deliver(
                self._finalize(slot.pts[lo:hi], slot.u[lo:hi], real),
                slot.out, None)
        stream = self._stream
        # order after the caller's work on its stream (the fitness'
        # resident tensors were made there)
        stream.wait_stream(torch.cuda.current_stream(self.device))
        with torch.cuda.stream(stream):
            pts = slot.pts[lo:hi].to(self.device, non_blocking=True)
            u = slot.u[lo:hi].to(self.device, non_blocking=True)
            return self._deliver(self._finalize(pts, u, real), slot.out,
                                 stream)

    # -- framing -------------------------------------------------------------

    def _new_slot(self, kp: int, n: int) -> _Slot:
        pin = self._cuda
        pts = torch.zeros((kp, n), dtype=torch.float32, pin_memory=pin)
        u = torch.full((kp,), float("nan"), dtype=torch.float32,
                       pin_memory=pin)
        out = torch.empty((kp,), dtype=torch.float32, pin_memory=pin)
        return _Slot(pts, u, out, pts.numpy(), u.numpy())

    def _staging(self, kp: int, n: int) -> int:
        """Next slot index in the bucket's ring.  The rotation is what makes
        restaging safe while earlier buckets are in flight — and a slot
        whose bucket is STILL uncollected refuses to restage."""
        ring = self._bufs.get(kp)
        if ring is None or ring[0].pts.shape[1] != n:
            self._bufs[kp] = [self._new_slot(kp, n)
                              for _ in range(STAGING_RING)]
            self._ring[kp] = 0
            self._slot_owner[kp] = [None] * STAGING_RING
        slot = self._ring[kp]
        if self._slot_owner[kp][slot] is not None:
            raise RuntimeError(
                f"an uncollected submission still owns staging slot "
                f"{slot} of bucket shape {kp} (ring depth {STAGING_RING}); "
                f"collect() in-flight handles before submitting more")
        self._ring[kp] = (slot + 1) % STAGING_RING
        return slot

    def warm(self, n_dims: int, max_k: int) -> "EvalBackend":
        """Run the whole bucket ladder (min_bucket up to
        ``bucket_size(max_k)``) once, so no bucket shape is first run
        mid-run, and preallocate the persistent staging buffers.
        Idempotent: shapes already run are skipped."""
        kp = bucket_size(1, self.min_bucket)
        top = bucket_size(max_k, self.min_bucket)
        ran = []
        while True:
            if (n_dims, kp) not in self._ran:
                i = self._staging(kp, n_dims)
                ran.append(self._run_bucket(self._bufs[kp][i], kp))
            if kp >= top:
                break
            kp *= 2
        for done in ran:
            if done is not None:
                done.synchronize()
        return self

    # -- the async protocol --------------------------------------------------

    def submit(self, pts: np.ndarray,
               mal_u: Optional[np.ndarray] = None,
               lane_tags: Optional[np.ndarray] = None) -> EvalHandle:
        """Frame a (k, n) block into its bucket and start the evaluation.
        ``mal_u``: per-lane malicious draw in [0.2, 0.8], NaN for honest
        lanes (None == all honest).  ``lane_tags``: optional (k,) per-lane
        submitter ids for coalesced multi-search buckets, carried on the
        handle (the device computation never sees them: lanes are
        row-independent, which is why coalescing is safe).  Returns at
        once; pass the handle to ``collect`` for the values."""
        k, n = pts.shape
        kp = bucket_size(k, self.min_bucket)
        i = self._staging(kp, n)
        slot = self._bufs[kp][i]
        self._submit_seq += 1
        self._slot_owner[kp][i] = self._submit_seq
        slot.pts_np[:k] = pts
        slot.u_np[:k] = np.nan if mal_u is None else mal_u
        if kp != k:
            slot.pts_np[k:] = slot.pts_np[k - 1]
            slot.u_np[k:] = np.nan
        event = self._run_bucket(slot, k)
        return EvalHandle(slot.out, k, kp, i, self._submit_seq, event,
                          None if lane_tags is None
                          else np.asarray(lane_tags), [])

    def collect(self, handle: EvalHandle) -> np.ndarray:
        """Wait for a submitted bucket, free its staging slot, and strip the
        pad lanes.  The slot is freed only if this handle still OWNS it — a
        double collect, or one stale across a ring reallocation, must not
        clear the flag guarding a newer in-flight submission, nor read the
        values that submission wrote into the freed slot."""
        if handle.kept:
            return handle.kept[0].copy()
        if handle.event is not None:
            handle.event.synchronize()
        ys = handle.ys.numpy()[:handle.k].astype(np.float64)
        owners = self._slot_owner.get(handle.kp)
        if owners is not None and owners[handle.slot] == handle.seq:
            owners[handle.slot] = None
        if handle.kept is not None:
            handle.kept.append(ys.copy())
        return ys

    def __call__(self, pts: np.ndarray,
                 mal_u: Optional[np.ndarray] = None) -> np.ndarray:
        return self.collect(self.submit(pts, mal_u))


class InProcessEvalBackend(EvalBackend):
    """Default backend: the bucket is one ``f_batch`` call on ``device``.

    f_batch: (kp, n) f32 tensor on ``device`` -> (kp,) fitness.  Pass
    ``n_dims`` + ``max_bucket`` to warm the bucket ladder at construction.
    """

    def __init__(self, f_batch: Callable,
                 min_bucket: int = DEFAULT_MIN_BUCKET, *,
                 n_dims: Optional[int] = None,
                 max_bucket: Optional[int] = None, device="cuda"):
        self.f_batch = f_batch
        super().__init__(min_bucket, device)
        if n_dims is not None and max_bucket is not None:
            self.warm(n_dims, max_bucket)

    def _raw_eval(self, pts):
        return self.f_batch(pts)
