"""Pod-mesh evaluation backend: each bucket split over the mesh's data axis.

Port of ``repro/core/substrates/pod_mesh.py``.  Instead of evaluating a
tick's workunit block with one ``f_batch`` call, ``PodMeshEvalBackend``
splits the padded bucket over the ``data`` axis of a mesh
(``launch/mesh.py``) into ``n_shards`` contiguous row blocks of
``kp / n_shards`` rows, the reference's ``P(data, None)`` layout, and
evaluates each block as one shard.  The ``model`` axis is left to the
fitness: it replicates, so one replica's rows are the result
(``out_specs=P(data)``).

The reference runs the shards in parallel with ``shard_map`` from one
controller.  The port runs them in one of two ways:

  * one process: the shards in order on the backend's stream, their rows
    concatenated.  The mesh's devices must all be the backend's device
    (the (1, 1) mesh of one GPU, and ``virtual_devices`` meshes up to the
    production 16 × 16); a one-process mesh over distinct GPUs is refused;
  * over ranks (``Mesh.over_ranks``, ``launch/ranks.py``): every rank runs
    the same engine and grid from the same seeds (SPMD), evaluates only
    its own shards' row blocks on its own device, and an all-gather of
    the finalized lanes assembles the (kp,) result in rank order, so
    every rank holds the bytes the one-process concatenation gives and
    commits the same iterates.  ``submit`` issues the all-gather without
    waiting and ``collect`` waits for it (``OverRanks``); every rank
    issues its collectives in the same order, the grid's.

What the backend keeps from the reference (DESIGN.md §6):

  * buckets are powers of two with a floor of 4 rows a shard
    (``bucket_size(4 * n_shards)``), so every shard gets the same whole
    number of rows and the bucket ladder is the reference's;
  * remainder lanes are padded with the last real point and come back
    NaN-masked by the shared finalization, never dropped;
  * rows are evaluated by the SAME per-row computation as in-process, so
    a given engine seed commits bit-identical iterates on either backend,
    provided a lane's value depends on its own bytes alone (ROADMAP note
    (a): the SDSS fitness's fixed-order row means make it so).
"""
from __future__ import annotations

from typing import Callable, Optional

import torch
import torch.distributed as dist

from repro_torch.core.substrates.eval_backend import EvalBackend, bucket_size
from repro_torch.launch.mesh import (Mesh, canonical_device,
                                     make_production_mesh, visible_devices)


def make_data_mesh(device="cuda") -> Mesh:
    """Best evaluation mesh for the visible devices of ``device``'s type:
    the production pod when enough exist, else the largest power-of-two
    data-parallel mesh that fits, down to a degenerate (1, 1) mesh (one
    GPU, or the CPU).  When a ``torch.distributed`` group is up, the
    devices are its ranks', one a rank (every rank must call this, as it
    gathers each rank's ``device``): the (world, 1) mesh over
    ranks."""
    if dist.is_available() and dist.is_initialized():
        world = dist.get_world_size()
        names = [None] * world
        dist.all_gather_object(names, str(canonical_device(device)))
        return Mesh.over_ranks((world, 1), ("data", "model"),
                               rank=dist.get_rank(), rank_devices=names)
    devices = visible_devices(device)
    if not devices:
        raise RuntimeError(f"no {torch.device(device).type} device is "
                           f"visible")
    try:
        return make_production_mesh(devices=devices)
    except RuntimeError:
        d = 1 << (len(devices).bit_length() - 1)
        return Mesh((d, 1), ("data", "model"), devices[:d])


def data_shards(mesh: Mesh, data_axis: str = "data") -> int:
    """The size of the mesh's data axis, which must be a power of two to
    divide the power-of-two buckets."""
    n = int(mesh.shape[data_axis])
    if n & (n - 1):
        raise ValueError(f"data axis must be a power of two to divide the "
                         f"power-of-two buckets, got {n}")
    return n


class Gathered:
    """A bucket's lanes in flight over ranks: this rank's block was sent
    in an all-gather (``work``), whose result lands in ``gathered`` on
    the device (CUDA) or straight in the slot's host buffer (CPU).
    ``synchronize`` waits for it and puts the (kp,) values in ``out``."""

    def __init__(self, work, gathered=None, out=None, stream=None):
        self.work, self.gathered, self.out = work, gathered, out
        self.stream = stream

    def synchronize(self) -> None:
        if self.work is None:
            return
        if self.stream is None:
            self.work.wait()
        else:
            with torch.cuda.stream(self.stream):
                self.work.wait()               # the stream waits for it
                self.out.copy_(self.gathered, non_blocking=True)
                event = torch.cuda.Event()
                event.record(self.stream)
            event.synchronize()
        self.work = self.gathered = None


class OverRanks:
    """Mixin for a backend with a ``mesh`` (None: in-process).  On a mesh
    over ranks, a bucket's kp lanes are ``world`` contiguous blocks, this
    rank evaluates block ``rank`` (its data positions' rows), and an
    all-gather over the default process group assembles the finalized
    lanes in rank order.  On the CPU the all-gather writes the slot's
    host buffer itself; on CUDA it gathers on the device (NCCL, or gloo,
    which stages through host memory itself) and ``Gathered`` copies the
    result back."""

    mesh: Optional[Mesh]

    def _over_ranks(self) -> bool:
        return self.mesh is not None and self.mesh.spans_ranks

    def _own_lanes(self, kp: int) -> tuple:
        if not self._over_ranks():
            return super()._own_lanes(kp)
        n = kp // self.mesh.world
        return self.mesh.rank * n, (self.mesh.rank + 1) * n

    def _deliver(self, ys: torch.Tensor, out: torch.Tensor, stream):
        if not self._over_ranks():
            return super()._deliver(ys, out, stream)
        world = self.mesh.world
        if stream is None:
            work = dist.all_gather(list(out.chunk(world)), ys, async_op=True)
            return Gathered(work)
        gathered = torch.empty(out.shape, dtype=ys.dtype, device=ys.device)
        work = dist.all_gather(list(gathered.chunk(world)), ys,
                               async_op=True)
        return Gathered(work, gathered, out, stream)


class PodMeshEvalBackend(OverRanks, EvalBackend):
    """Evaluate buckets split over the mesh's ``data`` axis.

    f_batch: (rows, n) -> (rows,) fitness on ``device``, row-independent
    (each shard calls it on its own rows).  ``mesh`` defaults to
    ``make_data_mesh(device)``; over ranks, this rank evaluates its
    ``local_shards`` of the ``n_shards``.  Pass ``n_dims`` +
    ``max_bucket`` to warm the bucket ladder at construction.
    """

    def __init__(self, f_batch: Callable, mesh: Optional[Mesh] = None,
                 data_axis: str = "data", *, n_dims: Optional[int] = None,
                 max_bucket: Optional[int] = None, device="cuda"):
        self.mesh = make_data_mesh(device) if mesh is None else mesh
        self.mesh.require_one_device(device)
        self.data_axis = data_axis
        self.n_shards = data_shards(self.mesh, data_axis)
        self.local_shards = self.n_shards // self.mesh.world
        self.f_batch = f_batch
        # the reference's floor of 4 rows a shard over the whole data
        # axis, kept so the bucket ladder (and with it every bucket shape
        # a run sees) is its own
        super().__init__(bucket_size(4 * self.n_shards), device)
        if n_dims is not None and max_bucket is not None:
            self.warm(n_dims, max_bucket)

    def _raw_eval(self, pts: torch.Tensor) -> torch.Tensor:
        # this process's lanes: its shards' blocks of kp / n_shards rows
        rows = pts.shape[0] // self.local_shards
        return torch.cat([self.f_batch(pts[s * rows:(s + 1) * rows])
                          for s in range(self.local_shards)])
