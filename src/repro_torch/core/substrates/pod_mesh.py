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
controller.  The port keeps the one controller and no process group: it
runs the shards in order on the backend's stream and concatenates their
rows.  It accepts meshes whose devices are all the backend's device (the
(1, 1) mesh of one GPU, and ``virtual_devices`` meshes up to the
production 16 × 16); a mesh over distinct GPUs is refused.

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

from repro_torch.core.substrates.eval_backend import EvalBackend, bucket_size
from repro_torch.launch.mesh import (Mesh, make_production_mesh,
                                     visible_devices)


def make_data_mesh(device="cuda") -> Mesh:
    """Best evaluation mesh for the visible devices of ``device``'s type:
    the production pod when enough exist, else the largest power-of-two
    data-parallel mesh that fits, down to a degenerate (1, 1) mesh (one
    GPU, or the CPU)."""
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


class PodMeshEvalBackend(EvalBackend):
    """Evaluate buckets split over the mesh's ``data`` axis.

    f_batch: (rows, n) -> (rows,) fitness on ``device``, row-independent
    (each shard calls it on its own rows).  ``mesh`` defaults to
    ``make_data_mesh(device)``.  Pass ``n_dims`` + ``max_bucket`` to warm
    the bucket ladder at construction.
    """

    def __init__(self, f_batch: Callable, mesh: Optional[Mesh] = None,
                 data_axis: str = "data", *, n_dims: Optional[int] = None,
                 max_bucket: Optional[int] = None, device="cuda"):
        self.mesh = make_data_mesh(device) if mesh is None else mesh
        self.mesh.require_one_device(device)
        self.data_axis = data_axis
        self.n_shards = data_shards(self.mesh, data_axis)
        self.f_batch = f_batch
        # the reference's floor of 4 rows a shard, kept so the bucket
        # ladder (and with it every bucket shape a run sees) is its own
        super().__init__(bucket_size(4 * self.n_shards), device)
        if n_dims is not None and max_bucket is not None:
            self.warm(n_dims, max_bucket)

    def _raw_eval(self, pts: torch.Tensor) -> torch.Tensor:
        rows = pts.shape[0] // self.n_shards
        return torch.cat([self.f_batch(pts[s * rows:(s + 1) * rows])
                          for s in range(self.n_shards)])
