"""Device meshes for the pod-mesh evaluation backend.

Port of ``repro/launch/mesh.py``.  The reference's mesh is a JAX
``Mesh``: named axes over an array of devices, one controller placing
arrays on all of them.  A port ``Mesh`` is named axes over an array of
``torch.device``, in one of two forms:

* one process (the default): the backends that take one
  (``core/substrates/pod_mesh.py``, ``core/substrates/lm_loss.py``) run
  every shard from this process, on one device;
* over ranks (``Mesh.over_ranks``): the ``data`` axis of size d is cut
  into ``world`` contiguous blocks, one for each rank of a process group
  (``launch/ranks.py`` starts them), and rank r holds the data positions
  [r·d/world, (r+1)·d/world) with the whole of every other axis, on its
  own device.  PyTorch's idiom for several devices, one process each, as
  JAX's own on a multi-host pod; a backend on such a mesh evaluates the
  rank's positions and gathers the rest.

Single pod: (data=16, model=16) = 256 devices.  Multi-pod: (pod=2,
data=16, model=16) = 512, the "pod" axis an outer data-parallel axis.
No machine the port runs on has 256 GPUs, so ``virtual_devices`` stands in
for the reference's ``--xla_force_host_platform_device_count``: n logical
devices that are all one ``torch.device``, over which the production mesh
can be built on one GPU or on the CPU.  Over ranks, the positions a
rank holds are virtual in the same way: 2 ranks × 8 virtual data shards
are the production 16 × 16.  The backends accept a one-process mesh
whose devices are all their own device; one over distinct GPUs is
refused (``require_one_device``): the data axis reaches them through
ranks.
"""
from __future__ import annotations

import math
from collections import OrderedDict
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

#: the axis a mesh over ranks cuts over them
DATA_AXIS = "data"
#: where the model axis across distinct devices waits for its port
MULTI_DEVICE_ITEM = "ROADMAP A.8 (iii), the model axis over distinct cards"


def canonical_device(device) -> torch.device:
    """``device`` as a ``torch.device`` with its index filled in for CUDA
    (``cuda`` and ``cuda:0`` name one card and must compare equal)."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    return device


class Mesh:
    """Named axes over an array of devices.

    ``axis_names``: the axes in order; ``shape``: an ordered mapping from
    axis name to size (the reference's ``mesh.shape[axis]``); ``devices``:
    an object array of ``torch.device`` shaped like the mesh.  On a mesh
    over ranks (``over_ranks``, the ranks of the default process group)
    ``rank_devices`` is each rank's device in rank order, ``rank`` this
    process's and ``devices`` at every position its owner's device; on a
    one-process mesh ``rank_devices`` is None.
    """

    rank_devices: Optional[Tuple[torch.device, ...]] = None
    rank = 0

    def __init__(self, shape: Sequence[int], axis_names: Sequence[str],
                 devices: Sequence):
        shape = tuple(int(s) for s in shape)
        if len(shape) != len(axis_names):
            raise ValueError(f"mesh shape {shape} for axes {axis_names}")
        if len(devices) != math.prod(shape):
            raise ValueError(f"mesh {shape} needs {math.prod(shape)} "
                             f"devices, got {len(devices)}")
        arr = np.empty(len(devices), dtype=object)
        arr[:] = [canonical_device(d) for d in devices]
        self.devices = arr.reshape(shape)
        self.axis_names: Tuple[str, ...] = tuple(axis_names)
        self.shape = OrderedDict(zip(self.axis_names, shape))

    @classmethod
    def over_ranks(cls, shape: Sequence[int], axis_names: Sequence[str], *,
                   rank: int, rank_devices: Sequence) -> "Mesh":
        """The mesh ``shape`` whose ``data`` axis is cut into
        ``len(rank_devices)`` contiguous blocks, block r held by rank r of
        the default process group on ``rank_devices[r]``; this process is
        ``rank``."""
        shape = tuple(int(s) for s in shape)
        world = len(rank_devices)
        if DATA_AXIS not in axis_names:
            raise ValueError(f"mesh axes {tuple(axis_names)} have no "
                             f"{DATA_AXIS!r} axis to spread over ranks")
        axis = list(axis_names).index(DATA_AXIS)
        d = shape[axis]
        if world < 1 or d % world:
            raise ValueError(f"a data axis of {d} does not divide over "
                             f"{world} ranks")
        if not 0 <= rank < world:
            raise ValueError(f"rank {rank} of a group of {world}")
        owners = np.indices(shape)[axis] // (d // world)
        devices = [canonical_device(rank_devices[r]) for r in owners.flat]
        mesh = cls(shape, axis_names, devices)
        mesh.rank_devices = tuple(canonical_device(x) for x in rank_devices)
        mesh.rank = int(rank)
        return mesh

    @property
    def size(self) -> int:
        return int(self.devices.size)

    @property
    def spans_ranks(self) -> bool:
        """Whether the mesh is over the ranks of a process group."""
        return self.rank_devices is not None

    @property
    def world(self) -> int:
        """The ranks the mesh spans (1 for a one-process mesh)."""
        return 1 if self.rank_devices is None else len(self.rank_devices)

    def local_positions(self) -> list:
        """The mesh coordinates this process holds, in row-major order:
        every position of a one-process mesh; this rank's block of the
        data axis, and the whole of every other axis, over ranks."""
        coords = list(np.ndindex(self.devices.shape))
        if self.rank_devices is None:
            return coords
        block = self.shape[DATA_AXIS] // self.world
        axis = self.axis_names.index(DATA_AXIS)
        lo = self.rank * block
        return [c for c in coords if lo <= c[axis] < lo + block]

    def distinct_devices(self) -> list:
        """The devices of the mesh, each once, in mesh order."""
        out = []
        for d in self.devices.flat:
            if d not in out:
                out.append(d)
        return out

    def require_one_device(self, device) -> torch.device:
        """The one device every position this process holds is, which must
        be ``device``.  A one-process mesh over distinct devices is
        refused: its data axis reaches them as a mesh over ranks."""
        device = canonical_device(device)
        if self.rank_devices is None:
            distinct = self.distinct_devices()
        else:
            distinct = [self.rank_devices[self.rank]]
        if len(distinct) > 1:
            names = ", ".join(map(str, distinct))
            raise NotImplementedError(
                f"a one-process mesh over distinct devices ({names}) is not "
                f"supported: a process evaluates its shards on one device. "
                f"Spread the data axis over ranks, one process a device "
                f"(Mesh.over_ranks, launch/ranks.py); the model axis across "
                f"cards waits for {MULTI_DEVICE_ITEM}")
        if distinct[0] != device:
            raise ValueError(f"the mesh lies on {distinct[0]}, the backend "
                             f"on {device}")
        return device

    def __repr__(self) -> str:
        axes = ", ".join(f"{a}={n}" for a, n in self.shape.items())
        devices = ", ".join(map(str, self.distinct_devices()))
        if self.rank_devices is None:
            return f"Mesh({axes}; {devices})"
        return (f"Mesh({axes}; rank {self.rank} of {self.world}; "
                f"{', '.join(map(str, self.rank_devices))})")


def visible_devices(device="cuda") -> list:
    """Every device of ``device``'s type: each CUDA card, or the CPU."""
    device = torch.device(device)
    if device.type == "cuda":
        return [torch.device("cuda", i)
                for i in range(torch.cuda.device_count())]
    return [device]


def virtual_devices(n: int, device="cuda") -> list:
    """``n`` logical devices that are all ``device``: the port's
    counterpart of ``--xla_force_host_platform_device_count``."""
    return [canonical_device(device)] * n


def make_production_mesh(*, multi_pod: bool = False, devices=None) -> Mesh:
    """The (16, 16) pod mesh, or (2, 16, 16) with ``multi_pod``, over
    ``devices`` (default: the visible CUDA devices)."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    n = math.prod(shape)
    devices = visible_devices("cuda") if devices is None else list(devices)
    if len(devices) < n:
        raise RuntimeError(
            f"mesh {shape} needs {n} devices but only {len(devices)} "
            f"present; build it over launch.mesh.virtual_devices({n}, device)")
    return Mesh(shape, axes, devices[:n])


def make_host_mesh(device="cuda") -> Mesh:
    """Degenerate 1-device mesh on ``device`` (axes kept): the card by
    default, as the reference's takes its default backend's first
    device; tests pass ``"cpu"``."""
    return Mesh((1, 1), ("data", "model"), [device])
