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
  rank's positions and gathers the rest, and training on a (W, 1) such
  mesh (``launch/train.py --ranks W``) takes its host's rows of the
  batch and sums the loss's reductions and the gradients over the ranks
  (``models/sharding.py::RankSum``, in the step's ``ShardCtx``).  With
  ``model_ranks`` M the ``model`` axis is cut over the ranks as well:
  the W ranks form a (W/M, M) grid, rank r holding data block r // M and
  model block r % M, so that a model group is M adjacent ranks
  (``launch/train.py --ranks W --model-ranks M``; the evaluation
  backends store their model blocks and gather them over the model
  group, ``dryrun --ranks W --model-ranks M``).

Single pod: (data=16, model=16) = 256 devices.  Multi-pod: (pod=2,
data=16, model=16) = 512, the "pod" axis an outer data-parallel axis.
No machine the port runs on has 256 GPUs, so ``virtual_devices`` stands in
for the reference's ``--xla_force_host_platform_device_count``: n logical
devices that are all one ``torch.device``, over which the production mesh
can be built on one GPU or on the CPU.  Over ranks, the positions a
rank holds are virtual in the same way: 2 ranks × 8 virtual data shards
are the production 16 × 16.  The backends accept a one-process mesh
whose devices are all their own device; one over distinct GPUs is
refused (``require_one_device``): its axes reach them through ranks.
"""
from __future__ import annotations

import math
from collections import OrderedDict
from typing import Any, Optional, Sequence, Tuple

import numpy as np
import torch

#: the axis a mesh over ranks cuts over them
DATA_AXIS = "data"
#: the axis a mesh over ranks cuts over them too where ``model_ranks`` > 1
MODEL_AXIS = "model"


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
    one-process mesh ``rank_devices`` is None.  ``model_ranks`` is the
    number of ranks the model axis is cut over (1: none);
    ``data_group`` / ``model_group`` are this rank's subgroups along the
    two axes (``launch/ranks.py::RankGroup.mesh`` makes them where
    ``model_ranks`` > 1; None: the default process group).
    """

    rank_devices: Optional[Tuple[torch.device, ...]] = None
    rank = 0
    model_ranks = 1
    data_group: Any = None
    model_group: Any = None

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
                   rank: int, rank_devices: Sequence,
                   model_ranks: int = 1) -> "Mesh":
        """The mesh ``shape`` over the ranks of the default process group,
        rank r on ``rank_devices[r]``; this process is ``rank``.  The
        ``len(rank_devices)`` = W ranks form a (W / ``model_ranks``,
        ``model_ranks``) grid: the ``data`` axis is cut into W /
        ``model_ranks`` contiguous blocks and the ``model`` axis into
        ``model_ranks``, and rank r holds data block r // ``model_ranks``
        and model block r % ``model_ranks`` (the whole model axis where
        ``model_ranks`` is 1)."""
        shape = tuple(int(s) for s in shape)
        world = len(rank_devices)
        if DATA_AXIS not in axis_names:
            raise ValueError(f"mesh axes {tuple(axis_names)} have no "
                             f"{DATA_AXIS!r} axis to spread over ranks")
        if model_ranks < 1 or world % model_ranks:
            raise ValueError(f"{world} ranks do not divide into model "
                             f"groups of {model_ranks}")
        if model_ranks > 1 and MODEL_AXIS not in axis_names:
            raise ValueError(f"mesh axes {tuple(axis_names)} have no "
                             f"{MODEL_AXIS!r} axis to cut over "
                             f"{model_ranks} ranks")
        data_ranks = world // model_ranks
        axis = list(axis_names).index(DATA_AXIS)
        d = shape[axis]
        if d % data_ranks:
            raise ValueError(f"a data axis of {d} does not divide over "
                             f"{data_ranks} ranks")
        if not 0 <= rank < world:
            raise ValueError(f"rank {rank} of a group of {world}")
        owners = np.indices(shape)[axis] // (d // data_ranks) * model_ranks
        if model_ranks > 1:
            m_axis = list(axis_names).index(MODEL_AXIS)
            m = shape[m_axis]
            if m % model_ranks:
                raise ValueError(f"a model axis of {m} does not divide over "
                                 f"{model_ranks} ranks")
            owners = owners + np.indices(shape)[m_axis] // (m // model_ranks)
        devices = [canonical_device(rank_devices[r]) for r in owners.flat]
        mesh = cls(shape, axis_names, devices)
        mesh.rank_devices = tuple(canonical_device(x) for x in rank_devices)
        mesh.rank = int(rank)
        mesh.model_ranks = int(model_ranks)
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

    @property
    def data_ranks(self) -> int:
        """The ranks the data axis is cut over: a model group's size
        divides them out of ``world``."""
        return self.world // self.model_ranks

    def local_positions(self) -> list:
        """The mesh coordinates this process holds, in row-major order:
        every position of a one-process mesh; over ranks, this rank's
        block of the data axis and of the model axis (all of it where
        ``model_ranks`` is 1), and the whole of every other axis."""
        coords = list(np.ndindex(self.devices.shape))
        if self.rank_devices is None:
            return coords
        held = [(DATA_AXIS, self.rank // self.model_ranks, self.data_ranks)]
        if self.model_ranks > 1:
            held.append((MODEL_AXIS, self.rank % self.model_ranks,
                         self.model_ranks))
        for name, index, parts in held:
            block = self.shape[name] // parts
            axis = self.axis_names.index(name)
            lo = index * block
            coords = [c for c in coords if lo <= c[axis] < lo + block]
        return coords

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
        refused: its axes reach them as a mesh over ranks.  A mesh whose
        model axis spans ranks must carry its subgroups
        (``launch/ranks.py::RankGroup.mesh``)."""
        device = canonical_device(device)
        if self.model_ranks > 1 and (self.model_group is None
                                     or self.data_group is None):
            raise ValueError(
                f"{self} cuts its model axis over ranks but has no model "
                f"and data groups: build it with RankGroup.mesh("
                f"model_ranks=) (launch/ranks.py)")
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
                f"(Mesh.over_ranks, launch/ranks.py), and the model axis "
                f"too with Mesh.over_ranks(model_ranks=)")
        if distinct[0] != device:
            raise ValueError(f"the mesh lies on {distinct[0]}, the backend "
                             f"on {device}")
        return device

    def __repr__(self) -> str:
        axes = ", ".join(f"{a}={n}" for a, n in self.shape.items())
        devices = ", ".join(map(str, self.distinct_devices()))
        if self.rank_devices is None:
            return f"Mesh({axes}; {devices})"
        over = ("" if self.model_ranks == 1
                else f", model over {self.model_ranks}")
        return (f"Mesh({axes}; rank {self.rank} of {self.world}{over}; "
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
