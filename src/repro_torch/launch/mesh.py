"""Device meshes for the pod-mesh evaluation backend.

Port of ``repro/launch/mesh.py``.  The reference's mesh is a JAX
``Mesh``: named axes over an array of devices, one controller placing
arrays on all of them.  The port keeps that single-controller model with
no process group: a ``Mesh`` is named axes over an array of
``torch.device``, and the backends that take one
(``core/substrates/pod_mesh.py``, ``core/substrates/lm_loss.py``) run
every shard from this process.

Single pod: (data=16, model=16) = 256 devices.  Multi-pod: (pod=2,
data=16, model=16) = 512, the "pod" axis an outer data-parallel axis.
No machine the port runs on has 256 GPUs, so ``virtual_devices`` stands in
for the reference's ``--xla_force_host_platform_device_count``: n logical
devices that are all one ``torch.device``, over which the production mesh
can be built on one GPU or on the CPU.  The backends accept meshes whose
devices are all their own device; a mesh over distinct GPUs is refused
(``require_one_device``).
"""
from __future__ import annotations

import math
from collections import OrderedDict
from typing import Sequence, Tuple

import numpy as np
import torch

#: where a mesh over distinct devices waits for its port
MULTI_DEVICE_ITEM = "ROADMAP A.8 (the pod mesh's multi-GPU leg)"


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
    an object array of ``torch.device`` shaped like the mesh.
    """

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

    @property
    def size(self) -> int:
        return int(self.devices.size)

    def distinct_devices(self) -> list:
        """The devices of the mesh, each once, in mesh order."""
        out = []
        for d in self.devices.flat:
            if d not in out:
                out.append(d)
        return out

    def require_one_device(self, device) -> torch.device:
        """The one device every position of the mesh is, which must be
        ``device``.  A mesh over distinct devices is refused."""
        device = canonical_device(device)
        distinct = self.distinct_devices()
        if len(distinct) > 1:
            names = ", ".join(map(str, distinct))
            raise NotImplementedError(
                f"a mesh over distinct devices ({names}) is not supported: "
                f"this port evaluates every shard from one process on one "
                f"device, and the multi-GPU leg waits for "
                f"{MULTI_DEVICE_ITEM}")
        if distinct[0] != device:
            raise ValueError(f"the mesh lies on {distinct[0]}, the backend "
                             f"on {device}")
        return device

    def __repr__(self) -> str:
        axes = ", ".join(f"{a}={n}" for a, n in self.shape.items())
        devices = ", ".join(map(str, self.distinct_devices()))
        return f"Mesh({axes}; {devices})"


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


def make_host_mesh(device="cpu") -> Mesh:
    """Degenerate 1-device mesh for CPU tests and examples (axes kept)."""
    return Mesh((1, 1), ("data", "model"), [device])
