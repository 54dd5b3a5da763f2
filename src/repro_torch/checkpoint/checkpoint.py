"""Checkpoint/restart: npz bundles + manifest, atomic writes, retention,
optional async save, and placement onto a mesh on restore.

Port of ``repro/checkpoint/checkpoint.py``, in its layout::

    <dir>/step_000123/arrays.npz      # one entry per tree leaf (path-keyed)
    <dir>/step_000123/MANIFEST.json   # step, leaf paths/dtypes/shapes, extras
    <dir>/LATEST                      # atomic pointer file

A leaf's key is its path in JAX's flatten order (``core/tree.py``:
``params/segments/0/0/attn/wq``), which is the reference's key, and bf16
and fp8 are stored as their bit patterns (``uint16`` / ``uint8``), as the
reference stores them through ``ml_dtypes``.  So a checkpoint written by
either package restores in the other, bit for bit.  The port needs no
``ml_dtypes``: a bf16 tensor's bits are read through ``view(torch.int16)``
and a stored leaf is decoded by the template's type.

Restoring onto a mesh: ``shardings`` (a tree of the port's
``PartitionSpec`` shaped like the template) with ``mesh`` (a
``launch/mesh.py`` mesh) cuts each leaf into its pieces along its spec
(a ``sharding.Sharded``, as ``sharding.to_named`` makes), where the
reference ``device_put``s it onto a ``NamedSharding``.  The
reference restarts a 256-chip checkpoint on 512 chips that way; the port's
one-process meshes lie on one device, and across devices a mesh spans
ranks, each restoring its own blocks (below).

Over the ranks of a process group (training's data axis,
``launch/train.py --ranks``) every rank holds the same state: ``save``
with the mesh writes once, from rank 0, behind a barrier, and every rank
restores from the same files.  Where the ranks hold pieces of the leaves
(``--fsdp``: ``shardings`` cut leaves over ``data``; ``--model-ranks``:
over ``model``), ``save`` gathers each cut leaf in turn over the ranks
that hold its blocks and rank 0 writes the whole tree in the same
format, and ``restore`` with ``shardings`` / ``mesh`` keeps each rank's
block.
"""
from __future__ import annotations

import json
import os
import shutil
import threading
import time
from typing import Any, Dict, Optional

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.core.tree import leaves_with_paths
from repro_torch.models.sharding import (Sharded, gather_blocks, rank_cut,
                                         spec_leaves)

#: types npz cannot hold, stored as their bits: (the stored numpy type,
#: the torch integer type of the same width that views them)
_RAW = {torch.bfloat16: (np.uint16, torch.int16),
        torch.float8_e4m3fn: (np.uint8, torch.uint8),
        torch.float8_e5m2: (np.uint8, torch.uint8)}


def _encode(x) -> np.ndarray:
    """A leaf (tensor, numpy array or number) as a host numpy array, bf16
    and fp8 tensors as their bits.  A tensor is copied here, from any
    device, so the array never shares the tensor's memory."""
    if not torch.is_tensor(x):
        return np.array(x)
    x = x.detach()
    raw = _RAW.get(x.dtype)
    if raw is not None:
        return x.view(raw[1]).to("cpu", copy=True).numpy().view(raw[0])
    return x.to("cpu", copy=True).numpy()


def _numpy_dtype(dtype: torch.dtype) -> np.dtype:
    return torch.empty(0, dtype=dtype).numpy().dtype


def _decode(arr: np.ndarray, dtype: torch.dtype, device) -> torch.Tensor:
    """A stored array as a tensor of the template's ``dtype`` on
    ``device``: bits back into bf16/fp8, another stored type cast (as the
    reference's ``astype``)."""
    raw = _RAW.get(dtype)
    if raw is not None and arr.dtype == raw[0]:
        t = torch.from_numpy(np.asarray(arr, order="C").view(
            _numpy_dtype(raw[1]))).view(dtype)
    elif raw is not None:
        t = torch.from_numpy(np.asarray(arr, np.float32)).to(dtype)
    else:
        want = _numpy_dtype(dtype)
        t = torch.from_numpy(np.asarray(arr, dtype=want, order="C"))
    return t.to(device)


def _host_over_ranks(tree, shardings, mesh) -> Optional[Dict]:
    """Rank 0's host arrays of ``tree`` over the ranks of ``mesh``: each
    leaf that ``shardings`` cuts over ranks all-gathered in turn over the
    ranks that hold its blocks (``sharding.rank_cut``; every group of them
    takes part), so no more than one whole leaf stands on a device at a
    time; None on the other ranks."""
    specs = dict(spec_leaves(shardings)) if shardings is not None else {}
    host = {}
    for key, x in leaves_with_paths(tree):
        cut = rank_cut(specs[key], mesh) if key in specs else None
        if cut is not None:
            dim, group, n = cut
            x = gather_blocks(x, dim, n, group)
        if mesh.rank == 0:
            host[key] = _encode(x)
    return host if mesh.rank == 0 else None


def save(ckpt_dir: str, step: int, tree, extras: Optional[Dict] = None,
         keep: int = 3, async_save: bool = False, mesh=None,
         shardings=None):
    """Write a checkpoint bundle.  Atomic via tmp-dir + rename.  With
    ``async_save`` the leaves are copied to the host first and a thread
    writes them (returned; join it before the next save reads the
    directory): the next step may update the moments in place, so the
    thread never reads device memory.  On a ``mesh`` whose data axis
    spans ranks (``Mesh.over_ranks``) rank 0 writes the whole tree and
    every rank waits for it at a barrier of the default process group,
    so the save is synchronous there; the leaves that ``shardings`` (a
    tree of ``PartitionSpec`` shaped like ``tree``) cuts over ranks
    (``data``, or ``model`` where the model axis spans them) are each
    rank's block, gathered leaf by leaf (every rank calls ``save``), the
    others the same on every rank."""
    if mesh is not None and mesh.spans_ranks:
        if async_save:
            raise ValueError("a save over ranks ends at a barrier: it "
                             "cannot be asynchronous")
        host = _host_over_ranks(tree, shardings, mesh)
        if mesh.rank == 0:
            _write(ckpt_dir, step, host, extras, keep)
        dist.barrier()
        return None
    host = {k: _encode(v) for k, v in leaves_with_paths(tree)}
    return _write(ckpt_dir, step, host, extras, keep, async_save)


def _write(ckpt_dir: str, step: int, host: Dict, extras: Optional[Dict],
           keep: int, async_save: bool = False):
    """Write host arrays as the bundle of ``step`` (``save``)."""

    def bundle():
        name = f"step_{step:08d}"
        tmp = os.path.join(ckpt_dir, f".tmp_{name}_{os.getpid()}")
        os.makedirs(tmp, exist_ok=True)
        np.savez(os.path.join(tmp, "arrays.npz"), **host)
        manifest = {
            "step": step,
            "time": time.time(),
            "leaves": {k: {"shape": list(v.shape), "dtype": str(v.dtype)}
                       for k, v in host.items()},
            "extras": extras or {},
        }
        with open(os.path.join(tmp, "MANIFEST.json"), "w") as f:
            json.dump(manifest, f, indent=2)
        final = os.path.join(ckpt_dir, name)
        if os.path.exists(final):
            shutil.rmtree(final)
        os.rename(tmp, final)
        latest_tmp = os.path.join(ckpt_dir, ".LATEST.tmp")
        with open(latest_tmp, "w") as f:
            f.write(name)
        os.replace(latest_tmp, os.path.join(ckpt_dir, "LATEST"))
        _retain(ckpt_dir, keep)

    os.makedirs(ckpt_dir, exist_ok=True)
    if async_save:
        th = threading.Thread(target=bundle, daemon=True)
        th.start()
        return th
    bundle()
    return None


def _retain(ckpt_dir: str, keep: int):
    steps = sorted(d for d in os.listdir(ckpt_dir) if d.startswith("step_"))
    for d in steps[:-keep]:
        shutil.rmtree(os.path.join(ckpt_dir, d), ignore_errors=True)


def latest_step(ckpt_dir: str) -> Optional[int]:
    try:
        with open(os.path.join(ckpt_dir, "LATEST")) as f:
            return int(f.read().strip().split("_")[1])
    except (FileNotFoundError, IndexError, ValueError):
        return None


def _unflatten(template: Any, values: Dict[str, Any], prefix: str = ""):
    """``template``'s structure (dicts and lists) holding ``values`` by
    leaf path."""
    if isinstance(template, dict):
        return {k: _unflatten(v, values, f"{prefix}{k}/")
                for k, v in template.items()}
    if isinstance(template, (list, tuple)):
        return [_unflatten(v, values, f"{prefix}{i}/")
                for i, v in enumerate(template)]
    return values[prefix[:-1]]


def restore(ckpt_dir: str, template, step: Optional[int] = None,
            shardings=None, mesh=None, device="cuda"):
    """Restore into the structure of ``template`` (a tree of tensors or of
    ``transformer.TensorShape``).  Each leaf takes its template's type and
    lands on the template tensor's device (``device`` for a
    ``TensorShape``).  ``shardings``: optional tree of ``PartitionSpec``
    shaped like the template, with ``mesh``: each leaf is placed onto the
    mesh along its spec (a ``sharding.Sharded``); on a mesh over ranks
    each leaf is this rank's block, a tensor, and the template holds the
    blocks (``launch/train.py --fsdp`` / ``--model-ranks``).  Returns
    (tree, step, extras)."""
    if step is None:
        step = latest_step(ckpt_dir)
        if step is None:
            raise FileNotFoundError(f"no checkpoint under {ckpt_dir}")
    path = os.path.join(ckpt_dir, f"step_{step:08d}")
    with open(os.path.join(path, "MANIFEST.json")) as f:
        manifest = json.load(f)
    arrays = np.load(os.path.join(path, "arrays.npz"))

    flat_template = leaves_with_paths(template)
    keys = {k for k, _ in flat_template}
    missing = keys - set(arrays.files)
    extra = set(arrays.files) - keys
    if missing or extra:
        raise ValueError(f"checkpoint/template mismatch: missing="
                         f"{sorted(missing)[:5]} extra={sorted(extra)[:5]}")
    specs = {}
    if shardings is not None:
        if mesh is None:
            raise ValueError("shardings are placed onto a mesh: pass mesh=")
        specs = dict(spec_leaves(shardings))

    values = {}
    for key, leaf in flat_template:
        where = leaf.device if torch.is_tensor(leaf) else device
        val = _decode(arrays[key], leaf.dtype, where)
        spec = specs.get(key)
        if spec is not None and mesh.spans_ranks:       # the rank's block
            block = Sharded(val, spec, mesh).local(mesh.local_positions()[0])
            val = block.clone() if block.numel() < val.numel() else block
        if tuple(val.shape) != tuple(leaf.shape):
            raise ValueError(f"checkpoint leaf {key}: shape "
                             f"{tuple(val.shape)}, template "
                             f"{tuple(leaf.shape)}")
        if spec is not None and not mesh.spans_ranks:
            val = Sharded(val, spec, mesh)
        values[key] = val
    return (_unflatten(template, values), manifest["step"],
            manifest.get("extras", {}))
