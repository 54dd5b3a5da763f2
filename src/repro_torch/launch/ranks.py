"""Ranks of a ``torch.distributed`` group, one child process a device.

Port-only: the reference's single controller places arrays on every
device of a pod and needs no process group.  PyTorch's idiom for several
devices is one process a device, joined by ``torch.distributed``, which
is also JAX's own on a multi-host pod.  A mesh's ``data`` axis spans
such ranks (``launch/mesh.py::Mesh.over_ranks``); the backends on it
(``core/substrates/pod_mesh.py``, ``core/substrates/lm_loss.py``)
evaluate a rank's own lanes and all-gather the rest.

``run(target, kwargs, world=, backend=, devices=, workdir=)`` forks
``world`` ranks from ``launch/child.py``'s forkserver (a fresh
interpreter costs ~12 s a child on the card's host, a fork ~2 s).  Rank
r runs ``main`` below with ``RANK`` = r and ``WORLD_SIZE`` = world in
its environment: it joins the group over a ``FileStore`` in ``workdir``
(no port to pick, so parallel runs never race for one), on
``devices[r]``, calls ``target(group, **kwargs)`` (``"module:function"``,
``group`` a ``RankGroup``) and writes the JSON doc it returns to
``workdir/rank_<r>.json``.  ``run`` waits for every rank and returns
their docs in rank order.  A rank that exits non-zero, or a run past
``timeout``, gets the other ranks SIGKILLed, which may be waiting in a
collective: ``run`` then returns a non-zero code and never hangs.  The
process group has a timeout of its own (``PG_TIMEOUT_S``), so a rank
waiting for a dead peer raises.

The backend is the caller's choice, never switched:

* ``gloo`` takes CPU or CUDA tensors, and ranks may share a device (two
  ranks on one card time-slice it).  Its sockets are pinned to the
  loopback interface (``GLOO_SOCKET_IFNAME=lo``): the card's host has no
  network, and the ranks are on one host;
* ``nccl`` needs a distinct CUDA device for every rank, and is refused
  otherwise (``check_backend``).

The parent frees its cached CUDA memory before the ranks start: they
share its card.

    python -m repro_torch.launch.ranks <module:function> '<json kwargs>'

is one rank's body; it reads the group from the environment ``run``
gives it.
"""
from __future__ import annotations

import dataclasses
import datetime
import gc
import importlib
import json
import multiprocessing.connection
import os
import sys
import time
from typing import List, Optional

import torch
import torch.distributed as dist

from repro_torch.launch import child
from repro_torch.launch.mesh import Mesh, canonical_device

BACKENDS = ("gloo", "nccl")
#: the process group's own timeout, s, by the ranks' device type: a
#: rank waiting longer for a peer raises (the CPU's runs are the tests')
PG_TIMEOUT_S = {"cuda": 120.0, "cpu": 30.0}

_ENV_DIR = "REPRO_RANKS_DIR"
_ENV_BACKEND = "REPRO_RANKS_BACKEND"
_ENV_DEVICES = "REPRO_RANKS_DEVICES"
_ENV_TIMEOUT = "REPRO_RANKS_PG_TIMEOUT"


def default_devices(backend: str, world: int, device="cuda") -> list:
    """Each rank's device: gloo puts every rank on ``device``; nccl rank r
    on ``cuda:r`` (``check_backend`` refuses it past the cards there
    are)."""
    if backend == "nccl":
        return [torch.device("cuda", r) for r in range(world)]
    return [canonical_device(device)] * world


def check_backend(backend: str, devices: list) -> list:
    """``devices`` (one a rank) as ``torch.device``, after the backend's
    refusals: an unknown backend; nccl on a device that is not CUDA, on
    a device shared by two ranks, or on more cards than there are."""
    if backend not in BACKENDS:
        raise ValueError(f"backend {backend!r} is not one of {BACKENDS}")
    devices = [torch.device(d) for d in devices]
    world = len(devices)
    if world < 1:
        raise ValueError("a group needs at least one rank")
    if backend == "nccl":
        names = ", ".join(map(str, devices))
        if any(d.type != "cuda" for d in devices):
            raise ValueError(f"nccl needs a CUDA device for every rank, got "
                             f"{names}; gloo takes CPU tensors")
        count = torch.cuda.device_count()
        indices = [d.index if d.index is not None else 0 for d in devices]
        if len(set(indices)) < world or max(indices) >= count:
            raise ValueError(
                f"nccl needs a distinct CUDA device for each of {world} "
                f"ranks, got {names} with torch.cuda.device_count() = "
                f"{count}; ranks that share a card take gloo")
        devices = [torch.device("cuda", i) for i in indices]
    return devices


@dataclasses.dataclass
class RankGroup:
    """This process's place in the group: ``rank`` of ``world``, on
    ``device``; ``rank_devices`` every rank's device in rank order."""
    rank: int
    world: int
    device: torch.device
    rank_devices: List[torch.device]
    #: model_ranks -> (this rank's model group, its data group)
    _grids: dict = dataclasses.field(default_factory=dict, repr=False)

    def mesh(self, shape, axis_names=("data", "model"),
             model_ranks: int = 1) -> Mesh:
        """The mesh ``shape`` with its data axis over this group's ranks
        (the default process group), and with ``model_ranks`` > 1 its
        model axis too, over the (world / model_ranks, model_ranks) grid
        of ``Mesh.over_ranks``, with this rank's subgroups along the two
        axes (``subgroups``)."""
        mesh = Mesh.over_ranks(shape, axis_names, rank=self.rank,
                               rank_devices=self.rank_devices,
                               model_ranks=model_ranks)
        if model_ranks > 1:
            mesh.model_group, mesh.data_group = self.subgroups(model_ranks)
        return mesh

    def subgroups(self, model_ranks: int) -> tuple:
        """(this rank's model group, its data group) on the (world /
        ``model_ranks``, ``model_ranks``) grid: a model group for each
        data row, ranks [i·M, (i+1)·M), and a data group for each model
        column, ranks j, j + M, ....  Every rank creates every group, in
        the same order (``dist.new_group``'s contract), once a grid."""
        if model_ranks not in self._grids:
            m = model_ranks
            rows = [dist.new_group(list(range(i * m, (i + 1) * m)))
                    for i in range(self.world // m)]
            cols = [dist.new_group(list(range(j, self.world, m)))
                    for j in range(m)]
            self._grids[m] = (rows[self.rank // m], cols[self.rank % m])
        return self._grids[model_ranks]


def join() -> RankGroup:
    """Join the group ``run`` started this process in (its environment):
    bind the rank's device and initialise the default process group over
    the ``FileStore`` in the run's directory."""
    env = os.environ
    rank, world = int(env["RANK"]), int(env["WORLD_SIZE"])
    backend = env[_ENV_BACKEND]
    devices = [torch.device(d) for d in env[_ENV_DEVICES].split(",")]
    device = devices[rank]
    if device.type == "cuda":
        torch.cuda.set_device(device)
    store = dist.FileStore(os.path.join(env[_ENV_DIR], "store"), world)
    dist.init_process_group(
        backend, store=store, rank=rank, world_size=world,
        timeout=datetime.timedelta(seconds=float(env[_ENV_TIMEOUT])),
        device_id=device if backend == "nccl" else None)
    return RankGroup(rank, world, device, devices)


def leave() -> None:
    """Leave the group: destroy the default process group."""
    if dist.is_initialized():
        dist.destroy_process_group()


def _resolve(target: str):
    module, name = target.split(":")
    return getattr(importlib.import_module(module), name)


def _report_path(workdir: str, rank: int) -> str:
    return os.path.join(workdir, f"rank_{rank}.json")


def main(argv=None) -> int:
    """One rank: join, run ``target(group, **kwargs)``, write its doc."""
    target, kwargs = sys.argv[1:] if argv is None else argv
    fn = _resolve(target)
    group = join()
    try:
        doc = fn(group, **json.loads(kwargs))
    finally:
        leave()
    path = _report_path(os.environ[_ENV_DIR], group.rank)
    with open(path + ".tmp", "w") as f:
        json.dump(doc, f)
    os.replace(path + ".tmp", path)
    return 0


@dataclasses.dataclass
class RanksResult:
    """``returncode``: 0 when every rank exited 0 and wrote its doc; else
    1 (a rank failed: ``failed`` says which and how) or 124 (the run's
    timeout).  ``docs``: each rank's doc in rank order (None where
    missing); ``exitcodes``: each rank's (-9 where killed); ``wall_s``:
    from the first fork to the last exit, starts included."""
    returncode: int
    docs: list
    exitcodes: list
    wall_s: float
    failed: Optional[str] = None


def _tail(path: str, n: int = 2000) -> str:
    try:
        with open(path) as f:
            return f.read()[-n:]
    except OSError:
        return ""


def run(target: str, kwargs: dict, *, world: int, backend: str,
        devices: Optional[list] = None, workdir: str, timeout: float = 600.0,
        env: Optional[dict] = None) -> RanksResult:
    """Run ``target(group, **kwargs)`` on ``world`` ranks (see the module
    docstring); ``devices`` defaults to ``default_devices(backend,
    world)``.  ``env`` is the ranks' environment (default this
    process's)."""
    devices = check_backend(backend, devices if devices is not None
                            else default_devices(backend, world))
    if len(devices) != world:
        raise ValueError(f"{len(devices)} devices for {world} ranks")
    os.makedirs(workdir, exist_ok=True)
    for name in ["store"] + [f"rank_{r}.json" for r in range(world)]:
        if os.path.exists(os.path.join(workdir, name)):
            os.remove(os.path.join(workdir, name))
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        # the ranks share this process's card: free what it caches
        torch.cuda.synchronize()
        gc.collect()
        torch.cuda.empty_cache()
    base = dict(os.environ if env is None else env)
    base.update({_ENV_DIR: workdir, _ENV_BACKEND: backend,
                 _ENV_DEVICES: ",".join(map(str, devices)),
                 _ENV_TIMEOUT: str(PG_TIMEOUT_S[devices[0].type]),
                 "WORLD_SIZE": str(world),
                 "GLOO_SOCKET_IFNAME": "lo"})
    t0 = time.perf_counter()
    procs = [child.start(__name__, [target, json.dumps(kwargs)],
                         dict(base, RANK=str(r)),
                         os.path.join(workdir, f"rank_{r}.out"),
                         os.path.join(workdir, f"rank_{r}.err"),
                         name=f"rank{r}")
             for r in range(world)]
    deadline = time.monotonic() + timeout
    failed, code = None, 0
    try:
        live = list(procs)
        while live and failed is None:
            left = deadline - time.monotonic()
            if left <= 0 or not multiprocessing.connection.wait(
                    [p.sentinel for p in live], left):
                failed, code = f"timeout after {timeout} s", 124
                break
            for r, p in enumerate(procs):
                if p in live and p.exitcode is not None:
                    live.remove(p)
                    if p.exitcode != 0 and failed is None:
                        err = _tail(os.path.join(workdir, f"rank_{r}.err"))
                        failed = f"rank {r} exited {p.exitcode}: {err}"
                        code = 1
    finally:
        for p in procs:
            if p.exitcode is None:
                p.kill()
        for p in procs:
            p.join()
    wall = time.perf_counter() - t0
    docs = []
    for r in range(world):
        path = _report_path(workdir, r)
        if os.path.exists(path):
            with open(path) as f:
                docs.append(json.load(f))
        else:
            docs.append(None)
    if failed is None and any(d is None for d in docs):
        failed, code = "a rank exited 0 without its doc", 1
    return RanksResult(code, docs, [p.exitcode for p in procs], wall, failed)


if __name__ == "__main__":
    raise SystemExit(main())
