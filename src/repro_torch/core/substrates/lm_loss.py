"""LM-loss evaluation backend: the engine's fitness IS a model forward.

Port of ``repro/core/substrates/lm_loss.py``.  Every fitness evaluation
is a real forward + cross-entropy of a ``models/`` network on a fixed
synthetic batch, with the parameters moved along a k-dimensional
``SubspaceProjection`` (``core/subspace.py``).  An engine candidate is a
(k,) vector of subspace coefficients; the backend lifts it to θ0 + c·V
leaf by leaf and returns the loss.  On the card the forward's attention
and RWKV6 recurrence run the port's CUDA kernels (``kernels/ops.py``).

Two evaluation modes, one class, as in the reference:

  * ``mesh=None``: in-process, the bucket's lanes on the workload's
    device;
  * ``mesh`` given (``launch/mesh.py``): the bucket's lanes are split
    over the ``data`` axis, while θ0 and the basis are STORED cut over
    ``model`` with the model's own ``param_specs`` (after
    ``enforce_divisible``: a smoke config's 4 heads cannot split 16 ways
    and fall back explicitly, ``spec_fallbacks``).  Before a bucket the
    pieces are gathered back, once for each distinct device, and every
    data shard evaluates its lanes on the whole leaves; the gathered copy
    is freed after the bucket (where no leaf is cut, a model axis of 1,
    the pieces are the leaves and nothing is copied).  A one-process mesh
    must lie on the workload's device (the (1, 1) mesh and virtual
    meshes), on which the stored pieces are views and cost no memory.
    Over ranks (``Mesh.over_ranks``), every rank builds θ0, the basis and
    the batch from the workload's seed, stores and gathers the pieces of
    its own positions (the model axis stays inside a rank), holds the
    batch whole, scores its own lanes and all-gathers the lane losses
    (``pod_mesh.OverRanks``).

Gather-at-use keeps pod == in-process bit for bit: the gathered basis is
written into a (k, P) buffer at each leaf's offset, so every lane's lift
makes the very same matrix call on the very same strides as in-process.

Lanes are evaluated one at a time, as the reference's ``lax.map`` does:
every lane runs the same sequence of kernels at the same shapes whatever
the width of its bucket, so a lane's loss is bitwise the same in a bucket
of 8 or of 32, pipelined or not, in-process or on a mesh.  Pad lanes are
evaluated too (the reference maps over the whole bucket).  Each lane's
lift is written in place into one set of working parameters that every
lane reuses: lanes run in order on the backend's one stream, so no lane
sees another's.  Framing, staging, malicious lanes and pad masking are
the base class's.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import numpy as np
import torch

from repro_torch.configs import (ModelConfig, ShapeConfig, cut_depth,
                                 get_config, get_smoke_config)
from repro_torch.core.subspace import (SubspaceProjection, basis_to_tree,
                                       tree_lift)
from repro_torch.core.substrates.eval_backend import (DEFAULT_MIN_BUCKET,
                                                      EvalBackend, bucket_size)
from repro_torch.core.substrates.pod_mesh import OverRanks, data_shards
from repro_torch.launch.mesh import Mesh
from repro_torch.models import sharding
from repro_torch.models import transformer as T


@dataclasses.dataclass(frozen=True)
class LmWorkload:
    """One frozen LM fitness problem: model configuration + synthetic
    batch (on the device) + subspace chart, plus the engine-facing search
    box.  Built from (arch, seed) by ``make_lm_workload``, or from the
    reference's arrays by ``convert.lm_workload_from_reference``."""
    arch: str
    cfg: ModelConfig
    batch: Dict[str, torch.Tensor]   # tokens, labels (B, S) int64
    proj: SubspaceProjection
    k: int
    coeff_bound: float
    seed: int

    # -- the engine-facing search space: subspace coefficients ------------
    @property
    def x0(self) -> np.ndarray:
        return np.zeros(self.k, np.float64)          # θ0 itself

    @property
    def lo(self) -> np.ndarray:
        return np.full(self.k, -self.coeff_bound, np.float64)

    @property
    def hi(self) -> np.ndarray:
        return np.full(self.k, self.coeff_bound, np.float64)

    @property
    def step(self) -> np.ndarray:
        return np.full(self.k, 0.2 * self.coeff_bound, np.float64)


def synthetic_batch(vocab_size: int, batch_size: int, seq_len: int,
                    seed: int) -> Dict[str, np.ndarray]:
    """The reference's fixed token/label batch (the same numpy draws)."""
    rng = np.random.default_rng(seed * 7919 + 11)
    return {
        "tokens": rng.integers(0, vocab_size, (batch_size, seq_len),
                               dtype=np.int64).astype(np.int32),
        "labels": rng.integers(0, vocab_size, (batch_size, seq_len),
                               dtype=np.int64).astype(np.int32),
    }


def make_lm_workload(arch: str, *, k: int = 8, batch_size: int = 2,
                     seq_len: int = 32, seed: int = 0,
                     coeff_bound: float = 1.0, full_width: bool = False,
                     n_layers: Optional[int] = None,
                     device="cuda") -> LmWorkload:
    """Build the LM fitness problem for one architecture on ``device``.

    By default the configuration is the arch's smoke reduction, as in the
    reference; ``full_width=True`` takes the published configuration, and
    ``n_layers`` cuts its depth (every width stays as published).  The
    batch is the reference's numpy draw; θ0 and the basis are drawn from a
    ``torch.Generator`` seeded with ``seed``, with the reference's
    distributions (not its ``jax.random`` values).
    """
    cfg, batch, params0, gen = lm_model(
        arch, batch_size=batch_size, seq_len=seq_len, seed=seed,
        full_width=full_width, n_layers=n_layers, device=device)
    proj = SubspaceProjection.create(params0, k, gen)
    return LmWorkload(arch=arch, cfg=cfg, batch=batch, proj=proj, k=k,
                      coeff_bound=coeff_bound, seed=seed)


def lm_model(arch: str, *, batch_size: int = 2, seq_len: int = 32,
             seed: int = 0, full_width: bool = False,
             n_layers: Optional[int] = None, device="cuda"):
    """(cfg, batch tensors, θ0, generator) of ``make_lm_workload``'s model
    without its chart: the same configuration, batch and weights, and the
    generator left where the basis would be drawn from it."""
    cfg = get_config(arch) if full_width else get_smoke_config(arch)
    if n_layers is not None:
        cfg = cut_depth(cfg, n_layers)
    cfg = dataclasses.replace(cfg, use_kernels=True)
    batch = synthetic_batch(cfg.vocab_size, batch_size, seq_len, seed)
    gen = torch.Generator(device=device).manual_seed(seed)
    params0 = T.init_params(cfg, gen, device)
    return cfg, batch_tensors(batch, device), params0, gen


def batch_tensors(batch: Dict[str, np.ndarray],
                  device) -> Dict[str, torch.Tensor]:
    return {key: torch.as_tensor(np.asarray(val, np.int64), device=device)
            for key, val in batch.items()}


class LmLossEvalBackend(OverRanks, EvalBackend):
    """``EvalBackend`` whose ``_raw_eval`` lifts each lane's (k,) subspace
    coefficients to model parameters and returns the forward/CE loss on
    the workload's fixed batch, on the workload's device.

    ``mesh=None``: in-process.  ``mesh`` given: lanes split over
    ``data_axis``, θ0 and basis stored cut over ``model_axis`` (see the
    module docstring); ``spec_fallbacks`` lists the parameter-spec
    entries ``enforce_divisible`` downgraded to replicated, and
    ``sharded_params`` counts (parameters stored cut over ``model_axis``,
    all parameters).
    """

    def __init__(self, workload: LmWorkload, mesh: Optional[Mesh] = None, *,
                 data_axis: str = "data", model_axis: str = "model",
                 n_dims: Optional[int] = None,
                 max_bucket: Optional[int] = None):
        self.workload = workload
        self.mesh = mesh
        self._loss_fn = T.make_loss_fn(workload.cfg)
        device = workload.proj.basis.device
        # the one set of parameters every lane's lift overwrites
        self._work = workload.proj.lift(
            torch.zeros(workload.k, device=device))
        if mesh is None:
            self.n_shards = 1
            min_bucket = DEFAULT_MIN_BUCKET
        else:
            mesh.require_one_device(device)
            self.n_shards = data_shards(mesh, data_axis)
            pspecs, self.spec_fallbacks = sharding.enforce_divisible(
                workload.cfg, mesh)
            self.sharded_params = sharding.sharded_numel(
                workload.cfg, pspecs, model_axis)
            # basis leaves are the parameter leaves with a leading lane axis
            bspecs = sharding.map_specs(lambda _, s: sharding.P(None, *s),
                                        pspecs)
            tokens = workload.batch["tokens"]
            shape = ShapeConfig("lm_subspace", seq_len=tokens.shape[1],
                                global_batch=tokens.shape[0], kind="train")
            _, in_specs = sharding.input_specs(workload.cfg, shape, mesh)
            if mesh.spans_ranks:
                # every lane scores the whole batch, and a rank holds only
                # its own data positions: it keeps the batch whole
                in_specs = sharding.map_specs(lambda *_: sharding.P(),
                                              in_specs)
            self._theta = sharding.to_named(workload.proj.theta0, pspecs,
                                            mesh)
            self._basis = sharding.to_named(workload.proj.basis_tree, bspecs,
                                            mesh)
            self._batch = sharding.to_named(workload.batch, in_specs, mesh)
            # lanes run one at a time, so any rows-per-shard count is
            # width-stable: the floor is just even division
            min_bucket = bucket_size(self.n_shards)
        super().__init__(min_bucket, device)
        if n_dims is not None and max_bucket is not None:
            self.warm(n_dims, max_bucket)

    def lane_loss(self, c: torch.Tensor) -> torch.Tensor:
        """The loss at θ0 + c·V, a 0-d f32 tensor (c: (k,) f32 on the
        workload's device)."""
        wl = self.workload
        return self._loss(wl.proj.theta0, wl.proj.basis_tree, wl.batch, c)

    def _loss(self, theta0, basis_tree, batch, c: torch.Tensor):
        with torch.no_grad():
            params = tree_lift(theta0, basis_tree, c, out=self._work)
            return self._loss_fn(params, batch)[0]

    def _raw_eval(self, pts: torch.Tensor) -> torch.Tensor:
        out = torch.empty(pts.shape[0], dtype=torch.float32,
                          device=pts.device)
        if self.mesh is None:
            for i in range(pts.shape[0]):
                out[i] = self.lane_loss(pts[i])
            return out
        # the whole leaves, gathered once for the mesh's one device: the
        # basis into a (k, P) buffer laid out as the workload's own.  The
        # batch too: every lane's loss is over the whole batch (the
        # reference gives each data shard its slice when the batch divides
        # the data axes, ROADMAP C)
        wl = self.workload
        basis = sharding.held_whole(self._basis)
        if basis is None:
            basis = basis_to_tree(torch.empty_like(wl.proj.basis),
                                  wl.proj.theta0)
            sharding.gather(self._basis, out=basis)
        theta0 = sharding.gather(self._theta)
        batch = sharding.gather(self._batch)
        # data shard s's lanes are the s-th block of kp / n_shards rows,
        # each run in order: over this process's shards in order, every
        # lane in order
        for i in range(pts.shape[0]):
            out[i] = self._loss(theta0, basis, batch, pts[i])
        return out
