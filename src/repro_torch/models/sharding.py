"""Sharding rules: PartitionSpec mirrors of the parameter, cache and input
trees.

Port of ``repro/models/sharding.py``.  Megatron-style TP over the
``model`` axis, DP over ``data`` (+ ``pod``).  Specs are assigned by walking the parameter
tree's shapes (``transformer.param_specs``, the ``Leaf`` tree
``init_params`` draws from), so they cannot drift structurally from the
parameters, and the decode caches' from ``transformer.init_cache``'s
shapes; a stacked segment's leaves carry the leading layer axis, as the
reference's do.

The reference hands its specs to JAX (``NamedSharding``, ``device_put``);
the port's ``to_named`` cuts each tensor of a tree into its per-shard
pieces along its spec (``Sharded``), and ``gather`` puts a tree's pieces
back together, as the reference's tiled all-gather does.

Training's data axis over the ranks of a process group (``Mesh.over_ranks``)
takes the collectives GSPMD inserts in the reference's step:
``RankSum`` sums the loss's reductions over the batch and the gradients
over the ranks, and counts the bytes it hands to each all-reduce;
``data_parallel_ctx`` puts it in the step's ``ShardCtx``.
"""
from __future__ import annotations

import math
import time
from typing import Any, Callable, Dict, List, Optional, Tuple

import torch
import torch.distributed as dist

from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.core.tree import leaves_with_paths, map_with_paths
from repro_torch.models import transformer as T
from repro_torch.models.transformer import TensorShape


class PartitionSpec(tuple):
    """One entry per leading dimension: a mesh axis name, a tuple of them
    (the dimension split over their product, major first), or None
    (replicated).  Dimensions past the last entry are replicated.  A
    one-name tuple is that name, as in JAX."""

    def __new__(cls, *entries):
        return super().__new__(cls, (
            e[0] if isinstance(e, tuple) and len(e) == 1 else e
            for e in entries))

    def __repr__(self) -> str:
        return f"P{tuple.__repr__(self)}"


P = PartitionSpec


def mesh_axes(mesh) -> Tuple[Tuple[str, ...], str]:
    """Returns (dp_axes, tp_axis) from mesh axis names."""
    if "pod" in mesh.axis_names:
        return ("pod", "data"), "model"
    return ("data",), "model"


def _div(n: int, k: int) -> bool:
    return n % k == 0


def map_specs(fn: Callable, tree: Any, *rest: Any, path: tuple = ()) -> Any:
    """``fn(path, leaf, *rest_leaves)`` over trees of one structure, in
    JAX's flatten order (dict keys sorted); a path is the tuple of dict
    keys and list indices, the reference's ``_path_names``.  A
    ``PartitionSpec`` is a leaf."""
    if isinstance(tree, dict):
        return {key: map_specs(fn, tree[key], *(r[key] for r in rest),
                               path=path + (key,))
                for key in sorted(tree)}
    if isinstance(tree, (list, tuple)) and not isinstance(tree, P):
        return [map_specs(fn, sub, *(r[i] for r in rest), path=path + (i,))
                for i, sub in enumerate(tree)]
    return fn(path, tree, *rest)


def _path_str(path: tuple) -> str:
    return "/".join(str(n) for n in path)


def spec_leaves(tree: Any) -> List[Tuple[str, Any]]:
    """[(path, leaf), ...] in JAX's flatten order (dict keys sorted), a
    ``PartitionSpec`` counting as a leaf."""
    out: List[Tuple[str, Any]] = []
    map_specs(lambda path, leaf: out.append((_path_str(path), leaf)), tree)
    return out


def _axis_size(mesh, entry) -> int:
    axes = entry if isinstance(entry, tuple) else (entry,)
    return math.prod(mesh.shape[a] for a in axes)


# ---------------------------------------------------------------------------
# Parameters
# ---------------------------------------------------------------------------

def _param_spec(name: str, ndim: int, shape, cfg: ModelConfig, tp: str,
                tp_size: int) -> P:
    """Sharding rule for one parameter, identified by its dict key."""
    kv_ok = _div(cfg.n_kv_heads, tp_size)
    if name in ("wq", "w_uk", "w_uv", "w_r", "w_k", "w_v", "w_g", "w_lora_b"):
        return P(None, tp, None)                       # (in, heads, hd)
    if name in ("wk", "wv"):
        return P(None, tp, None) if kv_ok else P(None, None, None)
    if name in ("wo", "w_o"):
        return P(tp, None, None)                       # (heads, hd, out)
    if name == "bq":
        return P(tp, None)
    if name in ("bk", "bv"):
        return P(tp, None) if kv_ok else P(None, None)
    if name in ("w_gate", "w_in"):
        return P(tp, None, None) if ndim == 3 else P(None, tp)   # MoE (E,d,ff) / dense
    if name == "w_out":
        return P(tp, None, None) if ndim == 3 else P(tp, None)
    if name == "tok":
        return P(tp, None) if _div(shape[0], tp_size) else P(None, None)
    if name == "w" and ndim == 2:                      # lm head (d, V)
        return P(None, tp) if _div(shape[1], tp_size) else P(None, None)
    if name in ("w0", "u", "ln_out"):
        return P(tp, None)                             # rwkv (H, hd)
    if name in ("w_k_cm",):
        return P(None, tp)
    if name in ("w_v_cm",):
        return P(tp, None)
    if name in ("w_z", "w_xs", "conv_w_xs"):
        return P(None, tp)                             # mamba (d|W, d_in)
    if name == "conv_b_xs":
        return P(tp)
    if name == "norm" and ndim == 1 and shape[0] != cfg.d_model:
        return P(tp)                                   # mamba d_in norm
    if name == "out_proj":
        return P(tp, None)
    # everything else (norms, biases, router, mu_*, loras, small convs): replicate
    return P(*([None] * ndim))


def param_specs(cfg: ModelConfig, mesh, fsdp: bool = False):
    """A ``PartitionSpec`` for every parameter, in a tree shaped like the
    parameters.  ``fsdp=True`` also shards every parameter of at least 2²⁰
    elements over the 'data' axis (its largest unsharded, data-divisible
    dimension); the 'pod' axis stays replicated."""
    dp, tp = mesh_axes(mesh)
    tp_size = mesh.shape[tp]
    fsdp_size = mesh.shape["data"]
    segs = T.find_segments(T.layer_sigs(cfg))

    def assign(path, leaf):
        shape = tuple(leaf.shape)
        stacked = path[0] == "segments" and segs[path[1]][1] > 1
        base_shape = shape[1:] if stacked else shape
        base_ndim = len(base_shape)
        name = next((n for n in reversed(path) if isinstance(n, str)
                     and n != "segments"), "")
        spec = _param_spec(name, base_ndim, base_shape, cfg, tp, tp_size)
        if fsdp and math.prod(shape) >= (1 << 20):
            entries = list(spec)
            # largest unsharded, data-divisible dim gets the 'data' axis
            cands = [(base_shape[i], i) for i in range(base_ndim)
                     if entries[i] is None and _div(base_shape[i], fsdp_size)]
            if cands:
                _, idx = max(cands)
                entries[idx] = "data"
                spec = P(*entries)
        if stacked:
            spec = P(*((None,) + tuple(spec)))
        return spec

    return map_specs(assign, T.param_specs(cfg))


def enforce_divisible(cfg: ModelConfig, mesh, specs=None):
    """Downgrade any spec entry whose dimension does not divide its mesh
    axes to replicated, and report each downgrade.

    A rule can emit a spec a small configuration cannot honour (a smoke
    config's 4 heads over model=16); cutting such a leaf into equal pieces
    is impossible, so this walk is the one place the divisibility
    contract is enforced tree-wide.  Returns ``(specs, fallbacks)``, each
    fallback ``(path, dim, axis_entry, dim_size)``.
    """
    if specs is None:
        specs = param_specs(cfg, mesh)
    fallbacks = []

    def fix(path, spec, leaf):
        entries = list(spec)
        for dim, e in enumerate(entries):
            if e is not None and leaf.shape[dim] % _axis_size(mesh, e):
                fallbacks.append((_path_str(path), dim, e, leaf.shape[dim]))
                entries[dim] = None
        return P(*entries)

    fixed = map_specs(fix, specs, T.param_specs(cfg))
    return fixed, fallbacks


# ---------------------------------------------------------------------------
# Decode caches
# ---------------------------------------------------------------------------

def cache_specs(cfg: ModelConfig, shape: ShapeConfig, mesh):
    """A ``PartitionSpec`` for every leaf of ``init_cache(cfg,
    shape.global_batch, shape.seq_len)``: the batch over the data axes
    where it divides them, else the sequence over every axis; k/v, MLA's
    c_kv / k_rope and their int8 scales' sequence over ``model``, rwkv6's
    wkv state's heads over ``model`` where they divide it, its shifts
    replicated, Mamba2's ssm state's heads and conv_xs's channels over
    ``model``, conv_bc replicated."""
    dp, tp = mesh_axes(mesh)
    dp_size = math.prod(mesh.shape[a] for a in dp)
    tp_size = mesh.shape[tp]
    b = shape.global_batch
    b_spec = dp if (b > 1 and _div(b, dp_size)) else None
    # sequence dim: over tp normally; over everything when batch can't shard
    s_spec = tp if b_spec is not None else tuple(dp) + (tp,)
    segs = T.find_segments(T.layer_sigs(cfg))

    def assign(path, leaf):
        stacked = segs[path[0]][1] > 1
        name = path[-1]
        if name in ("k", "v"):
            spec = P(b_spec, s_spec, None, None)
        elif name.endswith("_scale"):
            spec = P(b_spec, s_spec)
        elif name == "wkv":
            h = leaf.shape[2] if stacked else leaf.shape[1]
            spec = P(b_spec, tp if _div(h, tp_size) else None, None, None)
        elif name in ("shift_tm", "shift_cm"):
            spec = P(b_spec, None)
        elif name in ("c_kv", "k_rope"):
            spec = P(b_spec, s_spec, None)
        elif name == "ssm":
            spec = P(b_spec, tp, None, None)
        elif name == "conv_xs":
            spec = P(b_spec, None, tp)
        elif name == "conv_bc":
            spec = P(b_spec, None, None)
        else:
            raise ValueError(name)
        if stacked:
            spec = P(*((None,) + tuple(spec)))
        return spec

    return map_specs(assign, T.init_cache(cfg, b, shape.seq_len,
                                          as_shape=True))


# ---------------------------------------------------------------------------
# Inputs
# ---------------------------------------------------------------------------

def input_specs(cfg: ModelConfig, shape: ShapeConfig, mesh):
    """Returns (batch shapes, batch specs) for the given cell.

    train/prefill: token (or stub-embedding) batch.  decode: (tokens, t).
    Tokens and labels are int64, as the port's batches carry them.
    """
    dp, tp = mesh_axes(mesh)
    dp_size = math.prod(mesh.shape[a] for a in dp)
    b, s = shape.global_batch, shape.seq_len
    b_spec = dp if (b > 1 and _div(b, dp_size)) else None

    if shape.kind == "decode":
        sds = {"tokens": TensorShape((b, 1), torch.int64),
               "t": TensorShape((), torch.int64)}
        specs = {"tokens": P(b_spec, None), "t": P()}
        return sds, specs

    if cfg.frontend == "audio_stub":
        sds = {"embeds": TensorShape((b, s, cfg.d_model),
                                     T.param_dtype(cfg)),
               "labels": TensorShape((b, s), torch.int64),
               "mask": TensorShape((b, s), torch.bool)}
        specs = {"embeds": P(b_spec, None, None), "labels": P(b_spec, None),
                 "mask": P(b_spec, None)}
    else:
        sds = {"tokens": TensorShape((b, s), torch.int64),
               "labels": TensorShape((b, s), torch.int64)}
        specs = {"tokens": P(b_spec, None), "labels": P(b_spec, None)}
    if shape.kind == "prefill":
        del sds["labels"], specs["labels"]
        if cfg.frontend == "audio_stub":
            del sds["mask"], specs["mask"]
    return sds, specs


# ---------------------------------------------------------------------------
# Placement: a tree cut into per-shard pieces, and put back together
# ---------------------------------------------------------------------------

class Sharded:
    """One tensor stored cut along ``spec`` over ``mesh``.

    Dimension d is cut into as many equal blocks as the product of its
    entry's axis sizes; the device at mesh coordinates c holds the block
    whose index along d is c's row-major index over those axes (JAX's
    placement).  Each distinct block is kept once, on the device of the
    first coordinate holding it: a piece placed on the device its source
    already lies on is a view of the source, not a copy.  Only the
    positions this process holds (``mesh.local_positions()``) get their
    blocks: on a mesh over ranks a rank keeps its own.
    """

    def __init__(self, x: torch.Tensor, spec: P, mesh):
        if len(spec) > x.dim():
            raise ValueError(f"spec {spec} has more entries than "
                             f"{tuple(x.shape)} has dimensions")
        self.spec, self.mesh = spec, mesh
        self.shape, self.dtype = tuple(x.shape), x.dtype
        self.cuts = tuple(1 if e is None else _axis_size(mesh, e)
                          for e in spec) + (1,) * (x.dim() - len(spec))
        for dim, n in enumerate(self.cuts):
            if self.shape[dim] % n:
                raise ValueError(f"dimension {dim} of {self.shape} does not "
                                 f"divide into {n} blocks ({spec})")
        self._pos = {a: i for i, a in enumerate(mesh.axis_names)}
        self.pieces: Dict[tuple, torch.Tensor] = {}
        for coords in mesh.local_positions():
            block = self.block_of(coords)
            if block not in self.pieces:
                self.pieces[block] = self._narrow(x, block).to(
                    mesh.devices[coords])

    def block_of(self, coords: tuple) -> tuple:
        """The block index, per dimension, held at mesh ``coords``."""
        out = []
        for e in self.spec:
            idx = 0
            for a in (() if e is None else e if isinstance(e, tuple)
                      else (e,)):
                idx = idx * self.mesh.shape[a] + coords[self._pos[a]]
            out.append(idx)
        return tuple(out) + (0,) * (len(self.shape) - len(self.spec))

    def _narrow(self, x: torch.Tensor, block: tuple) -> torch.Tensor:
        for dim, (i, n) in enumerate(zip(block, self.cuts)):
            if n > 1:
                step = self.shape[dim] // n
                x = x.narrow(dim, i * step, step)
        return x

    def local(self, coords: tuple) -> torch.Tensor:
        """The piece the device at mesh ``coords`` holds."""
        return self.pieces[self.block_of(coords)]

    def whole(self) -> Optional[torch.Tensor]:
        """The one piece if it is the whole tensor (no dimension cut),
        else None."""
        if all(n == 1 for n in self.cuts):
            return self.pieces[(0,) * len(self.shape)]
        return None

    def gather(self, out: Optional[torch.Tensor] = None) -> torch.Tensor:
        """The whole tensor, its pieces written in block order into
        ``out`` (a new tensor on the first piece's device if None).  Every
        block must be held here: across ranks a gather is a collective."""
        if len(self.pieces) != math.prod(self.cuts):
            raise ValueError(
                f"this process holds {len(self.pieces)} of the "
                f"{math.prod(self.cuts)} blocks of {self.shape} ({self.spec} "
                f"over {self.mesh})")
        first = next(iter(self.pieces.values()))
        if out is None:
            out = torch.empty(self.shape, dtype=self.dtype,
                              device=first.device)
        for block, piece in self.pieces.items():
            self._narrow(out, block).copy_(piece)
        return out


def to_named(tree: Any, specs: Any, mesh) -> Any:
    """``tree`` cut into per-shard pieces along ``specs`` (a tree of
    ``PartitionSpec`` of the same structure): a tree of ``Sharded``."""
    return map_specs(lambda _, x, spec: Sharded(x, spec, mesh), tree, specs)


def gather(tree: Any, out: Any = None) -> Any:
    """A tree of ``Sharded`` put back together, into the tensors of
    ``out`` (a tree of the same structure) if given."""
    if out is None:
        return map_specs(lambda _, s: s.gather(), tree)
    return map_specs(lambda _, s, dst: s.gather(dst), tree, out)


def held_whole(tree: Any) -> Optional[Any]:
    """A tree of ``Sharded`` as its pieces if every leaf is held whole
    (``Sharded.whole``): the source's own tensors where they lie on the
    mesh's device, gathered at no cost.  None if any leaf is cut."""
    pieces = map_specs(lambda _, s: s.whole(), tree)
    if any(p is None for _, p in spec_leaves(pieces)):
        return None
    return pieces


# ---------------------------------------------------------------------------
# The data axis over ranks: sums that a training step hands to all-reduces
# ---------------------------------------------------------------------------

class _SumOverRanks(torch.autograd.Function):
    """x summed over the ranks of the default process group; the
    backward is the identity.  Every rank computes the same global value
    from the sum and the ranks' gradients are summed afterwards
    (``RankSum.sum_grads``), so each rank passes the upstream gradient to
    its own term unchanged and the ranks' gradients add up to the global
    one.  (``torch.distributed.nn.functional.all_reduce`` sums the
    upstream gradients over the ranks in its backward, which counts every
    global term once a rank.)"""

    @staticmethod
    def forward(ctx, x):
        out = x.clone()
        dist.all_reduce(out)
        return out

    @staticmethod
    def backward(ctx, grad):
        return grad


class RankSum:
    """Sums over the ranks of a mesh's data axis (``Mesh.over_ranks``, the
    default process group), where the reference's GSPMD inserts them in a
    step over a batch cut over ``data``: ``sum`` for a reduction of the
    loss over the batch (the cross-entropy's sums, MoE's load-balance
    statistics), ``sum_grads`` for the data-parallel gradient all-reduce.

    Counts what it hands to the all-reduces: ``gradient_bytes`` and
    ``gradient_all_reduces`` for the gradients, ``loss_bytes`` and
    ``loss_all_reduces`` for the loss's sums (which the dry-run leaves
    out, ``roofline/analysis.py``), and ``gradient_seconds``, the host
    wall of the gradient all-reduces with the device synchronized on
    either side, so that it is the collective's own time."""

    def __init__(self, mesh):
        if not mesh.spans_ranks:
            raise ValueError(f"{mesh} is a one-process mesh: its data axis "
                             f"spans no ranks to sum over")
        self.world = mesh.world
        self.gradient_bytes = self.gradient_all_reduces = 0
        self.loss_bytes = self.loss_all_reduces = 0
        self.gradient_seconds = 0.0

    def sum(self, x: torch.Tensor) -> torch.Tensor:
        """``x`` summed over the ranks, the same on every rank; autograd
        passes through it (the identity backward, ``_SumOverRanks``)."""
        self.loss_bytes += x.numel() * x.element_size()
        self.loss_all_reduces += 1
        return _SumOverRanks.apply(x)

    def sum_grads(self, grads: Any) -> Any:
        """A gradient tree summed over the ranks: one flat buffer a type,
        in the parameters' own types (the dry-run's "local piece of every
        parameter in the parameter's type"), all-reduced; the returned
        leaves are views of it, in leaf order.  Every rank gets the same
        bits."""
        leaves = leaves_with_paths(grads)
        by_dtype: Dict[torch.dtype, list] = {}
        for path, g in leaves:
            by_dtype.setdefault(g.dtype, []).append((path, g))
        summed = {}
        for items in by_dtype.values():
            flat = torch.cat([g.reshape(-1) for _, g in items])
            self.gradient_bytes += flat.numel() * flat.element_size()
            self.gradient_all_reduces += 1
            cuda = flat.device.type == "cuda"
            if cuda:
                torch.cuda.synchronize(flat.device)
            t0 = time.perf_counter()
            dist.all_reduce(flat)
            if cuda:
                torch.cuda.synchronize(flat.device)
            self.gradient_seconds += time.perf_counter() - t0
            for (path, g), piece in zip(items, torch.split(
                    flat, [g.numel() for _, g in items])):
                summed[path] = piece.view(g.shape)
        return map_with_paths(lambda path, _: summed[path], grads)


def data_parallel_ctx(mesh) -> T.ShardCtx:
    """The ``ShardCtx`` of a step over ``mesh`` whose data axis spans
    ranks: every reduction over the batch and the gradients summed over
    them (``RankSum``)."""
    dp, tp = mesh_axes(mesh)
    return T.ShardCtx(mesh=mesh, dp=dp, tp=tp, ranks=RankSum(mesh))


def sharded_numel(cfg: ModelConfig, specs: Any,
                  axis: str = "model") -> Tuple[int, int]:
    """(parameters in leaves cut along ``axis``, all parameters)."""
    cut = total = 0
    for (_, spec), (_, leaf) in zip(spec_leaves(specs),
                                    spec_leaves(T.param_specs(cfg))):
        n = math.prod(leaf.shape)
        total += n
        if any(e == axis or (isinstance(e, tuple) and axis in e)
               for e in spec):
            cut += n
    return cut, total
