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
``data_parallel_ctx`` puts it in the step's ``ShardCtx``.  With the
parameters cut over ``data`` as well (the reference's ``--fsdp``,
``param_specs(fsdp=True)``), ``RankShards`` holds rank r's block of each
cut leaf, all-gathers a leaf where the step uses it and reduce-scatters
its gradient; ``fsdp_ctx`` puts it in the step's ``ShardCtx``.  With the
parameters cut over ``model`` across the ranks (Megatron's tensor
parallelism, ``Mesh.over_ranks(model_ranks=)``), ``ModelShards`` holds
rank r's ``model`` block of every leaf, and the step takes the
collectives GSPMD inserts around a cut unit as explicit autograd
functions (``_EnterModel``, ``_ReduceModel``); ``tp_ctx`` puts it in the
step's ``ShardCtx``.
"""
from __future__ import annotations

import contextlib
import math
import time
import weakref
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

    Where the mesh's model axis spans ranks (``Mesh.over_ranks(
    model_ranks=M)``) a view would keep the whole source alive on every
    rank, so the rank keeps a contiguous copy instead (``held``): of its
    model block, the contiguous 1/M of the dimension cut over ``model``
    (``over_model`` is that dimension), or of the whole tensor where the
    spec does not name ``model``; its pieces are views of the copy.
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
        self.held: Optional[torch.Tensor] = None
        self.over_model: Optional[int] = None
        self._origin = (0,) * x.dim()
        if mesh.model_ranks > 1:
            x = self._hold(x)
        for coords in mesh.local_positions():
            block = self.block_of(coords)
            if block not in self.pieces:
                self.pieces[block] = self._narrow(x, block, self._origin).to(
                    mesh.devices[coords])

    def _hold(self, x: torch.Tensor) -> torch.Tensor:
        """The rank's contiguous copy of ``x``'s model block (or of ``x``),
        kept as ``held``."""
        dim = model_dim(self.spec)
        if dim is not None:
            if self.spec[dim] != "model":
                raise NotImplementedError(
                    f"{self.spec}: a dimension cut over 'model' with "
                    f"another axis cannot span model ranks")
            n = self.shape[dim] // self.mesh.model_ranks
            x = x.narrow(dim, self.mesh.rank % self.mesh.model_ranks * n, n)
            self.over_model = dim
            self._origin = tuple(
                self.mesh.rank % self.mesh.model_ranks * n if d == dim
                else 0 for d in range(x.dim()))
        self.held = x.clone(memory_format=torch.contiguous_format)
        return self.held

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

    def _narrow(self, x: torch.Tensor, block: tuple,
                origin: Optional[tuple] = None) -> torch.Tensor:
        """``block`` of ``x``, whose first element lies at ``origin`` of
        the whole (the rank's copy's; None: ``x`` is the whole)."""
        origin = origin or (0,) * x.dim()
        for dim, (i, n) in enumerate(zip(block, self.cuts)):
            step = self.shape[dim] // n
            if x.shape[dim] != step:
                x = x.narrow(dim, i * step - origin[dim], step)
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
        """The whole tensor, written into ``out`` (a new tensor on the
        first piece's device if None): its pieces in block order, or, cut
        over model ranks (``over_model``), the model group's copies
        all-gathered straight into ``out``'s slices along that dimension.
        Every other block must be held here: a block held by a rank of
        another data block is not gathered."""
        world = 1 if self.over_model is None else self.mesh.model_ranks
        if len(self.pieces) * world != math.prod(self.cuts):
            raise ValueError(
                f"this process holds {len(self.pieces)} of the "
                f"{math.prod(self.cuts)} blocks of {self.shape} ({self.spec} "
                f"over {self.mesh})")
        first = next(iter(self.pieces.values()))
        if out is None:
            out = torch.empty(self.shape, dtype=self.dtype,
                              device=first.device)
        if self.over_model is not None:
            n = self.held.shape[self.over_model]
            dist.all_gather([out.narrow(self.over_model, j * n, n)
                             for j in range(world)], self.held,
                            group=self.mesh.model_group)
            return out
        for block, piece in self.pieces.items():
            self._narrow(out, block).copy_(piece)
        return out

    @property
    def nbytes(self) -> int:
        """The bytes of the blocks this process holds."""
        return sum(p.numel() * p.element_size()
                   for p in self.pieces.values())


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

def timed(fn: Callable, x: torch.Tensor):
    """(``fn()``, its host wall in seconds with ``x``'s device synchronized
    on either side, so that a collective's own time is read)."""
    cuda = x.device.type == "cuda"
    if cuda:
        torch.cuda.synchronize(x.device)
    t0 = time.perf_counter()
    out = fn()
    if cuda:
        torch.cuda.synchronize(x.device)
    return out, time.perf_counter() - t0


class _SumOverRanks(torch.autograd.Function):
    """x summed over the ranks of ``group`` (None: the default process
    group); the backward is the identity.  Every rank computes the same
    global value from the sum and the ranks' gradients are summed
    afterwards (``RankSum.sum_grads``), so each rank passes the upstream
    gradient to its own term unchanged and the ranks' gradients add up to
    the global one.  (``torch.distributed.nn.functional.all_reduce`` sums
    the upstream gradients over the ranks in its backward, which counts
    every global term once a rank.)"""

    @staticmethod
    def forward(ctx, x, group):
        out = x.clone()
        dist.all_reduce(out, group=group)
        return out

    @staticmethod
    def backward(ctx, grad):
        return grad, None


def _sum_flat(leaves: List[Tuple[str, torch.Tensor]], group
              ) -> Tuple[Dict[str, torch.Tensor], int, int, float]:
    """``leaves`` summed over the ranks of ``group``: one flat buffer a
    type, in the leaves' own types, all-reduced.  Returns ({path: the
    sum, a view of its buffer}, the bytes handed to the all-reduces,
    their number, their seconds with the device synchronized on either
    side)."""
    by_dtype: Dict[torch.dtype, list] = {}
    for path, g in leaves:
        by_dtype.setdefault(g.dtype, []).append((path, g))
    summed, nbytes, seconds = {}, 0, 0.0
    for items in by_dtype.values():
        flat = torch.cat([g.reshape(-1) for _, g in items])
        nbytes += flat.numel() * flat.element_size()
        _, s = timed(lambda: dist.all_reduce(flat, group=group), flat)
        seconds += s
        for (path, g), piece in zip(items, torch.split(
                flat, [g.numel() for _, g in items])):
            summed[path] = piece.view(g.shape)
    return summed, nbytes, len(by_dtype), seconds


class RankSum:
    """Sums over the ranks of a mesh's data axis (``Mesh.over_ranks``, its
    ``data_group``: the default process group where the model axis spans
    no ranks), where the reference's GSPMD inserts them in a step over a
    batch cut over ``data``: ``sum`` for a reduction of the loss over the
    batch (the cross-entropy's sums, MoE's load-balance statistics),
    ``sum_grads`` for the data-parallel gradient all-reduce.

    Counts what it hands to the all-reduces: ``gradient_bytes`` and
    ``gradient_all_reduces`` for the gradients, ``loss_bytes`` and
    ``loss_all_reduces`` for the loss's sums (the dry-run's "data
    gradient" and "loss" entries, ``roofline/analysis.py``, count each
    twice, the ring), and ``gradient_seconds``, the host wall of the
    gradient all-reduces with the device synchronized on either side, so
    that it is the collective's own time."""

    def __init__(self, mesh):
        if not mesh.spans_ranks:
            raise ValueError(f"{mesh} is a one-process mesh: its data axis "
                             f"spans no ranks to sum over")
        #: the ranks of the data axis, and their group
        self.world, self.group = mesh.data_ranks, mesh.data_group
        self.gradient_bytes = self.gradient_all_reduces = 0
        self.loss_bytes = self.loss_all_reduces = 0
        self.gradient_seconds = 0.0

    def sum(self, x: torch.Tensor) -> torch.Tensor:
        """``x`` summed over the ranks, the same on every rank; autograd
        passes through it (the identity backward, ``_SumOverRanks``)."""
        self.loss_bytes += x.numel() * x.element_size()
        self.loss_all_reduces += 1
        return _SumOverRanks.apply(x, self.group)

    def sum_grads(self, grads: Any) -> Any:
        """A gradient tree summed over the ranks: one flat buffer a type,
        in the parameters' own types (the dry-run's "local piece of every
        parameter in the parameter's type"), all-reduced; the returned
        leaves are views of it, in leaf order.  Every rank gets the same
        bits."""
        summed, nbytes, calls, seconds = _sum_flat(
            leaves_with_paths(grads), self.group)
        self.gradient_bytes += nbytes
        self.gradient_all_reduces += calls
        self.gradient_seconds += seconds
        return map_with_paths(lambda path, _: summed[path], grads)

    #: the clip's norm over the ranks (``RankShards.combine_norm``); a
    #: rank that holds every leaf whole has the global gradient already
    combine_norm = None
    #: the model axis's hooks (``ModelShards``): a rank that holds every
    #: leaf whole is model block 0 of 1, and its units are not cut
    model_ranks, model_block = 1, 0
    table_cut = head_cut = False

    def use(self, tree: Any, path: str) -> Any:
        """``tree`` (the subtree at ``path``) as a step uses it: every
        leaf is held whole here."""
        return tree

    def packing(self):
        """The context a forward runs in (``RankShards.packing``)."""
        return contextlib.nullcontext()


def data_parallel_ctx(mesh) -> T.ShardCtx:
    """The ``ShardCtx`` of a step over ``mesh`` whose data axis spans
    ranks: every reduction over the batch and the gradients summed over
    them (``RankSum``)."""
    dp, tp = mesh_axes(mesh)
    return T.ShardCtx(mesh=mesh, dp=dp, tp=tp, ranks=RankSum(mesh))


# ---------------------------------------------------------------------------
# Parameters cut over the data axis across ranks (the reference's --fsdp)
# ---------------------------------------------------------------------------

#: the tensor forms of the two collectives (torch renamed them; gloo takes
#: the blocks concatenated along the leading dimension, not stacked)
_ALL_GATHER = getattr(dist, "all_gather_single", None) \
    or dist.all_gather_into_tensor
_REDUCE_SCATTER = getattr(dist, "reduce_scatter_single", None) \
    or dist.reduce_scatter_tensor


def data_dim(spec) -> Optional[int]:
    """The dimension ``spec`` cuts over ``data``, or None."""
    for dim, e in enumerate(spec):
        if e == "data" or (isinstance(e, tuple) and "data" in e):
            return dim
    return None


def model_dim(spec) -> Optional[int]:
    """The dimension ``spec`` cuts over ``model``, or None."""
    for dim, e in enumerate(spec):
        if e == "model" or (isinstance(e, tuple) and "model" in e):
            return dim
    return None


def rank_cut(spec, mesh) -> Optional[Tuple[int, Any, int]]:
    """Where ``spec`` cuts a leaf over ranks of ``mesh`` (``Mesh.over_ranks``):
    (the dimension, the group of ranks that hold its blocks, their
    number), or None where every rank holds it whole: a ``model`` entry
    where the model axis spans ranks, else a ``data`` entry where the data
    axis does."""
    if mesh.model_ranks > 1 and model_dim(spec) is not None:
        return model_dim(spec), mesh.model_group, mesh.model_ranks
    if mesh.data_ranks > 1 and data_dim(spec) is not None:
        return data_dim(spec), mesh.data_group, mesh.data_ranks
    return None


def gather_blocks(piece: torch.Tensor, dim: int, world: int,
                  group=None) -> torch.Tensor:
    """The whole tensor of which rank r of ``group`` (None: the default
    process group) holds block r along ``dim`` (``piece`` here): one
    all-gather of the blocks concatenated along the leading dimension,
    then, for another ``dim``, the blocks moved into place (one copy)."""
    piece = piece.contiguous()
    out = torch.empty((world * piece.shape[0],) + tuple(piece.shape[1:]),
                      dtype=piece.dtype, device=piece.device)
    _ALL_GATHER(out, piece, group=group)
    if dim == 0:
        return out
    shape = list(piece.shape)
    shape[dim] *= world
    return out.view((world,) + tuple(piece.shape)).movedim(0, dim).reshape(
        shape)


def scatter_blocks(whole: torch.Tensor, dim: int, world: int,
                   group=None) -> torch.Tensor:
    """This rank's block along ``dim`` of ``whole`` summed over the ranks:
    one reduce-scatter of the blocks laid along the leading dimension."""
    n = whole.shape[dim] // world
    if dim == 0:
        src = whole.contiguous()
    else:
        src = whole.unflatten(dim, (world, n)).movedim(dim, 0).contiguous() \
            .flatten(0, 1)
    shape = list(whole.shape)
    shape[dim] = n
    out = torch.empty(shape, dtype=whole.dtype, device=whole.device)
    _REDUCE_SCATTER(out, src, group=group)
    return out


class _Gathered:
    """One gather of a piece for use: where the step's autograd saves the
    whole (a view of it) for the backward, the forward's ``packing`` keeps
    this record instead, and the backward gathers the piece again at its
    first read (``whole``), once, until the gradient is reduce-scattered
    (``release``)."""

    def __init__(self, shards: "RankShards", piece: torch.Tensor, dim: int):
        self.shards, self.piece, self.dim = shards, piece.detach(), dim
        self.root: Optional[weakref.ref] = None
        self.again: Optional[torch.Tensor] = None

    def whole(self) -> torch.Tensor:
        if self.again is None:
            self.again = self.shards.gather(self.piece, self.dim)
        return self.again

    def release(self) -> None:
        self.again = None


class _GatherForUse(torch.autograd.Function):
    """A piece all-gathered for use; the backward reduce-scatters the whole
    leaf's gradient into the piece's, summed over the ranks."""

    @staticmethod
    def forward(ctx, piece, record):
        ctx.record = record
        return record.shards.gather(piece, record.dim)

    @staticmethod
    def backward(ctx, grad):
        record = ctx.record
        record.release()
        return record.shards.scatter(grad, record.dim), None


def _root(x: torch.Tensor) -> torch.Tensor:
    return x if x._base is None else x._base


class _Blocks(RankSum):
    """A ``RankSum`` whose rank holds only its block of the leaves it
    cuts: ``specs`` (the tree's specs), ``cuts`` (path -> the cut
    dimension of the leaf as held) and ``cut_group`` (the ranks that hold
    a cut leaf's blocks) are set by the subclass, ``coords`` is the
    rank's mesh position."""

    def shard(self, params: Any) -> Any:
        """``params`` (whole, the same on every rank) with each cut leaf
        replaced by a copy of this rank's block: the wholes can be
        freed."""
        specs = dict(spec_leaves(self.specs))

        def keep(path, x):
            if path not in self.cuts:
                return x
            sh = Sharded(x, specs[path], self.mesh)
            piece = sh.local(self.coords)
            return piece if piece is sh.held else piece.clone()
        return map_with_paths(keep, params)

    def whole_leaves(self, tree: Any) -> Dict[str, torch.Tensor]:
        """The leaves of a parameter-shaped ``tree`` held whole, by path."""
        return {path: x for path, x in leaves_with_paths(tree)
                if path not in self.cuts}

    def combine_norm(self, sums: List[Tuple[str, torch.Tensor]]
                     ) -> torch.Tensor:
        """The clip's global norm from the leaves' squared sums, slice by
        slice (``adamw.global_norm``): the cut pieces' summed over
        ``cut_group``, the whole leaves' (every rank holds their summed
        gradient) added once.  Every rank gets the same value (kept in
        ``gnorms``)."""
        zero = torch.zeros((), dtype=torch.float32, device=sums[0][1].device)
        cut = sum((s for path, s in sums if path in self.cuts), zero)
        dist.all_reduce(cut, group=self.cut_group)
        whole = sum((s for path, s in sums if path not in self.cuts), zero)
        gnorm = torch.sqrt(cut + whole)
        self.gnorms.append(gnorm)
        return gnorm


class RankShards(_Blocks):
    """A ``RankSum`` whose rank holds, of every leaf that ``param_specs(cfg,
    mesh, fsdp=True)`` cuts over ``data``, only its block along that
    dimension (``Sharded.block_of`` on the (W, 1) mesh), and every other
    leaf whole: the reference's rule copied, so a dimension with a
    ``model`` entry is never cut (even at ``model`` = 1), nor a stacked
    leaf's layer axis, and a leaf of 2²⁰ elements or more with no
    dimension that W divides stays whole.

    ``use`` gathers the cut leaves of a subtree where the step uses them
    (a layer's views inside its unit, the embedding, the LM head); the
    backward reduce-scatters their gradients (``_GatherForUse``), and
    ``sum_grads`` all-reduces the whole leaves' alone.  A training step
    gathers each cut leaf twice a layer, as the dry-run counts it
    (``roofline.analysis``): inside a unit under ``cfg.remat`` the
    recompute gathers again, and without remat ``packing`` keeps the
    saved whole as its record and the backward gathers it again.  The
    embedding's table, read only by the lookup (whose backward needs no
    values), is gathered once; with tied embeddings the lookup and the
    head share one gather (``transformer.make_loss_fn``).  A weight-shared
    block (``shared_attn``) is gathered at each of its applications.

    Counts ``gather_bytes`` / ``gathers`` (the whole's bytes, the
    all-gather's result) and ``scatter_bytes`` / ``scatters`` (the
    piece's), each collective's seconds with the device synchronized on
    either side (``gather_seconds``, ``scatter_seconds``), and the clip's
    norm each step (``gnorms``, ``combine_norm``)."""

    def __init__(self, mesh, cfg: ModelConfig):
        super().__init__(mesh)
        self.mesh, self.cut_group = mesh, self.group
        self.coords = mesh.local_positions()[0]
        segs = T.find_segments(T.layer_sigs(cfg))
        self.specs = param_specs(cfg, mesh, fsdp=True)
        #: path -> the cut dimension of the leaf as held
        self.cuts: Dict[str, int] = {}
        #: path -> (the cut dimension of what ``use`` meets: one layer's
        #: slice of a stacked leaf, else the leaf; its whole size)
        self.use_dims: Dict[str, Tuple[int, int]] = {}
        shapes = dict(spec_leaves(T.param_specs(cfg)))
        for path, spec in spec_leaves(self.specs):
            dim = data_dim(spec)
            if dim is None:
                continue
            parts = path.split("/")
            stacked = parts[0] == "segments" and segs[int(parts[1])][1] > 1
            self.cuts[path] = dim
            self.use_dims[path] = (dim - 1 if stacked else dim,
                                   shapes[path].shape[dim])
        self.gather_bytes = self.gathers = 0
        self.scatter_bytes = self.scatters = 0
        self.gather_seconds = self.scatter_seconds = 0.0
        self.gnorms: List[torch.Tensor] = []
        self._records: Optional[Dict[int, _Gathered]] = None

    def gather(self, piece: torch.Tensor, dim: int) -> torch.Tensor:
        """``piece`` all-gathered along ``dim``, counted."""
        whole, s = timed(
            lambda: gather_blocks(piece, dim, self.world, self.group),
            piece)
        self.gather_bytes += whole.numel() * whole.element_size()
        self.gathers += 1
        self.gather_seconds += s
        return whole

    def scatter(self, grad: torch.Tensor, dim: int) -> torch.Tensor:
        """``grad`` reduce-scattered along ``dim``, counted."""
        piece, s = timed(
            lambda: scatter_blocks(grad, dim, self.world, self.group),
            grad)
        self.scatter_bytes += piece.numel() * piece.element_size()
        self.scatters += 1
        self.scatter_seconds += s
        return piece

    def use(self, tree: Any, path: str) -> Any:
        """``tree``, the subtree at ``path`` (one layer's views of a stacked
        segment, or the unstacked leaves), with every cut leaf gathered
        (``_GatherForUse``); a leaf already whole is returned as it is."""
        def one(leaf_path, x):
            dim, size = self.use_dims.get(leaf_path, (None, None))
            if dim is None or x.shape[dim] == size:
                return x
            record = _Gathered(self, x, dim)
            out = _GatherForUse.apply(x, record)
            if self._records is not None and torch.is_grad_enabled():
                root = _root(out)
                record.root = weakref.ref(root)
                self._records[id(root)] = record
            return out
        return map_with_paths(one, tree, f"{path}/")

    @contextlib.contextmanager
    def packing(self):
        """The forward's context: a whole that autograd saves for the
        backward (a view of a gather's result) is kept as its ``_Gathered``
        record, and gathered again where the backward reads it."""
        records: Dict[int, _Gathered] = {}

        def pack(t):
            record = records.get(id(_root(t)))
            if record is None or record.root() is not _root(t):
                return t
            return record, t.size(), t.stride(), t.storage_offset()

        def unpack(saved):
            if isinstance(saved, torch.Tensor):
                return saved
            record, size, stride, offset = saved
            return record.whole().as_strided(size, stride, offset)

        self._records = records
        try:
            with torch.autograd.graph.saved_tensors_hooks(pack, unpack):
                yield
        finally:
            self._records = None

    def sum_grads(self, grads: Any) -> Any:
        """The gradient tree with its whole leaves summed over the ranks
        (``RankSum.sum_grads``); a cut leaf's was reduce-scattered in the
        backward."""
        summed = super().sum_grads(self.whole_leaves(grads))
        return map_with_paths(lambda path, g: summed.get(path, g), grads)

def fsdp_ctx(mesh, cfg: ModelConfig) -> T.ShardCtx:
    """The ``ShardCtx`` of a step over ``mesh`` (the (W, 1) mesh of
    ``Mesh.over_ranks``) whose parameters are cut over its data axis as
    ``param_specs(cfg, mesh, fsdp=True)`` says (``RankShards``)."""
    dp, tp = mesh_axes(mesh)
    return T.ShardCtx(mesh=mesh, dp=dp, tp=tp, ranks=RankShards(mesh, cfg))


# ---------------------------------------------------------------------------
# Parameters cut over the model axis across ranks (Megatron's tensor
# parallelism, the reference's ``param_specs`` over ``model``)
# ---------------------------------------------------------------------------

def check_moe_groups(cfg: ModelConfig, rows: int, model_ranks: int) -> None:
    """Refuse a model group of ``model_ranks`` ranks that cannot split a
    data rank's ``rows`` MoE groups (batch rows) evenly among its ranks
    where it cuts the experts (``ModelShards.own_groups``)."""
    if (cfg.moe is not None and cfg.moe.n_experts % model_ranks == 0
            and rows % model_ranks):
        raise ValueError(
            f"{cfg.name}: a data rank's {rows} batch rows (--batch over the "
            f"data ranks) do not divide among --model-ranks {model_ranks}: "
            f"each rank of a model group dispatches its block of the MoE "
            f"groups to the experts")


def check_mamba_heads(cfg: ModelConfig, model_ranks: int) -> None:
    """Refuse a model group of ``model_ranks`` ranks whose cut of Mamba2's
    inner channels (``w_z`` / ``w_xs`` / ``out_proj`` over ``model``)
    would split a head: each rank runs whole heads
    (``ssm.mamba2_mixer``)."""
    if "mamba2" not in cfg.blocks():
        return
    d_in, pdim = cfg.ssm.expand * cfg.d_model, cfg.ssm.head_dim
    if d_in % model_ranks == 0 and (d_in // model_ranks) % pdim:
        raise ValueError(
            f"{cfg.name}: Mamba2's {d_in} inner channels over --model-ranks "
            f"{model_ranks} are {d_in // model_ranks} a rank, which split "
            f"its heads of {pdim}")


class _EnterModel(torch.autograd.Function):
    """Megatron's f at the input of a column-cut product: the identity
    forward; the backward sums the input's gradient (each rank's, from
    its block of the unit) over the model group, in ``dtype``, and rounds
    it once to the gradient's type."""

    @staticmethod
    def forward(ctx, x, shards, dtype, kind):
        ctx.shards, ctx.dtype, ctx.kind = shards, dtype, kind
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        total = grad.to(ctx.dtype, copy=True).contiguous()
        ctx.shards.all_reduce(total, ctx.kind)
        return total.to(grad.dtype), None, None, None


class _ReduceModel(torch.autograd.Function):
    """Megatron's g after a row-cut product: the forward sums the ranks'
    partial products over the model group, in ``dtype``, and rounds the
    sum once to the product's type; the backward is the identity (every
    rank holds the whole sum's gradient, as after ``_SumOverRanks``)."""

    @staticmethod
    def forward(ctx, x, shards, dtype, kind):
        total = x.to(dtype, copy=True).contiguous()
        shards.all_reduce(total, kind)
        return total.to(x.dtype)

    @staticmethod
    def backward(ctx, grad):
        return grad, None, None, None


class _StatOverModel(torch.autograd.Function):
    """A statistic over a dimension the model group cuts (Mamba2's sum of
    squares over its inner channels): the ranks' sums all-reduced in the
    forward.  Every rank's channels read the whole sum, so each rank's
    gradient of it is only a share: the backward all-reduces it too (not
    ``_SumOverRanks``' identity, which holds where all downstream of the
    sum is whole).  GSPMD's pair for a mean over a cut dimension."""

    @staticmethod
    def forward(ctx, x, shards):
        ctx.shards = shards
        total = x.to(torch.float32, copy=True).contiguous()
        shards.all_reduce(total, "norm")
        return total.to(x.dtype)

    @staticmethod
    def backward(ctx, grad):
        total = grad.to(torch.float32, copy=True).contiguous()
        ctx.shards.all_reduce(total, "norm")
        return total.to(grad.dtype), None


class _Exchange(torch.autograd.Function):
    """GShard's all-to-all over the model group: ``x``'s M blocks along its
    leading dimension, block j sent to rank j of the group; block i of the
    result is rank i's block for this rank.  Its transpose is the same
    exchange, so the backward exchanges the gradient."""

    @staticmethod
    def forward(ctx, x, shards):
        ctx.shards = shards
        return shards.all_to_all(x)

    @staticmethod
    def backward(ctx, grad):
        return ctx.shards.all_to_all(grad), None


class _OwnGroups(torch.autograd.Function):
    """The rank's block of ``x``'s leading dimension (the MoE groups a
    rank of the model group dispatches); the backward all-gathers the
    blocks' gradients over the model group, so every rank holds the whole
    input's gradient, as after Megatron's f."""

    @staticmethod
    def forward(ctx, x, shards):
        ctx.shards = shards
        n = x.shape[0] // shards.model_ranks
        return x.narrow(0, shards.model_block * n, n)

    @staticmethod
    def backward(ctx, grad):
        return ctx.shards.all_gather(grad), None


class _AllGroups(torch.autograd.Function):
    """The model group's blocks of the leading dimension all-gathered (the
    MoE groups' outputs put together); every rank holds the whole
    output's gradient, so the backward keeps the rank's block of it."""

    @staticmethod
    def forward(ctx, x, shards):
        ctx.shards = shards
        return shards.all_gather(x)

    @staticmethod
    def backward(ctx, grad):
        shards = ctx.shards
        n = grad.shape[0] // shards.model_ranks
        return grad.narrow(0, shards.model_block * n, n), None


#: RWKV6's time-mix leaves, the unit that ends in ``w_o``; its channel
#: mix's whole leaves are read outside the f and g of ``w_k_cm`` /
#: ``w_v_cm`` (``ssm.rwkv6_channel_mix``), so they belong to no cut unit
_TIME_MIX = frozenset(("mu_r", "mu_k", "mu_v", "mu_g", "mu_w", "w_r", "w_k",
                       "w_v", "w_g", "w_o", "w0", "w_lora_a", "w_lora_b", "u",
                       "ln_out"))


def _unit_output(path: str) -> Optional[str]:
    """The output projection's path of the cut unit a leaf at ``path``
    belongs to (``segments/<s>/<b>/attn/wo``, ``.../mlp/w_out``, the
    experts' ``.../moe/w_out`` for the router, ``.../moe/shared/w_out``
    for the shared experts, ``.../rwkv/w_o`` for RWKV6's time mix,
    ``.../mamba/out_proj``; the weight-shared block's
    ``shared_attn/attn/wo`` and ``shared_attn/mlp/w_out``), else None."""
    parts = path.split("/")
    if parts[0] == "shared_attn" and len(parts) > 2:
        unit = parts[:2]
    elif parts[0] == "segments" and len(parts) > 4:
        unit = parts[:4]
    else:
        return None
    kind = unit[-1]
    if kind == "moe" and parts[len(unit)] == "shared":
        unit = unit + ["shared"]
    if kind == "rwkv":
        out = "w_o" if parts[-1] in _TIME_MIX else None
    else:
        out = {"attn": "wo", "mlp": "w_out", "moe": "w_out",
               "mamba": "out_proj"}.get(kind)
    return None if out is None else "/".join(unit + [out])


def model_cuts(specs) -> Dict[str, int]:
    """path -> the dimension ``specs`` cut over ``model``, for every leaf
    they cut over it."""
    cuts = {}
    for path, spec in spec_leaves(specs):
        dim = model_dim(spec)
        if dim is not None:
            cuts[path] = dim
    return cuts


def partial_leaves(specs) -> set:
    """The whole leaves read inside a cut unit: the paths of the leaves
    ``specs`` leave whole over ``model`` whose unit's output projection
    (``_unit_output``) they cut.  Over the model axis's ranks each rank
    gets only its share of such a leaf's gradient (``ModelShards``), and
    the dry-run counts the sum over ``model``
    (``roofline.analysis.collective_bytes_from_specs``)."""
    cuts = model_cuts(specs)
    return {path for path, _ in spec_leaves(specs)
            if path not in cuts and _unit_output(path) in cuts}


def vocab_cuts(cfg: ModelConfig, specs) -> Tuple[bool, bool]:
    """(whether ``specs`` cut the embedding table's vocabulary over
    ``model``, whether they cut the LM head's: the table's where the
    embeddings are tied, else ``head/w``'s)."""
    cuts = model_cuts(specs)
    return ("embed/tok" in cuts,
            ("embed/tok" if cfg.tie_embeddings else "head/w") in cuts)


#: the kinds a step over the model axis's ranks counts its collectives by
#: (``ModelShards.model_bytes``), each the name of the dry-run's entries
#: of that kind (``roofline.analysis.CollectiveStats.kinds``); "heads",
#: "merge" and "logits" are the serving steps'
MODEL_KINDS = ("block", "norm", "vocab", "gradient", "exchange", "gather",
               "stats", "heads", "merge", "logits")


class ModelShards(_Blocks):
    """The step's collectives where rank r holds, of every leaf, its block
    of the ``model`` cut that ``enforce_divisible(param_specs(cfg,
    mesh))`` gives it (the reference's rules, on the (W/M, M) mesh of
    ``Mesh.over_ranks(model_ranks=M)``: rank r is model block r % M), and
    every leaf the specs leave whole; ``fallbacks`` are the cuts a
    dimension M does not divide forced back to whole.

    The collectives are the ones GSPMD inserts around a cut unit (a dense
    attention or MLP block whose output projection is cut), Megatron's
    pair, written as autograd functions because
    ``torch.distributed.nn``'s all-reduce counts each term M times in its
    backward:

    * ``enter`` (f) at the unit's input: identity forward, the input
      gradient all-reduced over the model group in the backward;
    * ``reduce`` (g) after the row-cut product (``wo``, ``w_out``): the
      partial products all-reduced in the forward, identity backward.

    Both sum in f32 and round once to the activations' type, or in the
    parameters' type under ``pin_proj_outputs`` (the reference pins the
    outputs before the reduction): what the dry-run's ``tp_reduce``
    counts, once a pass, three passes a step under remat.  A unit's
    recompute then runs whole (``transformer.forward``): each g runs in
    it again, as the dry-run counts it.  Where the vocabulary divides M the
    table and the head are cut over it: ``lookup`` looks up the rank's
    rows, zeroes the others and all-reduces, and ``chunk_loss`` makes the
    loss from the cut logits with each chunk's max, sum of exponentials
    and gold logit all-reduced (the logits are never gathered), its
    input through an f.

    MLA is cut over its heads as GQA attention is (``wq``, ``w_uk``,
    ``w_uv`` and ``wo``), between the same f and g; every rank makes the
    whole latent ``c_kv`` and the rope key.  Where the experts are cut
    (GShard's expert parallelism, the rules' (E, d, ff) over ``model``),
    the ranks of a model group hold the same rows and rank r dispatches
    its block of the MoE groups (``own_groups``): it routes them, decides
    their drops (each group's own, as one process does), exchanges the
    (E, groups / M · capacity, d) dispatch buffer over the model group by
    one all-to-all (``exchange``, what the dry-run's ``moe_exchange``
    counts: a dispatch and a combine a pass), runs its block of the
    experts, exchanges their outputs back, combines and all-gathers the
    groups' outputs (``all_groups``).  The load-balance statistics are
    summed over every rank (``sum_all``).  The shared experts are a cut
    MLP between f and g, and so is the weight-shared block's MLP at each
    of its applications, its attention as GQA's.

    RWKV6's time mix is cut over its heads (``w_r`` / ``w_k`` / ``w_v`` /
    ``w_g`` / ``w_lora_b``, ``w0``, ``u``, ``ln_out``, ``w_o``) between an
    f at its input and a g after ``w_o``; the per-head WKV state and group
    norm need no collective.  Its channel mix is cut over its hidden units
    (``w_k_cm``, ``w_v_cm``) with the f on the k branch's input alone and
    the g on the ``w_v_cm`` product, before the product with the whole r
    branch.  Mamba2 is cut over its inner channels, whole heads a rank
    (``w_z``, ``w_xs``, ``conv_w_xs``, ``conv_b_xs``, ``norm``,
    ``out_proj``), between an f at its input and a g after ``out_proj``;
    its RMS norm's sum of squares is the whole d_in's by ``stat``, an
    all-reduce in the forward and in the backward.  Where the audio stub
    has no table, only the head is cut over the vocabulary (``head_cut``
    without ``table_cut``).

    Gradients: a cut leaf's is its block's, local to the rank; a leaf
    held whole outside a cut unit gets the same gradient on every rank of
    a model group.  A whole leaf read inside a cut unit (``q_norm``,
    ``k_norm``, and ``wk`` / ``wv`` / ``bk`` / ``bv`` where the kv heads
    do not divide M, in the weight-shared block too; MLA's ``w_dkv``,
    ``w_krope`` and ``kv_norm``, read by the rank's heads alone; the
    router, which routes the rank's groups alone; RWKV6's time-mix
    ``mu_r`` / ``mu_k`` / ``mu_v`` / ``mu_g`` / ``mu_w`` and ``w_lora_a``,
    behind the time mix's f; Mamba2's ``w_bc``, ``w_dt``, ``conv_w_bc``,
    ``conv_b_bc``, ``a_log``, ``dt_bias`` and ``dd``, read for the rank's
    heads alone) gets only the rank's share, so ``sum_grads`` sums those
    over the model group (``partial``) before every gradient is summed
    over the data group (``RankSum.sum_grads``).  The channel mix's
    ``mu_k_cm``, ``mu_r_cm`` and ``w_r_cm`` get whole gradients.

    Serving (``transformer.make_serve_step`` / ``make_prefill_step``):
    the rank holds its block of each decode cache as ``cache_specs``
    lays it out (``init_cache``: the batch's rows over the data axes
    where they divide them, k/v's rows over ``model``, or over every
    axis where the batch's rows do not divide), and a decode step's
    attention over that block gathers the step's query heads (and the
    new k/v row's, where the kv heads are cut) over the model group
    (``gather_heads``) and merges the blocks' softmax partials over the
    ranks that hold the cache's rows (``seq_max_``, ``seq_sum_``;
    ``layers.attention_block``).  Where the head's vocabulary is cut, the
    logits are all-gathered over the model group (``gather_logits``), so
    every rank returns the same whole logits; where the batch's rows are
    cut over the data ranks (``rows_cut``), a serving loop takes its rows
    (``own_rows``) and gathers the logits' rows (``all_rows``).

    Counts, by kind (``MODEL_KINDS``; "block": the units' f and g;
    "norm": Mamba2's norm statistics; "vocab": the vocabulary cut's
    lookup, head input and chunk sums; "gradient": the partial leaves'
    sums; "exchange": the MoE's all-to-alls; "gather": the MoE groups'
    all-gathers, forward and backward; "stats": the load-balance
    statistics' sums; "heads": a decode step's gathers of the query and
    new k/v heads; "merge": its softmax merges; "logits": the serving
    head's output gathers), each held against the dry-run's entries of the
    same kind (``roofline.analysis.CollectiveStats.kinds``; an
    all-reduce's entry is 2 x the buffer handed, an all-gather's M x,
    an all-to-all's 1 x): ``model_bytes`` (the buffer handed to the
    collective), ``model_calls`` and ``model_seconds`` (each with the
    device synchronized on either side), and the clip's norm each step
    (``gnorms``)."""

    def __init__(self, mesh, cfg: ModelConfig):
        super().__init__(mesh)
        m = mesh.model_ranks
        if m < 2 or mesh.shape["model"] != m:
            raise ValueError(f"{mesh}: the model axis must be cut over its "
                             f"ranks, one position a rank")
        self.mesh, self.model_ranks = mesh, m
        self.cut_group = self.model_group = mesh.model_group
        self.coords = mesh.local_positions()[0]
        self.model_block = mesh.rank % m
        self.specs, self.fallbacks = enforce_divisible(cfg, mesh)
        self.cuts = model_cuts(self.specs)
        self.partial = partial_leaves(self.specs)
        self.table_cut, self.head_cut = vocab_cuts(cfg, self.specs)
        self.vocab0 = self.model_block * (cfg.vocab_size // m)
        self.model_bytes = dict.fromkeys(MODEL_KINDS, 0)
        self.model_calls = dict.fromkeys(MODEL_KINDS, 0)
        self.model_seconds = dict.fromkeys(MODEL_KINDS, 0.0)
        self.gnorms: List[torch.Tensor] = []
        #: the decode caches' layout (``init_cache``): the rank's block of
        #: the cache's rows, of how many, and the ranks that hold them
        self.seq_block, self.seq_blocks = self.model_block, m
        self.seq_group = self.model_group

    def _count(self, kind: str, x: torch.Tensor, seconds: float) -> None:
        self.model_bytes[kind] += x.numel() * x.element_size()
        self.model_calls[kind] += 1
        self.model_seconds[kind] += seconds

    def all_reduce(self, x: torch.Tensor, kind: str,
                   op=dist.ReduceOp.SUM, group=None) -> None:
        """``x`` reduced over ``group`` (None: the model group) in place,
        counted under ``kind``."""
        group = self.model_group if group is None else group
        _, s = timed(lambda: dist.all_reduce(x, op=op, group=group), x)
        self._count(kind, x, s)

    def init_cache(self, cfg: ModelConfig, batch: int, max_seq: int,
                   device) -> Any:
        """The rank's block of ``transformer.init_cache(cfg, batch,
        max_seq)``, zeros, as ``cache_specs`` lays the cache out over the
        mesh (the block ``Sharded.block_of`` gives this rank's position).
        Sets the layout a decode step reads: the rank's block
        ``seq_block`` of the ``seq_blocks`` blocks of the k/v rows, held
        by ``seq_group``.  The mesh holds one position a rank."""
        mesh = self.mesh
        if mesh.shape["data"] != self.world:
            raise ValueError(f"{mesh}: a rank's cache is one position's "
                             f"block; its data axis must be one position a "
                             f"data rank")
        specs = cache_specs(cfg, ShapeConfig("serve", max_seq, batch,
                                             "decode"), mesh)
        pos = {a: i for i, a in enumerate(mesh.axis_names)}

        def block(path, leaf, spec):
            shape = list(leaf.shape)
            for dim, e in enumerate(spec):
                n = 1 if e is None else _axis_size(mesh, e)
                if shape[dim] % n:
                    raise ValueError(
                        f"{cfg.name}: cache {_path_str(path)} of "
                        f"{tuple(leaf.shape)} does not cut into {n} blocks "
                        f"along dimension {dim} ({spec} over {mesh}): pick "
                        f"a batch and max_seq that divide")
                shape[dim] //= n
            return torch.zeros(shape, dtype=leaf.dtype, device=device)

        cache = map_specs(block, T.init_cache(cfg, batch, max_seq,
                                              as_shape=True), specs)
        kv = [spec for path, spec in spec_leaves(specs)
              if path.endswith("/k")]
        if kv:
            seq = kv[0][-3]
            axes = seq if isinstance(seq, tuple) else (seq,)
            index = 0
            for a in axes:
                index = index * mesh.shape[a] + self.coords[pos[a]]
            self.seq_block, self.seq_blocks = index, _axis_size(mesh, seq)
            self.seq_group = (self.model_group if axes == ("model",)
                              else dist.group.WORLD)
        return cache

    def gather_heads(self, x: torch.Tensor) -> torch.Tensor:
        """The model group's blocks of heads along ``x``'s dimension 2 put
        together, in block order (each rank's a block of the heads),
        counted under "heads" (the block handed over)."""
        out, s = timed(lambda: gather_blocks(x, 2, self.model_ranks,
                                             self.model_group), x)
        self._count("heads", x, s)
        return out

    def seq_max_(self, x: torch.Tensor) -> None:
        """``x`` the largest over the ranks that hold the cache's rows, in
        place, counted under "merge"."""
        self.all_reduce(x, "merge", dist.ReduceOp.MAX, self.seq_group)

    def seq_sum_(self, x: torch.Tensor) -> None:
        """``x`` summed over the ranks that hold the cache's rows, in
        place, counted under "merge"."""
        self.all_reduce(x, "merge", group=self.seq_group)

    def gather_logits(self, x: torch.Tensor) -> torch.Tensor:
        """The logits of the rank's block of the vocabulary put together
        with the model group's along the last dimension, counted under
        "logits" (the block handed over)."""
        out, s = timed(lambda: gather_blocks(x, x.dim() - 1,
                                             self.model_ranks,
                                             self.model_group), x)
        self._count("logits", x, s)
        return out

    def rows_cut(self, batch: int) -> bool:
        """Whether a batch of ``batch`` rows is cut over the data ranks
        (``input_specs``' and ``cache_specs``' rule: more than one row, a
        number the data axis divides)."""
        return self.world > 1 and batch > 1 and batch % self.world == 0

    def own_rows(self, x: torch.Tensor) -> torch.Tensor:
        """The rank's rows of a batch ``x`` (rows leading) where its rows
        are cut over the data ranks (``rows_cut``), else ``x``."""
        if not self.rows_cut(x.shape[0]):
            return x
        n = x.shape[0] // self.world
        return x.narrow(0, self.mesh.rank // self.model_ranks * n, n)

    def all_rows(self, x: torch.Tensor, batch: int) -> torch.Tensor:
        """The data group's rows of ``x`` put together where a batch of
        ``batch`` rows is cut over the data ranks (``rows_cut``), else
        ``x``."""
        if not self.rows_cut(batch):
            return x
        return gather_blocks(x, 0, self.world, self.group)

    def all_to_all(self, x: torch.Tensor) -> torch.Tensor:
        """``x``'s blocks along its leading dimension exchanged over the
        model group (``dist.all_to_all_single``), counted under
        "exchange"."""
        x = x.contiguous()
        out = torch.empty_like(x)
        _, s = timed(lambda: dist.all_to_all_single(
            out, x, group=self.model_group), x)
        self._count("exchange", x, s)
        return out

    def all_gather(self, x: torch.Tensor) -> torch.Tensor:
        """The model group's blocks of ``x`` put together along the leading
        dimension, counted under "gather" (the block handed over)."""
        out, s = timed(lambda: gather_blocks(x, 0, self.model_ranks,
                                             self.model_group), x)
        self._count("gather", x, s)
        return out

    def exchange(self, x: torch.Tensor) -> torch.Tensor:
        """The all-to-all of the MoE's buffers (``_Exchange``): ``x`` (M·n,
        ...) in M blocks, block j to rank j; its gradient exchanged
        back."""
        return _Exchange.apply(x, self)

    def own_groups(self, x: torch.Tensor) -> torch.Tensor:
        """The rank's block of the MoE groups ``x`` (G, N, d), G / M
        of them (``_OwnGroups``)."""
        if x.shape[0] % self.model_ranks:
            raise ValueError(f"{x.shape[0]} MoE groups do not divide among "
                             f"the model group's {self.model_ranks} ranks")
        return _OwnGroups.apply(x, self)

    def all_groups(self, y: torch.Tensor) -> torch.Tensor:
        """The model group's blocks of the groups' outputs ``y`` put
        together (``_AllGroups``)."""
        return _AllGroups.apply(y, self)

    def stat(self, x: torch.Tensor) -> torch.Tensor:
        """``x``, the rank's share of a statistic over a cut dimension,
        summed over the model group forward and backward
        (``_StatOverModel``), in f32, counted under "norm"."""
        return _StatOverModel.apply(x, self)

    def sum_all(self, x: torch.Tensor) -> torch.Tensor:
        """``x`` summed over every rank (the default process group: each
        holds its block of the batch's groups), identity backward
        (``_SumOverRanks``), counted under "stats"."""
        out, s = timed(lambda: _SumOverRanks.apply(x, None), x)
        self._count("stats", x, s)
        return out

    @staticmethod
    def _dtype(x: torch.Tensor, pinned: bool) -> torch.dtype:
        return x.dtype if pinned else torch.float32

    def enter(self, x: torch.Tensor, pinned: bool = False,
              kind: str = "block") -> torch.Tensor:
        """f: ``x`` as it is; its gradient summed over the model group."""
        return _EnterModel.apply(x, self, self._dtype(x, pinned), kind)

    def reduce(self, x: torch.Tensor, pinned: bool = False,
               kind: str = "block") -> torch.Tensor:
        """g: the ranks' partial products ``x`` summed over the model
        group."""
        return _ReduceModel.apply(x, self, self._dtype(x, pinned), kind)

    def lookup(self, tok: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
        """The embedding rows of ``tokens`` from the rank's block of the
        table (the vocabulary cut): its own rows looked up, the others
        zero, summed over the model group (a g, in the table's type: one
        term of each sum is not zero, so the sum is exact)."""
        n = tok.shape[0]
        local = tokens - self.vocab0
        hit = (local >= 0) & (local < n)
        x = tok[local.clamp(0, n - 1)] * hit[..., None].to(tok.dtype)
        return self.reduce(x, pinned=True, kind="vocab")

    def chunk_loss(self, h_c: torch.Tensor, w_head: torch.Tensor,
                   l_c: torch.Tensor, w_c: torch.Tensor):
        """``transformer._chunk_loss`` over the rank's block of the
        vocabulary (``w_head`` (d, V/M)): the logits' max over the model
        group, then the sum of exponentials and the gold logit (on the
        rank that holds the label's column, zero elsewhere) summed over
        it, in one all-reduce; the max is a constant of the backward."""
        logits = torch.matmul(h_c, w_head).to(torch.float32)
        top = logits.detach().amax(dim=-1)
        self.all_reduce(top, "vocab", dist.ReduceOp.MAX)
        n = logits.shape[-1]
        local = l_c.long() - self.vocab0
        hit = (local >= 0) & (local < n)
        gold = torch.gather(logits, -1, local.clamp(0, n - 1)[..., None])
        parts = torch.stack([torch.exp(logits - top[..., None]).sum(-1),
                             torch.where(hit, gold[..., 0], 0.0)])
        total, gold = self.reduce(parts, kind="vocab").unbind()
        lse = top + torch.log(total)
        return torch.sum((lse - gold) * w_c), torch.sum(w_c)

    def sum(self, x: torch.Tensor) -> torch.Tensor:
        """``RankSum.sum`` over the data group; ``x`` itself where the
        data axis spans one rank."""
        return x if self.world == 1 else super().sum(x)

    def sum_grads(self, grads: Any) -> Any:
        """The partial leaves' gradients summed over the model group, then
        every gradient over the data group where it spans ranks
        (``RankSum.sum_grads``: a cut leaf's block, a whole leaf's
        whole)."""
        if self.partial:
            summed, nbytes, calls, seconds = _sum_flat(
                [(path, g) for path, g in leaves_with_paths(grads)
                 if path in self.partial], self.model_group)
            self.model_bytes["gradient"] += nbytes
            self.model_calls["gradient"] += calls
            self.model_seconds["gradient"] += seconds
            grads = map_with_paths(lambda path, g: summed.get(path, g), grads)
        return grads if self.world == 1 else super().sum_grads(grads)


def tp_ctx(mesh, cfg: ModelConfig) -> T.ShardCtx:
    """The ``ShardCtx`` of a step over ``mesh`` (the (W/M, M) mesh of
    ``Mesh.over_ranks(model_ranks=M)``) whose parameters are cut over its
    model axis across the ranks (``ModelShards``)."""
    dp, tp = mesh_axes(mesh)
    return T.ShardCtx(mesh=mesh, dp=dp, tp=tp, ranks=ModelShards(mesh, cfg))


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
