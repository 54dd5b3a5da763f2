"""Dry-run of the model cells: what one step of every (arch × shape × mesh)
cell costs a device of the production mesh, reckoned for the H100.

Port of the model-cell half of ``repro/launch/dryrun.py`` (``lower_cell``,
``run_cell``, ``main``).  The reference lowers and compiles each cell with
XLA against ``ShapeDtypeStruct`` stand-ins and reads XLA's memory and cost
analyses.  The port has no compiler to ask, so it runs its own eager step
once on ``torch.device("meta")``: parameters, AdamW state, batch and
decode cache are meta tensors of the cell's global shapes, the step comes
from the port's factories (``unroll=True``, ``use_kernels=False``, the
plain path the reference's configurations count), and nothing is
allocated or touches a device.  A step that read a device value on the
host would raise here (a meta tensor has no value), so a cell that
reckons is also a step with no host read.

What a report holds, per device (``n_chips`` devices of the mesh):

* exact from the specs: argument and output bytes, each leaf's piece on
  one device under ``sharding.param_specs`` (after ``enforce_divisible``)
  / ``opt_state_specs`` / ``cache_specs`` / ``input_specs``; under
  ``donate``, the outputs that alias donated arguments (the new parameters
  and AdamW state, or the decode cache) are not counted again;
* the traced global counts ÷ ``n_chips``: ``hlo_flops``, from
  ``torch.utils.flop_counter.FlopCounterMode``, which counts the products
  only (mm, bmm, addmm, baddbmm, convolutions, attention): XLA's count
  also holds the elementwise work, and nothing is added here for it; and
  ``hlo_bytes_accessed``, each op's tensor inputs and outputs (views cost
  nothing; an in-place op reads and writes its operand);
* the traced peaks, storages followed from the op that makes them to
  their release, each storage once and each by its piece on one device:
  ``temp_size_bytes``, the peak of the storages that are neither
  argument nor output (XLA's meaning), and ``peak_size_bytes`` (the
  port's own key), the arguments plus the peak of everything live
  beside them, outputs included: the eager step's peak, what a card's
  ``max_memory_allocated`` reads on a one-device mesh.  Each storage is
  divided by the devices its own layout cuts it over, dimension by
  dimension (``TraceCounter``): a gradient by its parameter's spec
  (after ``enforce_divisible``), the new parameters and AdamW moments by
  theirs, the logits and decode cache by theirs, an activation by the
  spec its ``ctx.cons`` / ``ctx.cons_spec`` names (the reference's
  sharding constraints; ``TraceCtx``); any other storage from the
  inputs of the op that makes it, as XLA's propagation would lay it
  out: a product's output by its operands' free dimensions (the batch's
  rows by the data shards, a weight's output dimension by the spec that
  cuts it, the heads of q, k and v, and so the scores and probabilities,
  by ``model``; a contraction over a cut dimension leaves a partial sum
  cut as its free dimensions alone), a copy, a cast or an elementwise
  op by its inputs' cuts.  The figure is a reckoning: nothing checks it
  on a mesh of more than one device;
* ``collective_bytes``: ``roofline.analysis.collective_bytes_from_specs``,
  a model of the collectives from the specs (no machine here has more
  than one card), charged at the link each crosses.

The two keys named after XLA's analyses (``hlo_flops``,
``hlo_bytes_accessed``) keep their names, so readers of the reference's
reports (``benchmarks/roofline.py::load_reports``) read these; the report's
``counted_by`` says how each number was counted.

``--substrate X`` instead runs one substrate smoke of the registry
(``launch/substrates.py``; ``--list-substrates`` prints it) on
``--device`` (default ``cuda``).  ``pod_mesh`` (``run_substrate_smoke``),
``multi_search``, ``cached_portfolio`` and ``lm_subspace`` run in this
process, each on the production 16 × 16 mesh over virtual devices of the
one device (the reference forces 512 host devices); ``server``,
``chaos_server``, ``obs_server`` and ``postmortem`` run their legs as
child processes of ``server/sim.py`` on the same device, SIGKILL some of
them mid-run and restore them (``ServerChildren``), and run their
in-process legs on the same virtual mesh.  ``--ranks N`` (``pod_mesh``,
``lm_subspace``) adds the pod leg over N ranks of a ``torch.distributed``
group (``--dist-backend``, ``launch/ranks.py``), the mesh's data axis cut
over them, each rank a child process on its device (``over_ranks``).

Usage:
    python -m repro_torch.launch.dryrun --arch qwen2-72b --shape train_4k
    python -m repro_torch.launch.dryrun --all [--mesh pod|multipod|both]
    python -m repro_torch.launch.dryrun --list-substrates
    python -m repro_torch.launch.dryrun --substrate pod_mesh [--device cpu]
    python -m repro_torch.launch.dryrun --substrate server [--device cpu]
    python -m repro_torch.launch.dryrun --substrate pod_mesh --ranks 2 \
        [--dist-backend gloo|nccl] [--device cpu]

Reports go to ``artifacts/dryrun_torch/<arch>__<shape>__<mesh>.json``,
a smoke's to ``artifacts/dryrun_torch/substrate_<X>.json`` (or ``--out``).
"""
from __future__ import annotations

import argparse
import concurrent.futures
import dataclasses
import gc
import json
import math
import os
import shutil
import signal
import sys
import tempfile
import time
import traceback
import weakref
from array import array
from typing import Any, Callable, Dict, Optional, Tuple

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import FlopCounterMode

from repro_torch.configs import (ARCH_NAMES, SHAPES, ModelConfig, ShapeConfig,
                                 cell_is_runnable, get_config)
from repro_torch.core.tree import map_tree
from repro_torch.kernels import ops
from repro_torch.launch import child
from repro_torch.launch.mesh import (Mesh, make_production_mesh,
                                     virtual_devices)
from repro_torch.launch.substrates import SUBSTRATES, list_substrates
from repro_torch.models import sharding as S
from repro_torch.models import transformer as T
from repro_torch.optim.adamw import AdamW, opt_state_specs
from repro_torch.roofline.analysis import (H100, collective_bytes_from_specs,
                                           local_numel, model_flops,
                                           roofline_terms)

ARTIFACTS = os.path.join(os.path.dirname(__file__), "..", "..", "..",
                         "artifacts", "dryrun_torch")

META = torch.device("meta")

#: the substrate smokes that take ``--ranks``
RANKS_SUBSTRATES = ("pod_mesh", "lm_subspace")

COUNTED_BY = {
    "hlo_flops": "FlopCounterMode over the step traced on meta (products "
                 "only: no elementwise work), / n_chips",
    "hlo_bytes_accessed": "each aten op's tensor inputs + outputs over the "
                          "step traced on meta (views free), / n_chips",
    "argument_size_bytes": "each argument leaf's piece on one device, "
                           "from the sharding specs",
    "output_size_bytes": "each output leaf's piece on one device, from the "
                         "sharding specs; donated outputs not counted",
    "temp_size_bytes": "peak of the storages neither argument nor output "
                       "live in the meta trace, each storage's piece on "
                       "one device (see layout_rule)",
    "peak_size_bytes": "argument_size_bytes + the peak of the storages "
                       "live beside the arguments in the meta trace (temps "
                       "and the outputs that alias no argument), each "
                       "storage's piece on one device (see layout_rule): "
                       "the eager step's peak, what a card's "
                       "max_memory_allocated reads",
    "layout_rule": "each storage's piece from the cuts of its "
                   "dimensions: a gradient / the new parameters and AdamW "
                   "moments / the logits and decode cache: their specs'; "
                   "an activation a ctx.cons or ctx.cons_spec constraint "
                   "names: that spec's; any other storage: from the op "
                   "that makes it, a product's output by its operands' "
                   "free dimensions (a contraction over a cut dimension "
                   "a partial sum), any other op's by its inputs' "
                   "dimensions matched from the left and the right, and "
                   "at least / the batch's data shards when an input "
                   "carries the batch's rows; made from nothing, whole",
    "collective_bytes": "roofline.analysis.collective_bytes_from_specs "
                        "(a model from the specs, not a measurement)",
    "gradient_all_reduce_bytes": "its data-parallel gradient all-reduce "
                                 "entries: 2 x each parameter's piece in "
                                 "its type (the ring); a step over ranks "
                                 "hands half of it to its all-reduces "
                                 "(sharding.RankSum.gradient_bytes)",
    "fsdp_all_gather_bytes": "its all-gather entries of the leaves cut "
                             "over data: each leaf's piece x |data|, "
                             "twice a training step (once for a table "
                             "only the lookup reads), which a step over "
                             "ranks with --fsdp hands its all-gathers "
                             "(sharding.RankShards.gather_bytes)",
    "fsdp_reduce_scatter_bytes": "its reduce-scatter entries of the cut "
                                 "leaves' gradients: each piece once "
                                 "(sharding.RankShards.scatter_bytes)",
    "loss_all_reduce_bytes": "its \"loss\" entries: the loss's sums over "
                             "the data axes, 2 x (the weighted CE's and the "
                             "weights' f32 sums once a step, and where the "
                             "experts are not cut over model each MoE "
                             "layer's 2 x experts f32 statistics a "
                             "forward); a step over ranks hands half of it "
                             "to its loss sums (sharding.RankSum."
                             "loss_bytes)",
    "loss_all_reduces": "the number of those all-reduces a step "
                        "(sharding.RankSum.loss_all_reduces)",
    "model_all_reduce_bytes": "its all-reduce entries over model of the "
                              "cut units' outputs: 2 x the device's "
                              "tokens x d_model in f32 (the parameters' "
                              "type pinned) a pass; a step over the model "
                              "axis's ranks hands half of it to its f and "
                              "g all-reduces (sharding.ModelShards."
                              "model_bytes['block'])",
    "model_all_reduces": "the number of those all-reduces a step",
    "norm_all_reduce_bytes": "its all-reduce entries over model of "
                             "Mamba2's norm statistics: 2 x the device's "
                             "tokens x 4 B (an f32 sum of squares a "
                             "token) a pass, which a step over the model "
                             "axis's ranks hands half of to its "
                             "statistic's all-reduces (sharding."
                             "ModelShards.model_bytes['norm'])",
    "norm_all_reduces": "the number of those all-reduces a step",
    "moe_all_to_all_bytes": "its all-to-all entries of the MoE's dispatch "
                            "and combine: a device's share of the "
                            "(experts x groups x capacity x d_model) "
                            "buffer each, twice a pass, which a step over "
                            "the model axis's ranks hands its exchanges "
                            "(sharding.ModelShards.model_bytes"
                            "['exchange'])",
    "moe_all_to_alls": "the number of those all-to-alls a step",
    "vocab_all_reduce_bytes": "its \"vocab\" entries over model where "
                              "the vocabulary is cut: 2 x (the lookup's "
                              "tokens x d_model in the table's type, and "
                              "in training the head input's gradient, "
                              "tokens x d_model f32, and each loss "
                              "chunk's max and two sums, 3 x rows x chunk "
                              "f32 in the forward and the recompute); a "
                              "step over the model axis's ranks hands "
                              "half of it (sharding.ModelShards."
                              "model_bytes['vocab'])",
    "vocab_all_reduces": "the number of those all-reduces a step "
                         "(ModelShards.model_calls['vocab'])",
    "partial_gradient_all_reduce_bytes": "its \"gradient\" entries over "
                                         "model: 2 x the piece of each "
                                         "whole leaf read inside a cut "
                                         "unit (sharding.partial_leaves), "
                                         "once a training step; a step "
                                         "over the model axis's ranks "
                                         "hands half of it, in one buffer "
                                         "a type (sharding.ModelShards."
                                         "model_bytes['gradient'])",
    "partial_gradient_all_reduces": "the number of those entries' "
                                    "all-reduces a step, one a leaf "
                                    "(ModelShards.model_calls['gradient'] "
                                    "counts one a type)",
    "moe_stats_all_reduce_bytes": "its \"stats\" entries over the data "
                                  "axes and model where the experts are "
                                  "cut over model: 2 x each MoE layer's "
                                  "2 x experts f32 load-balance "
                                  "statistics a forward (the recompute's "
                                  "too), in training; a step over the "
                                  "model axis's ranks hands half of it "
                                  "(sharding.ModelShards.model_bytes"
                                  "['stats'])",
    "moe_stats_all_reduces": "the number of those all-reduces a step "
                             "(ModelShards.model_calls['stats'])",
    "moe_all_gather_bytes": "its \"gather\" entries over model, the "
                            "port's own (the grouped MoE's rows split "
                            "among a model group): each MoE layer's "
                            "result, the device's tokens x d_model in the "
                            "activations' type, a pass; a step over the "
                            "model axis's M ranks hands 1/M of it "
                            "(sharding.ModelShards.model_bytes"
                            "['gather'])",
    "moe_all_gathers": "the number of those all-gathers a step "
                       "(ModelShards.model_calls['gather'])",
    "compile_s": "wall of the meta trace",
    "lower_s": "wall of building the stand-ins and specs",
}


#: the report's keys of the bytes and the number a step of each kind of
#: collective entry (``analysis.CollectiveStats.kinds``) that a step over
#: ranks counts apart: ``sharding.MODEL_KINDS`` and the loss's sums
KIND_KEYS = {
    "block": ("model_all_reduce_bytes", "model_all_reduces"),
    "norm": ("norm_all_reduce_bytes", "norm_all_reduces"),
    "vocab": ("vocab_all_reduce_bytes", "vocab_all_reduces"),
    "gradient": ("partial_gradient_all_reduce_bytes",
                 "partial_gradient_all_reduces"),
    "exchange": ("moe_all_to_all_bytes", "moe_all_to_alls"),
    "gather": ("moe_all_gather_bytes", "moe_all_gathers"),
    "stats": ("moe_stats_all_reduce_bytes", "moe_stats_all_reduces"),
    "loss": ("loss_all_reduce_bytes", "loss_all_reduces"),
}


def handed(report: dict, kind: str, model_ranks: int) -> Tuple[int, int]:
    """(the bytes a rank of a step over ranks hands the collectives of
    ``kind`` a step, their number) as ``report`` reckons them: an
    all-reduce's entry counts 2 x the buffer handed (the ring), an
    all-gather's over the ``model_ranks`` of a model group its result,
    ``model_ranks`` x the block handed, an all-to-all's what is
    handed."""
    nbytes, calls = (report[key] for key in KIND_KEYS[kind])
    return nbytes // {"exchange": 1, "gather": model_ranks}.get(kind, 2), \
        calls


# ---------------------------------------------------------------------------
# The trace's counters
# ---------------------------------------------------------------------------

def _tensors(tree) -> list:
    """The tensors in a tree of lists, tuples and dicts (no recursive
    closure: a cycle would keep the tensors alive until the collector
    runs, and the trace's peak would count them past their release)."""
    out, stack = [], [tree]
    while stack:
        x = stack.pop()
        if isinstance(x, torch.Tensor):
            out.append(x)
        elif isinstance(x, (list, tuple)):
            stack.extend(reversed(x))
        elif isinstance(x, dict):
            stack.extend(reversed(list(x.values())))
    return out


def _is_view(func) -> bool:
    """An op whose outputs alias its inputs without writing them."""
    rets = func._schema.returns
    return bool(rets) and all(r.alias_info is not None
                              and not r.alias_info.is_write for r in rets)


#: ops that move no data: fresh storage that nothing writes
_ALLOCATE_ONLY = {"empty", "empty_like", "empty_strided", "new_empty",
                  "new_empty_strided"}


#: the aten products whose output follows their operands' free dims: name
#: → the positions of (a, b) in the op's arguments; a bias or accumulator
#: before them is laid out as any other input
_PRODUCTS = {"mm": 0, "addmm": 1, "bmm": 0, "baddbmm": 1}


class TraceCounter(TorchDispatchMode):
    """Bytes accessed and live bytes of the ops run under it, and a guard
    that every tensor made lies on ``meta`` (or holds no element:
    ``torch.utils.checkpoint`` makes an empty CPU tensor in some torch
    versions, which allocates nothing).

    ``exclude(tree)`` names the arguments, whose storages are neither
    counted as live nor freed.  A storage made by an op is live from that
    op until Python releases it (a weak reference's callback), counted
    once however many views alias it.  Each such storage gets a serial
    number, and the order of the allocations and releases is kept, so
    that ``peak(without=serials(outputs))`` replays it without the
    storages the step's outputs hold.

    Each storage also has its piece on one device of ``mesh``
    (``local_peak``), from the cuts of its dimensions.  A cut is a mesh
    axis splitting one index of the storage, kept as (axis, ways, stride,
    extent): the index of that element stride and extent is split into
    ``ways`` blocks (so a view that merges, splits or transposes
    dimensions finds each cut on the dimension that holds that stride).
    A storage given a layout, an argument's by ``exclude(tree, specs)`` or
    one the step makes by ``tag(tree, specs)``, is cut as its spec cuts
    its tensor.  Any other storage takes its cuts from the inputs of the
    op that makes it, dimension by dimension:

    * a product (``mm``, ``addmm``, ``bmm``, ``baddbmm``; what ``matmul``,
      ``linear`` and ``einsum`` lower to) takes its operands' free
      dimensions' cuts: the rows of ``a``, the columns of ``b``, and the
      batch dimension of both.  A cut of the contracted dimension is
      dropped: the output is a partial sum, whole but for its free cuts
      (the storage a row-parallel product's all-reduce fills);
    * any other op matches each input's dimensions to the output's from
      the left and from the right while their sizes agree (a copy, a cast
      or an elementwise op keeps its input's cuts; a reduction keeps
      those of the dimensions it keeps; broadcasting aligns from the
      right), the most cut input first;

    a mesh axis cuts at most its own size over all of a storage's
    dimensions, and a dimension only by a factor of its size.  A storage
    made from the batch's rows (an argument excluded with ``rows=True``,
    or what is made from one) whose cuts split the data axes fewer than
    ``row_shards`` ways counts at least a ``row_shards``-th (a partial sum
    over the rows, or a layout the matching missed); a storage made from
    no laid-out input is whole.  On a one-device mesh every piece is the
    whole."""

    def __init__(self, mesh=None, row_shards: int = 1):
        super().__init__()
        self.mesh = mesh
        self.row_shards = row_shards
        #: the mesh axes cut more than one way, their sizes; the data axes
        self._axes = ({} if mesh is None else
                      {a: n for a, n in mesh.shape.items() if n > 1})
        self._dp = (frozenset(S.mesh_axes(mesh)[0]) if mesh is not None
                    else frozenset())
        self.bytes_accessed = 0
        self.live = 0
        self.ops = 0
        #: storage → its serial (None for an argument's)
        self._known: Dict[int, Optional[int]] = {}
        self._refs: Dict[int, Any] = {}
        #: storage → (its cuts, rows, its share as (local, whole) elements)
        self._layout: Dict[int, Tuple[tuple, bool, int, int]] = {}
        #: bytes, by serial: whole and one device's piece
        self._sizes = array("q")
        self._local = array("q")
        #: in order: serial + 1 where made, -(serial + 1) where freed
        self._events = array("q")

    def exclude(self, tree, specs=None, rows: bool = False) -> None:
        """Name ``tree``'s tensors as arguments, laid out by ``specs``
        (whole where None) and carrying the batch's rows if ``rows``."""
        for t in _tensors(tree):
            self._known[t.untyped_storage()._cdata] = None
        if specs is not None:
            self.tag(tree, specs, rows)

    def tag(self, tree, specs, rows: bool = False) -> None:
        """Lay out the storages of ``tree``'s tensors by ``specs`` (a tree
        of one structure, or one spec for a single tensor)."""
        if isinstance(tree, torch.Tensor):
            tree, specs = [tree], [specs]
        S.map_specs(lambda _, t, spec: self._state(t, spec, rows),
                    tree, specs)

    def _state(self, t: torch.Tensor, spec, rows: bool) -> None:
        if not isinstance(t, torch.Tensor):
            return
        key = t.untyped_storage()._cdata
        whole = max(t.numel(), 1)
        local = (whole if self.mesh is None
                 else local_numel(tuple(t.shape), spec, self.mesh))
        dims = []
        for n, entry in zip(t.shape, tuple(spec) + (None,) * t.dim()):
            cuts, left = [], n
            for a in (() if entry is None else
                      entry if isinstance(entry, tuple) else (entry,)):
                f = self._axes.get(a, 1)
                if f > 1 and left % f == 0:
                    cuts.append((a, f, 1, left))
                    left //= f
            dims.append(cuts)
        self._layout[key] = (self._to_storage(t, dims), rows, local, whole)
        self._place(key)

    def _place(self, key: int) -> None:
        """Set a made storage's piece from its layout."""
        s = self._known.get(key)
        if s is not None:
            _, _, local, whole = self._layout[key]
            self._local[s] = self._sizes[s] * local // whole

    @staticmethod
    def _to_storage(t: torch.Tensor, dims) -> tuple:
        """The cuts of ``t``'s dimensions as cuts of its storage."""
        return tuple((a, f, s * inner, ext)
                     for s, cuts in zip(t.stride(), dims)
                     for a, f, inner, ext in cuts)

    def _dims(self, t: torch.Tensor, cuts: tuple) -> list:
        """The cuts of each dimension of ``t``, a view of a storage cut by
        ``cuts``: each (axis, ways, inner, extent) splitting the index
        ``(i // inner) % extent`` of that dimension.  A cut whose stride
        range ``t`` spans over several dimensions goes to the outer ones
        first, each taking what its part of the range divides."""
        dims = [[] for _ in range(t.dim())]
        shape, strides = t.shape, t.stride()
        for a, f, st, ext in cuts:
            hi = st * ext
            over = sorted(((s, n, i) for i, (n, s) in
                           enumerate(zip(shape, strides))
                           if n > 1 and 0 < s < hi and s * n > st),
                          reverse=True)
            for s, n, i in over:
                lo = max(s, st)
                part = min(s * n, hi) // lo
                g = math.gcd(f, part)
                if g > 1:
                    dims[i].append((a, g, lo // s, part))
                    f //= g
                if f == 1:
                    break
        return dims

    def _inherit(self, key: int, t: torch.Tensor, func, args,
                 ins: list) -> None:
        """A made storage's layout from the op's inputs (class doc)."""
        rows, laid = False, []
        for x in ins:
            st = self._layout.get(x.untyped_storage()._cdata)
            if st is not None:
                rows = rows or st[1]
                if st[0]:
                    laid.append((x, self._dims(x, st[0])))
        shape = tuple(t.shape)
        pairs = []                       # (output dim, cut), in priority
        first = _PRODUCTS.get(func._opname)
        if first is not None and laid:
            a, b = args[first], args[first + 1]
            da = next((d for x, d in laid if x is a), None)
            db = next((d for x, d in laid if x is b), None)
            batch = t.dim() - 2          # bmm's leading dimension
            for d, free in ((da, batch), (db, batch + 1)):
                if d is not None:
                    pairs += [(free, c) for c in d[free]]
                    pairs += [(0, c) for c in (d[0] if batch else ())]
            laid = [(x, d) for x, d in laid if x is not a and x is not b]
        laid.sort(key=lambda xd: -math.prod(c[1] for cuts in xd[1]
                                            for c in cuts))
        for x, d in laid:
            xs = tuple(x.shape)
            k = min(len(xs), len(shape))
            j = 0
            while j < k and xs[j] == shape[j]:
                pairs += [(j, c) for c in d[j]]
                j += 1
            if j < k:
                i = 1
                while i <= k - j and xs[-i] == shape[-i]:
                    pairs += [(len(shape) - i, c) for c in d[-i]]
                    i += 1
        dims = [[] for _ in shape]
        used: Dict[str, int] = {}
        ways = [1] * len(shape)
        for i, (a, f, inner, ext) in pairs:
            if (used.get(a, 1) * f <= self._axes[a]
                    and shape[i] % (ways[i] * f) == 0
                    and all(c[0] != a for c in dims[i])):
                dims[i].append((a, f, inner, ext))
                used[a] = used.get(a, 1) * f
                ways[i] *= f
        whole = math.prod(ways)
        if rows:
            dp = math.prod(n for a, n in used.items() if a in self._dp)
            if dp < self.row_shards:
                whole *= self.row_shards // math.gcd(self.row_shards, dp)
        self._layout[key] = (self._to_storage(t, dims), rows, 1, whole)

    def piece(self, t: torch.Tensor) -> int:
        """Bytes of one device's piece of the storage ``t`` lies in (a
        storage the step made and has not released)."""
        return self._local[self._known[t.untyped_storage()._cdata]]

    def serials(self, tree) -> frozenset:
        """The serials of the storages that ``tree``'s tensors hold (none
        for an argument's)."""
        found = (self._known.get(t.untyped_storage()._cdata)
                 for t in _tensors(tree))
        return frozenset(s for s in found if s is not None)

    def peak(self, without: frozenset = frozenset()) -> int:
        """The most bytes live at once, the storages of serials
        ``without`` left out."""
        return self._replay(self._sizes, without)

    def local_peak(self, without: frozenset = frozenset()) -> int:
        """``peak`` of the pieces on one device of the mesh."""
        return self._replay(self._local, without)

    def _replay(self, sizes, without: frozenset) -> int:
        live = peak = 0
        for e in self._events:
            s = abs(e) - 1
            if s not in without:
                live += sizes[s] if e > 0 else -sizes[s]
                peak = max(peak, live)
        return peak

    def _release(self, key: int) -> None:
        s = self._known.pop(key)
        self._refs.pop(key, None)
        self._layout.pop(key, None)
        self.live -= self._sizes[s]
        self._events.append(-(s + 1))

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        self.ops += 1
        outs = _tensors(out)
        for t in outs:
            if t.device != META and t.numel():
                raise RuntimeError(f"{func} made a tensor on {t.device} in "
                                   f"a dry-run, which must stay on meta")
        ins = _tensors((args, kwargs))
        if not (_is_view(func) or func._opname in _ALLOCATE_ONLY):
            self.bytes_accessed += sum(t.numel() * t.element_size()
                                       for t in ins + outs)
        for t in outs:
            st = t.untyped_storage()
            key = st._cdata
            if key in self._known:
                continue
            s = len(self._sizes)
            self._known[key] = s
            self._sizes.append(st.nbytes())
            self._local.append(st.nbytes())
            self._events.append(s + 1)
            self._refs[key] = weakref.ref(
                st, lambda _, key=key: self._release(key))
            self.live += st.nbytes()
            if self._axes:
                self._inherit(key, t, func, args, ins)
                self._place(key)
        return out


@dataclasses.dataclass
class LayoutTags:
    """Where a dry-run step states the layouts of the storages it makes,
    for the ``TraceCounter`` tracing it (``counter``; outside a trace
    nothing is recorded): activations through ``TraceCtx``'s
    constraints, gradients through ``TaggedOptimizer``."""
    counter: Optional[TraceCounter] = None

    def tag(self, tree, specs, rows: bool = False) -> None:
        if self.counter is not None:
            self.counter.tag(tree, specs, rows)


@dataclasses.dataclass(frozen=True)
class TraceCtx(T.ShardCtx):
    """The dry-run's ``ShardCtx``: each constraint the forward names
    (the reference's ``with_sharding_constraint``) lays out the storage
    of its tensor in the trace, and the tensor is returned unchanged, as
    ``ShardCtx`` returns it on a real step."""
    tags: LayoutTags = dataclasses.field(default_factory=LayoutTags)

    def cons(self, x, *tail):
        return self.cons_spec(x, ("dp",) + tail)

    def cons_spec(self, x, spec_entries):
        entries = tuple(self.dp if e == "dp" else e for e in spec_entries)
        self.tags.tag(x, S.P(*entries), rows=True)
        return x


class TaggedOptimizer:
    """The dry-run's optimiser for a train step: lays out each gradient's
    storage by its parameter's spec, then updates as ``opt``."""

    def __init__(self, opt: AdamW, pspecs, tags: LayoutTags):
        self.opt, self.pspecs, self.tags = opt, pspecs, tags

    def init(self, params):
        return self.opt.init(params)

    def update(self, grads, state, params):
        self.tags.tag(grads, self.pspecs)
        return self.opt.update(grads, state, params)


# ---------------------------------------------------------------------------
# Stand-ins and per-device bytes
# ---------------------------------------------------------------------------

def _meta(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device=META)


def meta_params(cfg: ModelConfig):
    """The parameter tree as meta tensors, each leaf in its own type (the
    MoE router in f32), from ``transformer.param_specs``."""
    dtype = T.param_dtype(cfg)
    return map_tree(lambda leaf: _meta(leaf.shape, leaf.dtype or dtype),
                    T.param_specs(cfg))


def _shape_tree(tree):
    return map_tree(lambda s: _meta(s.shape, s.dtype), tree)


def local_bytes(tree, specs, mesh) -> int:
    """Bytes of one device's pieces of ``tree`` (tensors or
    ``TensorShape``s) laid out by ``specs`` over ``mesh``."""
    sizes = []
    S.map_specs(lambda _, x, spec: sizes.append(
        local_numel(x.shape, spec, mesh) * x.dtype.itemsize), tree, specs)
    return sum(sizes)


def _batch_shards(shape: ShapeConfig, mesh) -> int:
    """The data-parallel shards the global batch is cut into
    (``input_specs``' rule)."""
    dp, _ = S.mesh_axes(mesh)
    n = math.prod(mesh.shape[a] for a in dp)
    b = shape.global_batch
    return n if (b > 1 and b % n == 0) else 1


def _logit_spec(cfg: ModelConfig, shape: ShapeConfig, mesh, pspecs):
    """The logits' layout: rows over the data axes as the batch, the
    vocabulary over ``model`` where the head's spec cuts it."""
    dp, tp = S.mesh_axes(mesh)
    head = (pspecs["embed"]["tok"][0] if cfg.tie_embeddings
            else pspecs["head"]["w"][1])
    rows = dp if _batch_shards(shape, mesh) > 1 else None
    return S.P(rows, None, head)


@dataclasses.dataclass
class Cell:
    """One cell's step, its meta arguments and their specs, the specs of
    its outputs, ``donated``: the outputs that alias an argument under
    ``donate``, ``rows``: the arguments that carry the batch's rows, and
    ``tags``: where the step states its layouts in a trace."""
    step: Callable
    args: tuple
    arg_specs: tuple
    out_specs: tuple
    donated: Tuple[int, ...]
    rows: Tuple[bool, ...] = ()
    tags: LayoutTags = dataclasses.field(default_factory=LayoutTags)


def build_cell(cfg: ModelConfig, shape: ShapeConfig, mesh, *,
               optimizer: Optional[AdamW] = None, mla_absorb: bool = False,
               fsdp: bool = False) -> Cell:
    """The step of ``shape.kind`` for ``cfg`` and its meta stand-ins over
    ``mesh``: ``make_train_step`` with AdamW (``optimizer``, default
    ``AdamW(lr=1e-4)`` as the reference's), ``make_prefill_step``, or
    ``make_serve_step(absorb=mla_absorb)`` over a cache of
    ``shape.seq_len`` positions.  The step runs under a ``TraceCtx`` and,
    in training, a ``TaggedOptimizer``, so that a trace lays out its
    activations and gradients."""
    cfg = dataclasses.replace(cfg, use_kernels=False)
    dp, tp = S.mesh_axes(mesh)
    tags = LayoutTags()
    ctx = TraceCtx(mesh=mesh, dp=dp, tp=tp, tags=tags)
    pspecs, _ = S.enforce_divisible(cfg, mesh,
                                    S.param_specs(cfg, mesh, fsdp=fsdp))
    params = meta_params(cfg)
    batch_shapes, bspecs = S.input_specs(cfg, shape, mesh)
    batch = _shape_tree(batch_shapes)
    if shape.kind == "train":
        opt = optimizer or AdamW(lr=1e-4)
        state = opt.init(params)
        ospecs = opt_state_specs(pspecs)
        step = T.make_train_step(cfg, TaggedOptimizer(opt, pspecs, tags),
                                 ctx, unroll=True)
        metrics = {k: S.P() for k in ("aux", "ce", "loss")}
        return Cell(step, (params, state, batch), (pspecs, ospecs, bspecs),
                    (pspecs, ospecs, metrics), donated=(0, 1),
                    rows=(False, False, True), tags=tags)
    logits = _logit_spec(cfg, shape, mesh, pspecs)
    if shape.kind == "prefill":
        step = T.make_prefill_step(cfg, ctx, unroll=True)
        return Cell(step, (params, batch), (pspecs, bspecs), (logits,),
                    donated=(), rows=(False, True), tags=tags)
    cache = _shape_tree(T.init_cache(cfg, shape.global_batch, shape.seq_len,
                                     as_shape=True))
    cspecs = S.cache_specs(cfg, shape, mesh)
    step = T.make_serve_step(cfg, ctx, absorb=mla_absorb, unroll=True)
    return Cell(step, (params, cache, batch["tokens"], batch["t"]),
                (pspecs, cspecs, bspecs["tokens"], bspecs["t"]),
                (logits, cspecs), donated=(1,),
                rows=(False, True, True, False), tags=tags)


def trace_step(cell: Cell, mesh=None, row_shards: int = 1) -> dict:
    """Run ``cell``'s step once on meta under ``FlopCounterMode`` and a
    ``TraceCounter`` over ``mesh`` (None: one device): its global FLOPs,
    bytes accessed, the peak of the bytes live beside the arguments
    (``peak_live``) and of those neither argument nor output
    (``peak_temp``), each also of one device's pieces (``local_live``,
    ``local_temp``), ops, its outputs, the counter and the wall.  The
    arguments and outputs are laid out by their specs, the arguments in
    ``cell.rows`` carry the batch's rows, cut ``row_shards`` ways."""
    counter = TraceCounter(mesh, row_shards)
    rows = cell.rows or (False,) * len(cell.args)
    for a, spec, r in zip(cell.args, cell.arg_specs, rows):
        counter.exclude(a, spec, rows=r)
    flops = FlopCounterMode(display=False)
    cell.tags.counter = counter
    t0 = time.perf_counter()
    try:
        with flops, counter:
            out = cell.step(*cell.args)
    finally:
        cell.tags.counter = None
    outs = out if isinstance(out, tuple) else (out,)
    for o, spec in zip(outs, cell.out_specs):
        counter.tag(o, spec)
    held = counter.serials(out)
    return {"flops": flops.get_total_flops(),
            "bytes_accessed": counter.bytes_accessed,
            "peak_live": counter.peak(),
            "peak_temp": counter.peak(without=held),
            "local_live": counter.local_peak(),
            "local_temp": counter.local_peak(without=held),
            "ops": counter.ops, "out": out, "counter": counter,
            "seconds": time.perf_counter() - t0}


def reckon(cfg: ModelConfig, shape: ShapeConfig, mesh, *,
           optimizer: Optional[AdamW] = None, mla_absorb: bool = False,
           donate: bool = False, fsdp: bool = False) -> dict:
    """The per-device numbers of one step (module docstring): memory,
    FLOPs, bytes, collectives and the roofline terms on the H100."""
    t0 = time.perf_counter()
    cell = build_cell(cfg, shape, mesh, optimizer=optimizer,
                      mla_absorb=mla_absorb, fsdp=fsdp)
    t_lower = time.perf_counter() - t0
    n_chips = mesh.size
    run = trace_step(cell, mesh, _batch_shards(shape, mesh))
    out = run["out"]
    outs = out if isinstance(out, tuple) else (out,)
    out_bytes = sum(local_bytes(o, s, mesh)
                    for i, (o, s) in enumerate(zip(outs, cell.out_specs))
                    if not (donate and i in cell.donated))
    arg_bytes = sum(local_bytes(a, s, mesh)
                    for a, s in zip(cell.args, cell.arg_specs))
    coll = collective_bytes_from_specs(cfg, shape, mesh, cell.arg_specs[0])
    flops = run["flops"] / n_chips
    bytes_accessed = run["bytes_accessed"] / n_chips
    terms = roofline_terms(flops, bytes_accessed, coll.bytes_by_link,
                           n_chips, H100)
    mf = model_flops(cfg, shape, shape.kind)
    return {
        "n_chips": n_chips,
        "kind": shape.kind,
        "lower_s": round(t_lower, 2),
        "compile_s": round(run["seconds"], 2),
        "memory_analysis": {
            "argument_size_bytes": arg_bytes,
            "output_size_bytes": out_bytes,
            "temp_size_bytes": run["local_temp"],
            "generated_code_size_bytes": None,
            "peak_size_bytes": arg_bytes + run["local_live"],
        },
        "hlo_flops": flops,
        "hlo_bytes_accessed": bytes_accessed,
        "traced_ops": run["ops"],
        "collective_bytes": coll.total_bytes,
        "collective_bytes_by_kind": coll.bytes_by_kind,
        "collective_count_by_kind": coll.count_by_kind,
        "collective_bytes_by_link": coll.bytes_by_link,
        "top_collectives": coll.top_ops,
        "gradient_all_reduce_bytes": coll.gradient_all_reduce_bytes,
        "fsdp_all_gather_bytes": coll.fsdp_all_gather_bytes,
        "fsdp_reduce_scatter_bytes": coll.fsdp_reduce_scatter_bytes,
        **{key: count(kind) for kind, keys in KIND_KEYS.items()
           for key, count in zip(keys, (coll.kind_bytes, coll.kind_calls))},
        "model_flops": mf,
        "useful_flops_ratio": (mf / (flops * n_chips)) if flops else None,
        "peaks": {"flops": H100.flops, "hbm_bw": H100.hbm_bw,
                  "link_bw": dict(H100.link_bw)},
        "counted_by": COUNTED_BY,
        **terms,
    }


def production_mesh(multi_pod: bool):
    """The (16, 16) or (2, 16, 16) mesh over virtual meta devices."""
    n = 512 if multi_pod else 256
    return make_production_mesh(multi_pod=multi_pod,
                                devices=virtual_devices(n, META))


def reckon_cell(arch: str, shape_name: str, multi_pod: bool,
                mla_absorb: bool = False, extra_tags=None, cfg_override=None,
                donate: bool = False, fsdp: bool = False) -> dict:
    """The report of one (arch, shape, mesh) cell (the reference's
    ``lower_cell``, which also returns XLA's lowered and compiled
    objects; the port has none)."""
    cfg = cfg_override or get_config(arch)
    shape = SHAPES[shape_name]
    report = reckon(cfg, shape, production_mesh(multi_pod),
                    mla_absorb=mla_absorb, donate=donate, fsdp=fsdp)
    base = get_config(arch)
    return {"arch": arch, "shape": shape_name,
            "mesh": "2x16x16" if multi_pod else "16x16",
            "tags": extra_tags or {}, **report,
            "n_params": base.n_params(),
            "n_active_params": base.n_active_params()}


def run_cell(arch, shape_name, multi_pod, out_dir, skip_existing=False,
             mla_absorb=False, suffix="", cfg_override=None, donate=False,
             fsdp=False) -> bool:
    """Reckon one cell into ``out_dir/<arch>__<shape>__<mesh><suffix>
    .json``: a skip-rule cell as ``{"skipped": true, "reason": ...}``, a
    failure's traceback into ``<name>.json.err`` (returns False)."""
    mesh_tag = "2x16x16" if multi_pod else "16x16"
    name = f"{arch}__{shape_name}__{mesh_tag}{suffix}"
    path = os.path.join(out_dir, name + ".json")
    if skip_existing and os.path.exists(path):
        print(f"[skip] {name}")
        return True
    cfg = get_config(arch)
    ok, reason = cell_is_runnable(cfg, SHAPES[shape_name])
    if not ok:
        report = {"arch": arch, "shape": shape_name, "mesh": mesh_tag,
                  "skipped": True, "reason": reason}
        with open(path, "w") as f:
            json.dump(report, f, indent=2)
        print(f"[SKIP-RULE] {name}: {reason}")
        return True
    try:
        report = reckon_cell(arch, shape_name, multi_pod,
                             mla_absorb=mla_absorb, cfg_override=cfg_override,
                             donate=donate, fsdp=fsdp)
        with open(path, "w") as f:
            json.dump(report, f, indent=2)
        print(f"[ok] {name}: compile={report['compile_s']}s "
              f"flops={report['hlo_flops']:.3e} "
              f"coll={report['collective_bytes']:.3e} "
              f"dom={report['dominant']} "
              f"frac={report['roofline_fraction']:.3f}")
        return True
    except Exception:
        err = traceback.format_exc()
        with open(path + ".err", "w") as f:
            f.write(err)
        print(f"[FAIL] {name}:\n{err}")
        return False


# ---------------------------------------------------------------------------
# The substrate smokes (launch/substrates.py): the in-process runners
# ---------------------------------------------------------------------------

def _pod_mesh(device, mesh=None):
    """``mesh``, or the production (16, 16) mesh over 256 virtual devices
    that are all ``device`` (the reference forces 512 host devices)."""
    if mesh is not None:
        return mesh
    return make_production_mesh(devices=virtual_devices(256, device))


def _mesh_tag(mesh) -> str:
    return "x".join(str(n) for n in mesh.shape.values())


def _since(before: Dict[str, int]) -> Dict[str, int]:
    """The launches since ``before``, counters that moved only."""
    now = ops.launch_counts()
    return {k: now[k] - before[k] for k in now if now[k] != before[k]}


def _timed(fn):
    """(fn(), wall seconds, its launches)."""
    before = ops.launch_counts()
    t0 = time.perf_counter()
    out = fn()
    return out, time.perf_counter() - t0, _since(before)


def _write(out_dir: str, name: str, report: dict) -> str:
    path = os.path.join(out_dir, f"substrate_{name}.json")
    with open(path, "w") as f:
        json.dump(report, f, indent=2)
    return path


def _sdss_problem(name: str, seed: int, n_stars: int, device):
    """(f_batch, x0) of the reference's substrate smokes: the stripe
    ``name`` from ``seed`` and a start drawn around its truth from
    ``default_rng(3)``."""
    import numpy as np
    from repro_torch.data import sdss

    stripe = sdss.make_stripe(name, n_stars=n_stars, seed=seed)
    f_batch, _ = sdss.make_fitness(stripe, device=device)
    rng = np.random.default_rng(3)
    x0 = np.clip(stripe.truth + rng.normal(0, 0.2, 8).astype(np.float32),
                 sdss.LO, sdss.HI)
    return f_batch, x0


def engine_doc(engine) -> dict:
    """An engine's committed trajectory and stats as JSON (float64
    round-trips exactly): what a rank reports and the parity gates of a
    leg over ranks compare."""
    return json.loads(json.dumps({
        "iteration": engine.iteration, "best_fitness": engine.best_fitness,
        "history": {"centers": [r.center.tolist() for r in engine.history],
                    "best_fitness": [r.best_fitness
                                     for r in engine.history]},
        "engine_stats": dataclasses.asdict(engine.stats)}))


_ENGINE_KEYS = ("iteration", "best_fitness", "history", "engine_stats")


def over_ranks(target: str, kwargs: dict, ranks: int, dist_backend: str,
               device, expect, counts: Optional[Callable] = None) -> dict:
    """Run ``target`` (a rank function of this module) over ``ranks``
    ranks of ``dist_backend`` (``launch/ranks.py``; gloo ranks all on
    ``device``, nccl rank r on ``cuda:r``) and hold every rank's engine
    against ``expect``, the one-process engine of the same leg.  Returns
    the report's ranks part: ``ranks_parity_ok`` is whether every rank
    exited 0, committed ``expect``'s iterates, fitness history and
    engine stats (so each other's too) and, where ``counts`` is given,
    has the counts it reckons (``counts(doc)``, also
    ``ranks_counts_ok``)."""
    from repro_torch.launch import ranks as R

    devices = R.default_devices(dist_backend, ranks, device)
    with tempfile.TemporaryDirectory(prefix="ranks_") as workdir:
        res = R.run(target, kwargs, world=ranks, backend=dist_backend,
                    devices=devices, workdir=workdir)
    want = engine_doc(expect)
    docs = res.docs
    counts_ok = res.returncode == 0 and (
        counts is None or all(counts(d) for d in docs))
    parity = counts_ok and all(
        all(d[k] == want[k] for k in _ENGINE_KEYS) for d in docs)
    return {
        "ranks": ranks, "dist_backend": dist_backend,
        "model_ranks": kwargs.get("model_ranks", 1),
        "ranks_parity_ok": parity, "ranks_counts_ok": counts_ok,
        "ranks_returncode": res.returncode,
        "ranks_failed": res.failed, "ranks_wall_s": round(res.wall_s, 3),
        "per_rank": [None if d is None else
                     {k: v for k, v in d.items() if k not in _ENGINE_KEYS}
                     for d in docs],
    }


def _pod_problem(m: int, iterations: int, n_stars: int, n_hosts: int,
                 device):
    """The pod_mesh runner's problem on ``device``, as its one-process
    legs and every rank of its leg over ranks build it (same seeds):
    (f_batch, the warm ladder's top, ``run``), where ``run(backend,
    pipelined)`` drives a fresh engine through the batched grid on
    ``backend`` and returns (engine, grid stats, wall, launches)."""
    from repro_torch.core.anm import AnmConfig
    from repro_torch.core.engine import AnmEngine
    from repro_torch.core.grid import GridConfig
    from repro_torch.core.substrates.batched_grid import BatchedVolunteerGrid
    from repro_torch.core.substrates.eval_backend import bucket_size
    from repro_torch.data import sdss

    f_batch, x0 = _sdss_problem("podmesh_smoke", 17, n_stars, device)
    anm_cfg = AnmConfig(m_regression=m, m_line_search=m,
                        max_iterations=iterations)
    grid_cfg = GridConfig(n_hosts=n_hosts, failure_prob=0.05,
                          malicious_prob=0.01, seed=9)

    def run(backend, pipelined):
        engine = AnmEngine(x0, sdss.LO, sdss.HI, sdss.DEFAULT_STEP,
                           anm_cfg, seed=7, device=device)
        stats, wall, launches = _timed(
            lambda: BatchedVolunteerGrid(f_batch, grid_cfg, backend=backend,
                                         pipelined=pipelined,
                                         device=device).run(engine))
        return engine, stats, wall, launches
    return f_batch, bucket_size(BatchedVolunteerGrid.warm_max_bucket(m)), run


def _peak_gib(device) -> Optional[float]:
    """The peak of this process's CUDA memory on ``device`` so far, GiB
    (None on the CPU, which has no device memory to read)."""
    if torch.device(device).type != "cuda":
        return None
    torch.cuda.synchronize(device)
    return torch.cuda.max_memory_allocated(device) / 2**30


def _blocks(mesh) -> dict:
    """A rank's place on the (W/M, M) grid of ``mesh``."""
    return dict(data_block=mesh.rank // mesh.model_ranks,
                model_block=mesh.rank % mesh.model_ranks,
                model_ranks=mesh.model_ranks)


def rank_grid(ranks: int, model_ranks: int, mesh) -> Mesh:
    """``mesh``'s shape over ``ranks`` ranks, its model axis over groups of
    ``model_ranks`` of them, as rank 0 holds it (what the parent reckons a
    rank's counts on), built before any rank starts: so a grid the shape
    cannot take is refused there (``Mesh.over_ranks``: M not dividing N,
    or the model or data axis not dividing over its ranks)."""
    return Mesh.over_ranks(list(mesh.shape.values()), mesh.axis_names,
                           rank=0, rank_devices=["meta"] * ranks,
                           model_ranks=model_ranks)


def pod_mesh_rank(group, *, m: int, iterations: int, n_stars: int,
                  n_hosts: int, mesh_shape: list, axis_names: list,
                  model_ranks: int = 1) -> dict:
    """One rank of ``run_substrate_smoke``'s leg over ranks: the same
    stripe, engine and grid as every rank (SPMD), the pod backend on the
    mesh ``mesh_shape`` with its data axis over the group (and its model
    axis over groups of ``model_ranks``), pipelined.  Returns the rank's
    doc: ``engine_doc``, and its device, data and model block, data
    shards, wall, launches (the warm's left out) and peak device
    memory."""
    from repro_torch.core.substrates.pod_mesh import PodMeshEvalBackend

    device = group.device
    f_batch, max_bucket, run = _pod_problem(m, iterations, n_stars, n_hosts,
                                            device)
    mesh = group.mesh(mesh_shape, axis_names, model_ranks=model_ranks)
    pod = PodMeshEvalBackend(f_batch, mesh=mesh, n_dims=8,
                             max_bucket=max_bucket, device=device)
    shapes = pod.compile_count
    engine, _, wall, launches = run(pod, True)
    return dict(engine_doc(engine), rank=group.rank, device=str(device),
                **_blocks(mesh), data_shards=pod.local_shards,
                wall_s=round(wall, 3), launches=launches,
                peak_gib=_peak_gib(device),
                new_shapes_after_warm=pod.compile_count - shapes)


def _chart_doc(backend, refs: list) -> dict:
    """An LM backend's chart counts on a rank: what it stores, what its
    pieces handed the model group's all-gathers over its buckets, and
    whether the workload's whole θ0 and basis (``refs``: weak references
    to them, the caller's own dropped) are freed."""
    gc.collect()
    return dict(stored_bytes=backend.stored_bytes,
                model_gather_bytes=backend.model_gather_bytes,
                model_gathers=backend.model_gathers,
                model_gather_s=round(backend.model_gather_seconds, 3),
                gathered_buckets=backend.gathered_buckets,
                chart_freed=all(r() is None for r in refs))


def _chart_refs(wl) -> list:
    """Weak references to a workload's whole θ0 leaves and basis."""
    return [weakref.ref(wl.proj.basis)] + [
        weakref.ref(x) for _, x in S.spec_leaves(wl.proj.theta0)]


def chart_counts(cfg: ModelConfig, mesh, k: int) -> Callable:
    """``over_ranks``' ``counts`` for an LM leg on ``mesh`` (its shape and
    ``model_ranks``): a rank stores the reckoned bytes
    (``lm_loss.reckon_model_ranks``), its pieces handed the reckoned bytes
    and all-gathers each bucket, and, cut over model ranks, it freed the
    workload's whole chart."""
    from repro_torch.core.substrates.lm_loss import reckon_model_ranks

    want = reckon_model_ranks(cfg, mesh, k)

    def ok(doc: dict) -> bool:
        n = doc["gathered_buckets"]
        return (doc["stored_bytes"] == want["stored_bytes"]
                and doc["model_gather_bytes"] == n * want["gather_bytes"]
                and doc["model_gathers"] == n * want["gathers"]
                and (doc["chart_freed"] or mesh.model_ranks == 1))
    return ok


def lm_grid_rank(group, *, mesh_shape: list, axis_names: list,
                 model_ranks: int = 1, **problem_kw) -> dict:
    """One rank of an LM grid leg over ranks: ``server.sim.lm_problem``
    (``problem_kw``) built on the rank's device from the workload's seed,
    the LM backend on the mesh ``mesh_shape`` with its data axis over the
    group (and its model axis over groups of ``model_ranks``; the rank
    drops the workload's whole chart once the backend holds its pieces),
    warmed, act 1 pipelined.  Returns the rank's doc: ``engine_doc``, and
    its device, data and model block, data shards, lanes, layers, wall,
    launches (the warm's left out), peak device memory and chart counts
    (``_chart_doc``)."""
    from repro_torch.core.substrates.batched_grid import BatchedVolunteerGrid
    from repro_torch.core.substrates.eval_backend import bucket_size
    from repro_torch.core.substrates.lm_loss import LmLossEvalBackend
    from repro_torch.server.sim import lm_problem

    device = group.device
    spec, fleet, wl = lm_problem(device=device, **problem_kw)
    m, k, refs = spec.anm.m_regression, wl.k, _chart_refs(wl)
    mesh = group.mesh(mesh_shape, axis_names, model_ranks=model_ranks)
    backend = LmLossEvalBackend(wl, mesh=mesh)
    del wl
    backend.warm(k, bucket_size(BatchedVolunteerGrid.warm_max_bucket(m)))
    engine = spec.build_engine()
    lanes0, shapes = backend.lanes_evaluated, backend.compile_count
    _, wall, launches = _timed(
        lambda: BatchedVolunteerGrid(None, fleet, backend=backend,
                                     pipelined=True).run(engine))
    return dict(engine_doc(engine), rank=group.rank, device=str(device),
                **_blocks(mesh),
                data_shards=backend.n_shards // mesh.data_ranks,
                lanes=backend.lanes_evaluated - lanes0,
                n_layers=backend.workload.cfg.n_layers, wall_s=round(wall, 3),
                launches=launches, peak_gib=_peak_gib(device),
                new_shapes_after_warm=backend.compile_count - shapes,
                **_chart_doc(backend, refs))


def lm_points_rank(group, *, mesh_shape: list, axis_names: list,
                   model_ranks: int, buckets: list, **workload_kw) -> dict:
    """One rank scoring given points in given buckets, with no warm:
    ``make_lm_workload`` (``workload_kw``) built on the rank's device from
    its seed, the LM backend on the mesh ``mesh_shape`` over the group
    (its model axis over groups of ``model_ranks``), the workload's whole
    chart dropped, then each of ``buckets`` (a list of (k,) points)
    submitted and collected in turn.  Returns the rank's doc: its device,
    data and model block, chart counts (``_chart_doc``), and for each
    bucket its values, the bytes and all-gathers its pieces handed, their
    seconds, its wall and its launches; and the peak device memory."""
    import numpy as np

    from repro_torch.core.substrates.lm_loss import (LmLossEvalBackend,
                                                     make_lm_workload)

    device = group.device
    wl = make_lm_workload(device=device, **workload_kw)
    refs = _chart_refs(wl)
    mesh = group.mesh(mesh_shape, axis_names, model_ranks=model_ranks)
    backend = LmLossEvalBackend(wl, mesh=mesh)
    del wl
    out = []
    for pts in buckets:
        before = (backend.model_gather_bytes, backend.model_gathers,
                  backend.model_gather_seconds)
        values, wall, launches = _timed(
            lambda: backend(np.asarray(pts, np.float64)).tolist())
        out.append(dict(
            values=values, wall_s=round(wall, 3), launches=launches,
            gather_bytes=backend.model_gather_bytes - before[0],
            gathers=backend.model_gathers - before[1],
            gather_s=round(backend.model_gather_seconds - before[2], 3)))
    return dict(rank=group.rank, device=str(device), **_blocks(mesh),
                buckets=out, peak_gib=_peak_gib(device),
                **_chart_doc(backend, refs))


def run_substrate_smoke(out_dir: str, m: int = 32, iterations: int = 2,
                        n_stars: int = 500, n_hosts: int = 512, *,
                        device="cuda", mesh=None, ranks: int = 0,
                        dist_backend: str = "gloo",
                        model_ranks: int = 1) -> bool:
    """Pod-mesh + pipelined substrate smoke (``--substrate pod_mesh``).

    Runs the SAME batched-grid workload three ways on ``device`` — the
    in-process backend with the synchronous tick loop (the reference),
    in-process PIPELINED, and ``PodMeshEvalBackend`` pipelined with every
    bucket split over the ``data`` axis of ``mesh`` (default: the
    production 16 × 16 mesh over virtual devices) — and requires
    identical committed centers, fitness history and iteration counts
    across all three (DESIGN.md §6–§7).  Both backends are warmed over
    the whole bucket ladder first, so no timed leg runs a new bucket
    shape.  Writes ``substrate_pod_mesh.json`` into ``out_dir`` (the
    reference's keys, and ``device``, each leg's kernel launches, its
    new bucket shapes and ``stats_equal``: whether each leg's final
    engine stats equal the sync leg's); returns pass/fail (the
    reference's: the trajectories).

    With ``ranks`` > 0, a fourth leg runs the pod backend over ``ranks``
    ranks of ``dist_backend`` (``over_ranks``: the data axis of
    ``mesh``'s shape cut over the ranks, each rank a child process on its
    device; with ``model_ranks`` M its model axis too, over the (ranks/M,
    M) grid), and every rank must commit the pod leg's iterates and
    engine stats and evaluate its data block's shards; the report gains
    ``over_ranks``' keys and the result its ``ranks_parity_ok``."""
    import numpy as np

    from repro_torch.core.engine import identical_trajectories
    from repro_torch.core.substrates.eval_backend import InProcessEvalBackend
    from repro_torch.core.substrates.pod_mesh import PodMeshEvalBackend

    mesh = _pod_mesh(device, mesh)
    rank_mesh = rank_grid(ranks, model_ranks, mesh) if ranks else None
    f_batch, max_bucket, run_with = _pod_problem(m, iterations, n_stars,
                                                 n_hosts, device)
    in_backend = InProcessEvalBackend(f_batch, n_dims=8,
                                      max_bucket=max_bucket, device=device)
    pod = PodMeshEvalBackend(f_batch, mesh=mesh, n_dims=8,
                             max_bucket=max_bucket, device=device)
    warmed = {id(b): b.compile_count for b in (in_backend, pod)}

    e_in, s_in, t_in, l_in = run_with(in_backend, False)
    e_pin, s_pin, t_pin, l_pin = run_with(in_backend, True)
    e_pod, s_pod, t_pod, l_pod = run_with(pod, True)

    centers_equal = (
        len(e_in.history) == len(e_pod.history) and
        all(np.array_equal(a.center, b.center)
            for a, b in zip(e_in.history, e_pod.history)))
    fitness_equal = [r.best_fitness for r in e_in.history] == \
        [r.best_fitness for r in e_pod.history]
    pipelined_ok = identical_trajectories(e_in, e_pin)
    pod_ok = identical_trajectories(e_in, e_pod)
    ok = pipelined_ok and pod_ok
    report = {
        "mesh": _mesh_tag(mesh), "data_shards": pod.n_shards,
        "min_bucket": pod.min_bucket, "n_hosts": n_hosts, "m": m,
        "iterations": {"in_process": e_in.iteration,
                       "in_process_pipelined": e_pin.iteration,
                       "pod_mesh": e_pod.iteration},
        "final": {"in_process": e_in.best_fitness,
                  "in_process_pipelined": e_pin.best_fitness,
                  "pod_mesh": e_pod.best_fitness},
        "batch_calls": {"in_process": s_in.batch_calls,
                        "in_process_pipelined": s_pin.batch_calls,
                        "pod_mesh": s_pod.batch_calls},
        "wall_s": {"in_process": round(t_in, 3),
                   "in_process_pipelined": round(t_pin, 3),
                   "pod_mesh": round(t_pod, 3)},
        "pipeline": {"spec_blocks": s_pin.spec_blocks,
                     "spec_discarded": s_pin.spec_discarded,
                     "max_in_flight": s_pin.max_in_flight,
                     "pod_max_in_flight": s_pod.max_in_flight},
        "centers_equal": centers_equal, "fitness_equal": fitness_equal,
        "pipelined_parity_ok": pipelined_ok, "pod_parity_ok": pod_ok,
        "parity_ok": ok,
        "device": str(device), "n_stars": n_stars,
        "launches": {"in_process": l_in, "in_process_pipelined": l_pin,
                     "pod_mesh": l_pod},
        "new_shapes_after_warm": sum(b.compile_count - warmed[id(b)]
                                     for b in (in_backend, pod)),
        "stats_equal": {"in_process_pipelined": e_pin.stats == e_in.stats,
                        "pod_mesh": e_pod.stats == e_in.stats},
    }
    if ranks:
        shards = pod.n_shards // rank_mesh.data_ranks
        report.update(over_ranks(
            "repro_torch.launch.dryrun:pod_mesh_rank",
            dict(m=m, iterations=iterations, n_stars=n_stars,
                 n_hosts=n_hosts, mesh_shape=list(mesh.shape.values()),
                 axis_names=list(mesh.axis_names), model_ranks=model_ranks),
            ranks, dist_backend, device, e_pod,
            counts=lambda doc: doc["data_shards"] == shards))
        ok = ok and report["ranks_parity_ok"]
    path = _write(out_dir, "pod_mesh", report)
    print(f"[{'ok' if ok else 'FAIL'}] substrate pod_mesh: "
          f"{pod.n_shards} data shards, iters "
          f"{e_in.iteration}/{e_pin.iteration}/{e_pod.iteration}, final "
          f"{e_in.best_fitness:.6f}/{e_pin.best_fitness:.6f}/"
          f"{e_pod.best_fitness:.6f}, wall {t_in:.2f}s/{t_pin:.2f}s/"
          f"{t_pod:.2f}s (sync/pipelined/pod-pipelined)"
          + _ranks_line(report) + f" -> {path}")
    return ok


def _ranks_line(report: dict) -> str:
    """The print's part for a leg over ranks ('' without one)."""
    if "ranks" not in report:
        return ""
    devices = [r and r["device"] for r in report["per_rank"]]
    return (f"; over {report['ranks']} {report['dist_backend']} ranks on "
            f"{devices}: == pod {report['ranks_parity_ok']}, wall "
            f"{report['ranks_wall_s']}s"
            + ("" if report["ranks_failed"] is None
               else f" ({report['ranks_failed']})"))


def run_multi_search_smoke(out_dir: str, n_searches: int = 4, m: int = 24,
                           iterations: int = 2, n_stars: int = 400,
                           fleet_hosts: int = 512, *, device="cuda",
                           mesh=None) -> bool:
    """Multi-search orchestrator smoke (``--substrate multi_search``).

    A heterogeneous ``n_searches``-way portfolio (two different per-phase
    ``m``'s, perturbed starts, per-slot sub-fleets) runs coalesced over
    one shared backend, twice: through ``InProcessEvalBackend`` and
    through ``PodMeshEvalBackend`` on ``mesh`` (default: the production
    16 × 16 mesh over virtual devices), on ``device``.  For EVERY search
    and BOTH backends, the orchestrated engine must commit bit-identical
    iterates and identical final stats to the same spec run alone on the
    same backend, and the two backends' portfolios must agree search by
    search — the coalescing-safety contract of DESIGN.md §8.  Writes
    ``substrate_multi_search.json`` (the reference's keys, and
    ``device``, each backend's kernel launches and
    ``cross_backend_stats_equal``: whether the backends' final engine
    stats agree search by search); returns pass/fail (the reference's:
    the cross-backend check is on the trajectories)."""
    from repro_torch.core.engine import AnmConfig, identical_trajectories
    from repro_torch.core.grid import GridConfig
    from repro_torch.core.orchestrator import (FleetScheduler,
                                               SearchDirector,
                                               multi_start_specs)
    from repro_torch.core.substrates.eval_backend import InProcessEvalBackend
    from repro_torch.core.substrates.pod_mesh import PodMeshEvalBackend
    from repro_torch.data import sdss

    mesh = _pod_mesh(device, mesh)
    f_batch, x0 = _sdss_problem("multisearch_smoke", 23, n_stars, device)
    fleet = GridConfig(n_hosts=fleet_hosts, failure_prob=0.05,
                       malicious_prob=0.01, seed=9)
    configs = [AnmConfig(m_regression=m, m_line_search=m,
                         max_iterations=iterations),
               AnmConfig(m_regression=m // 2, m_line_search=m // 2,
                         max_iterations=iterations)]

    def run_portfolio(backend):
        sched = FleetScheduler(backend, fleet)
        specs = multi_start_specs(sched, x0, sdss.LO, sdss.HI,
                                  sdss.DEFAULT_STEP, configs[0], n_searches,
                                  seed=7, jitter=0.3, configs=configs)
        res, wall, launches = _timed(SearchDirector(sched, specs).run)
        parity = []
        for o in res.outcomes:
            solo = o.spec.solo_run(backend)
            parity.append(identical_trajectories(o.engine, solo)
                          and o.engine.stats == solo.stats)
        return res, wall, parity, launches

    backends = {
        "in_process": InProcessEvalBackend(f_batch, device=device),
        "pod_mesh": PodMeshEvalBackend(f_batch, mesh=mesh, device=device),
    }
    report = {"mesh": _mesh_tag(mesh), "n_searches": n_searches,
              "fleet_hosts": fleet_hosts, "backends": {},
              "device": str(device), "n_stars": n_stars, "m": m}
    ok = True
    cross = {}
    for name, backend in backends.items():
        res, wall, parity, launches = run_portfolio(backend)
        co = res.coalesce_stats
        report["backends"][name] = {
            "parity_per_search": parity,
            "iterations": [o.engine.iteration for o in res.outcomes],
            "final": [o.engine.best_fitness for o in res.outcomes],
            "rounds": res.rounds,
            "dispatches": co.dispatches, "lane_blocks": co.lane_blocks,
            "padded_lanes": co.padded_lanes,
            "solo_padded_lanes": co.solo_padded_lanes,
            "wall_s": round(wall, 3),
            "launches": launches,
        }
        cross[name] = res
        ok = ok and all(parity)
    # row-independence also means the portfolio itself must agree across
    # backends, search by search
    backend_pair_ok = all(
        identical_trajectories(a.engine, b.engine)
        for a, b in zip(cross["in_process"].outcomes,
                        cross["pod_mesh"].outcomes))
    ok = ok and backend_pair_ok
    report["cross_backend_ok"] = backend_pair_ok
    report["cross_backend_stats_equal"] = all(
        a.engine.stats == b.engine.stats
        for a, b in zip(cross["in_process"].outcomes,
                        cross["pod_mesh"].outcomes))
    report["parity_ok"] = ok
    path = _write(out_dir, "multi_search", report)
    rb = report["backends"]
    print(f"[{'ok' if ok else 'FAIL'}] substrate multi_search: "
          f"{n_searches} searches, dispatches "
          f"{rb['in_process']['dispatches']}/{rb['pod_mesh']['dispatches']} "
          f"for {rb['in_process']['lane_blocks']} blocks, wall "
          f"{rb['in_process']['wall_s']}s/{rb['pod_mesh']['wall_s']}s "
          f"(in-process/pod), cross-backend "
          f"{'ok' if backend_pair_ok else 'FAIL'} -> {path}")
    return ok


def run_cached_portfolio_smoke(out_dir: str, n_searches: int = 8,
                               m: int = 24, iterations: int = 2,
                               n_stars: int = 400, fleet_hosts: int = 512,
                               *, device="cuda", mesh=None) -> bool:
    """Eval-cache smoke (``--substrate cached_portfolio``).

    An ``n_searches``-way coalesced portfolio runs three times per
    backend (``InProcessEvalBackend`` and ``PodMeshEvalBackend`` on
    ``mesh``, default the production 16 × 16 mesh over virtual devices,
    on ``device``): cache-off, cache-on cold, and cache-on warm (same
    cache, whole portfolio replayed).  The §10 gates:

      * bit-exact parity — both cache-on runs commit bit-identical
        iterates and identical final stats to cache-off, per search;
      * the warm rerun is FULLY served — zero new misses, hits > 0
        (only malicious lanes touch the device again).

    Writes ``substrate_cached_portfolio.json`` (the reference's keys, and
    ``device``, the cache-off searches' iterations and final fitness and
    each run's kernel launches); returns pass/fail."""
    from repro_torch.core.engine import AnmConfig, identical_trajectories
    from repro_torch.core.grid import GridConfig
    from repro_torch.core.orchestrator import (FleetScheduler,
                                               SearchDirector,
                                               multi_start_specs)
    from repro_torch.core.substrates.eval_backend import InProcessEvalBackend
    from repro_torch.core.substrates.eval_cache import EvalCache
    from repro_torch.core.substrates.pod_mesh import PodMeshEvalBackend
    from repro_torch.data import sdss

    mesh = _pod_mesh(device, mesh)
    f_batch, x0 = _sdss_problem("cached_portfolio_smoke", 23, n_stars,
                                device)
    fleet = GridConfig(n_hosts=fleet_hosts, failure_prob=0.05,
                       malicious_prob=0.01, seed=9)
    anm = AnmConfig(m_regression=m, m_line_search=m,
                    max_iterations=iterations)

    def portfolio(backend, cache):
        sched = FleetScheduler(backend, fleet, cache=cache)
        specs = multi_start_specs(sched, x0, sdss.LO, sdss.HI,
                                  sdss.DEFAULT_STEP, anm, n_searches,
                                  seed=7, jitter=0.3)
        return _timed(SearchDirector(sched, specs).run)

    def pairwise_identical(a, b):
        return all(identical_trajectories(x.engine, y.engine)
                   and x.engine.stats == y.engine.stats
                   for x, y in zip(a.outcomes, b.outcomes))

    backends = {
        "in_process": InProcessEvalBackend(f_batch, device=device),
        "pod_mesh": PodMeshEvalBackend(f_batch, mesh=mesh, device=device),
    }
    report = {"mesh": _mesh_tag(mesh), "n_searches": n_searches,
              "fleet_hosts": fleet_hosts, "backends": {},
              "device": str(device), "n_stars": n_stars, "m": m}
    ok = True
    for name, backend in backends.items():
        off, wall_off, l_off = portfolio(backend, None)
        cache = EvalCache(fingerprint=f"cached_portfolio/{name}")
        cold, wall_cold, l_cold = portfolio(backend, cache)
        misses0 = cache.stats.misses
        hits0 = cache.stats.hits
        warm, wall_warm, l_warm = portfolio(backend, cache)
        cold_parity = pairwise_identical(off, cold)
        warm_parity = pairwise_identical(off, warm)
        warm_served = (cache.stats.misses == misses0
                       and cache.stats.hits > hits0)
        b_ok = cold_parity and warm_parity and warm_served
        report["backends"][name] = {
            "iterations": [o.engine.iteration for o in off.outcomes],
            "final": [o.engine.best_fitness for o in off.outcomes],
            "cold_parity": cold_parity, "warm_parity": warm_parity,
            "warm_fully_served": warm_served,
            "cache": cache.status(),
            "lanes_deduped": (warm.coalesce_stats.lanes_deduped
                              if warm.coalesce_stats else 0),
            "wall_s": {"off": round(wall_off, 3),
                       "cold": round(wall_cold, 3),
                       "warm": round(wall_warm, 3)},
            "launches": {"off": l_off, "cold": l_cold, "warm": l_warm},
        }
        ok = ok and b_ok
    report["parity_ok"] = ok
    path = _write(out_dir, "cached_portfolio", report)
    rb = report["backends"]
    ip = rb["in_process"]
    print(f"[{'ok' if ok else 'FAIL'}] substrate cached_portfolio: "
          f"{n_searches} searches, hit_rate "
          f"{ip['cache']['hit_rate']:.2f}, wall off/cold/warm "
          f"{ip['wall_s']['off']}s/{ip['wall_s']['cold']}s/"
          f"{ip['wall_s']['warm']}s (in-process), pod warm_parity "
          f"{rb['pod_mesh']['warm_parity']} -> {path}")
    return ok


def run_lm_subspace_smoke(out_dir: str, arch: str = "rwkv6-7b",
                          k: int = 6, m: int = 12, iterations: int = 2,
                          n_hosts: int = 48, *, device="cuda", mesh=None,
                          problem=None,
                          portfolio_iterations: Optional[int] = None,
                          ranks: int = 0, dist_backend: str = "gloo",
                          model_ranks: int = 1) -> bool:
    """LM-loss workload smoke (``--substrate lm_subspace``).

    The model stack IS the fitness function: an ``LmWorkload`` over
    ``arch``'s smoke config (``server.sim.lm_problem``), or the ``(spec,
    fleet, workload)`` of ``problem``, already built (e.g. at published
    widths), searched in its k-dim subspace-coefficient box by the full
    asynchronous stack on ``device``.  Gates (DESIGN.md §11):

      1. sync == pipelined == pod: the batched grid commits bit-identical
         iterates through the in-process backend (both tick loops) and
         through the pod backend — lanes split over ``data``, θ0 and the
         basis stored cut over ``model`` of ``mesh`` (default: the
         production 16 × 16 mesh over virtual devices) — with no new
         bucket shape once warmed;
      2. orchestrator + cache: a coalesced 2-search portfolio over the
         shared backend, evaluated through ``CachingSubmitter``; every
         search bit-identical to its solo run, warm replay fully served
         (its searches run ``portfolio_iterations``, default the spec's);
      3. work server: the same workload through the crash-recoverable
         server (simulated crash at 40 % of the messages, restore from
         snapshot + replay log) — restored == uninterrupted, and
         in-process == pod through the whole server stack.

    Writes ``substrate_lm_subspace.json`` (the reference's keys, and
    ``device``, ``n_layers``, each gate's lanes and kernel launches, and
    whether the final engine stats agree: ``grid/stats_equal`` against
    the sync leg, ``orchestrator/solo_stats_equal`` and
    ``warm_stats_equal``); returns pass/fail (the reference's: gates 1
    and 2 on the trajectories).

    With ``ranks`` > 0, gate 1 gains a leg over ``ranks`` ranks of
    ``dist_backend`` (``over_ranks``, ``lm_grid_rank``: every rank builds
    the workload from its seed, so ``problem`` must be None; with
    ``model_ranks`` M the mesh's model axis is cut over groups of M of
    them): every rank must commit the pod leg's iterates and engine
    stats, and store and gather the chart's bytes ``chart_counts``
    reckons; the report gains ``over_ranks``' keys and the result its
    ``ranks_parity_ok``."""
    if ranks and problem is not None:
        raise ValueError("a leg over ranks builds the workload on every "
                         "rank from its seed: pass no problem")
    from repro_torch.core.engine import identical_trajectories
    from repro_torch.core.orchestrator import (FleetScheduler,
                                               SearchDirector,
                                               multi_start_specs)
    from repro_torch.core.substrates.batched_grid import BatchedVolunteerGrid
    from repro_torch.core.substrates.eval_backend import bucket_size
    from repro_torch.core.substrates.eval_cache import EvalCache
    from repro_torch.core.substrates.lm_loss import LmLossEvalBackend
    from repro_torch.server.sim import (ServerSubstrate, SimulatedCrash,
                                        lm_problem, result_doc)

    mesh = _pod_mesh(device, mesh)
    rank_mesh = rank_grid(ranks, model_ranks, mesh) if ranks else None
    spec, fleet, wl = problem or lm_problem(
        arch=arch, k=k, n_hosts=n_hosts, m=m, iterations=iterations,
        device=device)
    arch, k, m = wl.arch, wl.k, spec.anm.m_regression
    iterations = spec.anm.max_iterations
    max_bucket = bucket_size(BatchedVolunteerGrid.warm_max_bucket(m))
    t0 = time.perf_counter()
    in_backend = LmLossEvalBackend(wl, n_dims=k, max_bucket=max_bucket)
    pod = LmLossEvalBackend(wl, mesh=mesh, n_dims=k, max_bucket=max_bucket)
    t_warm = time.perf_counter() - t0
    compiles_warm = (in_backend.compile_count, pod.compile_count)
    backends = (in_backend, pod)

    def lanes() -> int:
        return sum(b.lanes_evaluated for b in backends)

    def gate(fn):
        """(fn(), wall, {"lanes": lanes evaluated, "launches": ...})."""
        lanes0 = lanes()
        out, wall, launches = _timed(fn)
        return out, wall, {"lanes": lanes() - lanes0, "launches": launches}

    # -- gate 1: sync == pipelined == pod, no new shape after warm --------
    def grid_run(backend, pipelined):
        engine = spec.build_engine()
        stats, wall, _ = _timed(
            lambda: BatchedVolunteerGrid(None, spec.grid, backend=backend,
                                         pipelined=pipelined).run(engine))
        return engine, stats, wall

    def grid():
        return (grid_run(in_backend, False), grid_run(in_backend, True),
                grid_run(pod, True))
    runs, _, grid_k = gate(grid)
    (e_sync, s_sync, t_sync), (e_pipe, s_pipe, t_pipe), \
        (e_pod, s_pod, t_pod) = runs
    pipe_ok = identical_trajectories(e_sync, e_pipe)
    pod_ok = identical_trajectories(e_sync, e_pod)
    zero_compiles = (in_backend.compile_count == compiles_warm[0]
                     and pod.compile_count == compiles_warm[1])

    # -- gate 2: coalesced portfolio through CachingSubmitter --------------
    cache = EvalCache(fingerprint=f"lm_subspace/{arch}/{k}")

    anm = (spec.anm if portfolio_iterations is None else
           dataclasses.replace(spec.anm, max_iterations=portfolio_iterations))

    def portfolio():
        sched = FleetScheduler(in_backend, fleet, cache=cache)
        specs = multi_start_specs(sched, spec.x0, spec.lo, spec.hi,
                                  spec.step, anm, 2, seed=7, jitter=0.3)
        return SearchDirector(sched, specs).run()

    def orchestrate():
        cold = portfolio()
        counts = cache.stats.misses, cache.stats.hits
        warm = portfolio()
        solo = [o.spec.solo_run(in_backend) for o in cold.outcomes]
        return cold, counts, warm, solo
    (cold, (misses0, hits0), warm, solos), t_port, orch_k = gate(
        orchestrate)
    solo_parity = [identical_trajectories(o.engine, e)
                   for o, e in zip(cold.outcomes, solos)]
    warm_parity = all(identical_trajectories(a.engine, b.engine)
                      for a, b in zip(cold.outcomes, warm.outcomes))
    warm_served = (cache.stats.misses == misses0
                   and cache.stats.hits > hits0)
    orch_ok = all(solo_parity) and warm_parity and warm_served

    # -- gate 3: the crash-recoverable work server -------------------------
    def serve():
        base = result_doc(ServerSubstrate(spec, fleet, in_backend).run())
        on_pod = result_doc(ServerSubstrate(spec, fleet, pod).run())
        kill_after = max(50, int(0.4 * base["pool"]["messages"]))
        with tempfile.TemporaryDirectory(prefix="lm_server_") as ckpt:
            try:
                ServerSubstrate(spec, fleet, in_backend, ckpt_dir=ckpt,
                                snapshot_every=25,
                                max_messages=kill_after).run()
                crashed = False        # finished before the crash: fail
            except SimulatedCrash:
                crashed = True
            resumed = ServerSubstrate(spec, fleet, in_backend,
                                      ckpt_dir=ckpt).run(resume=True)
        return base, on_pod, crashed, result_doc(resumed)
    (base_doc, pod_doc, crashed, res_doc), t_server, server_k = gate(serve)
    server_backend_ok = (
        base_doc["history"] == pod_doc["history"]
        and base_doc["engine_stats"] == pod_doc["engine_stats"])
    restore_ok = (crashed and not res_doc["recovered_done"]
                  and res_doc["history"] == base_doc["history"]
                  and res_doc["engine_stats"] == base_doc["engine_stats"])

    ok = (pipe_ok and pod_ok and zero_compiles and orch_ok
          and server_backend_ok and restore_ok)
    ranks_report = {}
    if ranks:
        ranks_report = over_ranks(
            "repro_torch.launch.dryrun:lm_grid_rank",
            dict(arch=arch, k=k, n_hosts=n_hosts, m=m, iterations=iterations,
                 mesh_shape=list(mesh.shape.values()),
                 axis_names=list(mesh.axis_names), model_ranks=model_ranks),
            ranks, dist_backend, device, e_pod,
            counts=chart_counts(wl.cfg, rank_mesh, k))
        ok = ok and ranks_report["ranks_parity_ok"]
    report = {
        "arch": arch, "k": k, "m": m, "iterations": iterations,
        "mesh": _mesh_tag(mesh), "n_params": int(wl.proj.n_params),
        "data_shards": pod.n_shards, "min_bucket": pod.min_bucket,
        "model_spec_fallbacks": len(pod.spec_fallbacks),
        "warm_s": round(t_warm, 3),
        "compiles": {"in_process": in_backend.compile_count,
                     "pod": pod.compile_count,
                     "zero_after_warm": zero_compiles},
        "grid": {
            "iterations": {"sync": e_sync.iteration,
                           "pipelined": e_pipe.iteration,
                           "pod": e_pod.iteration},
            "final": {"sync": e_sync.best_fitness,
                      "pipelined": e_pipe.best_fitness,
                      "pod": e_pod.best_fitness},
            "batch_calls": {"sync": s_sync.batch_calls,
                            "pipelined": s_pipe.batch_calls,
                            "pod": s_pod.batch_calls},
            "wall_s": {"sync": round(t_sync, 3),
                       "pipelined": round(t_pipe, 3),
                       "pod": round(t_pod, 3)},
            "pipelined_parity_ok": pipe_ok, "pod_parity_ok": pod_ok,
            "stats_equal": {"pipelined": e_pipe.stats == e_sync.stats,
                            "pod": e_pod.stats == e_sync.stats},
        },
        "orchestrator": {
            "solo_parity": solo_parity, "warm_replay_parity": warm_parity,
            "warm_fully_served": warm_served, "cache": cache.status(),
            "wall_s": round(t_port, 3), "parity_ok": orch_ok,
            "iterations": anm.max_iterations,
            "solo_stats_equal": [o.engine.stats == e.stats
                                 for o, e in zip(cold.outcomes, solos)],
            "warm_stats_equal": all(
                a.engine.stats == b.engine.stats
                for a, b in zip(cold.outcomes, warm.outcomes)),
        },
        "server": {
            "iterations": base_doc["iteration"],
            "best": base_doc["best_fitness"],
            "messages": base_doc["pool"]["messages"],
            "backend_parity_ok": server_backend_ok,
            "crashed_mid_run": crashed,
            "replayed": res_doc["replayed"],
            "resumed_leases": res_doc["pool"]["resumed_leases"],
            "restore_parity_ok": restore_ok,
            "wall_s": round(t_server, 3),
        },
        "parity_ok": ok,
        "device": str(device), "n_layers": wl.cfg.n_layers,
        "kernels": {"grid": grid_k, "orchestrator": orch_k,
                    "server": server_k},
        **ranks_report,
    }
    path = _write(out_dir, "lm_subspace", report)
    print(f"[{'ok' if ok else 'FAIL'}] substrate lm_subspace: {arch} "
          f"({wl.proj.n_params} params, k={k}), grid "
          f"{'ok' if pipe_ok and pod_ok else 'FAIL'} "
          f"(wall {t_sync:.1f}s/{t_pipe:.1f}s/{t_pod:.1f}s "
          f"sync/pipelined/pod), compiles "
          f"{'0' if zero_compiles else 'NONZERO'} after warm, "
          f"orchestrator {'ok' if orch_ok else 'FAIL'}, server "
          f"{'ok' if server_backend_ok and restore_ok else 'FAIL'}"
          + _ranks_line(report) + f" -> {path}")
    return ok


# ---------------------------------------------------------------------------
# The substrate smokes: the server runners, each leg a child process
# ---------------------------------------------------------------------------

#: the seeded server smoke's command line, and the post-mortem reader's
SIM_MODULE = "repro_torch.server.sim"
POSTMORTEM_MODULE = "repro_torch.launch.obs_postmortem"
#: the fault counters of a chaos run's doc
_FAULTS = ("drops_request", "drops_reply", "duplicates", "delays", "resets",
           "torn_writes")


def trajectories_equal(a: dict, b: dict) -> bool:
    """The server runners' parity gate on two result docs: the committed
    history, iteration and best fitness, and the final engine stats."""
    return all(a[k] == b[k] for k in ("history", "iteration", "best_fitness",
                                      "engine_stats"))


def _faults_injected(chaos: dict) -> int:
    return sum(chaos[k] for k in _FAULTS)


class ServerChildren:
    """What the four server runners share: their legs run as child
    processes of ``server/sim.py``'s command line (``SIM_MODULE``), each
    ``spec_args`` + ``--device`` + the leg's own flags, from a temporary
    directory (``path``; removed by ``close``).  A child is forked from
    the forkserver of ``launch/child.py``, which imported torch and the
    port once: it opens its own CUDA context, and a SIGKILL ends it as it
    ends any process.  Independent legs run at once (``parallel``).  On a
    CUDA device the kernels are built here before any child starts, so
    no child compiles and no SIGKILL lands inside ``nvcc``.  Every
    child's result doc is kept for ``device_gate``, each leg's wall in
    ``walls``."""

    def __init__(self, prefix: str, device, spec_args):
        self.device = str(device)
        self.cuda = torch.device(device).type == "cuda"
        if self.cuda:
            from repro_torch.kernels import build
            build.build_all()
        src = os.path.abspath(os.path.join(os.path.dirname(__file__), "..",
                                           ".."))
        self.env = dict(os.environ)
        self.env["PYTHONPATH"] = src + (
            ":" + self.env["PYTHONPATH"] if self.env.get("PYTHONPATH")
            else "")
        self.spec_args = list(spec_args)
        self.tmp = tempfile.mkdtemp(prefix=prefix)
        self.docs: list = []
        self.walls: Dict[str, float] = {}

    def path(self, name: str) -> str:
        return os.path.join(self.tmp, name)

    def argv(self, extra, module: str = SIM_MODULE) -> list:
        """A child's command line: ``python -m <module>`` and these."""
        args = (self.spec_args + ["--device", self.device]
                if module == SIM_MODULE else [])
        return [*args, *extra]

    def start(self, leg: str, extra, module: str = SIM_MODULE):
        """Start one child; its stderr goes to ``<leg>.stderr``."""
        return child.start(module, self.argv(extra, module), self.env,
                           err_path=self.path(f"{leg}.stderr"), name=leg)

    def _failed(self, leg: str, proc) -> None:
        with open(self.path(f"{leg}.stderr")) as f:
            print(f"[FAIL] {leg} child exited {proc.exitcode}:\n"
                  f"{f.read()[-2000:]}")

    def run(self, leg: str, extra, module: str = SIM_MODULE) -> dict:
        """Run one child to its end, ``--out`` into ``<leg>.json``, and
        return that doc.  A child that exits nonzero (or is still running
        after 600 s, and is killed) prints the end of its stderr and
        raises: no leg falls back to this process or the CPU."""
        out = self.path(f"{leg}.json")
        t0 = time.perf_counter()
        proc = self.start(leg, [*extra, "--out", out], module)
        proc.join(600)
        if proc.is_alive():
            proc.kill()
            proc.join()
        self.walls[leg] = round(time.perf_counter() - t0, 3)
        if proc.exitcode != 0:
            self._failed(leg, proc)
            raise RuntimeError(f"{leg} child failed")
        with open(out) as f:
            doc = json.load(f)
        if module == SIM_MODULE:
            self.docs.append(doc)
        return doc

    def kill_mid_run(self, leg: str, extra, ckpt: str, floor: int,
                     base_messages: int) -> bool:
        """Start a child checkpointing into ``ckpt`` and SIGKILL it once a
        snapshot is on disk and its replay log holds ``max(floor, 40 % of
        base_messages)`` records, polling every 20 ms for 300 s.
        Returns whether it was killed mid-run (False: it ended first, or
        never got there)."""
        kill_after = max(floor, int(0.4 * base_messages))
        log_path = os.path.join(ckpt, "replay.jsonl")
        t0 = time.perf_counter()
        proc = self.start(leg, extra)
        killed = False
        try:
            deadline = time.time() + 300
            while time.time() < deadline and proc.is_alive():
                has_snap = os.path.isdir(ckpt) and any(
                    f.startswith("snapshot_") for f in os.listdir(ckpt))
                lines = 0
                if os.path.exists(log_path):
                    with open(log_path, "rb") as f:
                        lines = f.read().count(b"\n")
                if has_snap and lines >= kill_after:
                    os.kill(proc.pid, signal.SIGKILL)
                    proc.join(30)
                    killed = True
                    break
                time.sleep(0.02)
        finally:
            if proc.is_alive():
                proc.kill()
            proc.join(30)
        self.walls[leg] = round(time.perf_counter() - t0, 3)
        if not killed and proc.exitcode:
            self._failed(leg, proc)
        return killed

    @staticmethod
    def parallel(legs: Dict[str, Callable[[], Any]]) -> Dict[str, Any]:
        """Run independent legs at once, a thread each (a leg waits on its
        children); their results by name.  A leg that raises raises here,
        once every leg has ended."""
        with concurrent.futures.ThreadPoolExecutor(len(legs)) as pool:
            futures = {name: pool.submit(fn) for name, fn in legs.items()}
        return {name: f.result() for name, f in futures.items()}

    def device_gate(self) -> dict:
        """Whether every child's doc says it ran on this device (and, on
        CUDA, that it launched the row_mean kernel)."""
        want = torch.device(self.device).type
        devices = [d["device"] for d in self.docs]
        row_mean = [d["launches"].get("row_mean_launches", 0)
                    for d in self.docs]
        ok = bool(devices) and all(torch.device(d).type == want
                                   for d in devices)
        if self.cuda:
            ok = ok and all(n > 0 for n in row_mean)
        return {"children": len(devices), "devices": sorted(set(devices)),
                "row_mean_launches": row_mean, "ok": ok}

    def close(self) -> None:
        shutil.rmtree(self.tmp, ignore_errors=True)


def _spec_args(n_hosts: int, m: int, iterations: int, n_stars: int,
               silence: bool = False) -> list:
    args = ["--n-hosts", str(n_hosts), "--m", str(m), "--iterations",
            str(iterations), "--n-stars", str(n_stars)]
    return args + (["--silence-at", "150", "--silence-frac", "0.25"]
                   if silence else [])


def _baseline(doc: dict) -> dict:
    return {"iterations": doc["iteration"], "best": doc["best_fitness"],
            "messages": doc["pool"]["messages"],
            "registry": doc["registry"]}


def _kill_restore(kids: ServerChildren, leg: str, extra, ckpt: str,
                  floor: int, base: dict) -> Tuple[dict, Optional[dict]]:
    """A child SIGKILLed mid-run (``ServerChildren.kill_mid_run``), then
    restored with ``--resume`` to its end: (the reference's kill-leg
    entry, the restored doc or None)."""
    if not kids.kill_mid_run(f"kill_{leg}", extra, ckpt, floor,
                             base["pool"]["messages"]):
        return {"killed_mid_run": False, "ok": False}, None
    try:
        res = kids.run(f"resume_{leg}", [*extra, "--resume"])
    except RuntimeError:
        return {"killed_mid_run": True, "ok": False,
                "error": "resume child failed"}, None
    equal = trajectories_equal(base, res)
    return {"killed_mid_run": True, "recovered_done": res["recovered_done"],
            "replayed": res["replayed"],
            "resumed_leases": res["pool"]["resumed_leases"],
            "trajectory_equal": equal,
            "ok": equal and not res["recovered_done"]}, res


def _on_mesh(device, mesh, n_hosts: int, m: int, iterations: int,
             n_stars: int, **kw) -> Tuple[dict, str]:
    """The smoke search in this process, evaluated through the pod backend
    over ``mesh`` (default: the production 16 × 16 mesh over virtual
    devices of ``device``), ``kw`` to ``ServerSubstrate``: (its result
    doc, the mesh's tag)."""
    from repro_torch.core.substrates.pod_mesh import PodMeshEvalBackend
    from repro_torch.server.sim import (ServerSubstrate, result_doc,
                                        smoke_problem)

    spec, fleet, f_batch = smoke_problem(
        n_stars=n_stars, n_hosts=n_hosts, m=m, iterations=iterations,
        device=device)
    backend = PodMeshEvalBackend(f_batch, mesh=_pod_mesh(device, mesh),
                                 device=device)
    doc = result_doc(ServerSubstrate(spec, fleet, backend, **kw).run())
    return doc, _mesh_tag(backend.mesh)


def _finish(name: str, out_dir: str, report: dict, kids: ServerChildren,
            ok: bool) -> Tuple[bool, str]:
    """Gate the children's devices, write the report; (ok, its path)."""
    gate = kids.device_gate()
    ok = ok and gate["ok"]
    report.update(device=kids.device, children=gate, wall_s=kids.walls,
                  parity_ok=ok)
    return ok, _write(out_dir, name, report)


def run_server_smoke(out_dir: str, n_hosts: int = 160, m: int = 24,
                     iterations: int = 4, n_stars: int = 400, *,
                     device="cuda", mesh=None) -> bool:
    """Service-layer kill/restore smoke (``--substrate server``).

    The seeded smoke search (``repro_torch.server.sim.smoke_problem``)
    runs four ways, every leg but one a child process on ``device``
    (``ServerChildren``; legs 2-5 at once, after 1):

      1. uninterrupted, loopback transport                → the baseline;
      2. uninterrupted, pod-mesh evaluation path          → must equal 1
         (row-independence across evaluation widths, DESIGN.md §6/§8) —
         plus an IN-PROCESS run over ``mesh`` (default: the production
         16 × 16 mesh over virtual devices of ``device``) here in the
         parent, exercising the partitioning;
      3. SIGKILLed mid-search on loopback, restored from snapshot +
         replay log, run to completion                    → must equal 1;
      4. the same kill/restore over the TCP transport     → must equal 1;
      5. the same loopback kill/restore with ``--cache``  → must equal 1,
         AND the restored process must come back WARM: its eval-cache
         store survives the SIGKILL in the checkpoint dir and serves the
         re-leased in-flight points (``cache.hits > 0``, DESIGN.md §10).

    "Equal" is the hard service-layer contract: bit-identical committed
    centers and fitness history AND identical final ``EngineStats``.
    Writes ``substrate_server.json`` (the reference's keys, and
    ``device``, ``mesh``, ``children``: every child's device and
    row_mean launches, and each leg's wall); returns pass/fail, which
    also requires every child to have run on ``device``."""
    kids = ServerChildren("server_smoke_", device,
                          _spec_args(n_hosts, m, iterations, n_stars))
    report = {"n_hosts": n_hosts, "m": m, "iterations": iterations}
    ok = True
    try:
        base = kids.run("base", [])

        def kill(variant, transport, cache_args):
            # kill once ~40% of the baseline's message count has been
            # logged: deep enough that the kill lands well past the
            # bootstrap, with most of the run still ahead (the throttle
            # in the child stretches the wall-clock window so the 20 ms
            # poll cannot miss it)
            ckpt = kids.path(f"ckpt_{variant}")
            entry, res = _kill_restore(
                kids, variant,
                ["--transport", transport, "--ckpt-dir", ckpt,
                 "--snapshot-every", "200", "--throttle-s", "0.002",
                 *cache_args], ckpt, 200, base)
            if res is not None and cache_args:
                # the §10 warm-restore gate: the store survived the kill
                # and the restored process actually served from it
                warm = (res["cache"] is not None
                        and res["cache"]["hits"] > 0
                        and res["cache"]["store_size"] > 0)
                entry.update(cache=res["cache"], warm_after_restore=warm,
                             ok=entry["ok"] and warm)
            return entry

        legs = kids.parallel({
            "pod": lambda: kids.run("pod", ["--backend", "pod_mesh"]),
            "mesh": lambda: _on_mesh(device, mesh, n_hosts, m, iterations,
                                     n_stars),
            "loopback": lambda: kill("loopback", "loopback", []),
            "tcp": lambda: kill("tcp", "tcp", []),
            "loopback_cache": lambda: kill("loopback_cache", "loopback",
                                           ["--cache"])})
        backend_ok = trajectories_equal(base, legs["pod"])
        mesh_doc, tag = legs["mesh"]
        mesh_ok = trajectories_equal(base, mesh_doc)
        kills = {v: legs[v] for v in ("loopback", "tcp", "loopback_cache")}
        report.update({
            "baseline": _baseline(base),
            "backend_parity_ok": backend_ok,
            "production_mesh_parity_ok": mesh_ok,
            "mesh": tag,
            "kill_restore": kills,
        })
        ok = (backend_ok and mesh_ok
              and all(k["ok"] for k in kills.values()))
    except Exception as e:  # noqa: BLE001 — smoke must report, not die
        report["error"] = str(e)
        ok = False
    finally:
        kids.close()
    ok, path = _finish("server", out_dir, report, kids, ok)
    kr = report.get("kill_restore", {})
    print(f"[{'ok' if ok else 'FAIL'}] substrate server: "
          f"backend_parity={report.get('backend_parity_ok')} "
          f"mesh_parity={report.get('production_mesh_parity_ok')} "
          f"loopback_kill={kr.get('loopback', {}).get('ok')} "
          f"tcp_kill={kr.get('tcp', {}).get('ok')} "
          f"cache_kill={kr.get('loopback_cache', {}).get('ok')} "
          f"warm={kr.get('loopback_cache', {}).get('warm_after_restore')} "
          f"-> {path}")
    return ok


def run_chaos_server_smoke(out_dir: str, n_hosts: int = 48, m: int = 12,
                           iterations: int = 3, n_stars: int = 200,
                           n_clients: int = 8, *, device="cuda",
                           mesh=None) -> bool:
    """Chaos-hardened work-service smoke (``--substrate chaos_server``,
    DESIGN.md §12).

    The seeded smoke search runs once serially on loopback with no faults
    (the baseline), then as ``n_clients`` truly concurrent TCP clients —
    clean, and under each of three seeded ``FaultPlan`` presets (drops +
    duplication, reordering delay, resets + torn writes) — every time in
    a child process on ``device``.  The hard gate is the tentpole
    contract: bit-identical committed iterates and identical final engine
    stats vs the fault-free serial baseline, with the fault counters
    proving the schedule actually injected.  Two more legs:

      * a SIGKILL mid-chaos (concurrent TCP + reset_torn), restored from
        snapshot + replay log and run to completion → must equal the
        baseline;
      * a concurrent+chaos run in the parent evaluating through the pod
        backend over ``mesh`` (default: the production 16 × 16 mesh over
        virtual devices of ``device``) — fault tolerance and the
        production partitioning composed.

    Every leg after the baseline runs at once.  Writes
    ``substrate_chaos_server.json`` (the reference's keys, and
    ``baseline``, ``device``, ``children`` and each leg's wall); returns
    pass/fail, which also requires every child to have run on
    ``device``."""
    kids = ServerChildren("chaos_smoke_", device,
                          _spec_args(n_hosts, m, iterations, n_stars))
    conc_args = ["--transport", "tcp", "--concurrent", str(n_clients)]
    report = {"n_hosts": n_hosts, "m": m, "iterations": iterations,
              "n_clients": n_clients}
    presets = ("drop_dup", "reorder_delay", "reset_torn")
    ok = True
    try:
        base = kids.run("base", [])
        report["baseline"] = _baseline(base)

        def plan(preset):
            try:
                doc = kids.run(preset, [*conc_args, "--chaos", preset])
            except RuntimeError:
                return {"ok": False, "error": "child failed"}
            ch = doc["chaos"]
            injected = _faults_injected(ch)
            return {"trajectory_equal": trajectories_equal(base, doc),
                    "faults_injected": injected,
                    "chaos": {k: v for k, v in ch.items() if k != "plan"},
                    "ok": trajectories_equal(base, doc) and injected > 0}

        # SIGKILL mid-chaos + restore under the same plan
        ckpt = kids.path("ckpt_chaos")
        kill_args = [*conc_args, "--chaos", "reset_torn", "--ckpt-dir",
                     ckpt, "--snapshot-every", "150", "--throttle-s",
                     "0.002"]
        legs = kids.parallel({
            # clean concurrency: the intake + release machinery alone
            "concurrent": lambda: kids.run("concurrent", conc_args),
            **{p: (lambda p=p: plan(p)) for p in presets},
            "kill": lambda: _kill_restore(kids, "chaos", kill_args, ckpt,
                                          150, base)[0],
            # concurrent + chaos over the 16x16 mesh, in the parent
            "mesh": lambda: _on_mesh(device, mesh, n_hosts, m, iterations,
                                     n_stars, transport="tcp",
                                     concurrent=n_clients,
                                     chaos="drop_dup")})
        clean = legs["concurrent"]
        concurrent_ok = (trajectories_equal(base, clean)
                         and clean["intake"]["parked"] > 0)
        report["concurrent_clean"] = {
            "trajectory_equal": trajectories_equal(base, clean),
            "intake": clean["intake"], "ok": concurrent_ok}
        report["fault_plans"] = {p: legs[p] for p in presets}
        kill = legs["kill"]
        report["kill_restore"] = kill
        mesh_doc, tag = legs["mesh"]
        mesh_ok = trajectories_equal(base, mesh_doc)
        report["production_mesh_chaos"] = {
            "mesh": tag, "trajectory_equal": mesh_ok,
            "chaos": {k: v for k, v in mesh_doc["chaos"].items()
                      if k != "plan"},
            "ok": mesh_ok}
        ok = (concurrent_ok and mesh_ok and kill["ok"]
              and all(legs[p]["ok"] for p in presets))
    except Exception as e:  # noqa: BLE001 — smoke must report, not die
        report["error"] = str(e)
        ok = False
    finally:
        kids.close()
    ok, path = _finish("chaos_server", out_dir, report, kids, ok)
    fp = report.get("fault_plans", {})
    print(f"[{'ok' if ok else 'FAIL'}] substrate chaos_server: "
          f"concurrent={report.get('concurrent_clean', {}).get('ok')} "
          f"drop_dup={fp.get('drop_dup', {}).get('ok')} "
          f"reorder={fp.get('reorder_delay', {}).get('ok')} "
          f"reset_torn={fp.get('reset_torn', {}).get('ok')} "
          f"kill={report.get('kill_restore', {}).get('ok')} "
          f"mesh={report.get('production_mesh_chaos', {}).get('ok')} "
          f"-> {path}")
    return ok


def run_obs_server_smoke(out_dir: str, n_hosts: int = 48, m: int = 12,
                         iterations: int = 3, n_stars: int = 200,
                         n_clients: int = 8, *, device="cuda",
                         mesh=None) -> bool:
    """Observability-plane smoke (``--substrate obs_server``, DESIGN.md
    §13).

    Every leg shares one injected fleet failure — a quarter of the host
    ids go silent at virtual time 150 — so the anomaly machinery always
    has churn to see, and every parity pair lives in the same world;
    each leg is a child process on ``device``, 2-5 at once after 1:

      1. the UNOBSERVED serial loopback baseline;
      2. observed live: metrics hub + ``n_clients`` truly concurrent TCP
         clients + a real background ``subscribe_stats`` subscriber
         polling over its own socket during the run → bit-identical to 1,
         and the subscriber must have received ≥ 2 stamped snapshots with
         strictly increasing seqs;
      3. observed under chaos (``drop_dup`` fault plan, concurrent TCP) →
         bit-identical to 1 with faults provably injected (monitoring
         traffic bypasses the injector, so the fault schedule — keyed on
         stamped client messages — is unchanged);
      4. observed + subscribed, SIGKILLed mid-stream on loopback,
         restored from snapshot + replay log with obs re-attached →
         bit-identical to 1 (the hub owns no replayable state);
      5. anomaly defense live: detectors quarantine the silenced cohort
         out of the registry's reliable set (measurably smaller than the
         undefended baseline's), recording the verdict schedule — then a
         REPLAY run applies the recorded schedule with detectors off and
         must reproduce the defended trajectory bit-for-bit.

    ``mesh`` is taken as the other runners take it and unused: no leg
    runs on a mesh.  Writes ``substrate_obs_server.json`` (the
    reference's keys, and ``baseline``, ``device``, ``children`` and
    each leg's wall); returns pass/fail, which also requires every
    child to have run on ``device``."""
    kids = ServerChildren("obs_smoke_", device, _spec_args(
        n_hosts, m, iterations, n_stars, silence=True))
    obs_args = ["--obs", "--stats-interval", "10"]
    conc_args = ["--transport", "tcp", "--concurrent", str(n_clients)]
    report = {"n_hosts": n_hosts, "m": m, "iterations": iterations,
              "n_clients": n_clients, "silence_at": 150.0,
              "silence_frac": 0.25}
    ok = True
    try:
        # 1: the unobserved baseline (same silenced world as every leg)
        base = kids.run("base", [])
        report["baseline"] = _baseline(base)

        ckpt = kids.path("ckpt_obs")
        kill_args = [*obs_args, "--subscribe", "--ckpt-dir", ckpt,
                     "--snapshot-every", "150", "--throttle-s", "0.002"]
        sched_path = kids.path("schedule.json")

        def kill():
            entry, res = _kill_restore(kids, "obs", kill_args, ckpt, 150,
                                       base)
            if res is not None:
                entry = {k: v for k, v in entry.items()
                         if k != "resumed_leases"}
                entry["hub_snapshots"] = res["obs"]["snapshots"]
            return entry

        def defense():
            defended = kids.run("defended", [*obs_args, "--defense",
                                             "--defense-out", sched_path])
            return defended, kids.run("replayed", [
                *obs_args, "--defense-replay", sched_path])

        legs = kids.parallel({
            # 2: observed + live TCP subscriber + concurrent clients
            "live": lambda: kids.run("observed", [*conc_args, *obs_args,
                                                  "--subscribe"]),
            # 3: observed under an injected fault schedule
            "chaos": lambda: kids.run("observed_chaos", [
                *conc_args, *obs_args, "--chaos", "drop_dup"]),
            # 4: SIGKILL mid-stream, restore with obs re-attached
            "kill": kill,
            # 5: live defense records its schedule; a replay reproduces it
            "defense": defense})

        live = legs["live"]
        sub = live["subscriber"]
        live_ok = (trajectories_equal(base, live)
                   and live["obs"]["snapshots"] >= 2
                   and sub["snapshots"] >= 2 and sub["stamped_ok"]
                   and not sub["errors"])
        report["observed_live"] = {
            "trajectory_equal": trajectories_equal(base, live),
            "hub_snapshots": live["obs"]["snapshots"],
            "subscriber": sub, "ok": live_ok}

        cdoc = legs["chaos"]
        injected = _faults_injected(cdoc["chaos"])
        chaos_ok = trajectories_equal(base, cdoc) and injected > 0
        report["observed_chaos"] = {
            "trajectory_equal": trajectories_equal(base, cdoc),
            "faults_injected": injected, "ok": chaos_ok}

        report["kill_restore"] = legs["kill"]

        defended, replayed = legs["defense"]
        d = defended["defense"]
        shrunk = (defended["registry"]["reliable_set"]
                  < base["registry"]["reliable_set"])
        defense_ok = (d["quarantined_now"] > 0 and shrunk
                      and trajectories_equal(defended, replayed)
                      and replayed["defense"]["mode"] == "replay"
                      and replayed["defense"]["quarantined_now"]
                      == d["quarantined_now"])
        report["defense"] = {
            "events": d["events"], "by_action": d["by_action"],
            "quarantined_now": d["quarantined_now"],
            "reliable_set_defended": defended["registry"]["reliable_set"],
            "reliable_set_undefended": base["registry"]["reliable_set"],
            "reliable_set_shrunk": shrunk,
            "replay_trajectory_equal": trajectories_equal(defended,
                                                          replayed),
            "ok": defense_ok}
        ok = live_ok and chaos_ok and legs["kill"]["ok"] and defense_ok
    except Exception as e:  # noqa: BLE001 — smoke must report, not die
        report["error"] = str(e)
        ok = False
    finally:
        kids.close()
    ok, path = _finish("obs_server", out_dir, report, kids, ok)
    print(f"[{'ok' if ok else 'FAIL'}] substrate obs_server: "
          f"live={report.get('observed_live', {}).get('ok')} "
          f"chaos={report.get('observed_chaos', {}).get('ok')} "
          f"kill={report.get('kill_restore', {}).get('ok')} "
          f"defense={report.get('defense', {}).get('ok')} "
          f"-> {path}")
    return ok


def run_postmortem_smoke(out_dir: str, n_hosts: int = 48, m: int = 12,
                         iterations: int = 3, n_stars: int = 200,
                         n_clients: int = 8, *, device="cuda",
                         mesh=None) -> bool:
    """Post-mortem-plane smoke (``--substrate postmortem``, DESIGN.md
    §14).  Same silenced smoke world as the obs_server smoke, each server
    leg a child process on ``device``, 2-4 at once after 1:

      1. the UNOBSERVED serial loopback baseline;
      2. retention byte-compatibility: two checkpointed runs — retention
         plus full tracing ON vs OFF — must write byte-identical replay
         logs (the §14 recovery-compatibility argument) and both match
         the baseline trajectory;
      3. flight recorder under fire: chaotic concurrent TCP with
         retention + tracing, SIGKILLed mid-run.  The CLI
         (``repro_torch.launch.obs_postmortem``, a child that needs no
         card) must reconstruct the dead server's timeline from the
         surviving store (epoch 1: snapshots, spans, phase transitions,
         replay-log extent) WITHOUT writing an epoch marker; the restored
         run then appends under epoch 2 and its trajectory is
         bit-identical to the baseline;
      4. windowed stall defense: ``--stall-window`` kills the stalled
         search through the director seam, the verdict is recorded in
         the anomaly schedule, and a REPLAY run applies the recorded
         kill at the recorded seq — bit-identical to the defended run
         (which, having been truncated by the kill, differs from the
         undefended baseline).

    ``mesh`` is taken as the other runners take it and unused.  Writes
    ``substrate_postmortem.json`` (the reference's keys, and
    ``baseline``, ``device``, ``children`` and each leg's wall); returns
    pass/fail, which also requires every server child to have run on
    ``device``."""
    kids = ServerChildren("postmortem_smoke_", device, _spec_args(
        n_hosts, m, iterations, n_stars, silence=True))
    retain_args = ["--retain", "--trace-rate", "1.0",
                   "--stats-interval", "10"]
    conc_args = ["--transport", "tcp", "--concurrent", str(n_clients)]
    report = {"n_hosts": n_hosts, "m": m, "iterations": iterations,
              "n_clients": n_clients, "silence_at": 150.0,
              "silence_frac": 0.25}
    ok = True
    try:
        # 1: the unobserved baseline
        base = kids.run("base", [])
        report["baseline"] = _baseline(base)
        kill_after = max(150, int(0.4 * base["pool"]["messages"]))

        def retained(leg, extra):
            ck = kids.path(f"ck_{leg}")
            doc = kids.run(f"retain_{leg}", ["--ckpt-dir", ck,
                                             "--snapshot-every", "150",
                                             *extra])
            with open(os.path.join(ck, "replay.jsonl"), "rb") as f:
                return doc, f.read()

        ckpt = kids.path("ckpt_pm")
        kill_args = [*conc_args, "--chaos", "drop_dup", *retain_args,
                     "--ckpt-dir", ckpt, "--snapshot-every", "150",
                     "--throttle-s", "0.002"]

        def recorder():
            if not kids.kill_mid_run("kill_pm", kill_args, ckpt, 150,
                                     base["pool"]["messages"]):
                return {"killed_mid_run": False, "ok": False}
            # the CLI reconstructs the DEAD run's timeline, read-only
            dead = kids.run("pm_dead", ["--ckpt-dir", ckpt, "--json"],
                            module=POSTMORTEM_MODULE)
            dead_ok = (dead["store"]["epochs"] == [1]
                       and dead["store"]["records"] > 0
                       and dead["spans"] > 0
                       and len(dead["phases"]) > 0
                       and dead["replay_log"]["records"] >= kill_after)
            try:
                res = kids.run("resume_pm", [*kill_args, "--resume"])
            except RuntimeError:
                return {"killed_mid_run": True, "dead_report_ok": dead_ok,
                        "ok": False, "error": "resume failed"}
            post = kids.run("pm_post", ["--ckpt-dir", ckpt, "--json"],
                            module=POSTMORTEM_MODULE)
            # the read-only CLI added no epoch; the restored server
            # appended under epoch 2
            epochs_ok = post["store"]["epochs"] == [1, 2]
            return {
                "killed_mid_run": True,
                "dead_epochs": dead["store"]["epochs"],
                "dead_snapshots": dead["store"]["by_type"].get("snap"),
                "dead_spans": dead["spans"],
                "dead_phase_transitions": len(dead["phases"]),
                "replay_log_records": dead["replay_log"]["records"],
                "post_restore_epochs": post["store"]["epochs"],
                "replayed": res["replayed"],
                "recovered_done": res["recovered_done"],
                "trajectory_equal": trajectories_equal(base, res),
                "ok": (dead_ok and epochs_ok
                       and trajectories_equal(base, res)
                       and not res["recovered_done"])}

        sched_path = kids.path("stall_schedule.json")

        def stall():
            defended = kids.run("stalled", ["--stats-interval", "10",
                                            "--stall-window", "3",
                                            "--defense-out", sched_path])
            return defended, kids.run("stall_replayed", [
                "--stats-interval", "10", "--defense-replay", sched_path])

        legs = kids.parallel({
            # 2: replay logs byte-compatible with retention on/off
            "off": lambda: retained("off", []),
            "on": lambda: retained("on", retain_args),
            # 3: chaotic TCP + retention + tracing, SIGKILL, reconstruct,
            # restore under a new epoch
            "recorder": recorder,
            # 4: stall-window kill recorded live, replayed bit-identically
            "stall": stall})

        (off_doc, log_off), (on_doc, log_on) = legs["off"], legs["on"]
        bytes_ok = (log_off == log_on and len(log_off) > 0
                    and trajectories_equal(base, off_doc)
                    and trajectories_equal(base, on_doc)
                    and on_doc["retention"]["snapshots_stored"] > 0
                    and on_doc["retention"]["spans_stored"] > 0)
        report["replay_log_byte_compat"] = {
            "bytes": len(log_off), "identical": log_off == log_on,
            "retention": on_doc["retention"], "trace": on_doc["trace"],
            "ok": bytes_ok}

        report["flight_recorder"] = legs["recorder"]

        defended, replayed = legs["stall"]
        d = defended["defense"]
        stall_ok = (d["searches_killed"] == [0]
                    and d["by_action"].get("kill_search", 0) >= 1
                    and trajectories_equal(defended, replayed)
                    and replayed["defense"]["searches_killed"] == [0]
                    and replayed["defense"]["mode"] == "replay"
                    and defended["iteration"] < base["iteration"])
        report["stall_kill"] = {
            "searches_killed": d["searches_killed"],
            "by_action": d["by_action"],
            "defended_iteration": defended["iteration"],
            "baseline_iteration": base["iteration"],
            "replay_trajectory_equal": trajectories_equal(defended,
                                                          replayed),
            "ok": stall_ok}
        ok = bytes_ok and legs["recorder"]["ok"] and stall_ok
    except Exception as e:  # noqa: BLE001 — smoke must report, not die
        report["error"] = str(e)
        ok = False
    finally:
        kids.close()
    ok, path = _finish("postmortem", out_dir, report, kids, ok)
    print(f"[{'ok' if ok else 'FAIL'}] substrate postmortem: "
          f"bytes={report.get('replay_log_byte_compat', {}).get('ok')} "
          f"recorder={report.get('flight_recorder', {}).get('ok')} "
          f"stall={report.get('stall_kill', {}).get('ok')} "
          f"-> {path}")
    return ok


def _variant(cfg: ModelConfig, args) -> ModelConfig:
    """``cfg`` with the perf-variant flags' fields replaced."""
    moe = cfg.moe
    if moe is not None and args.moe_dispatch:
        moe = dataclasses.replace(moe, dispatch=args.moe_dispatch)
    if moe is not None and args.moe_cf:
        moe = dataclasses.replace(moe, capacity_factor=args.moe_cf)
    fields = {"moe": moe}
    if args.remat_policy:
        fields["remat_policy"] = args.remat_policy
    if args.pin_proj:
        fields["pin_proj_outputs"] = True
    if args.quant_cache:
        fields["quantized_cache"] = True
    return dataclasses.replace(cfg, **fields)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--mesh", default="both",
                    choices=["pod", "multipod", "both"])
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--skip-existing", action="store_true")
    ap.add_argument("--mla-absorb", action="store_true",
                    help="use the absorbed MLA decode path (perf variant)")
    ap.add_argument("--moe-dispatch", default=None,
                    choices=["global", "grouped"],
                    help="override MoE dispatch strategy (perf variant)")
    ap.add_argument("--remat-policy", default=None, choices=["full", "dots"],
                    help="override remat policy (perf variant)")
    ap.add_argument("--pin-proj", action="store_true",
                    help="bf16 TP all-reduces (perf variant)")
    ap.add_argument("--moe-cf", type=float, default=None,
                    help="override MoE capacity factor (perf variant)")
    ap.add_argument("--donate", action="store_true",
                    help="donate params/opt (train) or cache (decode)")
    ap.add_argument("--fsdp", action="store_true",
                    help="FSDP/ZeRO-3 param+optimizer storage sharding")
    ap.add_argument("--quant-cache", action="store_true",
                    help="int8 KV/latent cache (perf variant)")
    ap.add_argument("--suffix", default="", help="artifact filename suffix")
    # choices come from the ONE substrate registry (launch/substrates.py):
    # an unknown substrate fails at parse time instead of falling through
    # to the model-cell path
    ap.add_argument("--substrate", default=None,
                    choices=sorted(SUBSTRATES),
                    help="run the substrate smoke instead of model cells")
    ap.add_argument("--list-substrates", action="store_true",
                    help="print the registered substrate smokes and exit")
    ap.add_argument("--device", default="cuda",
                    help="where a substrate smoke runs (the model cells "
                         "are reckoned on meta)")
    ap.add_argument("--ranks", type=int, default=0,
                    help="with --substrate pod_mesh or lm_subspace: also run "
                         "the pod leg over N ranks of a torch.distributed "
                         "group, one child process a rank "
                         "(launch/ranks.py)")
    ap.add_argument("--model-ranks", type=int, default=1,
                    help="with --ranks N: cut the mesh's model axis over "
                         "groups of M of the N ranks as well (the (N/M, M) "
                         "grid of Mesh.over_ranks)")
    ap.add_argument("--dist-backend", default="gloo",
                    choices=["gloo", "nccl"],
                    help="the ranks' backend: gloo (CPU or CUDA, ranks may "
                         "share a card) or nccl (a distinct card a rank)")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)

    if args.list_substrates:
        print(list_substrates())
        return 0

    out_dir = args.out or os.path.abspath(ARTIFACTS)
    os.makedirs(out_dir, exist_ok=True)
    if args.substrate is not None:
        runner = SUBSTRATES[args.substrate].resolve()
        kw = {}
        if args.model_ranks != 1 and not args.ranks:
            ap.error("--model-ranks runs with --ranks")
        if args.ranks:
            if args.substrate not in RANKS_SUBSTRATES:
                ap.error(f"--ranks runs with --substrate "
                         f"{' or '.join(RANKS_SUBSTRATES)}")
            try:
                rank_grid(args.ranks, args.model_ranks, _pod_mesh("meta"))
            except ValueError as e:
                ap.error(f"--ranks {args.ranks} --model-ranks "
                         f"{args.model_ranks}: {e}")
            kw = dict(ranks=args.ranks, dist_backend=args.dist_backend,
                      model_ranks=args.model_ranks)
        try:
            return 0 if runner(out_dir, device=args.device, **kw) else 1
        finally:
            if args.ranks:
                child.stop()
    meshes = {"pod": [False], "multipod": [True],
              "both": [False, True]}[args.mesh]
    archs = ARCH_NAMES if (args.all or args.arch is None) else [args.arch]
    shapes = (list(SHAPES) if (args.all or args.shape is None)
              else [args.shape])
    variant = (args.moe_dispatch or args.remat_policy or args.pin_proj
               or args.moe_cf or args.quant_cache)

    failures = 0
    for arch in archs:
        for shape_name in shapes:
            for mp in meshes:
                cfg_override = (_variant(get_config(arch), args) if variant
                                else None)
                ok = run_cell(arch, shape_name, mp, out_dir,
                              skip_existing=args.skip_existing,
                              mla_absorb=args.mla_absorb, suffix=args.suffix,
                              cfg_override=cfg_override, donate=args.donate,
                              fsdp=args.fsdp)
                failures += 0 if ok else 1
    print(f"done; failures={failures}")
    return 1 if failures else 0


if __name__ == "__main__":
    raise SystemExit(main())
