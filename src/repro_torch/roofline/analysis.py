"""Roofline terms of one step on the H100, from the dry-run's counts.

Port of ``repro/roofline/analysis.py``.  Three terms per (arch × shape ×
mesh) cell, all in seconds, from PER-DEVICE quantities (the reference's
relation: a device runs 1/n_chips of the program):

    compute    = flops_per_device            / PEAK_FLOPS
    memory     = bytes_accessed_per_device   / HBM_BW
    collective = Σ_link collective_bytes_link / link rate

The constants are an H100 SXM5's published dense peaks, and this module is
their one home in the port (``chip_smoke.py`` imports them).  The
collective rates model a cluster of DGX H100 nodes: 8 GPUs a node joined
by NVLink, one 400 Gb/s NIC a GPU between nodes.  Devices are laid 8 to a
node in mesh order (row-major over the mesh's axes), and each collective
is charged at the slowest link its axis crosses (``axis_link``).  On the
(16, 16) pod mesh a ``model`` group is 16 consecutive devices, two nodes,
so every collective of the production meshes crosses the network; a mesh
of at most 8 devices stays on NVLink.

The reference parses its collectives from XLA's partitioned HLO.  The port
has no HLO: ``collective_bytes_from_specs`` reckons them from the sharding
specs, per device and per step, by rules stated there.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Mapping, Optional, Tuple

from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.models import transformer as T
from repro_torch.models.layers import moe_capacity
from repro_torch.models.sharding import (mesh_axes, partial_leaves,
                                         spec_leaves, vocab_cuts)

#: NVIDIA H100 Tensor Core GPU data sheet, H100 SXM column: BF16 Tensor
#: Core 1,979 TFLOP/s "with sparsity", so 989 TFLOP/s dense
PEAK_FLOPS = 989e12
#: the same data sheet: FP32 67 TFLOP/s (outside the tensor cores)
F32_FLOPS = 67e12
#: the same data sheet: GPU memory bandwidth 3.35 TB/s (80 GB HBM3)
HBM_BW = 3.35e12
#: the same data sheet: NVLink 900 GB/s a GPU, both directions together,
#: so 450 GB/s each way, inside a DGX H100 node (DGX H100 data sheet:
#: 8 GPUs, 4 NVSwitches)
NVLINK_BW = 450e9
#: DGX H100 data sheet: 8 × ConnectX-7 at 400 Gb/s, one a GPU: 50 GB/s
NETWORK_BW = 50e9
#: GPUs a node (DGX H100)
DEVICES_PER_NODE = 8


@dataclasses.dataclass(frozen=True)
class Peaks:
    """One device's peak rates: FLOP/s of the products' type, HBM bytes/s
    and bytes/s each way of each kind of link, by name."""
    flops: float
    hbm_bw: float
    link_bw: Mapping[str, float]


H100 = Peaks(PEAK_FLOPS, HBM_BW, {"nvlink": NVLINK_BW,
                                  "network": NETWORK_BW})

_COLLECTIVES = ("all-reduce", "all-gather", "reduce-scatter", "all-to-all",
                "collective-permute")


#: the kinds of the data axes' own entries: the data-parallel gradient
#: all-reduce, ``fsdp``'s gathers and reduce-scatters, and the loss's sums
#: over the batch (``sharding.RankSum``'s ``gradient_bytes``,
#: ``RankShards``' ``gather_bytes`` / ``scatter_bytes``,
#: ``RankSum.loss_bytes``); beside them, ``sharding.MODEL_KINDS``
DATA_KINDS = ("data gradient", "fsdp gather", "fsdp scatter", "loss")


@dataclasses.dataclass
class CollectiveStats:
    bytes_by_kind: Dict[str, int]
    count_by_kind: Dict[str, int]
    top_ops: List[Tuple[str, int]]
    #: the same bytes by the link they cross ("nvlink" / "network")
    bytes_by_link: Dict[str, int] = dataclasses.field(default_factory=dict)
    #: every entry's bytes by its name (``top_ops`` is the largest few)
    ops: Dict[str, int] = dataclasses.field(default_factory=dict)
    #: every entry's number of collectives by its name
    op_counts: Dict[str, int] = dataclasses.field(default_factory=dict)
    #: every entry's kind by its name (``DATA_KINDS``,
    #: ``sharding.MODEL_KINDS``): what a step over ranks counts it under
    kinds: Dict[str, str] = dataclasses.field(default_factory=dict)

    @property
    def total_bytes(self) -> int:
        return sum(self.bytes_by_kind.values())

    def kind_bytes(self, kind: str) -> int:
        """The bytes of the entries of ``kind``."""
        return sum(self.ops[name] for name, k in self.kinds.items()
                   if k == kind)

    def kind_calls(self, kind: str) -> int:
        """The number of collectives of the entries of ``kind``."""
        return sum(self.op_counts[name] for name, k in self.kinds.items()
                   if k == kind)

    @property
    def fsdp_all_gather_bytes(self) -> int:
        """The bytes of the parameters' all-gathers over ``data``, the
        entries ``all-gather over data ...: <path> (fsdp)``, which a step
        over ranks with its parameters cut measures
        (``sharding.RankShards.gather_bytes``)."""
        return self.kind_bytes("fsdp gather")

    @property
    def fsdp_reduce_scatter_bytes(self) -> int:
        """The bytes of the cut gradients' reduce-scatters, the entries
        ``reduce-scatter over data ...: <path> gradient (fsdp)``
        (``sharding.RankShards.scatter_bytes``)."""
        return self.kind_bytes("fsdp scatter")

    @property
    def model_all_reduce_bytes(self) -> int:
        """The bytes of the cut units' all-reduces over ``model``, the
        entries ``all-reduce over model ...: <unit>/<output projection>``
        (2 × the bytes a device hands to them, the ring's count), which a
        step over the model axis's ranks measures
        (``sharding.ModelShards.model_bytes["block"]``)."""
        return self.kind_bytes("block")

    @property
    def model_all_reduces(self) -> int:
        """The number of those all-reduces."""
        return self.kind_calls("block")

    @property
    def norm_all_reduce_bytes(self) -> int:
        """The bytes of Mamba2's norm statistics' all-reduces over
        ``model``, the entries ``all-reduce over model ...:
        <unit>/mamba/norm`` (2 × the device's tokens × 4 B a pass), which a
        step over the model axis's ranks measures
        (``sharding.ModelShards.model_bytes["norm"]``)."""
        return self.kind_bytes("norm")

    @property
    def norm_all_reduces(self) -> int:
        """The number of those all-reduces."""
        return self.kind_calls("norm")

    @property
    def moe_all_to_all_bytes(self) -> int:
        """The bytes of the MoE's all-to-alls, the entries ``all-to-all
        over ...: <unit>/moe dispatch`` and ``... combine`` (a device's
        share of the dispatch buffer each), which a step over the model
        axis's ranks hands its exchanges
        (``sharding.ModelShards.model_bytes["exchange"]``)."""
        return self.kind_bytes("exchange")

    @property
    def moe_all_to_alls(self) -> int:
        """The number of those all-to-alls."""
        return self.kind_calls("exchange")

    @property
    def gradient_all_reduce_bytes(self) -> int:
        """The bytes of the data-parallel gradient all-reduces, the
        entries ``all-reduce over <the data axes> ...: <path> gradient``
        (2 × the bytes a device hands to them, the ring's count), which a
        step over ranks measures (``sharding.RankSum.gradient_bytes``)."""
        return self.kind_bytes("data gradient")


def roofline_terms(flops_per_device: float, bytes_per_device: float,
                   collective_bytes_by_link: Mapping[str, float],
                   n_chips: int, peaks: Optional[Peaks] = None
                   ) -> Dict[str, float]:
    """The reference's three terms over ``peaks`` (default the H100's),
    the collective bytes charged link by link (``CollectiveStats.
    bytes_by_link``).  Inputs are per device; n_chips is recorded only."""
    peaks = peaks or H100
    collective = sum(b / peaks.link_bw[link]
                     for link, b in collective_bytes_by_link.items())
    compute = flops_per_device / peaks.flops
    memory = bytes_per_device / peaks.hbm_bw
    terms = {"compute_s": compute, "memory_s": memory,
             "collective_s": collective}
    dom = max(terms, key=terms.get)
    terms["dominant"] = dom
    bound = max(compute, memory, collective)
    terms["step_time_lower_bound_s"] = bound
    terms["roofline_fraction"] = compute / bound if bound > 0 else 0.0
    return terms


def model_flops(cfg, shape, kind: str) -> float:
    """MODEL_FLOPS = 6·N·D for training, 2·N·D for inference forward
    (N = active params, D = tokens processed)."""
    n_active = cfg.n_active_params()
    if kind == "train":
        tokens = shape.global_batch * shape.seq_len
        return 6.0 * n_active * tokens
    if kind == "prefill":
        tokens = shape.global_batch * shape.seq_len
        return 2.0 * n_active * tokens
    # decode: one token per sequence
    return 2.0 * n_active * shape.global_batch


# ---------------------------------------------------------------------------
# Collectives from the sharding specs
# ---------------------------------------------------------------------------

def _axes(entry) -> Tuple[str, ...]:
    if entry is None:
        return ()
    return entry if isinstance(entry, tuple) else (entry,)


def axis_link(mesh, axes) -> str:
    """"nvlink" if one group of devices along ``axes`` (the others fixed)
    lies in one node of ``DEVICES_PER_NODE`` devices laid in mesh order,
    else "network".  The mesh is regular, so the group through the origin
    stands for every group."""
    names = list(mesh.axis_names)
    sizes = [mesh.shape[a] for a in names]
    strides = [math.prod(sizes[i + 1:]) for i in range(len(sizes))]
    members = [0]
    for a in axes:
        i = names.index(a)
        members = [m + j * strides[i] for m in members
                   for j in range(sizes[i])]
    return "nvlink" if len({m // DEVICES_PER_NODE for m in members}) == 1 \
        else "network"


def _size(mesh, axes) -> int:
    return math.prod(mesh.shape[a] for a in axes)


def local_numel(shape, spec, mesh) -> int:
    """Elements of one device's piece of a ``shape`` laid out by ``spec``."""
    n = math.prod(shape)
    for e in spec:
        n //= _size(mesh, _axes(e))
    return n


def _base(spec, stacked: bool) -> tuple:
    return tuple(spec)[1:] if stacked else tuple(spec)


class _Tally:
    def __init__(self, mesh):
        self.mesh = mesh
        self.bytes = {k: 0 for k in _COLLECTIVES}
        self.count = {k: 0 for k in _COLLECTIVES}
        self.links: Dict[str, int] = {}
        self.ops: Dict[str, int] = {}
        self.op_counts: Dict[str, int] = {}
        self.kinds: Dict[str, str] = {}

    def add(self, op: str, axes, nbytes: int, what: str, n: int = 1, *,
            kind: str):
        """``n`` collectives ``op`` over ``axes``, each of result
        ``nbytes`` (an all-reduce counted twice, ring RS + AG), an entry
        of ``kind`` (``CollectiveStats.kinds``)."""
        axes = tuple(a for a in axes if self.mesh.shape[a] > 1)
        if not axes or n == 0 or nbytes == 0:
            return
        b = n * nbytes * (2 if op == "all-reduce" else 1)
        self.bytes[op] += b
        self.count[op] += n
        link = axis_link(self.mesh, axes)
        self.links[link] = self.links.get(link, 0) + b
        key = f"{op} over {'x'.join(axes)} ({link}): {what}"
        self.kinds[key] = kind
        self.ops[key] = self.ops.get(key, 0) + b
        self.op_counts[key] = self.op_counts.get(key, 0) + n

    def stats(self, top_k: int) -> CollectiveStats:
        top = sorted(self.ops.items(), key=lambda t: -t[1])[:top_k]
        return CollectiveStats(self.bytes, self.count, top, self.links,
                               dict(self.ops), dict(self.op_counts),
                               dict(self.kinds))


def collective_bytes_from_specs(cfg: ModelConfig, shape: ShapeConfig, mesh,
                                specs, top_k: int = 8) -> CollectiveStats:
    """The collectives of one step of ``cfg`` at ``shape`` with parameters
    laid out by ``specs`` (``sharding.param_specs``, after
    ``enforce_divisible``) over ``mesh``: result bytes per device, an
    all-reduce counted twice (ring), as the reference counts them.

    Terms: a device's tokens are the global batch's rows over the
    data-parallel axes where they divide it (else every row) times the
    sequence (1 for decode).  A pass is one forward; a ``train`` step makes
    a forward, a backward and, with ``remat``, the forward again inside
    the backward, so its activation collectives run 3 times (2 without
    remat), and those of the forward alone 2 times (1 without remat).
    Each entry has a kind (``CollectiveStats.kinds``), the counter a step
    over ranks hands that collective to; a rank hands half an
    all-reduce's bytes (the ring), 1/M of an all-gather's result over M
    devices and all of an all-to-all's.  The rules:

    * tensor parallel ("block"): each unit whose output projection
      (attention ``wo``, RWKV6's ``w_o`` and ``w_v_cm``, Mamba2's
      ``out_proj``, a dense or shared-expert MLP's ``w_out``) has a
      contracted dimension cut over ``model`` ends in an all-reduce over
      ``model`` of its output, the device's tokens × d_model, in f32;
      under ``pin_proj_outputs`` an attention block's two in its
      parameters' type (the reference pins those outputs before the
      reduction).  Once a pass.  Without a pin the reduction moves the
      f32 that the next norm consumes, as the reference's comment on the
      pin says;
    * Mamba2's RMS norm over its inner channels ("norm"), where they are
      cut over ``model`` (``out_proj``'s rows, ``mamba/norm`` with them at
      every expand but 1): the mean of squares is the whole d_in's, so
      GSPMD all-reduces each token's f32 sum of squares over ``model``
      (the device's tokens × 4 B) in the forward and its gradient in the
      backward, once a pass as ``tp_reduce`` counts;
    * the vocabulary cut over ``model`` ("vocab", ``sharding.vocab_cuts``):
      where the table is cut, the lookup's all-reduce of the device's
      tokens × d_model in the table's type, once a step of every kind;
      where the head is cut, in ``train``, the all-reduce of the head
      input's gradient (tokens × d_model, f32) in the backward and, for
      each sequence chunk of ``transformer.LOSS_CHUNK``, its logits' max
      (rows × chunk × 4 B) and its sum of exponentials and gold logit
      (2 × that) over ``model``, in the forward and, under
      ``LOSS_CHUNK_RECOMPUTE``, again in the chunk's recompute;
    * the whole leaves read inside a cut unit ("gradient",
      ``sharding.partial_leaves``: q/k norms, k/v where the kv heads do
      not divide ``model``, MLA's ``w_dkv`` / ``w_krope`` / ``kv_norm``,
      the MoE router, RWKV6's ``mu_*`` and ``w_lora_a``, Mamba2's
      ``w_bc``, ``w_dt``, ``conv_*_bc``, ``a_log``, ``dt_bias``, ``dd``):
      in ``train`` each device's share of the leaf's gradient is
      all-reduced over ``model``, the leaf's piece in its type, once;
    * data parallel ("data gradient", ``train``): each device
      all-reduces its gradient, the local piece of every parameter in the
      parameter's type, over the data-parallel axes;
    * the loss's sums over the batch ("loss", ``train``): the weighted
      cross-entropy's and the weights' sums (2 × f32) all-reduced over
      the data-parallel axes once a step;
    * ``fsdp`` (a parameter cut over ``data``; "fsdp gather", "fsdp
      scatter"): the parameter is all-gathered over ``data`` (result: its
      piece times |data|) once a pass of inference and twice in training
      (forward and backward; the recompute reuses the backward's), but
      once for an embedding table that only the lookup reads (untied),
      whose backward needs no values; its gradient is reduce-scattered
      over ``data`` (result: the piece) and all-reduced over ``pod``
      where the mesh has one ("data gradient"), in place of the
      data-parallel all-reduce;
    * MoE ("exchange"): where the experts' leading axis is cut over an
      axis, each pass moves a device's share of the dispatch buffer,
      (experts × groups × capacity × d_model) in the activations' type
      over the data-parallel and the experts' axes, by one all-to-all to
      dispatch and one to combine;
    * the MoE's load-balance statistics (2 × experts f32 a layer, the
      whole batch's means), in ``train``, all-reduced in each forward (the
      recompute's too) over the data-parallel axes and, where the
      experts are cut over ``model``, over it too ("stats": each device
      routes its block of the rows); else a "loss" sum.  A serving step
      does not output its load-balance loss, so XLA drops the sum;
    * the port's MoE gathers ("gather", entries ``<unit>/moe gather
      (port)``): where the experts are cut over ``model`` under the
      grouped dispatch, a step over ranks splits a data rank's rows among
      its model group (``sharding.ModelShards.own_groups``), so the
      groups' outputs are all-gathered over ``model`` (result: the
      device's tokens × d_model in the activations' type) in each pass,
      and their input's gradient in the backward.  The reference's
      exchange has every device hold its own rows and has no such
      gather.

    Not counted: the LM head's output collectives in ``prefill`` /
    ``decode`` cells where the vocabulary is cut (no step of the port
    over model ranks runs them: serving over model ranks is ROADMAP A.8
    (viii)), and what XLA's partitioner would add beyond the rules
    (resharding copies).
    """
    dp, tp = mesh_axes(mesh)
    dp_size = _size(mesh, dp)
    b = shape.global_batch
    rows = b // dp_size if (b > 1 and b % dp_size == 0) else b
    seq = 1 if shape.kind == "decode" else shape.seq_len
    tokens = rows * seq
    train = shape.kind == "train"
    passes = (3 if cfg.remat else 2) if train else 1
    forwards = (2 if cfg.remat else 1) if train else 1
    pbytes = T.param_dtype(cfg).itemsize
    tally = _Tally(mesh)
    d = cfg.d_model
    leaves = dict(spec_leaves(T.param_specs(cfg)))

    def itemsize(path: str) -> int:
        dtype = leaves[path].dtype
        return dtype.itemsize if dtype is not None else pbytes

    def tp_reduce(spec, what: str, pinned: bool):
        """An all-reduce of the unit's output where ``spec`` (the output
        projection's, last dimension the output) cuts a contracted
        dimension over ``model``."""
        if any(tp in _axes(e) for e in spec[:-1]):
            nbytes = tokens * d * (pbytes if pinned else 4)
            tally.add("all-reduce", (tp,), nbytes, what, passes, kind="block")

    def moe(w_out_spec, what: str):
        """The MoE layer's statistics, its port's gathers and, where
        ``w_out_spec`` (the experts' (E, ff, d) output weights) cuts the
        experts over an axis, its dispatch and combine."""
        m = cfg.moe
        experts = _axes(w_out_spec[0])
        cut = tp in experts and mesh.shape[tp] > 1
        if train:
            tally.add("all-reduce", dp + ((tp,) if cut else ()),
                      2 * m.n_experts * 4, what + " statistics", forwards,
                      kind="stats" if cut else "loss")
        if cut and m.dispatch == "grouped":
            tally.add("all-gather", (tp,), tokens * d * pbytes,
                      what + " gather (port)", passes, kind="gather")
        if not experts:
            return
        if m.dispatch == "grouped":
            groups, cap = b, moe_capacity(m, seq)
        else:
            groups, cap = 1, moe_capacity(m, b * seq)
        share = dp_size if (b > 1 and b % dp_size == 0) else 1
        nbytes = (m.n_experts * groups * cap * d * pbytes
                  // (share * _size(mesh, experts)))
        for step in ("dispatch", "combine"):
            tally.add("all-to-all", experts, nbytes, f"{what} {step}",
                      passes, kind="exchange")

    table_cut, head_cut = vocab_cuts(cfg, specs)
    if table_cut:
        tally.add("all-reduce", (tp,), tokens * d * itemsize("embed/tok"),
                  "embed/tok lookup", kind="vocab")
    if head_cut and train:
        head = "embed/tok" if cfg.tie_embeddings else "head/w"
        tally.add("all-reduce", (tp,), tokens * d * 4,
                  f"{head} input's gradient (f)", kind="vocab")
        chunk = min(T.LOSS_CHUNK, seq)
        again = 2 if T.LOSS_CHUNK_RECOMPUTE else 1
        for c0 in range(0, seq, chunk):
            c = min(chunk, seq - c0)
            tally.add("all-reduce", (tp,), rows * c * 4,
                      f"{head} loss chunks' max", again, kind="vocab")
            tally.add("all-reduce", (tp,), 2 * rows * c * 4,
                      f"{head} loss chunks' sums", again, kind="vocab")
    if train:
        tally.add("all-reduce", dp, 2 * 4, "loss sums", kind="loss")

    segs = T.find_segments(T.layer_sigs(cfg))
    for si, (unit, repeat) in enumerate(segs):
        stacked = repeat > 1
        for ui, (kind, is_moe) in enumerate(unit):
            where = f"segments/{si}/{ui}"
            if kind == "shared_attn":
                bs, st, where = specs["shared_attn"], False, "shared_attn"
            else:
                bs, st = specs["segments"][si][ui], stacked

            def spec(*path):
                node = bs
                for key in path:
                    node = node[key]
                return _base(node, st)

            for _ in range(repeat):
                if kind in ("attn", "shared_attn"):
                    pin = cfg.pin_proj_outputs
                    tp_reduce(spec("attn", "wo"), f"{where}/attn/wo", pin)
                    if is_moe and kind == "attn":
                        moe(spec("moe", "w_out"), f"{where}/moe")
                        if "shared" in bs["moe"]:
                            tp_reduce(spec("moe", "shared", "w_out"),
                                      f"{where}/moe/shared/w_out", pin)
                    else:
                        tp_reduce(spec("mlp", "w_out"),
                                  f"{where}/mlp/w_out", pin)
                elif kind == "rwkv6":
                    tp_reduce(spec("rwkv", "w_o"), f"{where}/rwkv/w_o",
                              False)
                    tp_reduce(spec("rwkv", "w_v_cm"),
                              f"{where}/rwkv/w_v_cm", False)
                elif kind == "mamba2":
                    tp_reduce(spec("mamba", "out_proj"),
                              f"{where}/mamba/out_proj", False)
                    if tp in _axes(spec("mamba", "out_proj")[0]):
                        tally.add("all-reduce", (tp,), tokens * 4,
                                  f"{where}/mamba/norm", passes, kind="norm")

    # parameters: fsdp gathers, gradient reductions
    partial = partial_leaves(specs) if train else set()
    for path, pspec in spec_leaves(specs):
        local = local_numel(leaves[path].shape, pspec, mesh) * itemsize(path)
        cut_data = any("data" in _axes(e) for e in pspec)
        if cut_data:
            lookup_only = path == "embed/tok" and not cfg.tie_embeddings
            tally.add("all-gather", ("data",), local * mesh.shape["data"],
                      f"{path} (fsdp)", 1 if lookup_only or not train else 2,
                      kind="fsdp gather")
        if not train:
            continue
        if path in partial:
            tally.add("all-reduce", (tp,), local, f"{path} gradient",
                      kind="gradient")
        if cut_data:
            tally.add("reduce-scatter", ("data",), local,
                      f"{path} gradient (fsdp)", kind="fsdp scatter")
            tally.add("all-reduce", tuple(a for a in dp if a != "data"),
                      local, f"{path} gradient", kind="data gradient")
        else:
            tally.add("all-reduce", dp, local, f"{path} gradient",
                      kind="data gradient")
    return tally.stats(top_k)
