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
* the traced peaks ÷ the data-parallel shards the batch is cut into,
  storages followed from the op that makes them to their release, each
  storage once: ``temp_size_bytes``, the peak of the storages that are
  neither argument nor output (XLA's meaning), and ``peak_size_bytes``
  (the port's own key), the arguments plus the peak of everything live
  beside them, outputs included: the eager step's peak, what a card's
  ``max_memory_allocated`` reads on a one-device mesh.  The division is
  a reckoning, not a bound, and nothing checks it on a mesh of more than
  one device: an activation cut over ``model`` as well is counted whole
  over ``model`` (too high), and a gradient of a leaf cut over fewer
  axes than the batch's (a replicated norm's; any leaf's on
  ``2x16x16``, where the batch is cut 32 ways and ``model`` 16) is
  divided more than its layout divides it (too low);
* ``collective_bytes``: ``roofline.analysis.collective_bytes_from_specs``,
  a model of the collectives from the specs (no machine here has more
  than one card), charged at the link each crosses.

The two keys named after XLA's analyses (``hlo_flops``,
``hlo_bytes_accessed``) keep their names, so readers of the reference's
reports (``benchmarks/roofline.py::load_reports``) read these; the report's
``counted_by`` says how each number was counted.

Usage:
    python -m repro_torch.launch.dryrun --arch qwen2-72b --shape train_4k
    python -m repro_torch.launch.dryrun --all [--mesh pod|multipod|both]

Reports go to ``artifacts/dryrun_torch/<arch>__<shape>__<mesh>.json``.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import math
import os
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
from repro_torch.launch.mesh import make_production_mesh, virtual_devices
from repro_torch.models import sharding as S
from repro_torch.models import transformer as T
from repro_torch.optim.adamw import AdamW, opt_state_specs
from repro_torch.roofline.analysis import (H100, collective_bytes_from_specs,
                                           local_numel, model_flops,
                                           roofline_terms)

ARTIFACTS = os.path.join(os.path.dirname(__file__), "..", "..", "..",
                         "artifacts", "dryrun_torch")

#: where the substrate smokes wait for their port
SUBSTRATE_ITEM = ("ROADMAP A.7's substrate registry (launch/substrates.py "
                  "and its eight runners)")

META = torch.device("meta")

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
                       "live in the meta trace, / the batch's data-parallel "
                       "shards",
    "peak_size_bytes": "argument_size_bytes + the peak of the storages "
                       "live beside the arguments in the meta trace (temps "
                       "and the outputs that alias no argument), / the "
                       "batch's data-parallel shards: the eager step's "
                       "peak, what a card's max_memory_allocated reads",
    "collective_bytes": "roofline.analysis.collective_bytes_from_specs "
                        "(a model from the specs, not a measurement)",
    "compile_s": "wall of the meta trace",
    "lower_s": "wall of building the stand-ins and specs",
}


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
    storages the step's outputs hold."""

    def __init__(self):
        super().__init__()
        self.bytes_accessed = 0
        self.live = 0
        self.ops = 0
        #: storage → its serial (None for an argument's)
        self._known: Dict[int, Optional[int]] = {}
        self._refs: Dict[int, Any] = {}
        #: bytes, by serial
        self._sizes = array("q")
        #: in order: serial + 1 where made, -(serial + 1) where freed
        self._events = array("q")

    def exclude(self, tree) -> None:
        for t in _tensors(tree):
            self._known[t.untyped_storage()._cdata] = None

    def serials(self, tree) -> frozenset:
        """The serials of the storages that ``tree``'s tensors hold (none
        for an argument's)."""
        found = (self._known.get(t.untyped_storage()._cdata)
                 for t in _tensors(tree))
        return frozenset(s for s in found if s is not None)

    def peak(self, without: frozenset = frozenset()) -> int:
        """The most bytes live at once, the storages of serials
        ``without`` left out."""
        live = peak = 0
        for e in self._events:
            s = abs(e) - 1
            if s not in without:
                live += self._sizes[s] if e > 0 else -self._sizes[s]
                peak = max(peak, live)
        return peak

    def _release(self, key: int) -> None:
        s = self._known.pop(key)
        self._refs.pop(key, None)
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
        if not (_is_view(func) or func._opname in _ALLOCATE_ONLY):
            ins = _tensors((args, kwargs))
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
            self._events.append(s + 1)
            self._refs[key] = weakref.ref(
                st, lambda _, key=key: self._release(key))
            self.live += st.nbytes()
        return out


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
    its outputs, and ``donated``: the outputs that alias an argument under
    ``donate``."""
    step: Callable
    args: tuple
    arg_specs: tuple
    out_specs: tuple
    donated: Tuple[int, ...]


def build_cell(cfg: ModelConfig, shape: ShapeConfig, mesh, *,
               optimizer: Optional[AdamW] = None, mla_absorb: bool = False,
               fsdp: bool = False) -> Cell:
    """The step of ``shape.kind`` for ``cfg`` and its meta stand-ins over
    ``mesh``: ``make_train_step`` with AdamW (``optimizer``, default
    ``AdamW(lr=1e-4)`` as the reference's), ``make_prefill_step``, or
    ``make_serve_step(absorb=mla_absorb)`` over a cache of
    ``shape.seq_len`` positions."""
    cfg = dataclasses.replace(cfg, use_kernels=False)
    dp, tp = S.mesh_axes(mesh)
    ctx = T.ShardCtx(mesh=mesh, dp=dp, tp=tp)
    pspecs, _ = S.enforce_divisible(cfg, mesh,
                                    S.param_specs(cfg, mesh, fsdp=fsdp))
    params = meta_params(cfg)
    batch_shapes, bspecs = S.input_specs(cfg, shape, mesh)
    batch = _shape_tree(batch_shapes)
    if shape.kind == "train":
        opt = optimizer or AdamW(lr=1e-4)
        state = opt.init(params)
        ospecs = opt_state_specs(pspecs)
        step = T.make_train_step(cfg, opt, ctx, unroll=True)
        metrics = {k: S.P() for k in ("aux", "ce", "loss")}
        return Cell(step, (params, state, batch), (pspecs, ospecs, bspecs),
                    (pspecs, ospecs, metrics), donated=(0, 1))
    logits = _logit_spec(cfg, shape, mesh, pspecs)
    if shape.kind == "prefill":
        step = T.make_prefill_step(cfg, ctx, unroll=True)
        return Cell(step, (params, batch), (pspecs, bspecs), (logits,),
                    donated=())
    cache = _shape_tree(T.init_cache(cfg, shape.global_batch, shape.seq_len,
                                     as_shape=True))
    cspecs = S.cache_specs(cfg, shape, mesh)
    step = T.make_serve_step(cfg, ctx, absorb=mla_absorb, unroll=True)
    return Cell(step, (params, cache, batch["tokens"], batch["t"]),
                (pspecs, cspecs, bspecs["tokens"], bspecs["t"]),
                (logits, cspecs), donated=(1,))


def trace_step(cell: Cell) -> dict:
    """Run ``cell``'s step once on meta under ``FlopCounterMode`` and a
    ``TraceCounter``: its global FLOPs, bytes accessed, the peak of the
    bytes live beside the arguments (``peak_live``) and of those neither
    argument nor output (``peak_temp``), ops, its outputs and the wall."""
    counter = TraceCounter()
    counter.exclude(cell.args)
    flops = FlopCounterMode(display=False)
    t0 = time.perf_counter()
    with flops, counter:
        out = cell.step(*cell.args)
    return {"flops": flops.get_total_flops(),
            "bytes_accessed": counter.bytes_accessed,
            "peak_live": counter.peak(),
            "peak_temp": counter.peak(without=counter.serials(out)),
            "ops": counter.ops, "out": out,
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
    run = trace_step(cell)
    out = run["out"]
    outs = out if isinstance(out, tuple) else (out,)
    out_bytes = sum(local_bytes(o, s, mesh)
                    for i, (o, s) in enumerate(zip(outs, cell.out_specs))
                    if not (donate and i in cell.donated))
    arg_bytes = sum(local_bytes(a, s, mesh)
                    for a, s in zip(cell.args, cell.arg_specs))
    shards = _batch_shards(shape, mesh)
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
            "temp_size_bytes": run["peak_temp"] // shards,
            "generated_code_size_bytes": None,
            "peak_size_bytes": arg_bytes + run["peak_live"] // shards,
        },
        "hlo_flops": flops,
        "hlo_bytes_accessed": bytes_accessed,
        "traced_ops": run["ops"],
        "collective_bytes": coll.total_bytes,
        "collective_bytes_by_kind": coll.bytes_by_kind,
        "collective_count_by_kind": coll.count_by_kind,
        "collective_bytes_by_link": coll.bytes_by_link,
        "top_collectives": coll.top_ops,
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
    ap.add_argument("--substrate", default=None,
                    help="not ported yet: exits non-zero")
    ap.add_argument("--list-substrates", action="store_true",
                    help="not ported yet: exits non-zero")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)

    if args.substrate is not None or args.list_substrates:
        print(f"dryrun: the substrate smokes are not ported yet; they are "
              f"the next slice, {SUBSTRATE_ITEM}")
        return 2

    out_dir = args.out or os.path.abspath(ARTIFACTS)
    os.makedirs(out_dir, exist_ok=True)
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
