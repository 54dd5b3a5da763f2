"""The port's roofline (``repro_torch/roofline/analysis.py``).

* ``roofline_terms`` and ``model_flops`` fed a TPU v5e's constants (the
  reference's) equal the reference's for every arch × shape, so the
  formulas are the reference's and only the constants differ.
* The H100 constants are the published ones, and ``chip_smoke.py``
  imports them instead of defining its own.
* ``axis_link``: 8 devices a node in mesh order.
* ``collective_bytes_from_specs`` against counts made by hand, rule by
  rule, on a two-layer dense and a two-layer MoE configuration over
  stand-in meshes of 2 × 2, 2 × 2 × 2 and 16 × 16, with ``fsdp``,
  ``pin_proj_outputs`` and without ``remat``; and kind by kind on
  2 × 2: the vocabulary cut in train, prefill and decode, the whole
  leaves read inside a cut unit (k/v where the kv heads do not divide
  ``model``, RWKV6's and Mamba2's smoke configurations), the MoE's
  statistics and the port's gathers, the loss's sums over the data axes,
  and the accessors of the earlier kinds unchanged by the new entries;
  the serving steps' entries (the logits' gather, a decode step's heads
  gather and merges) on danube's decode_32k and prefill_32k cells over
  (1, 2) and its long_500k cell over 2 × 2.
"""
import ast
import dataclasses
import os

import numpy as np
import pytest

from repro.configs import SHAPES as j_SHAPES
from repro.configs import get_config as j_get_config
from repro.roofline import analysis as JA
from repro_torch.configs import (ARCH_NAMES, SHAPES, ModelConfig, MoEConfig,
                                 ShapeConfig, get_config, get_smoke_config)
from repro_torch.models import sharding as S
from repro_torch.models import transformer as T
from repro_torch.roofline import analysis as A

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

V5E = A.Peaks(JA.PEAK_FLOPS, JA.HBM_BW, {"ici": JA.ICI_BW})


class _FakeMesh:
    """Just enough Mesh interface for the spec builders."""
    def __init__(self, shape):
        self.axis_names = tuple(shape)
        self.shape = dict(shape)
        self.size = int(np.prod(list(shape.values())))


MESH_2x2 = _FakeMesh({"data": 2, "model": 2})
MESH_2x2x2 = _FakeMesh({"pod": 2, "data": 2, "model": 2})
MESH_16x16 = _FakeMesh({"data": 16, "model": 16})


# -- the reference's formulas ------------------------------------------------

@pytest.mark.parametrize("shape", list(SHAPES))
@pytest.mark.parametrize("arch", ARCH_NAMES)
def test_terms_and_model_flops_equal_the_reference(arch, shape):
    cfg, jcfg = get_config(arch), j_get_config(arch)
    s, js = SHAPES[shape], j_SHAPES[shape]
    mf = A.model_flops(cfg, s, s.kind)
    assert mf == JA.model_flops(jcfg, js, js.kind)
    for flops, nbytes, coll in [(mf / 256, mf / 256 * 0.37, mf / 256 * 0.02),
                                (mf / 512, mf / 1e4, mf / 10),
                                (1.0, 1e15, 0.0), (0.0, 0.0, 0.0)]:
        want = JA.roofline_terms(flops, nbytes, coll, 256)
        assert A.roofline_terms(flops, nbytes, {"ici": coll}, 256,
                                V5E) == want


def test_h100_constants_and_links():
    assert (A.PEAK_FLOPS, A.F32_FLOPS, A.HBM_BW) == (989e12, 67e12, 3.35e12)
    assert (A.NVLINK_BW, A.NETWORK_BW, A.DEVICES_PER_NODE) == (450e9, 50e9, 8)
    # the collective bytes are charged link by link
    t = A.roofline_terms(0.0, 0.0, {"network": 100e9}, 1)
    assert t["collective_s"] == 2.0
    t = A.roofline_terms(0.0, 0.0, {"nvlink": 450e9, "network": 50e9}, 1)
    assert t["collective_s"] == 2.0 and t["dominant"] == "collective_s"


def test_chip_smoke_imports_the_constants_and_defines_none():
    tree = ast.parse(open(os.path.join(ROOT, "chip_smoke.py")).read())
    names = {"PEAK_FLOPS", "F32_FLOPS", "HBM_BW"}
    assigned = {t.id for node in tree.body if isinstance(node, ast.Assign)
                for t in node.targets if isinstance(t, ast.Name)}
    imported = {a.name for node in tree.body
                if isinstance(node, ast.ImportFrom)
                and node.module == "repro_torch.roofline.analysis"
                for a in node.names}
    assert names <= imported and not names & assigned
    assert not any(isinstance(node, ast.Constant) and node.value == 989e12
                   for node in ast.walk(tree))


@pytest.mark.parametrize("mesh, axes, link", [
    (MESH_2x2, ("data",), "nvlink"), (MESH_2x2, ("model",), "nvlink"),
    (MESH_2x2x2, ("pod", "data"), "nvlink"),
    (_FakeMesh({"data": 2, "model": 8}), ("model",), "nvlink"),
    (_FakeMesh({"data": 2, "model": 8}), ("data",), "network"),
    (_FakeMesh({"data": 4, "model": 4}), ("data",), "network"),
    (_FakeMesh({"data": 4, "model": 2}), ("data",), "nvlink"),
    (MESH_16x16, ("model",), "network"), (MESH_16x16, ("data",), "network"),
])
def test_axis_link(mesh, axes, link):
    assert A.axis_link(mesh, axes) == link


# -- collectives counted by hand ---------------------------------------------

def _dense(**kw) -> ModelConfig:
    fields = dict(name="dense2", family="dense", n_layers=2, d_model=32,
                  n_heads=4, n_kv_heads=2, d_ff=64, vocab_size=128,
                  head_dim=8)
    fields.update(kw)
    return ModelConfig(**fields)


def _moe(cf: float = 1.25, dispatch: str = "grouped") -> ModelConfig:
    return _dense(name="moe2", family="moe", moe=MoEConfig(
        n_experts=4, experts_per_token=2, n_shared_experts=1,
        expert_d_ff=32, capacity_factor=cf, dispatch=dispatch))


def _stats(cfg, shape, mesh, fsdp=False):
    specs, fallbacks = S.enforce_divisible(cfg, mesh,
                                           S.param_specs(cfg, mesh, fsdp))
    assert not fallbacks
    return A.collective_bytes_from_specs(cfg, shape, mesh, specs)


TRAIN = ShapeConfig("t", 16, 4, "train")      # 2 rows a device on 2 x 2
PREFILL = ShapeConfig("p", 16, 4, "prefill")
DECODE = ShapeConfig("d", 64, 4, "decode")

# the dense config's pieces on one device of 2 x 2, bf16 bytes:
# tok (128, 32) cut over model 4096; head (32, 128) 4096; final norm 64;
# stacked over 2 layers: 2 norms 128 each, wq (32, 4, 8) heads cut 2048,
# wk / wv (32, 2, 8) 1024 each, wo (4, 8, 32) 2048, w_gate / w_in / w_out
# 4096 each
DENSE_LOCAL = 4096 + 4096 + 64 + 2 * 128 + 2048 + 2 * 1024 + 2048 + 3 * 4096
DENSE_LEAVES = 3 + 9
# one unit's all-reduce: 2 rows x 16 tokens x d 32 x f32, ring twice
UNIT_AR = 2 * 16 * 32 * 4 * 2


def _vocab_ar(rows: int, seq: int, d: int, table: int) -> int:
    """A training step's all-reduces over ``model`` where the table and
    the head are cut over it, ring twice: the lookup (rows x seq x d in
    the table's ``table`` bytes), the head input's gradient (f32) and,
    for the one chunk of ``seq`` <= 512 tokens, its max (rows x seq f32)
    and its two sums, in the forward and again in the recompute."""
    lookup = rows * seq * d * table
    head_input = rows * seq * d * 4
    chunk = 2 * (rows * seq * 4 + 2 * rows * seq * 4)
    return 2 * (lookup + head_input + chunk)


# the dense config on 2 x 2: 2 rows a device, the vocabulary 128 cut;
# 6 all-reduces (lookup, head input, max and sums twice)
DENSE_VOCAB_AR = _vocab_ar(2, 16, 32, 2)
# the loss's two f32 sums (weighted CE, weights) over data, ring twice
LOSS_AR = 2 * 8


def test_dense_train_counts_by_hand():
    st = _stats(_dense(), TRAIN, MESH_2x2)
    # 2 layers x (attention, MLP) x 3 passes (forward, backward, remat)
    tp = 2 * 2 * 3 * UNIT_AR
    assert DENSE_LOCAL == 26944
    assert DENSE_VOCAB_AR == 2 * (2048 + 4096 + 2 * (128 + 256))
    assert st.bytes_by_kind["all-reduce"] == (tp + 2 * DENSE_LOCAL
                                              + DENSE_VOCAB_AR + LOSS_AR)
    assert st.count_by_kind["all-reduce"] == 12 + DENSE_LEAVES + 6 + 1
    assert st.total_bytes == st.bytes_by_kind["all-reduce"]
    assert st.bytes_by_link == {"nvlink": st.total_bytes}
    assert st.top_ops[0][1] == 2 * 3 * UNIT_AR
    assert "attn/wo" in st.top_ops[0][0] or "mlp/w_out" in st.top_ops[0][0]
    assert [b for _, b in st.top_ops] == sorted(
        (b for _, b in st.top_ops), reverse=True)


def test_dense_variants_by_hand():
    # bf16 under the pin, 2 bytes an element
    st = _stats(_dense(pin_proj_outputs=True), TRAIN, MESH_2x2)
    assert st.bytes_by_kind["all-reduce"] == 12 * UNIT_AR // 2 \
        + 2 * DENSE_LOCAL + DENSE_VOCAB_AR + LOSS_AR
    # without remat, forward and backward only (the loss's chunks are
    # recomputed all the same)
    st = _stats(_dense(remat=False), TRAIN, MESH_2x2)
    assert st.bytes_by_kind["all-reduce"] == (8 * UNIT_AR + 2 * DENSE_LOCAL
                                              + DENSE_VOCAB_AR + LOSS_AR)
    # inference: one pass, no gradient, no loss; the lookup (2 rows x 16
    # tokens x d 32 in bf16, ring twice)
    st = _stats(_dense(), PREFILL, MESH_2x2)
    assert st.bytes_by_kind["all-reduce"] == 4 * UNIT_AR + 2 * 2048
    assert st.count_by_kind["all-reduce"] == 4 + 1
    # decode, 2 rows x 1 token: besides, each layer's attention merges its
    # cache blocks over model, the maxima (2 rows x 4 heads f32) and the
    # outputs with their sums (2 x 4 x (8 + 1) f32), ring twice
    st = _stats(_dense(), DECODE, MESH_2x2)
    assert st.bytes_by_kind["all-reduce"] == 4 * (2 * 1 * 32 * 4 * 2) \
        + 2 * (2 * 1 * 32 * 2) + 2 * 2 * (2 * 4 * 4 + 2 * 4 * 9 * 4)
    # a (1, 1) mesh has no collective
    st = _stats(_dense(), TRAIN, _FakeMesh({"data": 1, "model": 1}))
    assert st.total_bytes == 0 and st.top_ops == []


def test_dense_fsdp_by_hand():
    # vocab 32768 x d 32 = 2^20 elements: the embedding and the head are
    # cut over data too (their other dimension), nothing else is; in
    # training the head is gathered twice and the table once (only the
    # lookup reads it, and its backward needs no values)
    cfg = _dense(vocab_size=32768)
    big = 16384 * 16 * 2                          # each one's piece
    rest = DENSE_LOCAL - 4096 - 4096              # the other 10 leaves
    st = _stats(cfg, TRAIN, MESH_2x2, fsdp=True)
    assert st.bytes_by_kind["all-gather"] == (1 + 2) * big * 2
    assert st.count_by_kind["all-gather"] == 3
    assert st.fsdp_all_gather_bytes == st.bytes_by_kind["all-gather"]
    assert st.fsdp_reduce_scatter_bytes == 2 * big
    assert st.bytes_by_kind["reduce-scatter"] == 2 * big
    assert st.bytes_by_kind["all-reduce"] == (12 * UNIT_AR + 2 * rest
                                              + DENSE_VOCAB_AR + LOSS_AR)
    assert st.count_by_kind["all-reduce"] == 12 + 10 + 6 + 1
    # inference gathers each once, and the logits of the vocabulary cut
    # over model (2 rows x 16 tokens x 32768, bf16) once
    st = _stats(cfg, PREFILL, MESH_2x2, fsdp=True)
    logits = 2 * 16 * 32768 * 2
    assert st.bytes_by_kind["all-gather"] == 2 * big * 2 + logits
    assert st.fsdp_all_gather_bytes == 2 * big * 2
    assert st.kind_bytes("logits") == logits
    assert st.bytes_by_kind["reduce-scatter"] == 0
    # with a pod axis the fsdp gradients are also all-reduced over pod,
    # the rest over pod x data; 8 devices stay on NVLink
    st = _stats(cfg, TRAIN, MESH_2x2x2, fsdp=True)
    unit = 1 * 16 * 32 * 4 * 2                    # 1 row a device
    assert st.bytes_by_kind["reduce-scatter"] == 2 * big
    assert st.bytes_by_kind["all-reduce"] == (12 * unit + 2 * rest
                                              + 2 * 2 * big
                                              + _vocab_ar(1, 16, 32, 2)
                                              + LOSS_AR)
    assert st.bytes_by_link == {"nvlink": st.total_bytes}


def test_dense_16x16_by_hand():
    cfg = _dense(d_model=64, n_heads=16, n_kv_heads=16, head_dim=4,
                 d_ff=256, vocab_size=256)
    shape = ShapeConfig("t", 8, 32, "train")      # 2 rows a device
    # tok 16 x 64, head 64 x 16, final norm 64, stacked: 2 norms of
    # 2 x 64, wq / wk / wv / wo 2 x 64 x 4 x 1 head, MLP 2 x 64 x 16 each
    local = 2 * (16 * 64 * 2) + 128 + 2 * 256 + 4 * 1024 + 3 * 4096
    st = _stats(cfg, shape, MESH_16x16)
    unit = 2 * 8 * 64 * 4 * 2
    # the vocabulary 256 cut over 16 (2 rows x 8 tokens a device), the
    # loss's sums over data
    assert st.bytes_by_kind["all-reduce"] == (12 * unit + 2 * local
                                              + _vocab_ar(2, 8, 64, 2)
                                              + LOSS_AR)
    assert st.bytes_by_link == {"network": st.total_bytes}
    t = A.roofline_terms(0.0, 0.0, st.bytes_by_link, 256)
    assert t["collective_s"] == st.total_bytes / A.NETWORK_BW


def test_moe_by_hand():
    # experts (E=4) cut over model: all-to-alls; the shared expert's
    # w_out (32, 32) cut over model: an all-reduce with attention's
    st = _stats(_moe(), TRAIN, MESH_2x2)
    # grouped: 4 groups (rows) x capacity int(16·2·1.25/4) = 10 slots x
    # d 32 x bf16, over the 2 data x 2 expert shards
    a2a = 4 * 4 * 10 * 32 * 2 // 4
    assert st.bytes_by_kind["all-to-all"] == 2 * 2 * 3 * a2a
    assert st.count_by_kind["all-to-all"] == 12
    tp = 2 * 2 * 3 * UNIT_AR
    # gradients: tok, head, final norm 4096 + 4096 + 64; stacked: norms
    # 2 x 128, wq 2048, wk / wv 1024 each, wo 2048, the f32 router
    # (32, 4) replicated 1024, the experts (4, 32, 32) cut over experts
    # 8192 each, the shared MLP (32, 32) 2048 each
    local = (4096 + 4096 + 64 + 2 * 128 + 2048 + 2 * 1024 + 2048 + 1024
             + 3 * 8192 + 3 * 2048)
    # the router, read by the device's rows alone, summed over model too
    # (1024); the statistics (2 x E 4 x f32) over data x model, 2 layers x
    # 2 forwards (remat); the vocabulary cut and the loss's sums
    router, stats = 2 * 1024, 2 * 2 * 2 * (2 * 4 * 4)
    assert st.bytes_by_kind["all-reduce"] == (tp + 2 * local + router + stats
                                              + DENSE_VOCAB_AR + LOSS_AR)
    assert st.count_by_kind["all-reduce"] == 12 + 3 + 13 + 1 + 4 + 6 + 1
    # the port's gathers over model: the device's 2 rows x 16 x d 32 in
    # bf16, 2 layers x 3 passes
    assert st.bytes_by_kind["all-gather"] == 2 * 3 * (2 * 16 * 32 * 2)
    assert st.count_by_kind["all-gather"] == 6
    # decode: capacity max(int(1·2·1.25/4), 4) = 4 a group of one token,
    # 4 groups; global dispatch: one group of 4 tokens, capacity 4
    st = _stats(_moe(), DECODE, MESH_2x2)
    assert st.bytes_by_kind["all-to-all"] == 2 * 2 * (4 * 4 * 4 * 32 * 2 // 4)
    st = _stats(_moe(dispatch="global"), DECODE, MESH_2x2)
    assert st.bytes_by_kind["all-to-all"] == 2 * 2 * (4 * 1 * 4 * 32 * 2 // 4)
    # pinned: the attention and shared expert all-reduces in bf16
    # (and the lookup, in the table's bf16)
    st = _stats(dataclasses.replace(_moe(), pin_proj_outputs=True), PREFILL,
                MESH_2x2)
    assert st.bytes_by_kind["all-reduce"] == 4 * UNIT_AR // 2 + 2 * 2048


# -- the kinds a step over ranks counts, each by hand ------------------------

def _entries(st, kind: str) -> dict:
    """The entries of ``kind``: name after the axes -> (bytes, number)."""
    return {name.split(": ")[1]: (st.ops[name], st.op_counts[name])
            for name, k in st.kinds.items() if k == kind}


def test_the_vocabulary_cut_by_hand():
    """The dense config's vocabulary 128 over model 2: in train the lookup
    (2 rows x 16 x d 32, bf16), the head input's gradient (f32), the
    chunk's max (2 x 16 f32) and two sums, each in the forward and the
    chunk's recompute; in prefill and decode the lookup alone (the head's
    output gather is a "logits" entry).  Tied, the
    head is the table.  A 1100-token sequence makes 512 + 512 + 76-token
    chunks.  A vocabulary 2 does not divide is whole: no entry."""
    st = _stats(_dense(), TRAIN, MESH_2x2)
    assert _entries(st, "vocab") == {
        "embed/tok lookup": (2 * 2048, 1),
        "head/w input's gradient (f)": (2 * 4096, 1),
        "head/w loss chunks' max": (2 * 2 * 128, 2),
        "head/w loss chunks' sums": (2 * 2 * 256, 2)}
    assert st.kind_bytes("vocab") == DENSE_VOCAB_AR
    assert st.kind_calls("vocab") == 6
    assert _entries(_stats(_dense(), PREFILL, MESH_2x2), "vocab") == {
        "embed/tok lookup": (2 * 2048, 1)}
    assert _entries(_stats(_dense(), DECODE, MESH_2x2), "vocab") == {
        "embed/tok lookup": (2 * (2 * 1 * 32 * 2), 1)}
    tied = _entries(_stats(_dense(tie_embeddings=True), TRAIN, MESH_2x2),
                    "vocab")
    assert sorted(tied) == ["embed/tok input's gradient (f)",
                            "embed/tok lookup", "embed/tok loss chunks' max",
                            "embed/tok loss chunks' sums"]
    long = _stats(_dense(), ShapeConfig("t", 1100, 4, "train"), MESH_2x2)
    chunks = _entries(long, "vocab")
    assert chunks["head/w loss chunks' max"] == (2 * 2 * (2 * 1100 * 4), 6)
    assert chunks["head/w loss chunks' sums"] == (2 * 2 * (4 * 1100 * 4), 6)
    assert _entries(_stats(_dense(vocab_size=129), TRAIN, MESH_2x2),
                    "vocab") == {}


def test_whole_leaves_read_in_a_cut_unit_by_hand():
    """Leaves left whole inside a unit cut over model, their gradient's
    share summed over model once a training step in their type: one kv
    head over 2 keeps ``wk`` / ``wv`` (2 layers x 32 x 8, bf16) whole,
    with the q/k norms (2 x 8); RWKV6's time-mix ``mu_r`` / ``mu_k`` /
    ``mu_v`` / ``mu_g`` / ``mu_w`` (2 x 64) and ``w_lora_a`` (2 x 64 x
    32); Mamba2's ``w_bc`` (2 x 64 x 32), ``w_dt`` (2 x 64 x 8),
    ``conv_w_bc`` (2 x 4 x 32), ``conv_b_bc`` (2 x 32), ``dd`` (2 x 8)
    in bf16 and ``a_log`` / ``dt_bias`` (2 x 8) in f32, each unit's.
    None in inference, none where the kv heads divide."""
    st = _stats(_dense(n_kv_heads=1, qk_norm=True), TRAIN, MESH_2x2)
    unit = "segments/0/0/attn/"
    assert _entries(st, "gradient") == {
        unit + "wk gradient": (2 * 1024, 1),
        unit + "wv gradient": (2 * 1024, 1),
        unit + "q_norm gradient": (2 * 32, 1),
        unit + "k_norm gradient": (2 * 32, 1)}
    assert st.kind_bytes("gradient") == 2 * (2 * 1024 + 2 * 32)
    assert _entries(_stats(_dense(n_kv_heads=1, qk_norm=True), PREFILL,
                           MESH_2x2), "gradient") == {}
    assert _entries(_stats(_dense(), TRAIN, MESH_2x2), "gradient") == {}
    rwkv = _stats(get_smoke_config("rwkv6-7b"), TRAIN, MESH_2x2)
    unit = "segments/0/0/rwkv/"
    want = {unit + f"mu_{x} gradient": (2 * 256, 1) for x in "rkvgw"}
    want[unit + "w_lora_a gradient"] = (2 * 8192, 1)
    assert _entries(rwkv, "gradient") == want
    zamba = _stats(get_smoke_config("zamba2-2.7b"), TRAIN, MESH_2x2)
    each = {"w_bc": 8192, "w_dt": 2048, "conv_w_bc": 512, "conv_b_bc": 128,
            "dd": 32, "a_log": 64, "dt_bias": 64}
    assert _entries(zamba, "gradient") == {
        f"segments/0/{u}/mamba/{leaf} gradient": (2 * n, 1)
        for u in (0, 1) for leaf, n in each.items()}
    assert zamba.kind_bytes("gradient") == 2 * 2 * 11040


def test_the_moe_statistics_and_the_ports_gathers_by_hand():
    """The MoE config on 2 x 2 (experts 4 over model, grouped): each
    layer's statistics (2 x E 4 f32) summed over data x model in each
    forward, 2 under remat; each layer's groups' outputs all-gathered
    over model (the device's 2 rows x 16 x d 32 in bf16) in each pass,
    3 under remat, and in inference once.  Without remat 1 and 2.  The
    global dispatch has no gather.  On 2 x 1 the experts are whole on
    every device: the statistics are a loss sum over data."""
    st = _stats(_moe(), TRAIN, MESH_2x2)
    stats = _entries(st, "stats")
    assert stats == {"segments/0/0/moe statistics": (2 * 2 * 2 * 32, 4)}
    assert [n for n, k in st.kinds.items() if k == "stats"] == [
        "all-reduce over dataxmodel (nvlink): segments/0/0/moe statistics"]
    assert _entries(st, "gather") == {
        "segments/0/0/moe gather (port)": (2 * 3 * 2048, 6)}
    st = _stats(_moe(), PREFILL, MESH_2x2)
    assert _entries(st, "gather") == {
        "segments/0/0/moe gather (port)": (2 * 2048, 2)}
    assert _entries(st, "stats") == {}
    st = _stats(dataclasses.replace(_moe(), remat=False), TRAIN, MESH_2x2)
    assert st.kind_calls("stats") == 2 and st.kind_calls("gather") == 4
    st = _stats(_moe(dispatch="global"), TRAIN, MESH_2x2)
    assert st.kind_calls("gather") == 0 and st.kind_calls("stats") == 4
    st = _stats(_moe(), TRAIN, _FakeMesh({"data": 2, "model": 1}))
    assert st.kind_calls("stats") == st.kind_calls("gather") == 0
    assert _entries(st, "loss")["segments/0/0/moe statistics"] == (
        2 * 2 * 2 * 32, 4)


def test_the_loss_sums_over_the_data_axes_by_hand():
    """The weighted cross-entropy's and the weights' f32 sums, once a
    training step over the data axes (pod x data with a pod axis); none
    in inference or where the data axes are one device."""
    for mesh, axes in ((MESH_2x2, "data"), (MESH_2x2x2, "podxdata")):
        st = _stats(_dense(), TRAIN, mesh)
        assert [n for n, k in st.kinds.items() if k == "loss"] == [
            f"all-reduce over {axes} (nvlink): loss sums"]
        assert st.kind_bytes("loss") == LOSS_AR
        assert st.kind_calls("loss") == 1
    assert _stats(_dense(), PREFILL, MESH_2x2).kind_calls("loss") == 0
    st = _stats(_dense(), TRAIN, _FakeMesh({"data": 1, "model": 2}))
    assert st.kind_calls("loss") == 0


def test_danube_serving_cells_on_1x2_by_hand():
    """h2o-danube-3-4b's decode_32k and prefill_32k cells on (1, 2), as a
    run over 2 ranks with ``--model-ranks 2`` lays them out (32/8 heads of
    120, d 3840, vocabulary 32000 cut, bf16, 24 layers): the logits
    gathered over model (the device's tokens x 32000 x 2 B); in decode
    each layer's gather of the query and new k/v heads (128 rows x (32 +
    16) x 120 x 2 B, the result) and its two merges, the maxima (128 x 32
    f32) and the outputs with their sums (128 x 32 x 121 f32), ring
    twice; one Megatron all-reduce each for attn/wo and mlp/w_out a
    layer (tokens x 3840 f32, ring twice) and the lookup (tokens x 3840
    bf16, ring twice).  Nothing else."""
    cfg = get_config("h2o-danube-3-4b")
    mesh = _FakeMesh({"data": 1, "model": 2})
    assert (cfg.padded_heads, cfg.n_kv_heads, cfg.resolved_head_dim) == (
        32, 8, 120)
    layers = cfg.n_layers
    for shape_name, tokens in (("decode_32k", 128), ("prefill_32k",
                                                     32 * 32768)):
        st = _stats(cfg, SHAPES[shape_name], mesh)
        assert _entries(st, "logits") == {
            "head/w logits": (tokens * 32000 * 2, 1)}
        assert st.kind_bytes("block") == 2 * layers * tokens * 3840 * 4 * 2
        assert st.kind_calls("block") == 2 * layers
        assert _entries(st, "vocab") == {
            "embed/tok lookup": (tokens * 3840 * 2 * 2, 1)}
        decode = shape_name == "decode_32k"
        assert st.kind_bytes("heads") == (
            layers * 128 * 48 * 120 * 2 if decode else 0)
        assert st.kind_calls("heads") == (layers if decode else 0)
        assert st.kind_bytes("merge") == (
            layers * 2 * (128 * 32 * 4 + 128 * 32 * 121 * 4) if decode
            else 0)
        assert st.kind_calls("merge") == (2 * layers if decode else 0)
        assert set(st.kinds.values()) == (
            {"logits", "block", "vocab", "heads", "merge"} if decode
            else {"logits", "block", "vocab"})
        assert all(n.startswith(("all-reduce over model (nvlink)",
                                 "all-gather over model (nvlink)"))
                   for n in st.kinds)
    # batch 1 (long_500k) cuts the cache's rows over every axis: on
    # (2, 2) the merges run over data x model, the gathers over model
    st = _stats(cfg, SHAPES["long_500k"], MESH_2x2)
    merges = {n.split(": ")[0] for n, k in st.kinds.items() if k == "merge"}
    assert merges == {"all-reduce over dataxmodel (nvlink)"}
    assert st.kind_bytes("merge") == layers * 2 * (32 * 4 + 32 * 121 * 4)


@pytest.mark.parametrize("cfg, blocks", [
    # 2 layers x (attention, MLP) x 3 passes
    (_dense(n_kv_heads=1, qk_norm=True), (12, 12 * UNIT_AR)),
    # 2 layers x (attention, shared experts) x 3 passes
    (_moe(), (12, 12 * UNIT_AR)),
    # no remat: 2 passes x (4 Mamba2 layers + 2 applications x (attention,
    # MLP)), 2 rows x 16 x d 64 in f32 each
    (get_smoke_config("zamba2-2.7b"), (16, 16 * (2 * 16 * 64 * 4 * 2)))],
    ids=["dense", "moe", "zamba2"])
def test_the_earlier_accessors_are_unchanged_by_the_new_entries(cfg, blocks):
    """The "block" and data-parallel gradient accessors select by kind:
    the new all-reduces over model (the vocabulary's, the statistics',
    and a partial leaf's, whose name ends in " gradient" as the
    data-parallel entries' do) count in neither."""
    st = _stats(cfg, TRAIN, MESH_2x2)
    assert (st.model_all_reduces, st.model_all_reduce_bytes) == blocks
    assert st.kind_calls("gradient") > 0 and st.kind_calls("vocab") > 0
    assert any(n.startswith("all-reduce over model ")
               and n.endswith(" gradient")
               for n, k in st.kinds.items() if k == "gradient")
    # one entry a leaf over data, its piece in its type, twice
    specs, _ = S.enforce_divisible(cfg, MESH_2x2)
    leaves = dict(S.spec_leaves(T.param_specs(cfg)))
    pieces = {path: A.local_numel(leaves[path].shape, spec, MESH_2x2)
              * (leaves[path].dtype or T.param_dtype(cfg)).itemsize
              for path, spec in S.spec_leaves(specs)}
    assert st.gradient_all_reduce_bytes == 2 * sum(pieces.values())
    assert sorted(n for n, k in st.kinds.items() if k == "data gradient") \
        == sorted(f"all-reduce over data (nvlink): {p} gradient"
                  for p in pieces)
    assert set(st.kinds.values()) <= set(S.MODEL_KINDS) | set(A.DATA_KINDS)
    assert set(st.kinds) == set(st.ops) == set(st.op_counts)
