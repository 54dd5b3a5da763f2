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
  ``pin_proj_outputs`` and without ``remat``.
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
                                 ShapeConfig, get_config)
from repro_torch.models import sharding as S
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


def test_dense_train_counts_by_hand():
    st = _stats(_dense(), TRAIN, MESH_2x2)
    # 2 layers x (attention, MLP) x 3 passes (forward, backward, remat)
    tp = 2 * 2 * 3 * UNIT_AR
    assert DENSE_LOCAL == 26944
    assert st.bytes_by_kind["all-reduce"] == tp + 2 * DENSE_LOCAL
    assert st.count_by_kind["all-reduce"] == 12 + DENSE_LEAVES
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
        + 2 * DENSE_LOCAL
    # without remat, forward and backward only
    st = _stats(_dense(remat=False), TRAIN, MESH_2x2)
    assert st.bytes_by_kind["all-reduce"] == 8 * UNIT_AR + 2 * DENSE_LOCAL
    # inference: one pass, no gradient
    st = _stats(_dense(), PREFILL, MESH_2x2)
    assert st.bytes_by_kind["all-reduce"] == 4 * UNIT_AR
    assert st.count_by_kind["all-reduce"] == 4
    st = _stats(_dense(), DECODE, MESH_2x2)      # 2 rows x 1 token
    assert st.bytes_by_kind["all-reduce"] == 4 * (2 * 1 * 32 * 4 * 2)
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
    assert st.bytes_by_kind["all-reduce"] == 12 * UNIT_AR + 2 * rest
    assert st.count_by_kind["all-reduce"] == 12 + 10
    st = _stats(cfg, PREFILL, MESH_2x2, fsdp=True)
    assert st.bytes_by_kind["all-gather"] == 2 * big * 2
    assert st.bytes_by_kind["reduce-scatter"] == 0
    # with a pod axis the fsdp gradients are also all-reduced over pod,
    # the rest over pod x data; 8 devices stay on NVLink
    st = _stats(cfg, TRAIN, MESH_2x2x2, fsdp=True)
    unit = 1 * 16 * 32 * 4 * 2                    # 1 row a device
    assert st.bytes_by_kind["reduce-scatter"] == 2 * big
    assert st.bytes_by_kind["all-reduce"] == (12 * unit + 2 * rest
                                              + 2 * 2 * big)
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
    assert st.bytes_by_kind["all-reduce"] == 12 * unit + 2 * local
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
    assert st.bytes_by_kind["all-reduce"] == tp + 2 * local
    assert st.count_by_kind["all-reduce"] == 12 + 3 + 13
    # decode: capacity max(int(1·2·1.25/4), 4) = 4 a group of one token,
    # 4 groups; global dispatch: one group of 4 tokens, capacity 4
    st = _stats(_moe(), DECODE, MESH_2x2)
    assert st.bytes_by_kind["all-to-all"] == 2 * 2 * (4 * 4 * 4 * 32 * 2 // 4)
    st = _stats(_moe(dispatch="global"), DECODE, MESH_2x2)
    assert st.bytes_by_kind["all-to-all"] == 2 * 2 * (4 * 1 * 4 * 32 * 2 // 4)
    # pinned: the attention and shared expert all-reduces in bf16
    st = _stats(dataclasses.replace(_moe(), pin_proj_outputs=True), PREFILL,
                MESH_2x2)
    assert st.bytes_by_kind["all-reduce"] == 4 * UNIT_AR // 2
