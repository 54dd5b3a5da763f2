"""Training with RWKV6's units and the audio stub's head cut over the
model axis across ranks (``launch/train.py --ranks W --model-ranks M``,
``sharding.tp_ctx``): RWKV6's time mix over its heads between Megatron's
f and g, its channel mix over its hidden units with the f on the k
branch alone and the g before the product with the whole r branch;
HuBERT's head cut over its codebook though it has no table; against the
reference's whole-batch step, on the CPU with gloo ranks in f32 (rank
bodies in ``tests/torch_train_ranks.py``, the runs and the rule of
``test_torch_train_tp.py``).

Four configurations from the reference's own ``smoke()``, each from the
reference's parameters, 3 AdamW steps:

* ``rwkv6`` on the (1, 2) mesh and ``rwkv6-4`` on the (1, 4) mesh:
  rwkv6-7b's smoke configuration (2 layers of 4 heads of 16, d_ff 224,
  the segment stacked twice);
* ``rwkv6-remat`` on the (2, 2) mesh: the same with remat, so every
  collective runs a third time in the recompute (held against the
  reference's step without remat, which computes the same values);
* ``hubert`` on the (1, 2) mesh: hubert-xlarge's smoke configuration
  (the audio stub's frames, a head of 64 codes and no table).

Held: each step's loss within 1e-5 relative of the reference's, and each
step's gradient and the new parameters, the ranks' blocks put together,
within 1e-4 normwise a leaf (``test_torch_train_ranks._hold``), save
RWKV6's third gradient: in f32 it lies 1.3e-4 from the reference's in
the one-process port itself, and 1.0e-4 from the one-process port's in
the model axis's run (AdamW's first step moves an element whose gradient
two runs round to opposite signs by ±lr the other way, and the decay's
exponentials carry it on), a limit of the comparison, not of the model
axis; its clip norm is held at every step, and the new parameters after
it.  Every rank's whole leaves the same bits; a rank's block
all-reduces, count and bytes, equal to ``reckon``'s ``over model``
entries (RWKV6's ``rwkv/w_o`` and ``rwkv/w_v_cm``); the time mix's whole
leaves summed over the model group by name, and the channel mix's whole
leaves not, their gradients equal to the reference's; the head's cut
without the table's, and its collectives by hand and against the
dry-run's "vocab" entries; every kind a rank counts equal to the
dry-run's entries of that kind; the heads' and hidden units' blocks
summing to the whole mixers; the launcher's runs.
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as j_smoke
from repro_torch.configs.base import config_from_dict
from repro_torch.launch import train
from repro_torch.models import ssm

import torch_train_ranks as TR
from test_torch_train_ranks import BATCH, SEQ, _hold, _npz
from test_torch_train_tp import (N_STEPS, PORT_TOL, _hold_every_kind, _Runs,
                                 _reckon)

RWKV6 = dataclasses.replace(j_smoke("rwkv6-7b"), dtype="float32")
RWKV6_REMAT = dataclasses.replace(RWKV6, remat=True)
HUBERT = dataclasses.replace(j_smoke("hubert-xlarge"), dtype="float32")
#: name: (the reference's configuration, data ranks, model ranks[, the
#: configuration the reference steps: remat changes no value])
CASES = {"rwkv6": (RWKV6, 1, 2), "rwkv6-4": (RWKV6, 1, 4),
         "rwkv6-remat": (RWKV6_REMAT, 2, 2, RWKV6),
         "hubert": (HUBERT, 1, 2)}
#: the time mix's leaves the rules leave whole: read behind its f
TIME_MIX_PARTIAL = ("mu_g", "mu_k", "mu_r", "mu_v", "mu_w", "w_lora_a")
#: the channel mix's leaves the rules leave whole: read outside its f / g
CHANNEL_MIX_WHOLE = ("mu_k_cm", "mu_r_cm", "w_r_cm")


@pytest.fixture(autouse=True)
def one_thread(monkeypatch):
    monkeypatch.setenv("OMP_NUM_THREADS", "1")          # the ranks' too
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    return _Runs(tmp_path_factory.mktemp("train_tp_ssm"), CASES)


def _held_to(run) -> dict:
    """What the case is held to (the module docstring): the reference's
    step; for RWKV6 without its third gradient."""
    ref = run["ref"]
    if not run["cfg"].name.startswith("rwkv6"):
        return ref
    return dict(ref, grads=ref["grads"][:N_STEPS - 1])


@pytest.mark.parametrize("name", list(CASES))
def test_rwkv6_and_audio_over_the_model_axis_equal_the_reference_step(
        runs, name):
    run = runs(name)
    _hold(dict(run, ref=_held_to(run), arrays=[run["whole"]]))
    for r in range(run["m"], len(run["docs"])):
        assert run["docs"][r]["loss"] == run["docs"][r % run["m"]]["loss"]
    m = run["m"]
    cuts = run["docs"][0]["cuts"]
    if name.startswith("rwkv6"):
        # heads over model (a stacked leaf's dimension one later)
        unit = "segments/0/0/rwkv/"
        for leaf, dim in (("w_r", 2), ("w_lora_b", 2), ("w0", 1), ("u", 1),
                          ("ln_out", 1), ("w_o", 1), ("w_k_cm", 2),
                          ("w_v_cm", 1)):
            assert cuts[unit + leaf] == dim, leaf
    for doc, arrays in zip(run["docs"], run["arrays"]):
        for path, dim in doc["cuts"].items():
            whole = run["ref"]["init"][path].shape
            assert arrays[f"p/{path}"].shape[dim] * m == whole[dim], path


@pytest.mark.parametrize("name", list(CASES))
def test_whole_leaves_are_the_same_bits_on_every_rank(runs, name):
    run = runs(name)
    assert len({d["digest"] for d in run["docs"]}) == 1
    cuts = run["docs"][0]["cuts"]
    first = run["arrays"][0]
    for other in run["arrays"][1:]:
        for key, x in first.items():
            if key.split("/", 1)[1] not in cuts:
                assert np.array_equal(x, other[key]), key


@pytest.mark.parametrize("name", list(CASES))
def test_block_all_reduces_equal_the_dryrun_model_entries(runs, name):
    """A rank's f and g all-reduces a step, bytes × 2 and their number, as
    ``reckon``'s ``over model`` entries: two units a layer (RWKV6's time
    mix and channel mix, or attention and the MLP), three passes under
    remat and two without; no norm statistic."""
    run = runs(name)
    cfg = run["cfg"]
    report = _reckon(run)
    passes = 3 if cfg.remat else 2
    tokens = BATCH // run["hosts"] * SEQ
    assert report["model_all_reduces"] == 2 * cfg.n_layers * passes
    assert report["model_all_reduce_bytes"] == 2 * (
        report["model_all_reduces"] * tokens * cfg.d_model * 4)
    assert report["norm_all_reduces"] == 0
    for doc in run["docs"]:
        assert doc["model_calls"]["block"] == N_STEPS * report[
            "model_all_reduces"]
        assert 2 * doc["model_bytes"]["block"] == N_STEPS * report[
            "model_all_reduce_bytes"]
        assert doc["model_calls"]["norm"] == 0
        if run["hosts"] > 1:
            assert 2 * doc["gradient_bytes"] == N_STEPS * report[
                "gradient_all_reduce_bytes"]


@pytest.mark.parametrize("name", ["rwkv6", "rwkv6-4", "rwkv6-remat"])
def test_time_mix_leaves_are_summed_and_channel_mix_leaves_are_whole(
        runs, name):
    """The time mix's token-shift coefficients and ``w_lora_a`` are read
    behind its f by the rank's heads alone: their gradients are the
    rank's share until summed over the model group, one f32 buffer a
    step.  The channel mix's ``mu_k_cm``, ``mu_r_cm`` and ``w_r_cm`` are
    read outside its f and g: not summed, their gradients the
    reference's on every rank (an f on the channel mix's input would
    count the r branch's M times)."""
    run = runs(name)
    unit = "segments/0/0/rwkv/"
    want = sorted(unit + leaf for leaf in TIME_MIX_PARTIAL)
    for doc in run["docs"]:
        assert doc["partial"] == want
        assert doc["model_calls"]["gradient"] == N_STEPS
        n = sum(run["ref"]["init"][p].size for p in want)
        assert doc["model_bytes"]["gradient"] == N_STEPS * n * 4
    for i, g_ref in enumerate(run["ref"]["grads"]):
        for leaf in CHANNEL_MIX_WHOLE:
            want = g_ref[unit + leaf]
            for arrays in run["arrays"]:
                got = arrays[f"g{i}/{unit}{leaf}"]
                assert np.linalg.norm(got - want) <= 1e-4 * np.linalg.norm(
                    want), (i, leaf)


@pytest.mark.parametrize("name", list(CASES))
def test_every_kind_a_rank_counts_equals_the_dryrun(runs, name):
    _hold_every_kind(runs(name))


def test_the_audio_heads_collectives_equal_the_dryrun_entries(runs):
    """HuBERT's head input's gradient and its chunks' max and sums, x 2
    and in number, as the dry-run's "vocab" entries: no lookup entry."""
    run = runs("hubert")
    report = _reckon(run)
    assert report["vocab_all_reduces"] == 1 + 2 * 2
    for doc in run["docs"]:
        assert 2 * doc["model_bytes"]["vocab"] == N_STEPS * report[
            "vocab_all_reduce_bytes"]
        assert doc["model_calls"]["vocab"] == N_STEPS * report[
            "vocab_all_reduces"]


def test_the_audio_head_alone_is_cut_and_its_collectives_by_hand(runs):
    """HuBERT has no table (``mask_emb`` only) and a head of 64 codes: the
    rank holds its 32 columns and the loss is made over the cut logits,
    the hidden states through an f (tokens × d, f32) and, for each
    sequence chunk, its max and its two sums, each in the forward and
    again in the chunk's recompute; no lookup.  Its attention and MLP
    read no whole leaf (4 kv heads over 2)."""
    run = runs("hubert")
    cfg = run["cfg"]
    rows = BATCH // run["hosts"]
    tokens = rows * SEQ
    chunks = -(-SEQ // 512)
    want_bytes = (tokens * cfg.d_model * 4
                  + chunks * 2 * (rows * min(SEQ, 512) * 4 * 3))
    want_calls = 1 + chunks * 2 * 2
    for doc in run["docs"]:
        assert doc["cuts"]["head/w"] == 1
        assert not any(p.startswith("embed/") for p in doc["cuts"])
        assert doc["model_bytes"]["vocab"] == N_STEPS * want_bytes
        assert doc["model_calls"]["vocab"] == N_STEPS * want_calls
        assert doc["partial"] == []


def test_the_clip_norm_and_the_one_process_step(runs, tmp_path):
    """Every rank clips by one norm: the one-process port's on the same
    batch, and the reference's; the one-process losses equal the
    ranks'."""
    run = runs("rwkv6")
    gnorms = [d["gnorms"] for d in run["docs"]]
    assert all(g == gnorms[0] for g in gnorms) and len(gnorms[0]) == N_STEPS
    one = TR.steps(None, **dict(run["kw"], out=str(tmp_path / "out")))
    arrays = _npz(tmp_path / "out_one.npz")
    for i in range(N_STEPS):
        want = np.sqrt(sum(np.sum(x.astype(np.float64) ** 2)
                           for key, x in arrays.items()
                           if key.startswith(f"g{i}/")))
        ref = np.sqrt(sum(np.sum(x.astype(np.float64) ** 2)
                          for x in run["ref"]["grads"][i].values()))
        np.testing.assert_allclose(gnorms[0][i], want, rtol=PORT_TOL)
        np.testing.assert_allclose(gnorms[0][i], ref, rtol=1e-4)
    np.testing.assert_allclose(one["loss"], run["docs"][0]["loss"],
                               rtol=PORT_TOL)


class _Ctx:
    """A ``ShardCtx`` stand-in for one rank's block alone: f and g the
    identity, so a block's output is its share of the whole."""
    model_block = 0

    def model_in(self, x, cut):
        return x

    def model_out(self, x, cut, pinned):
        return x


def _rwkv(gen):
    cfg = config_from_dict(dataclasses.asdict(RWKV6))
    p = {name: torch.randn(leaf.shape, generator=gen) * 0.3
         for name, leaf in ssm.rwkv6_specs(cfg).items()}
    x = torch.randn(2, 16, cfg.d_model, generator=gen)
    return cfg, p, x


@pytest.mark.parametrize("m", [2, 4])
def test_head_blocks_sum_to_the_whole_time_mix(m):
    """A rank's time mix over its block of the heads (their rows of every
    per-head leaf, their rows of ``w_o``) makes its share of ``w_o``'s
    product: the blocks' products sum to the whole time mix's."""
    cfg, p, x = _rwkv(torch.Generator().manual_seed(0))
    whole, _ = ssm.rwkv6_time_mix(x, p, cfg)
    hb = (cfg.d_model // cfg.ssm.head_dim) // m
    total = torch.zeros_like(whole)
    for r in range(m):
        rows = slice(r * hb, (r + 1) * hb)
        block = dict(p, **{k: p[k][:, rows] for k in ("w_r", "w_k", "w_v",
                                                       "w_g", "w_lora_b")},
                     **{k: p[k][rows] for k in ("w0", "u", "ln_out", "w_o")})
        part, _ = ssm.rwkv6_time_mix(x, block, cfg)
        total += part
    torch.testing.assert_close(total, whole, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("m", [2, 4])
def test_hidden_blocks_times_the_whole_r_branch_sum_to_the_channel_mix(m):
    """A rank's channel mix over its block of the hidden units, its g the
    identity here, is its share of ``kv`` times the whole r branch: the
    blocks sum to the whole channel mix, since the product with r is
    linear in ``kv``."""
    cfg, p, x = _rwkv(torch.Generator().manual_seed(1))
    whole, _ = ssm.rwkv6_channel_mix(x, p)
    n = cfg.d_ff // m
    total = torch.zeros_like(whole)
    for r in range(m):
        cols = slice(r * n, (r + 1) * n)
        block = dict(p, w_k_cm=p["w_k_cm"][:, cols], w_v_cm=p["w_v_cm"][cols])
        part, _ = ssm.rwkv6_channel_mix(x, block, None, cfg, _Ctx())
        total += part
    torch.testing.assert_close(total, whole, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("arch", ["rwkv6-7b", "hubert-xlarge"])
def test_the_launcher_trains_the_smoke_configurations(arch, capsys):
    """``launch/train.py --ranks 2 --model-ranks 2 --device cpu --arch
    <arch>`` trains the smoke configuration in its bf16 to the end, each
    step's loss within the bf16 tolerance of one process's."""
    argv = ["--device", "cpu", "--arch", arch, "--batch", "4", "--seq",
            "32", "--steps", "2", "--log-every", "1"]
    assert train.main(argv + ["--ranks", "2", "--model-ranks", "2"]) == 0
    out = capsys.readouterr().out
    assert "[train] done" in out
    got = [float(line.split('"loss": ')[1].split(",")[0])
           for line in out.splitlines() if '"loss"' in line]
    one = train.run(argv)["losses"]
    assert len(got) == 2
    np.testing.assert_allclose(got, one, rtol=2e-2)
