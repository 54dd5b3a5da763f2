"""Training with its parameters cut over the model axis across ranks
(``launch/train.py --ranks W --model-ranks M``, ``sharding.tp_ctx``:
Megatron's tensor parallelism as the reference's ``param_specs`` rules
cut the dense units) against the reference's whole-batch step, on the
CPU with gloo ranks in f32 (rank bodies in ``tests/torch_train_ranks.py``).

Three configurations, each from the reference's own parameters, 3 AdamW
steps:

* ``gqa`` on the (1, 2) mesh: the tiny preset's widths with 10 query
  heads over 5 kv heads (M = 2 does not divide them, so ``wk`` / ``wv``
  stay whole and rank 0's heads 0-4 read kv heads 0, 0, 1, 1, 2), q/k/v
  biases, q/k norms, tied embeddings, a parallel block, LayerNorm and
  remat;
* ``data`` on the (2, 2) mesh and ``vocab`` on the (1, 4) mesh: the
  tiny preset with a vocabulary of 510, untied, without remat.  M = 2
  cuts the vocabulary and the 2 kv heads; M = 4 divides neither, so the
  table and the head stay whole (the rule's own fallback), and so do
  ``wk`` / ``wv`` under the 4 ranks' single query heads.

Held: each step's loss within 1e-5 relative of the reference's
``make_train_step`` on the whole batch, and each step's gradient and the
new parameters, the ranks' blocks put together, within 1e-4 normwise a
leaf (``test_torch_train_ranks._hold``'s rule); every rank's whole leaves
the same bits; each rank's blocks of the AdamW moments; the bytes a rank
hands its block all-reduces × 2 and their number equal to ``reckon``'s
``over model`` entries, three passes a step under remat and two without,
and the vocabulary cut's collectives to a count made from the shapes and
to the dry-run's "vocab" entries; the clip's norm the same on every rank
and equal to one process's; the whole leaves read inside a cut unit
summed over the model group; every
kind a rank counts (``ModelShards.model_bytes``, the loss's sums, the
data-parallel gradient) equal to the dry-run's entries of that kind by
the kind's relation (``dryrun.handed``); the rules' cuts and fallbacks;
every refusal of ``--model-ranks``.
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.launch.train import PRESETS as J_PRESETS
from repro.models import transformer as JT
from repro.optim.adamw import AdamW as JAdamW
from repro_torch.configs import get_smoke_config
from repro_torch.configs.base import ShapeConfig, config_from_dict
from repro_torch.launch import dryrun, ranks, train
from repro_torch.launch.mesh import Mesh, virtual_devices
from repro_torch.models import layers as L
from repro_torch.models import sharding as S
from repro_torch.models import transformer as T

import torch_train_ranks as TR
from test_torch_train_ranks import (BATCH, SEQ, TARGET, _batches, _flat,
                                    _hold, _jax_batch, _npz)

TINY = dataclasses.replace(J_PRESETS["tiny"], dtype="float32")
GQA = dataclasses.replace(
    TINY, n_heads=10, n_kv_heads=5, head_dim=8, qkv_bias=True,
    qk_norm=True, tie_embeddings=True, parallel_block=True,
    use_layernorm=True, remat=True)
V510 = dataclasses.replace(TINY, vocab_size=510)
#: name: (the reference's configuration, data ranks, model ranks)
CASES = {"gqa": (GQA, 1, 2), "data": (V510, 2, 2), "vocab": (V510, 1, 4)}
N_STEPS = 3
#: port against port: the f32 sums' order only
PORT_TOL = 1e-5


@pytest.fixture(autouse=True)
def one_thread(monkeypatch):
    monkeypatch.setenv("OMP_NUM_THREADS", "1")          # the ranks' too
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _references(cfg, batch_sets: list) -> list:
    """``test_torch_train_ranks._reference`` over each list of batches in
    ``batch_sets``, from the same parameters, the reference's functions
    jitted once."""
    params = jax.jit(JT.init_params, static_argnums=0)(cfg,
                                                       jax.random.key(0))
    opt = JAdamW(lr=TR.LR, weight_decay=TR.WD)
    step = jax.jit(JT.make_train_step(cfg, opt))
    grad = jax.jit(jax.grad(lambda p, b: JT.make_loss_fn(cfg)(p, b)[0]))
    outs = []
    for batches in batch_sets:
        p, state = params, opt.init(params)
        out = {"init": _flat(params), "loss": [], "ce": [], "aux": [],
               "grads": []}
        for b in batches:
            jb = _jax_batch(b, cfg)
            out["grads"].append(_flat(grad(p, jb)))
            p, state, metrics = step(p, state, jb)
            for name in ("loss", "ce", "aux"):
                out[name].append(float(metrics[name]))
        out["params"] = _flat(p)
        outs.append(out)
    return outs


class _Runs:
    """Each case of ``cases`` (name: (configuration, data ranks, model
    ranks[, the configuration the reference steps, where it differs only
    in what changes no value, as remat])) once a module: the reference on
    the hosts' concatenated batches (the cases of one reference
    configuration in one ``_references``), and ``TR.steps`` over its
    (data, model) grid of gloo ranks from the reference's parameters."""

    def __init__(self, base, cases=None):
        self.base, self.cache, self.refs = base, {}, {}
        self.cases = CASES if cases is None else cases

    def _ref_cfg(self, name: str):
        case = self.cases[name]
        return case[3] if len(case) > 3 else case[0]

    def ref(self, name: str) -> dict:
        if name not in self.refs:
            cfg = self._ref_cfg(name)
            names = [n for n in self.cases if self._ref_cfg(n) is cfg]
            outs = _references(cfg, [_batches(cfg, self.cases[n][1],
                                              N_STEPS) for n in names])
            self.refs.update(zip(names, outs))
        return self.refs[name]

    def __call__(self, name: str):
        if name not in self.cache:
            cfg, hosts, m = self.cases[name][:3]
            ref = self.ref(name)
            where = self.base / name
            where.mkdir()
            np.savez(where / "leaves.npz", **ref["init"])
            kw = dict(cfg=dataclasses.asdict(cfg),
                      leaves=str(where / "leaves.npz"), seq=SEQ,
                      batch=BATCH, n_steps=N_STEPS, hosts=hosts,
                      out=str(where / "out"))
            world = hosts * m
            res = ranks.run(TARGET + "steps", dict(kw, model_ranks=m),
                            world=world, backend="gloo",
                            devices=["cpu"] * world,
                            workdir=str(where / "w"))
            assert res.returncode == 0, res.failed
            arrays = [_npz(where / f"out_{r}.npz") for r in range(world)]
            self.cache[name] = dict(
                cfg=cfg, hosts=hosts, m=m, n_steps=N_STEPS, ref=ref,
                docs=res.docs, arrays=arrays, kw=kw,
                whole=_put_together(res.docs[:m], arrays[:m]))
        return self.cache[name]


def _put_together(docs: list, arrays: list) -> dict:
    """A model group's arrays with each cut leaf's blocks put together
    along its cut dimension (``ModelShards.cuts``), by key."""
    cuts = docs[0]["cuts"]
    out = {}
    for key, x in arrays[0].items():
        path = key.split("/", 1)[1]
        if path in cuts:
            x = np.concatenate([a[key] for a in arrays], cuts[path])
        out[key] = x
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    return _Runs(tmp_path_factory.mktemp("train_tp"))


@pytest.mark.parametrize("name", list(CASES))
def test_model_axis_over_ranks_equals_the_reference_step(runs, name):
    run = runs(name)
    _hold(dict(run, arrays=[run["whole"]]))
    # every data row's model group makes the same step
    for r in range(run["m"], len(run["docs"])):
        assert run["docs"][r]["loss"] == run["docs"][r % run["m"]]["loss"]
    # each rank holds its blocks only, and its blocks of the moments
    m = run["m"]
    for doc, arrays in zip(run["docs"], run["arrays"]):
        for path, dim in doc["cuts"].items():
            whole = run["ref"]["init"][path].shape
            got = arrays[f"p/{path}"].shape
            assert got[dim] * m == whole[dim], path
            assert tuple(doc["moment_shapes"][path]) == got, path


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


def _reckon(run) -> dict:
    """``dryrun.reckon`` of the case's step on its (data, model) mesh, once
    a run."""
    if "report" not in run:
        cfg = config_from_dict(dataclasses.asdict(run["cfg"]))
        shape = (run["hosts"], run["m"])
        run["report"] = dryrun.reckon(
            cfg, ShapeConfig("t", SEQ, BATCH, "train"),
            Mesh(shape, ("data", "model"),
                 virtual_devices(shape[0] * shape[1], dryrun.META)))
    return run["report"]


def _hold_every_kind(run) -> None:
    """Each kind a rank counts a step against the dry-run's entries of
    that kind (``dryrun.handed``: an all-reduce's entry 2 x the buffer
    handed, an all-gather's M x, an all-to-all's 1 x): bytes for every
    kind, the model group's and the data group's, and the number for all
    but the gradients' (a rank sums its leaves in one buffer a type, the
    dry-run has an entry a leaf)."""
    report = _reckon(run)
    for doc in run["docs"]:
        counted = dict(doc["model_bytes"], loss=doc["loss_bytes"])
        calls = dict(doc["model_calls"], loss=doc["loss_all_reduces"])
        assert set(counted) == set(S.MODEL_KINDS) | {"loss"}
        for kind, nbytes in counted.items():
            want_bytes, want_calls = dryrun.handed(report, kind, run["m"])
            assert nbytes == N_STEPS * want_bytes, kind
            if kind != "gradient":
                assert calls[kind] == N_STEPS * want_calls, kind
        assert 2 * doc["gradient_bytes"] == N_STEPS * report[
            "gradient_all_reduce_bytes"]


@pytest.mark.parametrize("name", list(CASES))
def test_block_all_reduces_equal_the_dryrun_model_entries(runs, name):
    """A rank's f and g all-reduces a step: bytes × 2 and their number as
    ``reckon``'s ``over model`` entries (two units a layer, three passes
    under remat, two without); the data group's gradient all-reduce as
    its gradient entries."""
    run = runs(name)
    cfg = run["cfg"]
    report = _reckon(run)
    passes = 3 if cfg.remat else 2
    tokens = BATCH // run["hosts"] * SEQ
    assert report["model_all_reduces"] == 2 * cfg.n_layers * passes
    assert report["model_all_reduce_bytes"] == 2 * (
        report["model_all_reduces"] * tokens * cfg.d_model * 4)
    for doc in run["docs"]:
        assert doc["model_calls"]["block"] == N_STEPS * report[
            "model_all_reduces"]
        assert 2 * doc["model_bytes"]["block"] == N_STEPS * report[
            "model_all_reduce_bytes"]
        if run["hosts"] > 1:
            assert 2 * doc["gradient_bytes"] == N_STEPS * report[
                "gradient_all_reduce_bytes"]
            assert doc["loss_all_reduces"] == N_STEPS
        else:
            assert doc["gradient_bytes"] == doc["loss_all_reduces"] == 0


@pytest.mark.parametrize("name", list(CASES))
def test_the_vocabulary_cuts_collectives_by_hand(runs, name):
    """Where the vocabulary is cut, a step makes the lookup's all-reduce
    (tokens × d in the table's type), the head input's f (tokens × d,
    f32) and, for each sequence chunk, its max and its two sums, each in
    the forward and again in the chunk's recompute; none where it is
    not."""
    run = runs(name)
    cfg = run["cfg"]
    rows = BATCH // run["hosts"]
    tokens = rows * SEQ
    chunks = -(-SEQ // 512)
    cut = cfg.vocab_size % run["m"] == 0
    want_bytes = (tokens * cfg.d_model * 4 * 2
                  + chunks * 2 * (rows * min(SEQ, 512) * 4 * 3))
    want_calls = 2 + chunks * 2 * 2
    for doc in run["docs"]:
        assert ("embed/tok" in doc["cuts"]) == cut
        assert doc["model_bytes"]["vocab"] == (N_STEPS * want_bytes
                                               if cut else 0)
        assert doc["model_calls"]["vocab"] == (N_STEPS * want_calls
                                               if cut else 0)


@pytest.mark.parametrize("name", list(CASES))
def test_the_vocabulary_cuts_collectives_equal_the_dryrun_entries(runs,
                                                                  name):
    """The vocabulary cut's collectives a rank hands a step, x 2 (the
    ring) and in number, equal the dry-run's "vocab" entries; none on
    either side where the vocabulary is whole."""
    run = runs(name)
    report = _reckon(run)
    cut = run["cfg"].vocab_size % run["m"] == 0
    assert (report["vocab_all_reduces"] > 0) == cut
    for doc in run["docs"]:
        assert 2 * doc["model_bytes"]["vocab"] == N_STEPS * report[
            "vocab_all_reduce_bytes"]
        assert doc["model_calls"]["vocab"] == N_STEPS * report[
            "vocab_all_reduces"]


@pytest.mark.parametrize("name", list(CASES))
def test_the_partial_leaves_sums_equal_the_dryrun_entries(runs, name):
    """The bytes a rank hands to sum its partial leaves' gradients over
    the model group a step, x 2, equal the dry-run's "gradient" entries
    over model, one a leaf (the rank sums them in one buffer a type, so
    only the bytes are held)."""
    run = runs(name)
    report = _reckon(run)
    for doc in run["docs"]:
        assert 2 * doc["model_bytes"]["gradient"] == N_STEPS * report[
            "partial_gradient_all_reduce_bytes"]
        assert report["partial_gradient_all_reduces"] == len(doc["partial"])


@pytest.mark.parametrize("name", list(CASES))
def test_every_kind_a_rank_counts_equals_the_dryrun(runs, name):
    _hold_every_kind(runs(name))


def test_whole_leaves_read_in_a_cut_unit_are_summed_over_the_model_group(
        runs):
    """``gqa``'s kv projections stay whole (5 kv heads over 2 ranks) and
    its q/k norms are read by each rank's heads alone: their gradients
    are the rank's heads' share until summed over the model group, one
    buffer a step; ``data``'s 2 kv heads divide over 2 ranks, and its cut
    units read no whole leaf; over 4 they do not."""
    run = runs("gqa")
    unit = "segments/0/0/attn/"
    want = sorted(unit + n for n in ("bk", "bv", "k_norm", "q_norm", "wk",
                                     "wv"))
    for doc in run["docs"]:
        assert doc["partial"] == want
        assert doc["model_calls"]["gradient"] == N_STEPS
        n = sum(run["ref"]["init"][p].size for p in want)
        assert doc["model_bytes"]["gradient"] == N_STEPS * n * 4
    assert runs("data")["docs"][0]["partial"] == []
    assert runs("vocab")["docs"][0]["partial"] == [
        "segments/0/0/attn/wk", "segments/0/0/attn/wv"]


@pytest.mark.parametrize("name", ["gqa", "data"])
def test_the_clip_norm_is_global(runs, name, tmp_path):
    """Every rank clips by the same norm: one process's on the hosts'
    concatenated batches, and the reference's."""
    run = runs(name)
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


def _shards(cfg, world: int, m: int, rank: int = 0) -> S.ModelShards:
    mesh = Mesh.over_ranks((world // m, m), ("data", "model"), rank=rank,
                           rank_devices=["cpu"] * world, model_ranks=m)
    return S.ModelShards(mesh, config_from_dict(dataclasses.asdict(cfg)))


def test_the_reference_rules_decide_the_cuts():
    """The tiny preset over 2 ranks: every attention and MLP leaf cut
    where the rules say (kv heads 2 over 2 divide), the table on V, the
    head on V, the norms whole; rank 1 keeps the second block.  Over 8,
    the 4 heads do not divide: q and o fall back to whole, reported (the
    2 kv heads' rule keeps k and v whole itself), and so the attention
    units are not cut and read no partial leaf."""
    cfg = config_from_dict(dataclasses.asdict(TINY))
    two = _shards(cfg, 2, 2, rank=1)
    unit = "segments/0/0/"
    assert two.cuts == {"embed/tok": 0, "head/w": 1,
                        unit + "attn/wq": 2, unit + "attn/wk": 2,
                        unit + "attn/wv": 2, unit + "attn/wo": 1,
                        unit + "mlp/w_gate": 2, unit + "mlp/w_in": 2,
                        unit + "mlp/w_out": 1}
    assert two.fallbacks == [] and two.partial == set()
    assert two.table_cut and two.head_cut
    assert two.vocab0 == 256 and two.model_block == 1
    params = T.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    held = two.shard(params)
    assert torch.equal(held["embed"]["tok"], params["embed"]["tok"][256:])
    wo = params["segments"][0][0]["attn"]["wo"]
    assert torch.equal(held["segments"][0][0]["attn"]["wo"], wo[:, 2:])
    assert held["final_norm"]["scale"] is params["final_norm"]["scale"]
    eight = _shards(cfg, 8, 8)
    assert sorted(f[0] for f in eight.fallbacks) == [
        unit + "attn/wo", unit + "attn/wq"]
    assert not any("/attn/" in p for p in eight.cuts)
    assert eight.partial == set()


@pytest.mark.parametrize("extra,match", [
    ([], "pass --ranks"),
    (["--ranks", "3"], "pass --ranks"),
    (["--ranks", "2", "--compress-grads"], r"--compress-grads.*A\.8 \(vii\)"),
    (["--ranks", "2", "--line-search", "2"], r"--line-search.*A\.8 \(vii\)"),
    (["--ranks", "2", "--optimizer", "subspace-newton"],
     r"subspace-newton.*A\.8 \(vii\)"),
    (["--ranks", "2", "--fsdp"], r"--fsdp.*A\.8 \(vii\)"),
], ids=["no-ranks", "not-dividing", "compress", "line-search",
        "subspace-newton", "fsdp"])
def test_unsupported_options_are_refused(extra, match):
    argv = ["--device", "cpu", "--preset", "tiny", "--model-ranks",
            "2"] + extra
    with pytest.raises(ValueError, match=match):
        train.main(argv)
    with pytest.raises(ValueError, match=match):
        train.run(argv)


def test_serving_steps_are_refused_over_the_model_axis():
    """Serving over the model axis runs the dense attention decoders
    (``tests/test_torch_serve_tp.py``); the recurrent states wait for
    A.8 (xi), MLA and MoE for A.8 (xii)."""
    dense = config_from_dict(dataclasses.asdict(TINY))
    for make in (T.make_serve_step, T.make_prefill_step):
        make(dense, T.ShardCtx(ranks=_shards(dense, 2, 2)))
    for arch, item in (("rwkv6-7b", r"A\.8 \(xi\)"),
                       ("zamba2-2.7b", r"A\.8 \(xi\)"),
                       ("deepseek-v2-lite-16b", r"A\.8 \(xii\)"),
                       ("llama4-maverick-400b-a17b", r"A\.8 \(xii\)")):
        cfg = get_smoke_config(arch)
        ctx = T.ShardCtx(ranks=_shards(cfg, 2, 2))
        for make in (T.make_serve_step, T.make_prefill_step):
            with pytest.raises(NotImplementedError, match=item):
                make(cfg, ctx)


@pytest.mark.parametrize("m", [2, 4])
def test_head_blocks_sum_to_the_whole_attention(m):
    """A rank's attention over its block of the query heads (from head
    ``head0``), its pad heads masked, makes its share of ``wo``'s
    product: the blocks' products sum to the whole attention's.  6 query
    heads padded to 8 over 2 kv heads (g = 4): over 2 ranks the kv heads
    are cut with the queries, over 4 they stay whole and rank r's heads
    2r, 2r + 1 read kv head 2r // 4."""
    cfg = config_from_dict(dataclasses.asdict(dataclasses.replace(
        TINY, n_heads=6, head_pad_to=8, n_kv_heads=2, head_dim=8)))
    gen = torch.Generator().manual_seed(0)
    p = {name: torch.randn(leaf.shape, generator=gen)
         for name, leaf in L.attention_specs(cfg).items()}
    x = torch.randn(2, 16, cfg.d_model, generator=gen)
    positions = torch.arange(16).expand(2, 16)
    whole, _ = L.attention_block(x, p, cfg, positions)
    hq, kv_cut = cfg.padded_heads // m, cfg.n_kv_heads % m == 0
    total = torch.zeros_like(whole)
    for r in range(m):
        block = dict(p, wq=p["wq"][:, r * hq:(r + 1) * hq],
                     wo=p["wo"][r * hq:(r + 1) * hq])
        if kv_cut:
            n = cfg.n_kv_heads // m
            block.update(wk=p["wk"][:, r * n:(r + 1) * n],
                         wv=p["wv"][:, r * n:(r + 1) * n])
        part, _ = L.attention_block(x, block, cfg, positions, head0=r * hq)
        total += part
    torch.testing.assert_close(total, whole, rtol=1e-5, atol=1e-5)
