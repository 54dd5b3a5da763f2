"""Serving over the model axis across ranks (``sharding.tp_ctx`` with each
rank's block of the caches, ``ModelShards.init_cache``; the serving steps
of ``models/transformer.py``), on the CPU with gloo ranks in f32 (rank
bodies in ``tests/torch_serve_ranks.py``), against one process of the
port and the reference's one-device ``make_serve_step`` /
``make_prefill_step`` from the same parameters.

The dense attention decoders' smoke configurations, one case each:

* ``ring``: h2o-danube-3-4b's sliding window, a ring of 16 rows cut 8 a
  rank over (1, 2), 40 decode steps: past its wrap, twice;
* ``batch1``: deepseek-coder-33b at batch 1, whose cache's rows
  ``cache_specs`` cuts over every axis;
* ``int8``: qwen2-72b with ``quantized_cache`` (int8 rows and their
  scales cut with them);
* ``parallel``: command-r-plus-104b's parallel block, LayerNorm and tied
  embeddings (the head is the table's block);
* ``kv_whole``: chameleon-34b's q/k norms with 6 query heads over 3 kv
  heads, which 2 ranks do not divide: ``wk`` / ``wv`` stay whole, every
  rank makes the new k/v row, and one writes it;
* ``data`` and ``data_batch1``: danube over 4 ranks on (2, 2): at batch
  2 each data rank holds its row (its cache's rows over model), at batch
  1 both hold the row and its cache's rows are cut over all 4 ranks.

In every case each decode step up to the first row of rank 1's block
finds no row to read in that block.  Held: each rank's decode logits,
step by step, and its prefill logits within 1e-5 of one process of the
port and within 1e-4 of the reference (max |err| / max |ref|); every
rank the same bits; each rank's block of the caches as ``cache_specs``
lays it out; and every kind of collective a rank hands in a decode step
and in the prefill equal to the dry-run's entries of that kind on the
same mesh (``dryrun.handed``).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as ref_smoke
from repro.models import transformer as JT
from repro_torch.configs import ShapeConfig, config_from_dict
from repro_torch.launch import dryrun, ranks
from repro_torch.models import sharding as S

import torch_serve_ranks as SR

TARGET = "torch_serve_ranks:probes"
#: name: (arch, fields of its smoke configuration, batch, decode steps,
#: max_seq, ranks, model ranks)
CASES = {
    "ring": ("h2o-danube-3-4b", (), 2, 40, 48, 2, 2),
    "batch1": ("deepseek-coder-33b", (), 1, 20, 32, 2, 2),
    "int8": ("qwen2-72b", (("quantized_cache", True),), 2, 20, 32, 2, 2),
    "parallel": ("command-r-plus-104b", (), 2, 20, 32, 2, 2),
    "kv_whole": ("chameleon-34b", (("n_heads", 6), ("n_kv_heads", 3),
                                   ("head_dim", 16)), 2, 20, 32, 2, 2),
    "data": ("h2o-danube-3-4b", (), 2, 24, 48, 4, 2),
    "data_batch1": ("h2o-danube-3-4b", (), 1, 24, 48, 4, 2),
}
#: port against port: the f32 sums' order only; against the reference,
#: the port's usual f32 tolerance
PORT_TOL, REF_TOL = 1e-5, 1e-4


@pytest.fixture(autouse=True)
def one_thread(monkeypatch):
    monkeypatch.setenv("OMP_NUM_THREADS", "1")          # the ranks' too
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _path(kp) -> str:
    return "/".join(str(getattr(e, "key", getattr(e, "idx", e))) for e in kp)


def _rel(got, want) -> float:
    return float(np.max(np.abs(got - want)) / np.max(np.abs(want)))


class _Reference:
    """The reference's configuration, parameters and jitted steps, one a
    configuration, shared by its cases."""

    def __init__(self, arch: str, fields: tuple):
        self.cfg = dataclasses.replace(ref_smoke(arch), dtype="float32",
                                       **dict(fields))
        self.params = jax.jit(JT.init_params, static_argnums=0)(
            self.cfg, jax.random.key(0))
        self.step = jax.jit(JT.make_serve_step(self.cfg))
        self.prefill = jax.jit(JT.make_prefill_step(self.cfg))

    def leaves(self) -> dict:
        return {_path(kp): np.asarray(x, np.float32) for kp, x in
                jax.tree_util.tree_leaves_with_path(self.params)}

    def logits(self, tokens: np.ndarray, decode_len: int,
               max_seq: int) -> dict:
        cache = JT.init_cache(self.cfg, tokens.shape[0], max_seq)
        outs = []
        for t in range(decode_len):
            logits, cache = self.step(self.params, cache,
                                      jnp.asarray(tokens[:, t:t + 1]),
                                      jnp.int32(t))
            outs.append(np.asarray(logits, np.float32))
        return {"decode": np.concatenate(outs, axis=1),
                "prefill": np.asarray(self.prefill(
                    self.params, {"tokens": jnp.asarray(tokens)}),
                    np.float32)}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Every case: the reference's and one process's logits, and over its
    ranks (one run of the 2-rank cases, one of the 4-rank ones) each
    rank's logits and docs."""
    base = tmp_path_factory.mktemp("serve_tp")
    refs, kw, out = {}, {}, {}
    for name, (arch, fields, b, steps, max_seq, world, m) in CASES.items():
        if (arch, fields) not in refs:
            ref = refs[arch, fields] = _Reference(arch, fields)
            np.savez(base / f"{arch}{len(refs)}.npz", **ref.leaves())
            ref.path = str(base / f"{arch}{len(refs)}.npz")
        ref = refs[arch, fields]
        tokens = np.random.default_rng(len(out)).integers(
            0, ref.cfg.vocab_size, (b, steps)).astype(np.int32)
        np.save(base / f"{name}.npy", tokens)
        case = dict(cfg=dataclasses.asdict(ref.cfg), leaves=ref.path,
                    tokens=str(base / f"{name}.npy"), decode_len=steps,
                    max_seq=max_seq, model_ranks=m,
                    out=str(base / f"{name}_{{rank}}_{{phase}}.npy"))
        kw.setdefault(world, {})[name] = case
        out[name] = dict(case=case, world=world, b=b,
                         cfg=config_from_dict(case["cfg"]),
                         ref=ref.logits(tokens, steps, max_seq),
                         one=SR.one_process(case))
    for world, cases in kw.items():
        res = ranks.run(TARGET, {"cases": cases}, world=world,
                        backend="gloo", devices=["cpu"] * world,
                        workdir=str(base / f"w{world}"))
        assert res.returncode == 0, res.failed
        for name, case in cases.items():
            out[name]["docs"] = [doc[name] for doc in res.docs]
            out[name]["logits"] = [
                {phase: np.load(case["out"].format(rank=r, phase=phase))
                 for phase in ("prefill", "decode")} for r in range(world)]
    return out


@pytest.mark.parametrize("phase", ["decode", "prefill"])
@pytest.mark.parametrize("name", list(CASES))
def test_each_rank_equals_one_process_and_the_reference(runs, name, phase):
    run = runs[name]
    for got in run["logits"]:
        assert got[phase].shape == run["ref"][phase].shape
        assert np.isfinite(got[phase]).all()
        assert _rel(got[phase], run["one"][phase]) <= PORT_TOL
        assert _rel(got[phase], run["ref"][phase]) <= REF_TOL


@pytest.mark.parametrize("name", list(CASES))
def test_every_rank_returns_the_same_bits(runs, name):
    first = runs[name]["logits"][0]
    for other in runs[name]["logits"][1:]:
        for phase, x in first.items():
            assert np.array_equal(x, other[phase]), phase


@pytest.mark.parametrize("name", list(CASES))
def test_each_rank_holds_its_block_of_the_caches(runs, name):
    """The k/v rows (a ring's ``min(max_seq, window)``) cut over the
    ranks ``cache_specs`` names: over model where the batch's rows divide
    the data axis (each data rank its rows), else over every axis; the
    blocks in rank order."""
    run, (_, _, b, _, max_seq, world, m) = runs[name], CASES[name]
    cfg = run["cfg"]
    spec = [sp for path, sp in S.spec_leaves(S.cache_specs(
        cfg, ShapeConfig("d", max_seq, b, "decode"), dryrun.rank_cell_mesh(world, m)))
        if path.endswith("/k")][0]
    rows = min(max_seq, cfg.sliding_window) if cfg.sliding_window \
        else max_seq
    over_all = b == 1 or world == m
    blocks = world if b == 1 else m
    assert (spec[-3] == ("data", "model")) == (b == 1)
    docs = [doc["decode"] for doc in run["docs"]]
    for r, doc in enumerate(docs):
        assert doc["seq_blocks"] == blocks
        assert doc["cache_rows"][-3] == rows // blocks
        assert doc["rows_cut"] == (not over_all)
        assert doc["cache_rows"][-4] == (b if over_all else b // (world // m))
        assert doc["seq_block"] == (r if b == 1 else r % m)


@pytest.mark.parametrize("name", ["ring", "int8", "data_batch1"])
def test_a_block_with_no_row_to_read_yet_adds_nothing(runs, name):
    """Before step t reaches the first row of the last block (8, 16 and 12
    rows in), that block's rank holds no row to read: its partial is
    zero (no NaN from a max over nothing), and the merged logits of those
    steps equal one process and the reference."""
    run = runs[name]
    first = run["docs"][-1]["decode"]
    row0 = first["seq_block"] * first["cache_rows"][-3]
    steps = CASES[name][3]
    assert 0 < row0 < steps
    for got in run["logits"]:
        early = got["decode"][:, :row0]
        assert np.isfinite(early).all()
        assert _rel(early, run["one"]["decode"][:, :row0]) <= PORT_TOL
        assert _rel(early, run["ref"]["decode"][:, :row0]) <= REF_TOL


@pytest.mark.parametrize("phase", ["decode", "prefill"])
@pytest.mark.parametrize("name", list(CASES))
def test_the_handed_bytes_equal_the_dryrun_entries(runs, name, phase):
    """Every kind a rank hands its collectives in one decode step (the
    first; the decode's total is as many steps' worth) and in the
    prefill, bytes and calls, against ``dryrun.reckon``'s entries of that
    kind for the cell on the same mesh by ``dryrun.handed``'s relation;
    the serving kinds at work where the mesh cuts them."""
    run, (_, _, b, steps, max_seq, world, m) = runs[name], CASES[name]
    shape = (ShapeConfig("d", max_seq, b, "decode") if phase == "decode"
             else ShapeConfig("p", steps, b, "prefill"))
    report = dryrun.reckon(run["cfg"], shape, dryrun.rank_cell_mesh(world, m))
    for doc in run["docs"]:
        counted = (doc["decode"]["first_step"] if phase == "decode"
                   else doc["prefill"])
        for kind in S.MODEL_KINDS:
            want_bytes, want_calls = dryrun.handed(report, kind, m)
            assert counted["bytes"][kind] == want_bytes, kind
            assert counted["calls"][kind] == want_calls, kind
        if phase == "decode":
            assert {k: steps * v for k, v in counted["bytes"].items()} == \
                doc[phase]["bytes"]
    assert report["logits_all_gathers"] == 1
    assert report["model_all_reduces"] == 2 * run["cfg"].n_layers
    if phase == "decode":
        assert report["decode_merge_all_reduces"] == 2 * run["cfg"].n_layers
        assert report["decode_heads_all_gathers"] == run["cfg"].n_layers
