"""The serving launcher over the model axis's ranks
(``launch/serve.py --ranks W --model-ranks M``) on the CPU, gloo ranks
forked from the forkserver.

* The reference CLI's defaults on danube's smoke configuration (bf16)
  over 2 ranks: every rank serves the same tokens, all inside the
  vocabulary, with no NaN logit, and rank 0 prints the reference's
  lines.  In bf16 the ranks' logits round otherwise than one process's
  (a row-cut product's partials are rounded before their sum), so a
  sampled token can part from the one-process launcher's; in f32
  (``over_ranks(cfg=)``) every rank serves the one-process launcher's
  tokens.
* Refused before any rank starts, with the ROADMAP item, exit 1:
  deepseek-v2-lite-16b (MLA and MoE, A.8 (xii)), rwkv6-7b and
  zamba2-2.7b (the recurrent states, A.8 (xi)); a model axis not cut
  over the ranks; ``--device cuda`` on a machine without one (never the
  CPU instead).
* A rank that fails (a cache whose rows do not cut into the model
  group's blocks) fails the run, exit 1.
* ``dryrun --ranks N --model-ranks M`` reckons a model cell on the
  (N/M, M) mesh of such a run.
"""
import contextlib
import dataclasses
import io
import json

import pytest
import torch

from repro_torch.configs import get_smoke_config
from repro_torch.launch import dryrun, serve

DANUBE = ["--arch", "h2o-danube-3-4b", "--device", "cpu"]
OVER_2 = ["--ranks", "2", "--model-ranks", "2"]


@pytest.fixture(autouse=True)
def one_thread(monkeypatch):
    monkeypatch.setenv("OMP_NUM_THREADS", "1")          # the ranks' too
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _lines(text: str) -> list:
    return [ln for ln in text.splitlines() if ln.startswith("[serve] req")]


def test_every_rank_serves_the_same_tokens_at_the_cli_defaults():
    res, lead = serve.over_ranks(DANUBE + OVER_2)
    assert res.returncode == 0, res.failed
    first = res.docs[0]
    vocab = get_smoke_config("h2o-danube-3-4b").vocab_size
    assert len(first["outputs"]) == 8
    assert all(len(toks) == 32 and all(0 <= t < vocab for t in toks)
               for toks in first["outputs"].values())
    for doc in res.docs:
        assert doc["outputs"] == first["outputs"]
        assert doc["nan_logits"] == 0 and doc["steps"] == first["steps"]
        assert doc["serve_bytes"]["merge"] > 0
        assert doc["serve_bytes"]["logits"] > 0
    assert lead.splitlines()[0] == ("[serve] h2o-danube-3-4b-smoke: 8 "
                                    "requests, batch=4, over 2 ranks (model "
                                    "axis over 2)")
    assert _lines(lead) == [
        f"[serve] req{rid}: 32 tokens -> {toks[:8]}..."
        for rid, toks in enumerate(first["outputs"].values())]


def test_main_prints_rank_0s_lines(capsys):
    assert serve.main(DANUBE + OVER_2 + ["--requests", "3", "--gen-len",
                                         "4"]) == 0
    out = capsys.readouterr().out
    assert len(_lines(out)) == 3
    assert out.splitlines()[-1].startswith("[serve] ")


def test_in_f32_every_rank_serves_the_one_process_tokens():
    cfg = dataclasses.asdict(dataclasses.replace(
        get_smoke_config("h2o-danube-3-4b"), dtype="float32"))
    res, _ = serve.over_ranks(DANUBE + OVER_2, cfg=cfg)
    assert res.returncode == 0, res.failed
    with contextlib.redirect_stdout(io.StringIO()):
        one = serve.run(DANUBE, cfg=cfg)
    for doc in res.docs:
        assert doc["outputs"] == {str(k): v for k, v in one.outputs.items()}
        assert doc["steps"] == one.steps


@pytest.mark.parametrize("arch, item", [
    ("deepseek-v2-lite-16b", "A.8 (xii)"), ("rwkv6-7b", "A.8 (xi)"),
    ("zamba2-2.7b", "A.8 (xi)")])
def test_the_other_architectures_are_refused(arch, item, capsys):
    argv = ["--arch", arch, "--device", "cpu"] + OVER_2
    assert serve.main(argv) == 1
    err = capsys.readouterr().err
    assert "refused" in err and item in err
    with pytest.raises(NotImplementedError, match=item.replace(
            "(", r"\(").replace(")", r"\)")):
        serve.over_ranks(argv)


@pytest.mark.parametrize("extra, match", [
    (["--ranks", "2"], "--model-ranks M > 1"),
    (["--ranks", "3", "--model-ranks", "2"], "dividing W"),
    (["--arch", "hubert-xlarge"] + OVER_2, "encoder-only")])
def test_a_model_axis_not_cut_over_the_ranks_is_refused(extra, match, capsys):
    assert serve.main(DANUBE + extra) == 1
    assert match in capsys.readouterr().err


def test_no_fallback_to_the_cpu(capsys):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: --device cuda would run")
    assert serve.main(["--arch", "h2o-danube-3-4b"] + OVER_2) == 1
    assert "no CUDA device" in capsys.readouterr().err


def test_a_rank_that_fails_fails_the_run(capsys):
    """qwen2's smoke cache of 127 rows does not cut into 2 blocks: each
    rank raises where it builds its cache, and the run exits 1."""
    argv = ["--arch", "qwen2-72b", "--device", "cpu", "--max-seq", "127",
            "--requests", "1"] + OVER_2
    assert serve.main(argv) == 1
    err = capsys.readouterr().err
    assert "the run over 2 ranks failed" in err and "127" in err


def test_the_dryrun_reckons_a_serving_cell_on_a_runs_mesh(tmp_path):
    """``dryrun --ranks 2 --model-ranks 2`` reckons danube's decode_32k
    cell on the (1, 2) mesh a run over 2 ranks lays out, with the
    serving kinds a rank hands (the logits' gather, the decode's heads
    gather and merges); a model group that does not divide the ranks is
    refused."""
    argv = ["--arch", "h2o-danube-3-4b", "--shape", "decode_32k", "--ranks",
            "2", "--model-ranks", "2", "--out", str(tmp_path)]
    assert dryrun.main(argv) == 0
    with open(tmp_path / "h2o-danube-3-4b__decode_32k__1x2.json") as f:
        report = json.load(f)
    assert report["mesh"] == "1x2" and report["n_chips"] == 2
    assert report["logits_all_gathers"] == 1
    assert report["decode_heads_all_gathers"] == 24
    assert report["decode_merge_all_reduces"] == 48
    assert report["model_all_reduces"] == 48
    with pytest.raises(SystemExit):
        dryrun.main(argv[:4] + ["--ranks", "2", "--model-ranks", "3"])
