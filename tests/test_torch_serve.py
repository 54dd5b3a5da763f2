"""The port's serving loop (``launch/serve.py``) against the reference's.

* Greedy parity: the reference's ``serve.main`` runs with its sampler
  patched to argmax, its smoke config in f32 and its parameters captured;
  the port's loop over those parameters (carried across by
  ``params_from_leaves``) prints the same tokens for every request.
* ``sample_logits`` draws only from the top k (ties at the k-th value
  kept), from a ``torch.Generator``, the same twice from one seed.
* The slot-reuse fault both packages share (ROADMAP.md C): a request
  admitted into a finished request's slot reads that request's cache
  rows and starts at the loop's global position, so its logits differ
  from the same request served alone; the port's equal the reference's.
* An encoder-only architecture is refused.
"""
import dataclasses
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.launch.serve as jserve
from repro.configs import get_smoke_config as ref_smoke
from repro_torch.configs import config_from_dict, get_smoke_config
from repro_torch.launch import serve as pserve
from repro_torch.models import transformer as T


def ref_leaves(params) -> dict:
    """{leaf path: f32 numpy} of a reference parameter pytree."""
    return {"/".join(str(getattr(e, "key", getattr(e, "idx", e)))
                     for e in kp): np.asarray(x, np.float32)
            for kp, x in jax.tree_util.tree_leaves_with_path(params)}


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _run_reference(monkeypatch, capsys, argv, queue=None):
    """The reference's ``serve.main(argv)`` with argmax sampling over f32
    parameters; returns (printed lines, f32 config, parameters, the logits
    its sampler saw per step).  ``queue``: prompts to serve in place of
    the ones its seeded rng would draw."""
    seen = {}
    logits_seen = []
    init = jserve.init_params

    def f32_smoke(name):
        return dataclasses.replace(ref_smoke(name), dtype="float32")

    def capture_init(cfg, key):
        seen["cfg"], seen["params"] = cfg, init(cfg, key)
        return seen["params"]

    def argmax(key, logits, temperature=1.0, top_k=40):
        logits_seen.append(np.asarray(logits, np.float32))
        return jnp.argmax(logits, axis=-1)

    monkeypatch.setattr(jserve, "init_params", capture_init)
    monkeypatch.setattr(jserve, "get_smoke_config", f32_smoke)
    monkeypatch.setattr(jserve, "sample_logits", argmax)
    if queue is not None:
        prompts = list(queue)
        fake_rng = types.SimpleNamespace(
            integers=lambda lo, hi, n: prompts.pop(0))
        monkeypatch.setattr(jserve, "np", types.SimpleNamespace(
            random=types.SimpleNamespace(default_rng=lambda seed: fake_rng),
            int32=np.int32, zeros=np.zeros, asarray=np.asarray))
    capsys.readouterr()
    assert jserve.main(argv) == 0
    lines = capsys.readouterr().out.splitlines()
    return lines, seen["cfg"], seen["params"], logits_seen


def _port(cfg, params):
    pcfg = config_from_dict(dataclasses.asdict(cfg))
    return pcfg, T.params_from_leaves(pcfg, ref_leaves(params), device="cpu")


def _argmax_recorder(seen):
    def sampler(logits):
        seen.append(logits.float().numpy().copy())
        return torch.argmax(logits, dim=-1)
    return sampler


@pytest.mark.parametrize("arch", ["qwen2-72b", "rwkv6-7b"])
def test_greedy_serving_prints_the_reference_s_tokens(arch, monkeypatch,
                                                      capsys):
    argv = ["--arch", arch, "--requests", "8", "--batch", "4", "--seed", "3"]
    lines, cfg, params, _ = _run_reference(monkeypatch, capsys, argv)
    pcfg, pparams = _port(cfg, params)
    rng = np.random.default_rng(3)             # the reference's prompts
    queue = [rng.integers(1, cfg.vocab_size, 16).astype(np.int32)
             for _ in range(8)]
    res = pserve.serve(pparams, pcfg, queue, lambda lg: torch.argmax(lg, -1),
                       batch=4, gen_len=32, max_seq=128)
    want = [ln for ln in lines if ln.startswith("[serve] req")]
    got = pserve.report(res, 4)
    assert len(want) == 8
    assert got[:-1] == want
    assert all(len(toks) == 32 for toks in res.outputs.values())
    steps = int(lines[-1].split()[1])
    assert res.steps == steps == 94              # two waves of 47 steps


def test_sample_logits_draws_from_the_top_k_with_ties_kept():
    logits = torch.full((4096, 10), -3.0)
    logits[:, 0] = 5.0
    logits[:, 1:4] = 4.0                       # three tied at the 2nd value
    gen = torch.Generator().manual_seed(0)
    ids = pserve.sample_logits(logits, gen, top_k=2)
    assert ids.shape == (4096,)
    assert set(ids.tolist()) == {0, 1, 2, 3}
    again = pserve.sample_logits(logits, torch.Generator().manual_seed(0),
                                 top_k=2)
    assert torch.equal(ids, again)
    other = pserve.sample_logits(logits, torch.Generator().manual_seed(1),
                                 top_k=2)
    assert not torch.equal(ids, other)
    # with no cut and a low temperature the draw is the argmax
    cold = pserve.sample_logits(logits, gen, temperature=1e-3, top_k=0)
    assert set(cold.tolist()) == {0}
    # frequencies follow softmax over the kept ids: e / (e + 3) for id 0
    p0 = float(np.e / (np.e + 3))
    assert abs(float((ids == 0).float().mean()) - p0) < 0.03


def test_a_reused_slot_reads_its_predecessor_in_both_packages(monkeypatch,
                                                              capsys):
    """Batch 1, two requests: the second takes the first's slot at step 7
    (4 prompt + 4 generated - 1), its first step at t = 7 over a cache
    still holding the first's rows.  Served alone it starts at t = 0 on
    an empty cache.  Its logits differ, in the reference and in the port
    alike (and the port's equal the reference's in both runs)."""
    cfg = dataclasses.replace(ref_smoke("qwen2-72b"), dtype="float32")
    rng = np.random.default_rng(12)
    p0, p1 = (rng.integers(1, cfg.vocab_size, 4).astype(np.int32)
              for _ in range(2))
    argv = ["--arch", "qwen2-72b", "--batch", "1", "--prompt-len", "4",
            "--gen-len", "4", "--max-seq", "32", "--seed", "0"]
    _, _, params, ref_both = _run_reference(
        monkeypatch, capsys, argv + ["--requests", "2"], queue=[p0, p1])
    _, _, _, ref_alone = _run_reference(
        monkeypatch, capsys, argv + ["--requests", "1"], queue=[p1])
    pcfg, pparams = _port(cfg, params)
    port_both, port_alone = [], []
    for queue, seen in (([p0, p1], port_both), ([p1], port_alone)):
        pserve.serve(pparams, pcfg, queue, _argmax_recorder(seen), batch=1,
                     gen_len=4, max_seq=32)
    assert len(ref_both) == len(port_both) == 14
    assert len(ref_alone) == len(port_alone) == 7
    for both, alone in ((ref_both, ref_alone), (port_both, port_alone)):
        reused = np.stack(both[7:])              # the second request's steps
        assert np.max(np.abs(reused - np.stack(alone))) > 1e-2
    for mine, theirs in ((port_both, ref_both), (port_alone, ref_alone)):
        np.testing.assert_allclose(np.stack(mine), np.stack(theirs)[:, :],
                                   rtol=1e-4, atol=1e-4)


def test_the_encoder_is_refused(monkeypatch, capsys):
    assert pserve.main(["--arch", "hubert-xlarge", "--device", "cpu"]) == 1
    assert "encoder-only" in capsys.readouterr().err
    assert jserve.main(["--arch", "hubert-xlarge"]) == 1
    cfg = get_smoke_config("hubert-xlarge")
    params = T.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    with pytest.raises(ValueError, match="encoder"):
        pserve.serve(params, cfg, [np.ones(4, np.int32)],
                     lambda lg: lg.argmax(-1), batch=1, gen_len=2, max_seq=8)


def test_serve_cli_on_the_cpu(capsys):
    assert pserve.main(["--device", "cpu", "--requests", "3", "--batch",
                        "2", "--gen-len", "5", "--prompt-len", "3"]) == 0
    out = capsys.readouterr().out.splitlines()
    assert out[0] == "[serve] qwen2-72b-smoke: 3 requests, batch=2"
    for rid in range(3):
        assert out[1 + rid].startswith(f"[serve] req{rid}: 5 tokens -> ")
        toks = eval(out[1 + rid].split("-> ")[1].rstrip("."))
        assert all(0 <= tok < 512 for tok in toks)
