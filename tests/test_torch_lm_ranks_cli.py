"""The dry-run's ``--substrate lm_subspace --ranks 2`` on the CPU.

The lm_subspace runner at its defaults (rwkv6's smoke config on the
virtual 16 × 16 mesh) with gate 1's leg over 2 gloo ranks: every rank
builds the workload from its seed (``dryrun.lm_grid_rank``), holds the
mesh's data axis cut in two (8 of the 16 data positions), and commits the
pod leg's iterates and engine stats; the two ranks score the pod leg's
lanes between them.
"""
import json

import pytest
import torch

from repro_torch.launch import dryrun


@pytest.fixture(autouse=True)
def one_thread(monkeypatch):
    monkeypatch.setenv("OMP_NUM_THREADS", "1")          # the ranks' too
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_the_dryrun_lm_subspace_smoke_over_two_ranks(tmp_path):
    code = dryrun.main(["--substrate", "lm_subspace", "--ranks", "2",
                        "--device", "cpu", "--out", str(tmp_path)])
    assert code == 0
    report = json.loads(
        (tmp_path / "substrate_lm_subspace.json").read_text())
    assert report["grid"]["pod_parity_ok"] and report["ranks_parity_ok"]
    assert report["ranks"] == 2 and report["dist_backend"] == "gloo"
    assert report["ranks_returncode"] == 0 and report["ranks_failed"] is None
    per = report["per_rank"]
    assert [r["device"] for r in per] == ["cpu", "cpu"]
    assert [r["data_shards"] for r in per] == [8, 8]
    assert all(r["n_layers"] == report["n_layers"] for r in per)
    assert all(r["new_shapes_after_warm"] == 0 for r in per)
    # the ranks split the pod leg's lanes evenly
    assert per[0]["lanes"] == per[1]["lanes"] > 0
