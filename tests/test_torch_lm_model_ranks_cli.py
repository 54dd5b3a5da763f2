"""The dry-run's ``--substrate lm_subspace --ranks 4 --model-ranks 2`` on
the CPU.

The lm_subspace runner at its defaults (rwkv6's smoke config on the
virtual 16 × 16 mesh) with gate 1's leg over 4 gloo ranks in a (2, 2)
grid: each rank builds the workload from its seed
(``dryrun.lm_grid_rank``), holds 8 × 8 of the mesh's positions, keeps
half of each leaf cut over ``model`` and gathers it over its model group
before each bucket, and commits the pod leg's iterates and engine stats
with the chart counts ``dryrun.chart_counts`` reckons; the two ranks of
a model group score the same lanes.
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


def test_the_dryrun_lm_subspace_smoke_over_a_two_by_two_grid(tmp_path):
    code = dryrun.main(["--substrate", "lm_subspace", "--ranks", "4",
                        "--model-ranks", "2", "--device", "cpu", "--out",
                        str(tmp_path)])
    assert code == 0
    report = json.loads(
        (tmp_path / "substrate_lm_subspace.json").read_text())
    assert report["grid"]["pod_parity_ok"] and report["ranks_parity_ok"]
    assert report["ranks_counts_ok"] and report["model_ranks"] == 2
    assert report["ranks"] == 4 and report["ranks_failed"] is None
    per = report["per_rank"]
    assert [(r["data_block"], r["model_block"]) for r in per] == [
        (0, 0), (0, 1), (1, 0), (1, 1)]
    assert [r["data_shards"] for r in per] == [8] * 4
    assert all(r["chart_freed"] and r["new_shapes_after_warm"] == 0
               for r in per)
    assert len({r["stored_bytes"] for r in per}) == 1
    assert all(r["model_gathers"] > 0 for r in per)
    # both data blocks score the same number of lanes, and so do the two
    # ranks of a model group
    assert len({r["lanes"] for r in per}) == 1 and per[0]["lanes"] > 0
