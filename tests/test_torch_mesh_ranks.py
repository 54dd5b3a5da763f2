"""``Mesh.over_ranks`` with the model axis cut over the ranks too
(``model_ranks``), and its default of 1 unchanged.

The W ranks form a (W/M, M) grid: rank r holds data block r // M and
model block r % M, so a model group is M adjacent ranks
(``launch/train.py --ranks W --model-ranks M``).  Held:

* each rank's ``local_positions()`` is its data block × model block, on
  the training mesh (W/M, M) and on the production (16, 16) mesh, and
  every position's device is its owner's;
* an M that does not divide W, a model axis that M does not divide, a
  mesh with no model axis and a data axis that W/M does not divide are
  refused;
* with M = 1 every rank holds its data block and the whole model axis,
  as before;
* an evaluation backend takes a mesh whose model axis spans ranks once
  it carries its model and data groups (``RankGroup.mesh``), and refuses
  one without them.
"""
import numpy as np
import pytest
import torch

from repro_torch.launch.mesh import Mesh

DEVICES = ["cpu"] * 4


def _grid(shape, world, model_ranks, rank=0, devices=None):
    return Mesh.over_ranks(shape, ("data", "model"), rank=rank,
                           rank_devices=devices or ["cpu"] * world,
                           model_ranks=model_ranks)


@pytest.mark.parametrize("world,model_ranks", [(2, 2), (4, 2), (4, 4)])
def test_each_rank_holds_its_data_and_model_block(world, model_ranks):
    m = model_ranks
    for rank in range(world):
        mesh = _grid((world // m, m), world, m, rank)
        assert mesh.local_positions() == [(rank // m, rank % m)]
        assert (mesh.world, mesh.data_ranks, mesh.model_ranks) == (
            world, world // m, m)


def test_blocks_of_the_production_mesh():
    """(16, 16) over 4 ranks in model groups of 2: rank r holds data rows
    [8·(r // 2), +8) and model columns [8·(r % 2), +8), each position
    on its owner's device."""
    devices = [torch.device("cpu"), torch.device("meta"),
               torch.device("cpu"), torch.device("meta")]
    seen = set()
    for rank in range(4):
        mesh = _grid((16, 16), 4, 2, rank, devices)
        held = mesh.local_positions()
        rows = range(8 * (rank // 2), 8 * (rank // 2) + 8)
        cols = range(8 * (rank % 2), 8 * (rank % 2) + 8)
        assert held == [(i, j) for i in rows for j in cols]
        assert not seen & set(held)
        seen |= set(held)
        assert all(mesh.devices[c] == devices[rank] for c in held)
    assert len(seen) == 256


@pytest.mark.parametrize("shape,world,model_ranks,match", [
    ((1, 3), 4, 3, "do not divide into model groups"),
    ((2, 3), 4, 2, "model axis of 3 does not divide"),
    ((3, 2), 4, 2, "data axis of 3 does not divide"),
    ((1, 2), 2, 0, "do not divide into model groups"),
], ids=["m-not-dividing-w", "model-axis", "data-axis", "zero"])
def test_a_bad_model_rank_count_is_refused(shape, world, model_ranks, match):
    with pytest.raises(ValueError, match=match):
        _grid(shape, world, model_ranks)


def test_a_mesh_without_a_model_axis_is_refused():
    with pytest.raises(ValueError, match="no 'model' axis"):
        Mesh.over_ranks((2,), ("data",), rank=0, rank_devices=DEVICES[:2],
                        model_ranks=2)


@pytest.mark.parametrize("world", [1, 2, 4])
def test_one_model_rank_keeps_every_result(world):
    """The default: rank r holds data block r and the whole model axis,
    the devices and the repr as a mesh over the data axis alone."""
    for rank in range(world):
        mesh = Mesh.over_ranks((16, 16), ("data", "model"), rank=rank,
                               rank_devices=["cpu"] * world)
        block = 16 // world
        assert mesh.local_positions() == [
            (i, j) for i in range(rank * block, rank * block + block)
            for j in range(16)]
        assert mesh.model_ranks == 1 and mesh.data_ranks == world
        assert mesh.data_group is None and mesh.model_group is None
        owners = np.indices((16, 16))[0] // block
        assert mesh.devices.shape == owners.shape
        assert repr(mesh) == (f"Mesh(data=16, model=16; rank {rank} of "
                              f"{world}; {', '.join(['cpu'] * world)})")


@pytest.mark.parametrize("world,model_ranks", [(2, 2), (4, 2)])
def test_an_evaluation_backend_takes_the_model_axis_over_ranks_with_groups(
        world, model_ranks):
    mesh = _grid((world // model_ranks, model_ranks), world, model_ranks)
    assert f"model over {model_ranks}" in repr(mesh)
    with pytest.raises(ValueError, match=r"RankGroup\.mesh\(model_ranks=\)"):
        mesh.require_one_device("cpu")
    mesh.model_group, mesh.data_group = object(), object()
    assert mesh.require_one_device("cpu") == torch.device("cpu")
