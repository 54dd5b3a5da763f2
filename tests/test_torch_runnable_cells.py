"""``configs.runnable_cells``: the port's (arch, shape, runnable, reason)
for every cell of the architectures × ``SHAPES`` matrix equals the
reference's (``repro/configs/__init__.py``), tuple for tuple and in
order."""
from repro.configs import runnable_cells as j_runnable_cells
from repro_torch.configs import ARCH_NAMES, SHAPES, runnable_cells


def test_runnable_cells_equal_the_reference():
    got, want = list(runnable_cells()), list(j_runnable_cells())
    assert len(got) == len(ARCH_NAMES) * len(SHAPES) == 40
    assert got == want
    assert any(not ok for _, _, ok, _ in got)          # some are skipped
    assert all(bool(reason) != ok for _, _, ok, reason in got)
