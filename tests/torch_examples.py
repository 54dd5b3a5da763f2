"""Helpers of the example launchers' tests (``tests/test_torch_examples_
*.py``): each reference example is loaded from ``examples/`` as written,
and what it builds is caught by wrapping the names it imported."""
import importlib.util
import os
import sys

import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def load_example(name: str):
    """``examples/<name>.py`` as a fresh module (its ``main`` not run)."""
    path = os.path.join(ROOT, "examples", f"{name}.py")
    spec = importlib.util.spec_from_file_location(f"_example_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def run_example(mod, argv=()):
    """``mod.main()`` with ``sys.argv`` set to the example's name and
    ``argv``; returns what ``main`` returns."""
    saved = sys.argv
    sys.argv = [mod.__file__, *argv]
    try:
        return mod.main()
    finally:
        sys.argv = saved


def recording(cls, runs: list):
    """A subclass of ``cls`` whose ``run`` appends (constructor kwargs,
    run result) to ``runs``."""
    class Recording(cls):
        def __init__(self, *args, **kw):
            super().__init__(*args, **kw)
            self._kw = kw

        def run(self, *args, **kw):
            res = super().run(*args, **kw)
            runs.append((self._kw, res))
            return res
    return Recording


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One torch thread for the module: the tests run beside others in
    parallel workers, where torch's own threads would oversubscribe the
    cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
