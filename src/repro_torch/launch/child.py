"""Command lines of the port run as child processes forked from
``multiprocessing``'s forkserver (``launch/dryrun.py::ServerChildren``,
``chip_smoke.py``'s crash/restart and command-line legs).

The forkserver is an interpreter that imports torch and what the parent
has imported of the port once, and touches no device; each child forked
from it starts with them imported, opens its own CUDA context, and ends
at a SIGKILL as any process does.  A fresh interpreter a child would pay
the import every time: 11.3-12.3 s a child on the H100's host against
2.0 s forked (``main`` below, which times both).  As with any
``multiprocessing`` child, each re-runs the parent's main module, which
must keep its entry point under ``if __name__ == "__main__"``.  ``stop``
ends the forkserver where a caller must leave no process behind.
"""
from __future__ import annotations

import importlib
import multiprocessing
import os
import subprocess
import sys
import tempfile


def _body(module: str, argv: list, env: dict, out_path: str,
          err_path: str) -> None:
    """``python -m <module> <argv>`` in this process: the parent's
    environment ``env``, stdout into ``out_path`` and stderr into
    ``err_path``; the process exits with ``main``'s code."""
    with open(out_path, "w") as out, open(err_path, "w") as err:
        os.dup2(out.fileno(), 1)
        os.dup2(err.fileno(), 2)
    os.environ.clear()
    os.environ.update(env)
    if env.get("OMP_NUM_THREADS"):
        import torch
        torch.set_num_threads(int(env["OMP_NUM_THREADS"]))
    sys.exit(importlib.import_module(module).main(argv) or 0)


#: what the forkserver imports beside the port: torch, and the module
#: ``torch.use_deterministic_algorithms`` imports at its first call
#: (inductor's config, which brings in dynamo), which every training child
#: makes (``launch/train.py``): 2–3 s a child on an 8-core CPU host, ~7 s
#: on an H100's host
PRELOAD = ("torch", "torch._inductor.config")


def _context():
    """The forkserver's context, its preload set from this process's
    modules (what the server imports when it starts: ``PRELOAD``, this
    module and the port's modules this process has, but its main module,
    which each child runs as ``__mp_main__``)."""
    main = getattr(sys.modules["__main__"].__spec__, "name", None)
    ctx = multiprocessing.get_context("forkserver")
    ctx.set_forkserver_preload(sorted(
        ({*PRELOAD, "repro_torch.launch.child"}
         | {m for m in sys.modules if m.startswith("repro_torch.")})
        - {main}))
    return ctx


def warm() -> None:
    """Start the forkserver now, so that its imports overlap the caller's
    work (a no-op once it runs)."""
    _context()
    from multiprocessing import forkserver
    forkserver.ensure_running()


def stop() -> None:
    """Stop the forkserver and the resource tracker ``multiprocessing``
    started beside it, and wait for both to end (each would end on its
    own once this process exits, a moment later; a no-op if neither
    runs)."""
    from multiprocessing import forkserver, resource_tracker
    forkserver._forkserver._stop()
    resource_tracker._resource_tracker._stop()


def start(module: str, argv: list, env: dict, out_path: str = os.devnull,
          err_path: str = os.devnull, name: str = None):
    """Fork ``python -m <module> <argv>`` (``_body``) and return its
    started ``multiprocessing`` process."""
    proc = _context().Process(target=_body, name=name,
                              args=(module, list(argv), dict(env), out_path,
                                    err_path))
    proc.start()
    return proc


def run(module: str, argv: list, env: dict,
        timeout: float = 600) -> subprocess.CompletedProcess:
    """``start`` and wait: its exit code, stdout and stderr, as
    ``subprocess.run(..., capture_output=True, text=True)`` gives them
    (a child past ``timeout`` is killed and returns -9)."""
    with tempfile.TemporaryDirectory(prefix="child_") as tmp:
        out, err = os.path.join(tmp, "out"), os.path.join(tmp, "err")
        proc = start(module, argv, env, out, err)
        proc.join(timeout)
        if proc.is_alive():
            proc.kill()
            proc.join()
        with open(out) as f, open(err) as g:
            return subprocess.CompletedProcess(
                [sys.executable, "-m", module, *argv], proc.exitcode,
                f.read(), g.read())


def main(argv=None) -> int:
    """Time one child's start both ways on ``--device``: the seeded smoke
    server (``server/sim.py`` at the obs smoke's size) as a fresh
    interpreter, ``python -m repro_torch.server.sim``, and forked (the
    first fork also starts the forkserver).  Prints one JSON line of
    seconds.

        python -m repro_torch.launch.child [--device cpu] [--repeats 2]
    """
    import argparse
    import json
    import time

    from repro_torch.launch import dryrun

    ap = argparse.ArgumentParser(description=main.__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--repeats", type=int, default=2)
    args = ap.parse_args(argv)
    kids = dryrun.ServerChildren("child_start_", args.device,
                                 dryrun._spec_args(48, 12, 3, 200))
    try:
        fresh = []
        for i in range(args.repeats):
            t0 = time.perf_counter()
            subprocess.run(
                [sys.executable, "-m", dryrun.SIM_MODULE,
                 *kids.argv(["--out", kids.path(f"fresh_{i}.json")])],
                env=kids.env, check=True, capture_output=True)
            fresh.append(round(time.perf_counter() - t0, 3))
        for i in range(args.repeats + 1):
            kids.run(f"forked_{i}", [])
    finally:
        kids.close()
    forked = [kids.walls[f"forked_{i}"] for i in range(args.repeats + 1)]
    print(json.dumps({"device": kids.device, "fresh_interpreter_s": fresh,
                      "forked_s": forked[1:],
                      "first_fork_with_server_start_s": forked[0]}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
