"""Serve a small model with batched requests and continuous batching, on
the port.

Port of ``examples/serve_lm.py``: the example's command line for
``launch/serve.py`` (8 requests of 8 prompt tokens at batch 4, 16 tokens
generated each, the smoke config of ``--arch``), passed to the port's
``serve.main`` with ``--device``.  ``--out`` writes the act's gates (the
loop exits 0 and answers every request), wall and kernel launches.

    PYTHONPATH=src python -m repro_torch.launch.serve_lm --device cpu \\
        [--arch rwkv6-7b]
"""
from __future__ import annotations

import argparse

from repro_torch.launch import serve
from repro_torch.launch.acts import ActLog, tee_stdout

#: the example's default arch and the requests its command line asks for
ARCH = "deepseek-v2-lite-16b"
REQUESTS = 8


def example_argv(arch: str = ARCH) -> list:
    """``examples/serve_lm.py``'s command line for ``serve.main``."""
    return ["--arch", arch, "--batch", "4", "--requests", str(REQUESTS),
            "--prompt-len", "8", "--gen-len", "16"]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default=ARCH)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out", default=None, help="result JSON path")
    args = ap.parse_args(argv)
    log = ActLog("serve_lm", args.device)
    with log.act("serve") as rec, tee_stdout() as text:
        rc = serve.main(example_argv(args.arch) + ["--device", args.device])
        answered = sum(line.startswith("[serve] req")
                       for line in text.getvalue().splitlines())
        rec.update(arch=args.arch, exit_code=rc, requests=answered)
        rec["gates"].update(exit_zero=rc == 0,
                            every_request_answered=answered == REQUESTS)
    return log.finish(args.out)


if __name__ == "__main__":
    raise SystemExit(main())
