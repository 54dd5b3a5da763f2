"""Train a ~100M-parameter LM end to end, on the port.

Port of ``examples/train_lm.py``: the example's command line for
``launch/train.py`` (the synthetic pipeline, AdamW, checkpoints; with
``--fast`` the tiny preset for 60 steps with the randomized parallel line
search, p = 4), passed to the port's ``train.main`` with ``--device``.
``--ckpt-dir`` moves the checkpoints from the example's fixed directory.
``--out`` writes the act's gates (the launcher exits 0), its first and
last logged loss, wall and kernel launches.

    PYTHONPATH=src python -m repro_torch.launch.train_lm --device cpu --fast
"""
from __future__ import annotations

import argparse
import json

from repro_torch.launch import train
from repro_torch.launch.acts import ActLog, tee_stdout

#: the example's checkpoint directories (full, ``--fast``)
CKPT_DIR = "/tmp/repro_train_lm"
FAST_CKPT_DIR = "/tmp/repro_train_lm_fast"


def example_argv(fast: bool = False, steps: int = None,
                 ckpt_dir: str = None) -> list:
    """``examples/train_lm.py``'s command line for ``train.main``;
    ``ckpt_dir`` in place of its fixed directory."""
    if fast:
        return ["--preset", "tiny", "--steps", str(steps or 60),
                "--batch", "4", "--seq", "64", "--line-search", "4",
                "--ckpt-dir", ckpt_dir or FAST_CKPT_DIR, "--ckpt-every", "20"]
    return ["--preset", "lm-100m", "--steps", str(steps or 200),
            "--batch", "4", "--seq", "256", "--lr", "1e-3",
            "--ckpt-dir", ckpt_dir or CKPT_DIR, "--ckpt-every", "50"]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--fast", action="store_true",
                    help="tiny model / fewer steps (CI-speed demo)")
    ap.add_argument("--steps", type=int, default=None)
    ap.add_argument("--ckpt-dir", default=None,
                    help="checkpoint directory (default: the example's)")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out", default=None, help="result JSON path")
    args = ap.parse_args(argv)
    log = ActLog("train_lm", args.device)
    with log.act("train") as rec, tee_stdout() as text:
        rc = train.main(example_argv(args.fast, args.steps, args.ckpt_dir)
                        + ["--device", args.device])
        logged = [json.loads(line.split(" ", 1)[1])
                  for line in text.getvalue().splitlines()
                  if line.startswith("[train] {")]
        rec.update(exit_code=rc, logged_steps=[x["step"] for x in logged],
                   first_loss=logged[0]["loss"] if logged else None,
                   last_loss=logged[-1]["loss"] if logged else None)
        rec["gates"]["exit_zero"] = rc == 0
    return log.finish(args.out)


if __name__ == "__main__":
    raise SystemExit(main())
