"""Checkpoint/restart of training state (``checkpoint.py``: the
reference's npz layout, readable by either package)."""
from repro_torch.checkpoint.checkpoint import (latest_step,  # noqa: F401
                                               restore, save)
