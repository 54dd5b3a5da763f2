"""Fault-tolerant FGDO service layer (DESIGN.md §9).

Port of ``repro/server/__init__.py``.

A BOINC-style work server over the ANM engine's generate/assimilate seam:

  * ``protocol``   — versioned msgpack/JSON-framed wire protocol;
  * ``registry``   — host reliability, latency and churn tracking;
  * ``checkpoint`` — append-only replay log + snapshots (crash recovery);
  * ``transport``  — in-process loopback and TCP transports;
  * ``server``     — the deterministic lease-granting work server;
  * ``sim``        — the simulated volunteer client pool + the
                     ``ServerSubstrate`` end-to-end driver.

Attribute access is lazy: ``core/fgdo.py`` imports ``repro_torch.server.registry``
while ``repro_torch.server.server`` imports ``core.fgdo`` back — eager package
imports here would make that pair circular.
"""
from __future__ import annotations

import importlib

_EXPORTS = {
    "HostRegistry": "repro_torch.server.registry",
    "HostRecord": "repro_torch.server.registry",
    "WorkServer": "repro_torch.server.server",
    "CheckpointManager": "repro_torch.server.checkpoint",
    "LoopbackTransport": "repro_torch.server.transport",
    "TcpTransport": "repro_torch.server.transport",
    "make_transport": "repro_torch.server.transport",
    "SimClientPool": "repro_torch.server.sim",
    "ServerSubstrate": "repro_torch.server.sim",
}

__all__ = sorted(_EXPORTS)


def __getattr__(name: str):
    mod = _EXPORTS.get(name)
    if mod is None:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    return getattr(importlib.import_module(mod), name)
