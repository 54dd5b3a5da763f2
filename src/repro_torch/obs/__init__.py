"""Observability plane: the live half (DESIGN.md §13 — MetricsHub
counters/probes, the ``subscribe_stats`` stream, anomaly-driven fleet
defense) and the post-mortem half (§14 — durable snapshot/trace
retention, workunit lifecycle tracing, windowed drift defense).

Port of ``repro/obs/__init__.py``: the same exports."""
from repro_torch.obs.anomaly import (KILL, PAGE, QUARANTINE, RELEASE,
                                     SCHEDULE_VERSION, AnomalyEvent,
                                     FleetDefense)
from repro_torch.obs.metrics import (STREAM_VERSION, MetricsHub,
                                     attach_cache, attach_coalescer,
                                     attach_engine, attach_grid,
                                     attach_intake)
from repro_torch.obs.retention import (OBS_STORE_DB, OBS_STORE_NAME,
                                       STORE_VERSION, RetentionSink,
                                       SnapshotStore, SqliteSnapshotStore,
                                       obs_store_path, open_snapshot_store)
from repro_torch.obs.stream import BackgroundSubscriber, StatsSubscriber
from repro_torch.obs.trace import TRACE_VERSION, WorkUnitTracer, wu_sampled

__all__ = [
    "MetricsHub", "STREAM_VERSION", "attach_engine", "attach_grid",
    "attach_coalescer", "attach_cache", "attach_intake",
    "AnomalyEvent", "FleetDefense", "SCHEDULE_VERSION",
    "QUARANTINE", "RELEASE", "PAGE", "KILL",
    "StatsSubscriber", "BackgroundSubscriber",
    "SnapshotStore", "SqliteSnapshotStore", "RetentionSink",
    "open_snapshot_store", "obs_store_path", "STORE_VERSION",
    "OBS_STORE_NAME", "OBS_STORE_DB",
    "WorkUnitTracer", "wu_sampled", "TRACE_VERSION",
]
