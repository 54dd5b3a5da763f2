"""Computing substrates that drive the shared ANM engine (DESIGN.md §1).

A substrate owns hosts, time and fitness evaluation; the engine owns every
optimization decision.  The synchronous driver lives in core/anm.py.

WHERE a substrate evaluates its workunit blocks is a second seam —
``EvalBackend`` (DESIGN.md §6–§7): an asynchronous submit/collect
protocol on the backend's own CUDA stream, in-process by default, or
split over a mesh's data axis (``pod_mesh.PodMeshEvalBackend``).
"""
from repro_torch.core.substrates.batched_grid import BatchedVolunteerGrid  # noqa: F401
from repro_torch.core.substrates.eval_backend import (  # noqa: F401
    EvalBackend, EvalHandle, InProcessEvalBackend)
from repro_torch.core.substrates.pod_mesh import PodMeshEvalBackend  # noqa: F401
