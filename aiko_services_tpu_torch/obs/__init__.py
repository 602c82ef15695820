"""The port's observability pieces.

* :mod:`.metrics` — Counter / Gauge / Histogram registry with fixed
  log-spaced buckets and Prometheus text, and the engines'
  ``CounterDict`` (a copy of ``aiko_services_tpu/obs/metrics.py``).
* :mod:`.trace` — distributed request spans riding the wire's ``trace``
  field; NVTX ranges in place of JAX profiler annotations.
* :mod:`.steplog` — the engine step-event ring (off unless installed).
* :mod:`.flight` — the flight recorder, without the sections that read
  modules the port does not have yet.
* :mod:`.compiles` — the CUDA graph capture ledger, the torch meaning of
  the reference's compile ledger.

Import discipline as in the reference: ``obs`` modules import nothing
from the rest of the package (``torch`` strictly lazily).
"""

from . import compiles, flight, metrics, steplog, trace  # noqa: F401

__all__ = ["compiles", "flight", "metrics", "steplog", "trace"]
