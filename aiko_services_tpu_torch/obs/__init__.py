"""The port's observability pieces.

* :mod:`.metrics` — Counter / Gauge / Histogram registry with fixed
  log-spaced buckets and Prometheus text, and the engines'
  ``CounterDict`` (a copy of ``aiko_services_tpu/obs/metrics.py``).
* :mod:`.trace` — distributed request spans riding the wire's ``trace``
  field; NVTX ranges in place of JAX profiler annotations.
* :mod:`.steplog` — the engine step-event ring (off unless installed).
* :mod:`.flight` — the flight recorder: capture bundles with the
  manifest, spans, steplog, counters, compiles, profile and census
  sections.
* :mod:`.attrib` — step-time attribution, the tax budget table; its
  device probe times on CUDA events.
* :mod:`.compiles` — the CUDA graph capture ledgers (one an engine, and
  the process-wide ledger with labels, records, the steady-state
  detector and the kernel library's cache counters).
* :mod:`.profiler` — the on-demand ``(profile N)`` bracket on
  ``torch.profiler``.
* :mod:`.pool_audit` — the KV memory accountant and the online pool
  auditor behind ``(census)``.

Import discipline as in the reference: ``obs`` modules import nothing
from the rest of the package (``torch`` strictly lazily).
"""

from . import (attrib, compiles, flight, metrics,  # noqa: F401
               pool_audit, profiler, steplog, trace)

__all__ = ["attrib", "compiles", "flight", "metrics", "pool_audit",
           "profiler", "steplog", "trace"]
