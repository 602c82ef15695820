"""The port's copy of the engine counter dict.

``aiko_services_tpu/obs/metrics.py`` mirrors every engine counter into a
process metrics registry for the ``(metrics ...)`` scrape.  The port
keeps only what ``ContinuousBatchingServer.stats()`` needs: a dict whose
numeric writes are mirrored into a gauge table under the same unified
names (``aiko_<prefix>_<key>`` plus labels).  The scrape, histograms and
the rest of the registry come with the actor/wire slice.
"""

from __future__ import annotations

import threading
from typing import Dict, Optional, Tuple

__all__ = ["CounterDict", "GaugeTable", "REGISTRY"]

LabelKey = Tuple[Tuple[str, str], ...]


class GaugeTable:
    """Latest value of every gauge, keyed by name and labels."""

    def __init__(self):
        self._lock = threading.Lock()
        self._values: Dict[Tuple[str, LabelKey], float] = {}

    def set(self, name: str, labels: Dict[str, str], value) -> None:
        key = (name, tuple(sorted(labels.items())))
        with self._lock:
            self._values[key] = value

    def get(self, name: str, labels: Optional[Dict[str, str]] = None):
        key = (name, tuple(sorted((labels or {}).items())))
        with self._lock:
            return self._values.get(key)


#: Process-wide gauge table the engines' counters mirror into.
REGISTRY = GaugeTable()


class CounterDict(dict):
    """Engine counters: a plain dict (``counters["shed"] += 1`` works)
    whose numeric writes also land in ``registry`` as
    ``aiko_<prefix>_<key>`` gauges."""

    def __init__(self, initial: Dict, prefix: str,
                 labels: Optional[Dict[str, str]] = None,
                 registry: Optional[GaugeTable] = None):
        super().__init__()
        self._registry = registry or REGISTRY
        self._prefix = prefix
        self._labels = dict(labels or {})
        for key, value in dict(initial).items():
            self[key] = value

    def __setitem__(self, key, value):
        super().__setitem__(key, value)
        if isinstance(value, (int, float)) and not isinstance(value, bool):
            self._registry.set(f"aiko_{self._prefix}_{key}", self._labels,
                               value)
