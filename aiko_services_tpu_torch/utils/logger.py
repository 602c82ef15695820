"""Logging: console and distributed (topic-published) handlers.

The port's copy of ``aiko_services_tpu/utils/logger.py`` (it has no JAX
in it); its imports point at the port's own modules.

Reference parity: upstream aiko_services ``main/utilities/
logger.py:98-172``.  ``get_logger(name)`` honours ``AIKO_LOG_LEVEL`` and
per-subsystem overrides ``AIKO_LOG_LEVEL_<NAME>``.  ``TopicLogHandler``
publishes every record to a service's ``…/log`` topic through whatever
``Message`` transport the process uses, ring-buffering up to 128 records
until the transport connects — the seam the Recorder/Dashboard consume.
"""

from __future__ import annotations

import logging
import os
import sys
import time
from collections import deque
from typing import Optional

__all__ = ["get_logger", "get_log_level", "TopicLogHandler", "LOG_FORMAT"]

LOG_FORMAT = "%(asctime)s.%(msecs)03d %(levelname)-5s [%(name)s] %(message)s"
LOG_DATE_FORMAT = "%Y-%m-%d %H:%M:%S"
_RING_SIZE = 128  # records buffered before the transport connects


def get_log_level(name: str = "", default: str = "INFO") -> str:
    subsystem = name.rsplit(".", 1)[-1].upper()
    return os.environ.get(f"AIKO_LOG_LEVEL_{subsystem}",
                          os.environ.get("AIKO_LOG_LEVEL", default))


def get_logger(name: str, log_level: Optional[str] = None,
               handler: Optional[logging.Handler] = None) -> logging.Logger:
    logger = logging.getLogger(name)
    level = (log_level or get_log_level(name)).upper()
    logger.setLevel(level)
    if handler is not None:
        logger.addHandler(handler)
    elif not logger.handlers and not logging.getLogger().handlers:
        console = logging.StreamHandler(sys.stderr)
        console.setFormatter(logging.Formatter(LOG_FORMAT, LOG_DATE_FORMAT))
        logger.addHandler(console)
    return logger


class TopicLogHandler(logging.Handler):
    """Publish log records to ``topic`` via a ``Message`` transport.

    Records emitted before the transport is connected are ring-buffered
    (most recent ``_RING_SIZE``) and flushed on first successful publish.

    Two observability hooks:

    * When a trace span is active on the emitting thread
      (``obs.trace``), its ``trace_id/span_id`` is appended to the
      published record — a broker-side log line joins the distributed
      trace that produced it.
    * A per-handler token bucket (``rate_limit_hz`` sustained,
      ``burst`` bucket depth) stops a hot error path from storming the
      broker; dropped records count into the process metrics registry
      (``aiko_log_records_dropped_total``, labelled by topic) so the
      drop itself is observable.  ``rate_limit_hz=0`` disables the
      limiter (the default keeps historical behavior for tests).
    """

    def __init__(self, message, topic: str,
                 rate_limit_hz: float = 0.0, burst: int = 20):
        super().__init__()
        self.message = message
        self.topic = topic
        self.rate_limit_hz = float(rate_limit_hz)
        self._bucket = float(burst)
        self._burst = float(burst)
        self._refill_at = time.monotonic()
        self.dropped = 0
        self._ring: deque = deque(maxlen=_RING_SIZE)
        self.setFormatter(logging.Formatter(LOG_FORMAT, LOG_DATE_FORMAT))

    def _admit(self) -> bool:
        """Token bucket: refill at ``rate_limit_hz``, cap at burst."""
        if self.rate_limit_hz <= 0:
            return True
        now = time.monotonic()
        self._bucket = min(
            self._burst,
            self._bucket + (now - self._refill_at) * self.rate_limit_hz)
        self._refill_at = now
        if self._bucket < 1.0:
            self.dropped += 1
            try:  # lazy: utils must not hard-depend on obs at import
                from ..obs.metrics import REGISTRY
                REGISTRY.counter("aiko_log_records_dropped_total",
                                 help="log records dropped by the "
                                      "per-topic rate limit",
                                 labels={"topic": self.topic}).inc()
            except Exception:  # noqa: BLE001 - never raise from logging
                pass
            return False
        self._bucket -= 1.0
        return True

    def emit(self, record: logging.LogRecord):
        try:
            if not self._admit():
                return
            payload = self.format(record)
            try:
                from ..obs.trace import current_ids
                ids = current_ids()
            except Exception:  # noqa: BLE001 - never raise from logging
                ids = None
            if ids is not None:
                payload = f"{payload} trace={ids[0]}/{ids[1]}"
            if self.message is not None and self.message.connected:
                while self._ring:
                    self.message.publish(self.topic, self._ring.popleft())
                self.message.publish(self.topic, payload)
            else:
                self._ring.append(payload)
        except Exception:  # logging must never raise into application code
            self.handleError(record)
