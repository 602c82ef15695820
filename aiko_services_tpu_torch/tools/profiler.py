"""Profiler actor: remote-controlled ``torch.profiler`` trace capture.

The port of ``aiko_services_tpu/tools/profiler.py``: this actor turns a
trace of the process on and off over the standard actor wire protocol,
so an operator (or the dashboard) can grab a device trace from ANY
running process in the fleet without restarting it:

    (profile_start /tmp/trace_dir)   → torch.profiler, CPU + CUDA
    (profile_stop)                   → stop; trace.json in the dir, which
                                       the share lists
    (profile_status)                 → echo state to topic_out

Traces are Chrome trace-event JSON (Perfetto-loadable) with the kernels'
device time and the host spans' NVTX ranges (``obs/trace.py``).  A
``ProfilerMixin`` is also provided so any Actor can adopt the same
commands.  The engines' bounded ``(profile N)`` bracket is
:mod:`~..obs.profiler`; both share the profiler's one process-wide
session, so a start while the other holds it fails and says so.
"""

from __future__ import annotations

import os
import time
from typing import Optional

from ..runtime.actor import Actor

__all__ = ["ProfilerActor", "ProfilerMixin"]


class ProfilerMixin:
    """Adds profile_start/profile_stop/profile_status commands to an
    Actor subclass (call :meth:`_init_profiler` after Actor.__init__)."""

    def _init_profiler(self):
        self._command_handlers["profile_start"] = self.profile_start
        self._command_handlers["profile_stop"] = self.profile_stop
        self._command_handlers["profile_status"] = self.profile_status
        self._command_handlers["profile_reset"] = self.profile_reset
        self._trace_dir: Optional[str] = None
        self._trace_started: Optional[float] = None
        self._trace = None
        self._share_update("profiling", False)

    def profile_start(self, trace_dir: str = ""):
        """Begin a trace of this process into ``trace_dir``."""
        if self._trace_dir is not None:
            self.logger.warning("%s: trace already running in %s",
                                self.name, self._trace_dir)
            return
        trace_dir = str(trace_dir) or os.path.join(
            os.environ.get("TMPDIR", "/tmp"),
            f"aiko_trace_{os.getpid()}_{int(time.time())}")
        os.makedirs(trace_dir, exist_ok=True)
        try:
            import torch
            from torch.profiler import ProfilerActivity, profile
            activities = [ProfilerActivity.CPU]
            if torch.cuda.is_available():
                activities.append(ProfilerActivity.CUDA)
            session = profile(activities=activities)
            session.start()
        except Exception as error:  # noqa: BLE001 - another session owns it
            # Do NOT stop the other session: it belongs to someone else
            # (an engine's (profile) bracket).  (profile_reset) clears only
            # this actor's state.
            self.logger.error("%s: profiler start failed: %r", self.name,
                              error)
            return
        self._trace = session
        self._trace_dir = trace_dir
        self._trace_started = time.time()
        self._share_update("profiling", True)
        self.logger.info("%s: tracing to %s", self.name, trace_dir)

    def profile_stop(self):
        """End the capture; the trace dir lands in the EC share so the
        dashboard / remote callers can find it."""
        if self._trace_dir is None:
            self.logger.warning("%s: no trace running", self.name)
            return
        try:
            self._trace.stop()
            self._trace.export_chrome_trace(
                os.path.join(self._trace_dir, "trace.json"))
        except Exception as error:  # noqa: BLE001
            # Keep the state so the operator can retry profile_stop.
            self.logger.error("%s: profiler stop failed (retryable): %r",
                              self.name, error)
            return
        duration = time.time() - (self._trace_started or time.time())
        self._share_update("profiling", False)
        self._share_update("last_trace_dir", self._trace_dir)
        self._share_update("last_trace_seconds", round(duration, 3))
        self.logger.info("%s: trace (%.1fs) written to %s", self.name,
                         duration, self._trace_dir)
        self._trace = None
        self._trace_dir = None
        self._trace_started = None

    def profile_reset(self):
        """Operator escape hatch: stop this actor's session if one is open
        and clear its state."""
        if self._trace is not None:
            try:
                self._trace.stop()
            except Exception as error:  # noqa: BLE001
                self.logger.warning("%s: reset stop: %r", self.name, error)
        self._trace = None
        self._trace_dir = None
        self._trace_started = None
        self._share_update("profiling", False)

    def profile_status(self):
        self.publish_out("profile_status",
                         ["running" if self._trace_dir else "idle",
                          self._trace_dir or
                          self.share.get("last_trace_dir", "")])

    def _share_update(self, key, value):
        """Share write + EC broadcast (ECProducer.update already sets
        the share dict; the direct write is only the no-producer
        fallback)."""
        if getattr(self, "ec_producer", None) is not None:
            self.ec_producer.update(key, value)
        else:
            self.share[key] = value


class ProfilerActor(ProfilerMixin, Actor):
    """Standalone profiler service: run one per process to capture that
    process's device traces on demand."""

    def __init__(self, context, process=None):
        context.protocol = context.protocol or "profiler:0"
        super().__init__(context, process)
        self._init_profiler()
