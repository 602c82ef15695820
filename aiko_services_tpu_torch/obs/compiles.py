"""The port's record of CUDA graph captures: the torch meaning of the
reference's compile ledger.

``aiko_services_tpu/obs/compiles.py`` counts every XLA compile and, once
its warm-up fence drops, every compile after it as a steady-state anomaly
(``compiles_steady_state``): a serving loop whose shapes are bucketed
compiles nothing new once warm.  On the card the port's counterpart of a
compile is a graph capture (``models/llama.py`` ``ChunkGraph``), and of a
compiled call a replay.  This keeps those counters and the fence; the
rest of the ledger (records, labels, the persistent cache, the flight
capture) comes with the other observability hooks.
"""

from __future__ import annotations

from typing import Dict

__all__ = ["CaptureLedger"]


class CaptureLedger:
    """Captures and replays of one engine's CUDA graphs, and the captures
    made after the warm-up fence dropped."""

    def __init__(self):
        self.captures = 0
        self.steady_captures = 0
        self.replays = 0
        self.fenced = False

    def fence(self) -> None:
        """Drop the warm-up fence: every later capture is a steady-state
        anomaly.  Idempotent."""
        self.fenced = True

    def lift_fence(self) -> None:
        """Re-enter warm-up (e.g. before an intentional reconfigure)."""
        self.fenced = False

    def record_capture(self) -> None:
        self.captures += 1
        if self.fenced:
            self.steady_captures += 1

    def record_replay(self) -> None:
        self.replays += 1

    def counters(self) -> Dict[str, int]:
        """The ``stats()`` keys of the engine that owns the ledger."""
        return dict(graph_captures=self.captures,
                    graph_replays=self.replays,
                    graph_captures_steady_state=self.steady_captures)
