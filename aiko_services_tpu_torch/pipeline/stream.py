"""Streams, frames, and stream events.

The port's copy of ``aiko_services_tpu/pipeline/stream.py`` (it has no
JAX in it).

Reference parity: upstream aiko_services ``main/stream.py:
35-109``.  A ``Stream`` is one logical media/data session flowing through a
Pipeline's graph; a ``Frame`` is one unit of work — and explicitly a
*continuation*: it records the accumulated outputs (``swag``) and, when
paused at a remote element, the node name to resume after
(``paused_pe_name``).

Single-writer discipline (design hardening vs the reference's documented
frame-id race, reference pipeline.py:1098-1118): all mutation of a Stream
happens on the owning pipeline's event-loop thread; generator threads only
*post* frames, they never touch Stream state directly.
"""

from __future__ import annotations

import enum
from dataclasses import dataclass, field
from typing import Any, Dict, Optional

__all__ = ["StreamEvent", "StreamState", "Frame", "Stream",
           "DEFAULT_STREAM_ID", "FIRST_FRAME_ID"]

DEFAULT_STREAM_ID = "*"
FIRST_FRAME_ID = 0


class StreamEvent(enum.IntEnum):
    """What an element reports after processing a frame."""
    ERROR = -2
    STOP = -1
    OKAY = 0
    DROP_FRAME = 1
    USER = 2        # first user-defined event


class StreamState(enum.IntEnum):
    """What the stream as a whole is doing."""
    ERROR = -2
    STOP = -1
    RUN = 0
    DROP_FRAME = 1


#: StreamEvent reported by an element → StreamState policy for the stream
#: (reference pipeline.py:1337-1371).
STREAM_EVENT_TO_STATE = {
    StreamEvent.ERROR: StreamState.ERROR,
    StreamEvent.STOP: StreamState.STOP,
    StreamEvent.OKAY: StreamState.RUN,
    StreamEvent.DROP_FRAME: StreamState.DROP_FRAME,
}


@dataclass
class Frame:
    """Per-frame continuation."""
    frame_id: int = FIRST_FRAME_ID
    swag: Dict[str, Any] = field(default_factory=dict)
    metrics: Dict[str, float] = field(default_factory=dict)
    paused_pe_name: Optional[str] = None
    #: On a remotely-invoked frame: the caller's frame id, echoed back in
    #: the response so the caller can correlate its paused continuation.
    caller_frame_id: Optional[str] = None

    def window_key(self):
        return self.frame_id


@dataclass
class Stream:
    stream_id: str = DEFAULT_STREAM_ID
    frame_id: int = FIRST_FRAME_ID        # next frame id to assign
    frames: Dict[int, Frame] = field(default_factory=dict)
    graph_path: Optional[str] = None
    parameters: Dict[str, Any] = field(default_factory=dict)
    variables: Dict[str, Any] = field(default_factory=dict)
    state: StreamState = StreamState.RUN
    topic_response: Optional[str] = None   # remote caller's response topic
    queue_response: Optional[Any] = None   # local caller's response queue
    lease: Optional[Any] = None

    #: False until every element's ``start_stream`` has completed.  Frame
    #: generators start posting the moment *their* element starts, so
    #: frames can reach the event loop while later elements are still
    #: starting — those are parked in ``pending`` and replayed on start
    #: completion (the reference serializes start/process with a
    #: per-stream lock instead, reference pipeline.py:817-845, 1097-1205).
    started: bool = False
    pending: list = field(default_factory=list)

    # The frame currently being processed (set by the pipeline hot loop,
    # event-loop thread only).
    frame: Optional[Frame] = None

    def as_dict(self) -> Dict[str, str]:
        """Wire form for remote process_frame crossings."""
        result = {"stream_id": str(self.stream_id),
                  "frame_id": str(self.frame.frame_id if self.frame
                                  else self.frame_id)}
        if self.topic_response:
            result["topic_response"] = self.topic_response
        if self.graph_path:
            result["graph_path"] = self.graph_path
        return result
