"""PipelineElement: the unit of pipeline computation.

The port's copy of ``aiko_services_tpu/pipeline/element.py`` (it has no
JAX in it); its imports point at the port's own modules.

Reference parity: upstream aiko_services ``main/pipeline.py:
302-508``.  Subclasses implement::

    def process_frame(self, stream, **inputs) -> (StreamEvent, dict)
    def start_stream(self, stream, stream_id) -> (StreamEvent, dict|None)
    def stop_stream(self, stream, stream_id)

plus optionally declare device compute (see
:class:`aiko_services_tpu_torch.pipeline.tpu_stage.TpuElement`) so
contiguous elements fuse into one program (a CUDA graph on the card).

``create_frames`` spawns a paced generator thread with mailbox
backpressure (pause while the pipeline has ≥ 32 queued frames, reference
pipeline.py:405); ``get_parameter`` implements the four-level precedence
stream[element] > element definition/share > stream > pipeline definition
(reference pipeline.py:450-484).
"""

from __future__ import annotations

import threading
import time
from typing import Any, Callable, Dict, Optional, Tuple

from ..runtime.actor import Actor
from ..runtime.context import PipelineElementContext
from .stream import Frame, Stream, StreamEvent

__all__ = ["PipelineElement", "BACKPRESSURE_QUEUED_FRAMES"]

BACKPRESSURE_QUEUED_FRAMES = 32   # reference pipeline.py:405


class PipelineElement(Actor):
    def __init__(self, context: PipelineElementContext, process=None):
        super().__init__(context, process)
        self.definition = context.definition
        self.pipeline = context.pipeline
        self._generator_stops: Dict[str, threading.Event] = {}

    # -- subclass API -------------------------------------------------------- #

    def process_frame(self, stream: Stream,
                      **inputs) -> Tuple[StreamEvent, dict]:
        raise NotImplementedError

    def start_stream(self, stream: Stream,
                     stream_id) -> Tuple[StreamEvent, Optional[dict]]:
        return StreamEvent.OKAY, None

    def stop_stream(self, stream: Stream, stream_id):
        return StreamEvent.OKAY, None

    # -- identity ------------------------------------------------------------- #

    def my_id(self, stream: Optional[Stream] = None) -> str:
        if stream is not None:
            frame_id = stream.frame.frame_id if stream.frame else "?"
            return f"{self.name}<{stream.stream_id}:{frame_id}>"
        return self.name

    # -- parameters ------------------------------------------------------------ #

    def get_parameter(self, name: str, default: Any = None,
                      stream: Optional[Stream] = None,
                      use_pipeline: bool = True) -> Tuple[Any, bool]:
        """Returns (value, found) with the reference's precedence."""
        if stream is None and self.pipeline is not None:
            stream = self.pipeline.current_stream()
        if stream is not None:
            scoped = f"{self.name}.{name}"
            if scoped in stream.parameters:
                return stream.parameters[scoped], True
        if self.definition is not None and \
                name in self.definition.parameters:
            return self.definition.parameters[name], True
        if name in self.context.parameters:
            return self.context.parameters[name], True
        if stream is not None and name in stream.parameters:
            return stream.parameters[name], True
        if use_pipeline and self.pipeline is not None:
            pipeline_parameters = self.pipeline.definition.parameters
            if name in pipeline_parameters:
                return pipeline_parameters[name], True
        return default, False

    def set_parameter(self, name: str, value):
        if self.definition is not None:
            self.definition.parameters[name] = value
        else:
            self.context.parameters[name] = value

    # -- frame creation ---------------------------------------------------------- #

    def create_frame(self, stream: Stream, frame_data: Dict[str, Any]):
        """Post one frame into the owning pipeline for this stream."""
        self.pipeline.post_frame(stream.stream_id, frame_data)

    def create_frames(self, stream: Stream, frame_generator: Callable,
                      rate: Optional[float] = None,
                      on_stop: Optional[Callable] = None):
        """Pull ``(StreamEvent, frame_data)`` from ``frame_generator(stream,
        frame_id)`` on a paced daemon thread, posting frames with mailbox
        backpressure, until the generator reports STOP/ERROR or the stream
        stops.

        ``on_stop`` runs on the generator thread when it exits (any
        cause) — the place to release capture devices the generator owns:
        releasing from ``stop_stream`` would race a blocked read on this
        thread (cv2.VideoCapture is not thread-safe across read/release).
        """
        stop = threading.Event()
        self._generator_stops[str(stream.stream_id)] = stop
        period = (1.0 / rate) if rate else 0.0
        pipeline = self.pipeline

        def run():
            try:
                self._generator_loop(stream, frame_generator, stop,
                                     period, pipeline)
            finally:
                if on_stop is not None:
                    try:
                        on_stop()
                    except Exception:  # noqa: BLE001
                        self.logger.exception(
                            "%s: generator on_stop failed", self.my_id())

        thread = threading.Thread(
            target=run, daemon=True,
            name=f"frames-{self.name}-{stream.stream_id}")
        thread.start()
        return thread

    def _generator_loop(self, stream, frame_generator, stop, period,
                        pipeline):
        frame_id = 0
        while not stop.is_set():
            started = time.monotonic()
            if pipeline.queued_frame_count() >= \
                    BACKPRESSURE_QUEUED_FRAMES:
                # stop.wait (not sleep): a stream destroy must interrupt
                # pacing promptly so on_stop releases devices at once.
                stop.wait(0.005)
                continue
            try:
                event, frame_data = frame_generator(stream, frame_id)
            except Exception:  # noqa: BLE001
                self.logger.exception(
                    "%s: frame generator failed", self.my_id())
                pipeline.post_stream_stop(stream.stream_id,
                                          StreamEvent.ERROR)
                return
            if event != StreamEvent.OKAY:
                pipeline.post_stream_stop(stream.stream_id, event)
                return
            pipeline.post_frame(stream.stream_id, frame_data or {})
            frame_id += 1
            if period:
                elapsed = time.monotonic() - started
                if period > elapsed:
                    stop.wait(period - elapsed)

    def stop_frame_generator(self, stream_id):
        stop = self._generator_stops.pop(str(stream_id), None)
        if stop:
            stop.set()

    def stop(self):
        for stop in self._generator_stops.values():
            stop.set()
        self._generator_stops.clear()
        super().stop()
