"""Pipeline: a dataflow DAG of PipelineElements processing Streams of
Frames.

The port's copy of ``aiko_services_tpu/pipeline/pipeline.py`` (it has no
JAX in it); its imports point at the port's own modules, and the fused
stages it builds are the port's (:mod:`.tpu_stage`: a CUDA graph a run on
the card).

Reference parity: upstream aiko_services ``main/pipeline.py:
512-1391`` — definitions → graph build (local elements instantiated,
remote ones discovered and proxy-swapped live), ``create_stream`` /
``destroy_stream`` with grace-time leases, the per-frame hot loop
accumulating outputs into the frame's ``swag``, per-element metrics,
input name-mapping from graph edge properties, stream-event → stream-state
policy, and remote-element continuations (frame pauses at the remote node,
crosses the wire, resumes from ``iterate_after`` when the response
arrives).

Differences by design:

* **Multiple in-flight frames are the default.**  The reference processes
  one frame at a time unless the experimental ``--windows`` flag is set
  (pipeline.py:136, 1246-1270); here every frame is an independent
  continuation keyed by frame id, so frames pipeline through remote (and
  TPU-async) stages naturally.
* **Single-writer streams.**  All stream/frame mutation happens on the
  event-loop thread (generator threads only post); the reference's
  frame-id race instrumentation (pipeline.py:1098-1118) has no analog.
* **Device stage fusion.**  With ``runtime: "tpu"`` (the definition's
  name for it, kept), contiguous runs of TpuElements become single
  stages, each captured as one CUDA graph per input-shape signature on
  the card and run eagerly on the CPU; array swag values stay
  device-resident between elements (see tpu_stage.py).
"""

from __future__ import annotations

import time
from collections import deque
from typing import Any, Dict, List, Optional, Tuple

from ..utils.graph import Graph
from ..utils.importer import load_module
from ..utils.sexpr import generate
from ..runtime.context import (
    PipelineContext, pipeline_element_args, compose_instance,
)
from ..runtime.proxy import make_remote_proxy
from ..runtime.lease import Lease
from ..registry.services_cache import services_cache_create_singleton
from ..runtime.service import ServiceFilter
from .codec import decode_swag, encode_swag
from .definition import (
    PipelineDefinition, PipelineElementDefinition, apply_output_renames,
    load_pipeline_definition,
)
from .element import PipelineElement
from .stream import (
    DEFAULT_STREAM_ID, Frame, Stream, StreamEvent, StreamState,
    STREAM_EVENT_TO_STATE,
)

__all__ = ["Pipeline", "PipelineRemote", "DEFAULT_GRACE_TIME",
           "REMOTE_RETRY_DELAY"]

DEFAULT_GRACE_TIME = 60.0   # reference pipeline.py:133
REMOTE_RETRY_DELAY = 3.0    # reference pipeline.py:779-787
STATS_PERIOD = 3.0          # reference pipeline.py:586
#: Service protocol pipelines register under (reference declares
#: "…/pipeline:0" via ServiceProtocol); discovery filters and dashboard
#: plugins key on it.
PIPELINE_PROTOCOL = "pipeline:0"


class PipelineRemote:
    """Interface spec for proxying a remote Pipeline (the methods that
    cross the wire; reference pipeline.py:1393-1427)."""

    def process_frame(self, stream_dict, inputs_dict): ...
    def create_stream(self, stream_id, parameters): ...
    def destroy_stream(self, stream_id): ...


class Pipeline(PipelineElement):
    def __init__(self, context: PipelineContext, process=None):
        self.definition: PipelineDefinition = context.definition
        if self.definition is None and context.definition_pathname:
            self.definition = load_pipeline_definition(
                context.definition_pathname)
            context.definition = self.definition
        if self.definition is None:
            raise ValueError("Pipeline requires a definition")
        context.pipeline = None   # a Pipeline is its own pipeline
        context.protocol = context.protocol or PIPELINE_PROTOCOL
        super().__init__(context, process)
        self.pipeline = self

        self.streams: Dict[str, Stream] = {}
        # Tombstones: ids of recently-destroyed streams — late frames for
        # them are dropped instead of auto-recreating the stream.
        self._destroyed_streams: "deque[str]" = deque(maxlen=256)
        self.elements: Dict[str, PipelineElement] = {}
        self.remote_proxies: Dict[str, Optional[Any]] = {}
        self._remote_topics: Dict[str, str] = {}
        #: node -> {input name: swag key it reads} (map_in side).
        self._input_sources: Dict[str, Dict[str, str]] = {}
        #: node -> {output name: [namespaced swag keys written]}
        #: (map_out side; the plain output name is popped).
        self._output_renames: Dict[str, Dict[str, List[str]]] = {}
        self._stream_current: Optional[Stream] = None
        self._frames_processed = 0
        self._services_cache = None

        self.graph = Graph.traverse(self.definition.graph,
                                    self._node_properties)
        self._create_elements()
        # Device runtime: fuse contiguous TpuElement runs into single
        # stages (device-resident swag between them; see tpu_stage.py).
        self._fused_stages: Dict[str, Any] = {}
        #: Every Nth frame additionally records time_{stage}_device
        #: (dispatch -> device completion, via a CUDA event sync);
        #: 0 = off.  The plain time_{stage} stamp is dispatch wall time
        #: only — CUDA dispatch is asynchronous.
        self._device_metrics_interval = int(
            self.definition.parameters.get("device_metrics_interval", 0))
        if self.definition.runtime == "tpu":
            from .tpu_stage import build_fused_stages
            for head in self.graph.head_names:
                path = list(self.graph.get_path(head))
                self._fused_stages.update(build_fused_stages(
                    path, self.elements, self._input_sources,
                    self._output_renames))
            if self._fused_stages:
                self.logger.info(
                    "%s: fused device stages: %s", self.name,
                    [s.name for s in self._fused_stages.values()])
        self._command_handlers.update({
            "process_frame": self._wire_process_frame,
            "process_frame_response": self._wire_process_frame_response,
            "_frame_local": self._frame_local,
            "_frame_retry": self._frame_retry,
            "_stream_stop": self._stream_stop_command,
            "_stream_started": self._stream_started,
        })
        self.share["streams"] = 0
        self.share["frames_processed"] = 0
        self.process.event.add_timer_handler(self._stats_timer, STATS_PERIOD)

    # -- graph build --------------------------------------------------------- #

    def _node_properties(self, node_name, properties, predecessor):
        """Graph edge dicts rename the predecessor's outputs into
        consumer-namespaced swag keys (reference map_in/map_out,
        pipeline.py:616-625, 1292-1325): edge ``(P C (out: in))`` makes
        P's output ``out`` travel as swag key ``"C.in"``, which C's
        declared input ``in`` then reads.  Fan-in branches emitting the
        same output name therefore stay distinct (the round-1 diamond
        collision).  The plain output name is *popped* from the
        producer's outputs, matching the reference's
        ``frame_data_out.pop(from_name)``."""
        if predecessor is None:
            raise ValueError(
                f"Graph edge properties on head node {node_name!r} have "
                "no source edge; attach them after a successor, e.g. "
                f"\"(P {node_name} (out: in))\"")
        sources = self._input_sources.setdefault(node_name, {})
        renames = self._output_renames.setdefault(predecessor, {})
        for from_name, to_name in properties.items():
            from_name, to_name = str(from_name), str(to_name)
            key = f"{node_name}.{to_name}"
            sources[to_name] = key
            targets = renames.setdefault(from_name, [])
            if key not in targets:
                targets.append(key)

    def _apply_map_out(self, node_name: str,
                       outputs: Dict[str, Any]) -> Dict[str, Any]:
        """Rename a producer's mapped outputs to their consumer-
        namespaced keys (reference ``_process_map_out``,
        pipeline.py:1314-1320); one output may fan out to several
        consumers."""
        return apply_output_renames(self._output_renames.get(node_name),
                                    outputs)

    def _create_elements(self):
        for node in self.graph.nodes():
            element_definition = self.definition.element(node.name)
            if element_definition is None:
                raise ValueError(
                    f"Graph node {node.name} missing from elements")
            if element_definition.is_remote:
                self.remote_proxies[node.name] = None
                self._watch_remote(element_definition)
            else:
                element = self._instantiate(element_definition)
                self.elements[node.name] = element
                node.element = element
        self._validate_graph_io()

    def _instantiate(self, definition: PipelineElementDefinition):
        deploy = definition.deploy_local
        module = load_module(deploy.module)
        cls = getattr(module, deploy.class_name)
        return compose_instance(
            cls,
            pipeline_element_args(definition.name, definition=definition,
                                  pipeline=self),
            process=self.process)

    def _validate_graph_io(self):
        """Every local element's declared inputs must be produced by some
        upstream element (or supplied as frame data) — typed-edge check,
        completing the reference's half-finished validation
        (pipeline.py:232-254)."""
        for head in self.graph.head_names:
            available: Dict[str, str] = {}
            for node in self.graph.get_path(head):
                definition = self.definition.element(node.name)
                mapping = self._input_sources.get(node.name, {})
                for io in definition.input:
                    name = mapping.get(io["name"], io["name"])
                    if name in available and \
                            available[name] != io["type"]:
                        raise ValueError(
                            f"{node.name}.{io['name']}: type "
                            f"{io['type']} != upstream {available[name]}")
                renames = self._output_renames.get(node.name, {})
                for io in definition.output:
                    for key in renames.get(io["name"], [io["name"]]):
                        available[key] = io["type"]

    def _watch_remote(self, definition: PipelineElementDefinition):
        if self._services_cache is None:
            self._services_cache = services_cache_create_singleton(
                self.process)
        service_filter = ServiceFilter(
            **{k: v for k, v in
               definition.deploy_remote.service_filter.items()
               if k in ("name", "protocol", "transport", "owner", "tags")})
        name = definition.name

        def on_add(fields):
            self._remote_topics[name] = fields.topic_path
            self.remote_proxies[name] = make_remote_proxy(
                self.process.message.publish, f"{fields.topic_path}/in",
                PipelineRemote)
            self.logger.info("%s: remote element %s -> %s",
                             self.name, name, fields.topic_path)

        def on_remove(fields):
            if self._remote_topics.get(name) == fields.topic_path:
                self.remote_proxies[name] = None
                self._remote_topics.pop(name, None)

        self._services_cache.add_handler(service_filter, on_add, on_remove)

    # -- stream lifecycle ------------------------------------------------------ #

    def create_stream(self, stream_id=DEFAULT_STREAM_ID, parameters=None,
                      graph_path=None, grace_time=DEFAULT_GRACE_TIME,
                      queue_response=None, topic_response=None) -> Stream:
        stream_id = str(stream_id)
        if stream_id in self.streams:
            return self.streams[stream_id]
        if stream_id in self._destroyed_streams:
            # Explicit re-creation clears the tombstone.
            self._destroyed_streams.remove(stream_id)
        stream = Stream(stream_id=stream_id,
                        parameters=dict(parameters or {}),
                        graph_path=graph_path or self.context.graph_path,
                        queue_response=queue_response,
                        topic_response=topic_response)
        if grace_time:
            stream.lease = Lease(
                float(grace_time), stream_id,
                lease_expired_handler=self._stream_lease_expired,
                engine=self.process.event)
        self.streams[stream_id] = stream
        self._stream_current = stream
        for node in self._local_path(stream):
            element = self.elements.get(node.name)
            if element is None:
                continue
            event, _ = element.start_stream(stream, stream_id) or \
                (StreamEvent.OKAY, None)
            if event not in (StreamEvent.OKAY,):
                self.logger.error("%s: start_stream %s -> %s",
                                  self.name, node.name, event.name)
                self.destroy_stream(stream_id)
                break
        self._stream_current = None
        if stream_id in self.streams:
            # Frames posted while elements were still starting are parked
            # on the stream; this message serializes behind them and
            # replays them in order.
            from ..runtime.actor import ActorMessage, Mailbox
            self._post_message(Mailbox.IN, ActorMessage(
                "_stream_started", [stream_id]))
        return stream

    def destroy_stream(self, stream_id):
        stream_id = str(stream_id)
        stream = self.streams.pop(stream_id, None)
        if stream is None:
            return
        self._destroyed_streams.append(stream_id)
        stream.pending.clear()
        stream.state = StreamState.STOP
        if stream.lease:
            stream.lease.terminate()
        for node in self._local_path(stream):
            element = self.elements.get(node.name)
            if element is None:
                continue
            element.stop_frame_generator(stream_id)
            try:
                element.stop_stream(stream, stream_id)
            except Exception:  # noqa: BLE001
                self.logger.exception("%s: stop_stream %s failed",
                                      self.name, node.name)

    def _stream_lease_expired(self, stream_id):
        self.logger.info("%s: stream %s lease expired", self.name,
                         stream_id)
        self.destroy_stream(stream_id)

    def _local_path(self, stream: Stream) -> List:
        head = Graph.path_local(stream.graph_path)
        return list(self.graph.get_path(head))

    def current_stream(self) -> Optional[Stream]:
        return self._stream_current

    # -- frame entry points ------------------------------------------------------ #

    def post_frame(self, stream_id, frame_data: Dict[str, Any]):
        """Thread-safe: queue one frame for processing (generator threads,
        tests, local callers)."""
        from ..runtime.actor import ActorMessage, Mailbox
        self._post_message(Mailbox.IN, ActorMessage(
            "_frame_local", [str(stream_id), frame_data]))

    def post_stream_stop(self, stream_id, event: StreamEvent):
        # Goes to the IN mailbox so the stop serializes *behind* frames the
        # generator already posted (CONTROL would destroy the stream first
        # and orphan them — priority inversion).
        from ..runtime.actor import ActorMessage, Mailbox
        self._post_message(Mailbox.IN, ActorMessage(
            "_stream_stop", [str(stream_id), int(event)]))

    def queued_frame_count(self) -> int:
        # Parked pending frames (streams still starting) count too, so
        # the generator backpressure gate can't be bypassed during a
        # slow start (model load in a later element's start_stream).
        parked = sum(len(stream.pending)
                     for stream in list(self.streams.values()))
        return self.process.event.mailbox_size(self._mailbox_in) + parked

    def _frame_retry(self, stream_id, swag, resume_at,
                     caller_frame_id=None):
        stream = self.streams.get(str(stream_id))
        if stream is None:
            return   # stream died while the frame was parked
        frame = Frame(frame_id=stream.frame_id, swag=dict(swag),
                      caller_frame_id=caller_frame_id)
        stream.frame_id += 1
        stream.frames[frame.frame_id] = frame
        frame.metrics["time_start"] = time.perf_counter()
        self._process_frame_common(stream, frame, resume_at=resume_at)

    def _stream_started(self, stream_id):
        stream = self.streams.get(str(stream_id))
        if stream is None:
            return
        stream.started = True
        pending, stream.pending = stream.pending, []
        for kind, *payload in pending:
            if kind == "frame":
                frame_data, caller_frame_id = payload
                self._run_frame(stream, frame_data,
                                caller_frame_id=caller_frame_id)
            elif kind == "stop":
                # Route through the drain-aware stop: frames replayed
                # just above may already be paused at a remote element.
                self._stream_stop_command(stream.stream_id, payload[0])
                return

    def _stream_stop_command(self, stream_id, event_value):
        stream = self.streams.get(str(stream_id))
        if stream is not None and not stream.started:
            # Keep FIFO semantics: the stop must run after the parked
            # frames it followed, not destroy the stream out from under
            # them.
            stream.pending.append(("stop", event_value))
            return
        if stream is not None and stream.frames and \
                int(event_value) != int(StreamEvent.ERROR):
            # Plain-int compare: values above StreamEvent.USER are
            # user-defined (stream.py:35) and would make the enum
            # constructor raise mid-drain.
            # Graceful drain: the mailbox serializes the stop behind
            # QUEUED frames, but frames already dispatched and paused
            # at a remote element are in stream.frames awaiting their
            # MQTT response — destroying now would discard them.  STOP
            # state blocks new frames; the last completion destroys
            # the stream (_complete_frame), the lease is the backstop.
            self.logger.info("%s: stream %s draining %d in-flight "
                             "frame(s) before stop", self.name,
                             stream_id, len(stream.frames))
            stream.state = StreamState.STOP
            return
        self.destroy_stream(stream_id)

    def _frame_local(self, stream_id, frame_data):
        stream_id = str(stream_id)
        stream = self.streams.get(stream_id)
        if stream is None:
            if stream_id in self._destroyed_streams:
                return   # late frame for a dead stream: drop
            stream = self.create_stream(stream_id)
        if not stream.started:
            stream.pending.append(("frame", dict(frame_data), None))
            return
        self._run_frame(stream, dict(frame_data))

    def _wire_process_frame(self, stream_dict, inputs_dict=None):
        """Remote caller entry: ``(process_frame (stream_id: … frame_id: …
        topic_response: …) (name: tagged-value …))``."""
        if not isinstance(stream_dict, dict):
            return
        stream_id = stream_dict.get("stream_id", DEFAULT_STREAM_ID)
        stream = self.streams.get(str(stream_id))
        if stream is None:
            stream = self.create_stream(
                stream_id,
                graph_path=stream_dict.get("graph_path"),
                topic_response=stream_dict.get("topic_response"))
        elif stream_dict.get("topic_response"):
            stream.topic_response = stream_dict["topic_response"]
        frame_data = decode_swag(inputs_dict or {})
        caller_frame_id = stream_dict.get("frame_id")
        if not stream.started:
            stream.pending.append(("frame", frame_data, caller_frame_id))
            return
        self._run_frame(stream, frame_data,
                        caller_frame_id=caller_frame_id)

    def _wire_process_frame_response(self, stream_dict, outputs_dict=None):
        """Remote element completed: resume the paused frame."""
        if not isinstance(stream_dict, dict):
            return
        stream = self.streams.get(str(stream_dict.get("stream_id")))
        if stream is None:
            return
        try:
            frame_id = int(stream_dict.get("caller_frame_id",
                                           stream_dict.get("frame_id")))
        except (TypeError, ValueError):
            return
        frame = stream.frames.get(frame_id)
        if frame is None or frame.paused_pe_name is None:
            return
        resume_after = frame.paused_pe_name
        frame.swag.update(self._apply_map_out(
            resume_after, decode_swag(outputs_dict or {})))
        frame.paused_pe_name = None
        self._process_frame_common(stream, frame, resume_after=resume_after)

    # -- the hot loop -------------------------------------------------------------- #

    def _run_frame(self, stream: Stream, frame_data: Dict[str, Any],
                   caller_frame_id=None):
        if stream.state in (StreamState.STOP, StreamState.ERROR):
            return
        frame = Frame(frame_id=stream.frame_id, swag=dict(frame_data),
                      caller_frame_id=caller_frame_id)
        stream.frame_id += 1
        stream.frames[frame.frame_id] = frame
        if stream.lease:
            stream.lease.extend()
        frame.metrics["time_start"] = time.perf_counter()
        self._process_frame_common(stream, frame)

    def _process_frame_common(self, stream: Stream, frame: Frame,
                              resume_after: Optional[str] = None,
                              resume_at: Optional[str] = None):
        head = Graph.path_local(stream.graph_path)
        if resume_after is not None:
            nodes = self.graph.iterate_after(resume_after, head)
        else:
            nodes = list(self.graph.get_path(head))
            if resume_at is not None:
                names = [n.name for n in nodes]
                if resume_at in names:
                    nodes = nodes[names.index(resume_at):]
        nodes = list(nodes)
        self._stream_current = stream
        stream.frame = frame
        try:
            i = 0
            while i < len(nodes):
                node = nodes[i]
                stage = self._fused_stages.get(node.name)
                if stage is not None and \
                        [n.name for n in
                         nodes[i:i + len(stage.node_names)]] == \
                        stage.node_names:
                    started = time.perf_counter()
                    try:
                        frame.swag = stage(frame.swag)
                    except Exception:  # noqa: BLE001
                        self.logger.exception("%s: fused stage %s failed",
                                              self.name, stage.name)
                        self._handle_stream_event(stream, frame,
                                                  stage.name,
                                                  StreamEvent.ERROR)
                        return
                    # Wall time around an ASYNC dispatch: honest label is
                    # dispatch time, not device time.
                    frame.metrics[f"time_{stage.name}"] = \
                        time.perf_counter() - started
                    interval = self._device_metrics_interval
                    if interval and frame.frame_id % interval == 0:
                        # Sampled device-true timing: sync this stage's
                        # program and stamp dispatch -> completion.
                        stage.sync_outputs(frame.swag)
                        frame.metrics[f"time_{stage.name}_device"] = \
                            time.perf_counter() - started
                    i += len(stage.node_names)
                    continue
                element = self.elements.get(node.name)
                if element is not None:
                    if not self._invoke_local(stream, frame, node, element):
                        return
                else:
                    self._invoke_remote(stream, frame, node)
                    return   # frame paused; response resumes it
                i += 1
            self._complete_frame(stream, frame)
        finally:
            stream.frame = None
            self._stream_current = None

    def _gather_inputs(self, frame: Frame, node) -> Dict[str, Any]:
        definition = self.definition.element(node.name)
        mapping = self._input_sources.get(node.name, {})
        inputs = {}
        for io in definition.input:
            name = io["name"]
            source = mapping.get(name, name)
            if source in frame.swag:
                inputs[name] = frame.swag[source]
        return inputs

    def _invoke_local(self, stream, frame, node, element) -> bool:
        inputs = self._gather_inputs(frame, node)
        started = time.perf_counter()
        try:
            event, outputs = element.process_frame(stream, **inputs)
        except Exception:  # noqa: BLE001
            self.logger.exception("%s: %s.process_frame failed",
                                  self.name, node.name)
            event, outputs = StreamEvent.ERROR, {}
        frame.metrics[f"time_{node.name}"] = time.perf_counter() - started
        if event == StreamEvent.OKAY:
            frame.swag.update(
                self._apply_map_out(node.name, dict(outputs or {})))
            return True
        self._handle_stream_event(stream, frame, node.name, event)
        return False

    def _invoke_remote(self, stream, frame, node):
        proxy = self.remote_proxies.get(node.name)
        if proxy is None:
            # Not discovered yet: park the frame and retry *at* this node
            # once the proxy may exist (reference retry-until-discovered,
            # pipeline.py:1068-1076) — upstream elements must not re-run.
            from ..runtime.actor import ActorMessage, Mailbox
            self.logger.info("%s: remote %s not ready; retrying",
                             self.name, node.name)
            stream.frames.pop(frame.frame_id, None)
            self._post_message(Mailbox.IN, ActorMessage(
                "_frame_retry",
                [stream.stream_id, frame.swag, node.name,
                 frame.caller_frame_id]),
                delay=REMOTE_RETRY_DELAY)
            return
        frame.paused_pe_name = node.name
        inputs = self._gather_inputs(frame, node)
        stream_dict = {
            "stream_id": stream.stream_id,
            "frame_id": str(frame.frame_id),
            "caller_frame_id": str(frame.frame_id),
            "topic_response": self.topic_in,
        }
        remote_path = Graph.path_remote(stream.graph_path)
        if remote_path:
            stream_dict["graph_path"] = remote_path
        proxy.process_frame(stream_dict, encode_swag(inputs))

    def _complete_frame(self, stream: Stream, frame: Frame):
        frame.metrics["time_pipeline"] = (
            time.perf_counter() - frame.metrics.pop("time_start",
                                                    time.perf_counter()))
        self._frames_processed += 1
        stream.frames.pop(frame.frame_id, None)
        outputs = self._final_outputs(frame)
        if stream.queue_response is not None:
            stream.queue_response.put((stream, frame, outputs))
        elif stream.topic_response:
            caller_id = frame.caller_frame_id \
                if frame.caller_frame_id is not None else frame.frame_id
            stream_dict = {"stream_id": stream.stream_id,
                           "caller_frame_id": str(caller_id),
                           "frame_id": str(frame.frame_id)}
            self.process.message.publish(
                stream.topic_response,
                generate("process_frame_response",
                         [stream_dict, encode_swag(outputs)]))
        else:
            self.process.message.publish(
                self.topic_out,
                generate("frame_complete",
                         [{"stream_id": stream.stream_id,
                           "frame_id": str(frame.frame_id)},
                          encode_swag(outputs)]))
        if stream.state == StreamState.STOP and not stream.frames \
                and stream.stream_id in self.streams:
            # Last in-flight frame of a draining (STOPped) stream has
            # delivered its outputs: now tear the stream down for real.
            self.destroy_stream(stream.stream_id)

    def _final_outputs(self, frame: Frame) -> Dict[str, Any]:
        """Outputs of the path's terminal elements (fall back to whole
        swag when no outputs are declared)."""
        terminal_outputs: Dict[str, Any] = {}
        for node in self.graph.nodes():
            if not node.successors:
                definition = self.definition.element(node.name)
                if definition:
                    for io in definition.output:
                        if io["name"] in frame.swag:
                            terminal_outputs[io["name"]] = \
                                frame.swag[io["name"]]
        return terminal_outputs or dict(frame.swag)

    def _handle_stream_event(self, stream, frame, element_name,
                             event: StreamEvent):
        state = STREAM_EVENT_TO_STATE.get(event, StreamState.ERROR)
        stream.frames.pop(frame.frame_id, None)
        if state == StreamState.DROP_FRAME:
            # This frame dies quietly; the stream lives — unless it was
            # the LAST in-flight frame of a draining (STOPped) stream,
            # whose teardown this drop must now perform (mirrors
            # _complete_frame; without it a drain ending in DROP_FRAME
            # leaks the stream forever when it has no lease).
            if stream.state == StreamState.STOP and not stream.frames \
                    and stream.stream_id in self.streams:
                self.destroy_stream(stream.stream_id)
            return
        if state in (StreamState.STOP, StreamState.ERROR):
            self.logger.info("%s: stream %s -> %s at %s", self.name,
                             stream.stream_id, state.name, element_name)
            if state == StreamState.STOP and stream.frames:
                # Graceful drain (reference destroy_stream's delayed
                # self-message drain, main/pipeline.py:849-917): a
                # source's STOP must not discard frames still in
                # flight — e.g. paused at a remote element awaiting
                # their MQTT response.  STOP state blocks new frames
                # (_run_frame); the last completion destroys the
                # stream (_complete_frame), the lease is the backstop.
                stream.state = StreamState.STOP
                return
            self.destroy_stream(stream.stream_id)

    # -- stats / parameters ------------------------------------------------------- #

    def _stats_timer(self):
        if self.ec_producer is not None:
            if self.share.get("streams") != len(self.streams):
                self.ec_producer.update("streams", len(self.streams))
            if self.share.get("frames_processed") != \
                    self._frames_processed:
                self.ec_producer.update("frames_processed",
                                        self._frames_processed)
            ready = all(proxy is not None
                        for proxy in self.remote_proxies.values())
            lifecycle = "ready" if ready else "waiting_remotes"
            if self.share.get("lifecycle") != lifecycle:
                self.ec_producer.update("lifecycle", lifecycle)

    def set_element_parameter(self, element_name, name, value):
        element = self.elements.get(str(element_name))
        if element is not None:
            element.set_parameter(str(name), value)

    # -- shutdown ------------------------------------------------------------------- #

    def stop(self):
        for stream_id in list(self.streams):
            self.destroy_stream(stream_id)
        self.process.event.remove_timer_handler(self._stats_timer)
        for element in self.elements.values():
            element.stop()
        super().stop()
