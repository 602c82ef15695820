"""Client side of the serving wire protocol.

The port's copy of ``aiko_services_tpu/orchestration/client.py`` (it has
no JAX in it); its imports point at the port's own modules.

Every replica kind (:class:`~.serving.ModelReplica`,
:class:`~.continuous.ContinuousReplica`, and a
:class:`~.serving.ReplicaRouter` front) speaks the same idiom:
``(infer request_id response_topic swag)`` in, ``(infer_response …)``
out, with optional ``(infer_partial …)`` streaming increments and
``(infer_cancel id)``.  :class:`InferClient` packages that idiom so an
application never hand-rolls S-expressions — the serving analog of the
reference's ``get_actor_mqtt`` reflection proxies
(reference main/transport/transport_mqtt.py:122-141; those are
fire-and-forget, while inference needs a response/streaming channel,
hence a dedicated client).

Futures, not blocking waits: the event engine may be driven by a
VirtualClock in tests or run in a thread in an application, so
``submit`` returns an :class:`InferFuture` that fills as messages
arrive; ``wait`` blocks on a condition variable that the response
handler wakes (real engines only).
"""

from __future__ import annotations

import itertools
import threading
import uuid
from typing import Callable, Dict, List, Optional

import numpy as np

from ..obs import trace
from ..pipeline.codec import decode_swag, encode_swag
from ..utils.sexpr import generate, parse

__all__ = ["InferClient", "InferFuture"]


class InferFuture:
    """Fills as the replica responds; readable at any time."""

    def __init__(self, request_id: str):
        self.request_id = request_id
        #: tokens streamed so far (partials; equals the final sequence
        #: once done when the request streamed).
        self.partial_tokens: List[int] = []
        self.outputs: Optional[Dict] = None      # full response swag
        self.error: Optional[str] = None
        self.done = False
        self.on_partial: Optional[Callable[[List[int]], None]] = None
        #: Full request span tree (root + router + replica + kv
        #: source spans) when tracing was on at submit — the remote
        #: spans ride back on the response's ``trace_spans`` field.
        self.spans: List = []
        self._root_span = None
        self._event = threading.Event()

    def _resolve(self, outputs: Optional[Dict], error) -> None:
        """Terminal transition: set results, then wake waiters."""
        if self.done:
            return
        if outputs is not None:
            self.outputs = outputs
        self.error = str(error) if error is not None else None
        self.done = True
        self._event.set()

    @property
    def tokens(self) -> List[int]:
        """Final tokens when done, streamed prefix otherwise."""
        if self.outputs is not None and "tokens_out" in self.outputs:
            return [int(t) for t in
                    np.asarray(self.outputs["tokens_out"])]
        return list(self.partial_tokens)


class InferClient:
    """Submit inference requests to a replica (or router) topic and
    collect responses on a private reply topic."""

    def __init__(self, process, topic_in: str):
        self.process = process
        self.topic_in = topic_in
        self._futures: Dict[str, InferFuture] = {}
        # Globally unique client id: request ids must not collide
        # across OS processes sharing one replica, or a cancel from
        # one client could retire another's request.
        self._uid = uuid.uuid4().hex[:10]
        self._counter = itertools.count()
        self.response_topic = (f"{process.topic_path_process}"
                               f"/infer_client/{self._uid}")
        process.add_message_handler(self._on_message,
                                    self.response_topic)

    # ------------------------------------------------------------- #

    def submit(self, tokens, max_new_tokens: int = 16,
               stream: bool = False, adapter: Optional[str] = None,
               temperature: float = 0.0, top_p: float = 1.0,
               on_partial=None,
               deadline_s: Optional[float] = None,
               request_id: Optional[str] = None,
               kv_source: Optional[str] = None,
               kv_migrate: bool = False) -> InferFuture:
        """Send one ``(infer …)``; returns the future immediately.

        ``deadline_s`` is a client-relative budget: the replica rejects
        the request at admission or evicts it from its slot once the
        budget elapses (``error="deadline_exceeded"``), and routers
        stop re-dispatching it.

        ``kv_source`` names the replica (its topic path) that holds the
        prompt's prefix: a paged replica pulls the prefix blocks from it
        before admission instead of prefilling them (the hint a router
        gives; ``kv_migrate`` marks a live migration's resume).
        """
        swag: Dict = {"tokens": np.asarray(tokens, np.int32),
                      "max_new_tokens": int(max_new_tokens)}
        if stream:
            swag["stream"] = 1
        if adapter:
            swag["adapter"] = adapter
        if temperature:
            swag["temperature"] = float(temperature)
            swag["top_p"] = float(top_p)
        if deadline_s is not None:
            swag["deadline_ms"] = int(float(deadline_s) * 1e3)
        if kv_source:
            swag["kv_source"] = str(kv_source)
        if kv_migrate:
            swag["kv_migrate"] = 1
        return self._send("infer", swag, on_partial=on_partial,
                          request_id=request_id)

    def load_adapter(self, name: str, path: str) -> InferFuture:
        """Hot-deploy a PEFT-layout adapter checkpoint directory to
        the replica; the future resolves with the ack (``ok``/
        ``error`` and the loaded-adapter list).  ContinuousReplica
        only — other replica kinds ack with ``unsupported_command``."""
        return self._send("adapter_load", {"name": name,
                                           "path": path}, prefix="a")

    def unload_adapter(self, name: str) -> InferFuture:
        return self._send("adapter_unload", {"name": name},
                          prefix="a")

    def _send(self, command: str, swag: Dict, on_partial=None,
              request_id: Optional[str] = None,
              prefix: str = "c") -> InferFuture:
        """Register a future and publish ONE wire command carrying
        (request_id, reply topic, swag) — the shared tail of every
        request kind."""
        request_id = request_id or \
            f"{prefix}{self._uid}_{next(self._counter)}"
        future = InferFuture(request_id)
        future.on_partial = on_partial
        if trace.TRACER is not None and command == "infer":
            span = trace.TRACER.start_span(
                "infer", attrs={"request_id": request_id,
                                "target": self.topic_in})
            swag = dict(swag, trace=trace.inject(span))
            future._root_span = span
        self._futures[request_id] = future
        self.process.message.publish(
            self.topic_in,
            generate(command, [request_id, self.response_topic,
                               encode_swag(swag)]))
        return future

    def cancel(self, future: InferFuture) -> None:
        """``(infer_cancel …)`` — the cancelled response resolves the
        future with ``error="cancelled"`` and any partial tokens.  The
        reply topic rides along so a router can resolve cancels it no
        longer has a route for (``error="cancel_unrouted"``)."""
        self.process.message.publish(
            self.topic_in,
            generate("infer_cancel", [future.request_id,
                                      self.response_topic]))

    def wait(self, future: InferFuture, timeout: float = 30.0,
             poll: Optional[float] = None) -> InferFuture:
        """Block until done — for REAL engines (an engine thread is
        pumping); under a VirtualClock drive the engine instead.

        Sleeps on the future's event (woken by the response handler —
        no polling; ``poll`` is accepted for back-compat and ignored).
        On timeout the future resolves with ``error="timeout"`` —
        distinguishable from a replica-side ``error="cancelled"`` —
        and is forgotten, so a late reply is dropped rather than
        resolving an abandoned request.
        """
        del poll
        if not future._event.wait(timeout):
            # Lost the race vs. _on_message?  _resolve is idempotent:
            # whichever terminal state landed first stands.
            future._resolve(None, "timeout")
            self.forget(future)
        return future

    def forget(self, future: InferFuture) -> None:
        """Abandon a request: late replies/partials for it are dropped
        (the entry for a target that never responds otherwise lives as
        long as the client)."""
        self._futures.pop(future.request_id, None)

    # ------------------------------------------------------------- #

    def _on_message(self, _topic, payload):
        command, params = parse(payload)
        if command not in ("infer_response", "infer_partial",
                           "adapter_response") or len(params) < 2:
            return
        future = self._futures.get(str(params[0]))
        if future is None:
            return
        try:
            outputs = decode_swag(params[1])
        except Exception:
            # A mangled final response still resolves the future — a
            # corrupt partial is merely dropped (the final response
            # carries the authoritative token list anyway).
            if command == "infer_partial":
                return
            future._resolve({"error": "corrupt_response"},
                            "corrupt_response")
            self._futures.pop(future.request_id, None)
            return
        if command == "infer_partial":
            if future._root_span is not None and \
                    not future.partial_tokens:
                future._root_span.mark("client_first_token")
            increment = [int(t) for t in
                         np.asarray(outputs["tokens_out"])]
            future.partial_tokens.extend(increment)
            if future.on_partial is not None:
                future.on_partial(increment)
            return
        if future._root_span is not None:
            root = future._root_span
            if trace.TRACER is not None:
                trace.TRACER.finish(root)
            elif root.end is None:
                root.end = root.start
            remote = outputs.get("trace_spans")
            future.spans = [root] + (trace.decode_spans(remote)
                                     if remote else [])
        future._resolve(outputs, outputs.get("error"))
        # pop, not del: a concurrent forget() may have removed the
        # entry between the get() above and here (documented usage
        # after a wait() timeout).
        self._futures.pop(future.request_id, None)
