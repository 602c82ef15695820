"""Host -> device input prefetch: overlap uploads with device compute.

Port of ``aiko_services_tpu/pipeline/prefetch.py``.  A step that copies
its batch to the card inline serializes the upload behind compute; this
prefetcher keeps ``depth`` batches in flight on a background thread so
the copy of batch N+1 rides under the compute of batch N (double
buffering; ``depth=2`` is usually enough because uploads are DMA, not
device cycles).

    for batch in DevicePrefetcher(host_batches(), depth=2):
        loss = train_step(batch)

On the card each host batch (an array, or a dict / list / tuple of them)
is staged into pinned host memory and copied on the prefetcher's own
stream (:attr:`DevicePrefetcher.copy_stream`), with an event recorded
after the copy.  ``next()`` makes the consumer's current stream wait on
that event, so the copy is ordered before any use, and marks each tensor
as used on the consumer stream (``record_stream``), so the allocator does
not hand its memory to the copy stream again while the consumer may still
read it.  On the CPU a batch becomes CPU tensors (a copy).

Backpressure is structural: the bounded queue blocks the feeder thread,
so an unboundedly fast generator cannot fill device memory with staged
batches (the reference's mailbox-≥32 heuristic, made exact).  ``device``
takes the place of the JAX module's ``sharding``: with none given it is
the card, and with no card it raises.  A ``transfer`` callable replaces
the staging; its results are handed back as they are.
"""

from __future__ import annotations

import queue
import threading
from typing import Any, Callable, Iterable, Iterator, Optional

import torch

from ..device import resolve_device
from ..models.bridge import tensor_from_numpy

__all__ = ["DevicePrefetcher"]

_END = object()


def _tree_map(fn: Callable, tree: Any) -> Any:
    if isinstance(tree, dict):
        return {key: _tree_map(fn, value) for key, value in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_tree_map(fn, value) for value in tree)
    return fn(tree)


def _host_tensor(value) -> torch.Tensor:
    if torch.is_tensor(value):
        return value.detach().cpu()
    return tensor_from_numpy(value)


class DevicePrefetcher:
    """Iterate device-resident batches from a host-batch iterable."""

    def __init__(self, source: Iterable, depth: int = 2, device=None,
                 transfer: Optional[Callable[[Any], Any]] = None):
        if depth < 1:
            raise ValueError("depth must be >= 1")
        self._queue: "queue.Queue" = queue.Queue(maxsize=depth)
        self._error: Optional[BaseException] = None
        self._stop = threading.Event()
        self._done = False
        #: The stream the staged copies run on (None off the card or with
        #: a caller's ``transfer``).
        self.copy_stream: Optional[torch.cuda.Stream] = None
        self.device = None

        if transfer is None:
            self.device = resolve_device(device)
            if self.device.type == "cuda":
                self.copy_stream = torch.cuda.Stream(self.device)
            transfer = self._stage

        def put_with_stop(item) -> bool:
            """Bounded put that gives up when the consumer closed —
            otherwise a full queue strands this thread forever (and
            pins the staged device buffer)."""
            while not self._stop.is_set():
                try:
                    self._queue.put(item, timeout=0.1)
                    return True
                except queue.Full:
                    continue
            return False

        def feed():
            try:
                for item in source:
                    if self._stop.is_set():
                        return
                    staged = transfer(item)   # async copy; the bounded
                    # queue (not the copy) provides backpressure
                    if not put_with_stop(staged):
                        return
            except BaseException as error:  # noqa: BLE001 - reraised
                self._error = error
            finally:
                put_with_stop(_END)

        self._thread = threading.Thread(target=feed, daemon=True,
                                        name="aiko-device-prefetch")
        self._thread.start()

    def _stage(self, batch) -> "_Staged":
        """One host batch onto ``self.device``: pinned + copied on the copy
        stream with an event behind it on the card, a plain copy on the
        CPU."""
        if self.copy_stream is None:
            return _Staged(_tree_map(
                lambda value: _host_tensor(value).clone().to(self.device),
                batch), None)
        with torch.cuda.stream(self.copy_stream):
            value = _tree_map(
                lambda item: _host_tensor(item).pin_memory().to(
                    self.device, non_blocking=True), batch)
            event = torch.cuda.Event()
            event.record(self.copy_stream)
        return _Staged(value, event)

    def __iter__(self) -> Iterator:
        return self

    def __next__(self):
        if self._done:
            # Repeat next() after exhaustion/close: terminal, not a
            # forever-block on a queue no one feeds.
            if self._error is not None:
                raise self._error
            raise StopIteration
        item = self._queue.get()
        if item is _END:
            self._done = True
            self._thread.join(timeout=5)
            if self._error is not None:
                raise self._error
            raise StopIteration
        if not isinstance(item, _Staged):
            return item
        if item.event is not None:
            consumer = torch.cuda.current_stream(self.device)
            consumer.wait_event(item.event)
            _tree_map(lambda tensor: tensor.record_stream(consumer),
                      item.value)
        return item.value

    def close(self):
        """Stop the feeder and drain; safe to call mid-iteration."""
        self._stop.set()
        self._done = True

        def drain():
            while True:
                try:
                    self._queue.get_nowait()
                except queue.Empty:
                    return

        drain()
        self._thread.join(timeout=5)
        # The feeder's in-flight put may have landed AFTER the first
        # drain; drain again so no staged device buffer stays pinned.
        drain()

    def __enter__(self):
        return self

    def __exit__(self, *_exc):
        self.close()
        return False


class _Staged:
    """A staged batch and the event its copies end with (None off the
    card)."""

    __slots__ = ("value", "event")

    def __init__(self, value, event):
        self.value, self.event = value, event
