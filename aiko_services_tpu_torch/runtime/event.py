"""Event engine: timers, mailboxes, queues, flatout handlers.

The port's copy of ``aiko_services_tpu/runtime/event.py`` (it has no JAX
in it); its imports point at the port's own modules.

The per-process cooperative scheduler every Service/Actor runs on.  API
parity with the reference engine (upstream aiko_services ``main/
event.py:72-322``): ``add_timer_handler`` / ``add_mailbox_handler`` /
``add_queue_handler`` / ``add_flatout_handler``, ``mailbox_put`` /
``queue_put``, ``loop()`` / ``terminate()``.  Differences, by design:

* **No polling.**  The reference sleeps 10 ms per iteration
  (``event.py:282``), bounding timer resolution and message latency; this
  engine blocks on a condition variable and wakes exactly when the next
  timer is due or work is posted.  Idle CPU is zero and cross-actor message
  latency is dominated by the handler itself.
* **Deterministic test clock.**  Construct with ``clock=VirtualClock()`` and
  drive time with ``advance(dt)`` — timers fire synchronously, making
  lease/election tests exact instead of sleep-and-hope.
* **Mailbox priority** is explicit (``priority=True``) rather than
  first-registered-wins; registration order still breaks ties, so an Actor
  registering CONTROL before IN gets the reference's semantics.

Thread model: producers (transport threads, frame generators) may call
``mailbox_put``/``queue_put`` from any thread; handlers always run on the
thread inside ``loop()`` (or the caller of ``drain()`` in tests).
"""

from __future__ import annotations

import heapq
import itertools
import threading
import time as _time
from collections import deque
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional

__all__ = [
    "EventEngine", "VirtualClock", "event",
    # module-level convenience API on the default engine:
    "add_timer_handler", "remove_timer_handler",
    "add_mailbox_handler", "remove_mailbox_handler", "mailbox_put",
    "add_queue_handler", "remove_queue_handler", "queue_put",
    "add_flatout_handler", "remove_flatout_handler",
    "loop", "terminate",
]

_FLATOUT_SLEEP = 0.001  # cap flatout handlers near 1 kHz, as the reference


class VirtualClock:
    """Manually advanced clock for deterministic tests."""

    def __init__(self, start: float = 0.0):
        self._now = start

    def now(self) -> float:
        return self._now

    def advance(self, dt: float):
        self._now += dt


class _WallClock:
    now = staticmethod(_time.monotonic)


@dataclass(order=True)
class _Timer:
    next_fire: float
    seq: int
    handler: Callable = field(compare=False)
    period: float = field(compare=False, default=0.0)
    once: bool = field(compare=False, default=False)
    cancelled: bool = field(compare=False, default=False)


class _Mailbox:
    __slots__ = ("name", "handler", "priority", "items", "high_water")

    def __init__(self, name, handler, priority):
        self.name = name
        self.handler = handler
        self.priority = priority
        self.items: deque = deque()
        self.high_water = 0


class EventEngine:
    def __init__(self, clock=None):
        self._clock = clock or _WallClock()
        self._cv = threading.Condition()
        self._timers: List[_Timer] = []
        self._timer_by_handler: Dict[Callable, List[_Timer]] = {}
        self._seq = itertools.count()
        self._mailboxes: Dict[str, _Mailbox] = {}
        self._queues: Dict[str, deque] = {}
        self._queue_handlers: Dict[str, Callable] = {}
        self._flatout: List[Callable] = []
        self._running = False
        self._loop_thread: Optional[threading.Thread] = None

    def now(self) -> float:
        """Current engine time — virtual under a VirtualClock, wall
        monotonic otherwise.  Timestamps that feed timer scheduling
        (e.g. router re-dispatch deadlines) must come from HERE, not
        ``time.monotonic()``, or deterministic tests can't advance
        them."""
        return self._clock.now()

    # -- timers ------------------------------------------------------------ #

    def add_timer_handler(self, handler: Callable, period: float,
                          immediate: bool = False, once: bool = False):
        with self._cv:
            now = self._clock.now()
            timer = _Timer(now if immediate else now + period,
                           next(self._seq), handler, period, once)
            heapq.heappush(self._timers, timer)
            self._timer_by_handler.setdefault(handler, []).append(timer)
            self._cv.notify_all()

    def remove_timer_handler(self, handler: Callable):
        with self._cv:
            for timer in self._timer_by_handler.pop(handler, []):
                timer.cancelled = True
            self._cv.notify_all()

    # -- mailboxes --------------------------------------------------------- #

    def add_mailbox_handler(self, handler: Callable, name: str,
                            priority: bool = False):
        with self._cv:
            self._mailboxes[name] = _Mailbox(name, handler, priority)

    def remove_mailbox_handler(self, name: str):
        with self._cv:
            self._mailboxes.pop(name, None)

    def mailbox_put(self, name: str, item: Any, delay: float = 0.0):
        if delay and delay > 0:
            self.add_timer_handler(
                lambda: self.mailbox_put(name, item), delay, once=True)
            return
        with self._cv:
            mailbox = self._mailboxes.get(name)
            if mailbox is None:
                return
            mailbox.items.append(item)
            mailbox.high_water = max(mailbox.high_water, len(mailbox.items))
            self._cv.notify_all()

    def mailbox_size(self, name: str) -> int:
        with self._cv:
            mailbox = self._mailboxes.get(name)
            return len(mailbox.items) if mailbox else 0

    def mailbox_high_water(self, name: str) -> int:
        with self._cv:
            mailbox = self._mailboxes.get(name)
            return mailbox.high_water if mailbox else 0

    # -- queues ------------------------------------------------------------ #

    def add_queue_handler(self, handler: Callable, name: str):
        with self._cv:
            self._queue_handlers[name] = handler
            self._queues.setdefault(name, deque())

    def remove_queue_handler(self, name: str):
        with self._cv:
            self._queue_handlers.pop(name, None)
            self._queues.pop(name, None)

    def queue_put(self, item: Any, name: str):
        with self._cv:
            if name not in self._queue_handlers:
                return
            self._queues[name].append(item)
            self._cv.notify_all()

    # -- flatout ----------------------------------------------------------- #

    def add_flatout_handler(self, handler: Callable):
        with self._cv:
            self._flatout.append(handler)
            self._cv.notify_all()

    def remove_flatout_handler(self, handler: Callable):
        with self._cv:
            try:
                self._flatout.remove(handler)
            except ValueError:
                pass

    # -- execution --------------------------------------------------------- #

    def _due_timers(self, now: float) -> List[_Timer]:
        due = []
        while self._timers and self._timers[0].next_fire <= now:
            timer = heapq.heappop(self._timers)
            if timer.cancelled:
                continue
            due.append(timer)
            if not timer.once:
                timer.next_fire = now + timer.period
                heapq.heappush(self._timers, timer)
        return due

    def _next_deadline(self) -> Optional[float]:
        while self._timers and self._timers[0].cancelled:
            heapq.heappop(self._timers)
        return self._timers[0].next_fire if self._timers else None

    def _collect_work(self) -> List[Callable]:
        """Gather runnable callbacks under the lock; run them outside it."""
        work: List[Callable] = []
        now = self._clock.now()
        for timer in self._due_timers(now):
            work.append(timer.handler)
            if timer.once:
                timers = self._timer_by_handler.get(timer.handler)
                if timers and timer in timers:
                    timers.remove(timer)
        # Priority mailboxes first, then registration order.
        boxes = sorted(self._mailboxes.values(),
                       key=lambda m: not m.priority)
        for mailbox in boxes:
            while mailbox.items:
                item = mailbox.items.popleft()
                work.append(lambda h=mailbox.handler, n=mailbox.name,
                            i=item: h(n, i))
        for name, handler in list(self._queue_handlers.items()):
            queue = self._queues.get(name)
            while queue:
                item = queue.popleft()
                work.append(lambda h=handler, i=item: h(i))
        return work

    def drain(self, max_cycles: int = 10_000) -> int:
        """Run pending (non-timer-future) work to quiescence; returns the
        number of callbacks executed.  This is the test-mode pump."""
        executed = 0
        for _ in range(max_cycles):
            with self._cv:
                work = self._collect_work()
            if not work:
                return executed
            for callback in work:
                callback()
                executed += 1
        raise RuntimeError("EventEngine.drain did not quiesce")

    def advance(self, dt: float, step: float = None):
        """Virtual-clock mode: advance time firing timers in order."""
        if not isinstance(self._clock, VirtualClock):
            raise RuntimeError("advance() requires a VirtualClock")
        target = self._clock.now() + dt
        while True:
            self.drain()
            with self._cv:
                deadline = self._next_deadline()
            if deadline is None or deadline > target:
                break
            self._clock._now = max(self._clock.now(), deadline)
            self.drain()
        self._clock._now = target
        self.drain()

    def loop(self):
        """Blocking scheduler loop (runs until ``terminate()``)."""
        self._running = True
        self._loop_thread = threading.current_thread()
        try:
            while self._running:
                with self._cv:
                    work = self._collect_work()
                    if not work:
                        if self._flatout:
                            timeout = _FLATOUT_SLEEP
                        else:
                            deadline = self._next_deadline()
                            timeout = (None if deadline is None
                                       else max(0.0, deadline
                                                - self._clock.now()))
                        if not self._running:
                            break
                        self._cv.wait(timeout)
                        continue
                for callback in work:
                    if not self._running:
                        break
                    callback()
                for handler in list(self._flatout):
                    handler()
        finally:
            self._running = False
            self._loop_thread = None

    def run_in_thread(self, daemon: bool = True) -> threading.Thread:
        thread = threading.Thread(target=self.loop, daemon=daemon,
                                  name="aiko-event-loop")
        thread.start()
        return thread

    def terminate(self):
        with self._cv:
            self._running = False
            self._cv.notify_all()

    @property
    def running(self) -> bool:
        return self._running


# Default per-process engine, mirroring the reference's module-level API.
event = EventEngine()


def add_timer_handler(handler, period, immediate=False, once=False):
    event.add_timer_handler(handler, period, immediate, once)

def remove_timer_handler(handler):
    event.remove_timer_handler(handler)

def add_mailbox_handler(handler, name, priority=False):
    event.add_mailbox_handler(handler, name, priority)

def remove_mailbox_handler(name):
    event.remove_mailbox_handler(name)

def mailbox_put(name, item, delay=0.0):
    event.mailbox_put(name, item, delay)

def add_queue_handler(handler, name):
    event.add_queue_handler(handler, name)

def remove_queue_handler(name):
    event.remove_queue_handler(name)

def queue_put(item, name):
    event.queue_put(item, name)

def add_flatout_handler(handler):
    event.add_flatout_handler(handler)

def remove_flatout_handler(handler):
    event.remove_flatout_handler(handler)

def loop():
    event.loop()

def terminate():
    event.terminate()
