"""Minimal finite state machine.

The port's copy of ``aiko_services_tpu/utils/state_machine.py`` (it has no
JAX in it).

Replaces the upstream aiko_services dependency on the third-party
``transitions`` package (upstream ``main/state.py:21-61``), which is
not available in this environment.  Supports named transitions with
source-state guards and ``on_enter_<state>`` callbacks on a model object —
the subset the Registrar election and media examples need.  A bad transition
raises ``StateMachineError`` (the reference fatally exits; we let the caller
decide).
"""

from __future__ import annotations

from typing import Any, Dict, Iterable, List, Optional, Union

__all__ = ["StateMachine", "StateMachineError"]


class StateMachineError(Exception):
    pass


class StateMachine:
    """``transitions``: list of dicts ``{"source": str|list|"*", "trigger":
    str, "dest": str}``.  ``model`` receives ``on_enter_<dest>(event_data)``
    calls; ``event_data`` is an optional dict passed to ``transition()``."""

    def __init__(self, states: Iterable[str], initial: str,
                 transitions: List[Dict], model: Any = None):
        self.states = list(states)
        if initial not in self.states:
            raise StateMachineError(f"Unknown initial state: {initial}")
        self.state = initial
        self.model = model
        self._transitions: Dict[str, List[Dict]] = {}
        for t in transitions:
            self._transitions.setdefault(t["trigger"], []).append(t)

    def may_transition(self, trigger: str) -> bool:
        return self._find(trigger) is not None

    def _find(self, trigger: str) -> Optional[Dict]:
        for t in self._transitions.get(trigger, []):
            source: Union[str, List[str]] = t.get("source", "*")
            if source == "*" or self.state == source or (
                    isinstance(source, (list, tuple)) and self.state in source):
                return t
        return None

    def transition(self, trigger: str, event_data: Optional[Dict] = None):
        t = self._find(trigger)
        if t is None:
            raise StateMachineError(
                f"No transition {trigger!r} from state {self.state!r}")
        self.state = t["dest"]
        handler = getattr(self.model, f"on_enter_{self.state}", None)
        if handler:
            handler(event_data or {})
        return self.state
