"""ProcessManager: OS child-process supervisor.

The port's copy of ``aiko_services_tpu/orchestration/process_manager.py``
(it has no JAX in it); its imports point at the port's own modules.

Reference parity: upstream aiko_services ``main/
process_manager.py:48-110``.  ``create(id, command, arguments)`` resolves
python-module commands to the interpreter, Popens the child, and a poll
timer (0.2 s) detects exits and fires the exit handler;
``delete(id, kill=…)`` terminates or kills.
"""

from __future__ import annotations

import os
import shutil
import subprocess
import sys
from typing import Callable, Dict, List, Optional

from ..utils.logger import get_logger
from ..runtime.event import EventEngine, event as default_engine

__all__ = ["ProcessManager"]

_logger = get_logger(__name__)
POLL_PERIOD = 0.2  # reference process_manager.py:41


class ProcessManager:
    """``exit_handler(id, argv, return_code)`` fires exactly once per
    child that leaves on its own: ``return_code`` is the OS exit code,
    or ``None`` when the spawn itself failed (the supervisor contract —
    a crash-loop detector needs the code, a respawn loop needs to see
    launch failures through the same funnel as deaths).  Intentional
    ``delete`` calls do NOT fire it; their outcome is the return
    value.  ``exit_codes`` keeps the last-known code per id for both
    paths."""

    def __init__(self, exit_handler: Optional[Callable] = None,
                 engine: Optional[EventEngine] = None):
        self.exit_handler = exit_handler
        self.processes: Dict[str, subprocess.Popen] = {}
        self.commands: Dict[str, List[str]] = {}
        #: id -> last observed return code (None = spawn failed).
        self.exit_codes: Dict[str, Optional[int]] = {}
        self._engine = engine or default_engine
        self._polling = False

    def __contains__(self, id) -> bool:
        return str(id) in self.processes

    def create(self, id, command: str,
               arguments: Optional[List[str]] = None,
               env: Optional[dict] = None) -> subprocess.Popen:
        """Start a child.  ``command`` may be an executable on PATH, a
        path, or a python file / ``-m module`` spec.  ``env`` entries
        are overlaid on this process's environment (e.g. a multi-host
        worker's rank and address)."""
        id = str(id)
        if id in self.processes:
            raise ValueError(f"ProcessManager already has id: {id}")
        argv = self._resolve(command) + [str(a) for a in (arguments or [])]
        child_env = None
        if env is not None:
            child_env = dict(os.environ)
            child_env.update({k: str(v) for k, v in env.items()})
        try:
            process = subprocess.Popen(argv, env=child_env)
        except OSError as error:
            # Spawn failures report through the SAME funnel as child
            # deaths (return_code None) — a supervisor's respawn loop
            # must not need a second error path — and still raise for
            # direct callers.
            _logger.warning("Child %s failed to spawn: %s", id, error)
            self.exit_codes[id] = None
            if self.exit_handler:
                self.exit_handler(id, argv, None)
            raise
        self.processes[id] = process
        self.commands[id] = argv
        if not self._polling:
            self._engine.add_timer_handler(self._poll, POLL_PERIOD)
            self._polling = True
        return process

    @staticmethod
    def _resolve(command: str) -> List[str]:
        if command.endswith(".py"):
            return [sys.executable, command]
        if command.startswith("-m "):
            return [sys.executable, "-m", command[3:]]
        if shutil.which(command):
            return [command]
        return [sys.executable, command]

    def delete(self, id, kill: bool = False, wait: float = 0.0,
               grace: Optional[float] = None) -> Optional[str]:
        """Stop a child with explicit terminate → grace-wait → kill
        escalation.  ``grace`` is how long a SIGTERM'd child gets to
        exit before SIGKILL (defaults to ``wait`` for back-compat);
        ``wait`` additionally blocks until the child is reaped after a
        kill.  Returns which path actually fired — ``"already_exited"``,
        ``"terminated"``, ``"escalated_kill"`` (the child ignored its
        grace period), or ``"killed"`` (immediate, ``kill=True``) — so
        supervisors (and the chaos kill injector) can tell a graceful
        shutdown from a hang."""
        id = str(id)
        process = self.processes.pop(id, None)
        command = self.commands.pop(id, None)
        if process is None:
            return None
        if process.poll() is not None:
            # The child exited on its own and delete() won the pop
            # race against _poll: honor ``wait`` (reap, never leave a
            # zombie behind an early return) and deliver the exit
            # notification _poll can no longer see.
            if wait:
                try:
                    process.wait(timeout=wait)
                except subprocess.TimeoutExpired:
                    pass
            self.exit_codes[id] = process.returncode
            if self.exit_handler:
                self.exit_handler(id, command, process.returncode)
            return "already_exited"
        if grace is None:
            grace = wait
        if kill:
            process.kill()
            outcome = "killed"
        else:
            process.terminate()
            outcome = "terminated"
            if grace:
                try:
                    process.wait(timeout=grace)
                except subprocess.TimeoutExpired:
                    _logger.warning(
                        "Child %s ignored SIGTERM for %.1fs — killing",
                        id, grace)
                    process.kill()
                    outcome = "escalated_kill"
        if wait:
            try:
                process.wait(timeout=wait)
            except subprocess.TimeoutExpired:
                pass
        if process.poll() is not None:
            self.exit_codes[id] = process.returncode
        return outcome

    def terminate_all(self, kill: bool = False):
        for id in list(self.processes):
            self.delete(id, kill=kill)
        if self._polling:
            self._engine.remove_timer_handler(self._poll)
            self._polling = False

    def _poll(self):
        for id, process in list(self.processes.items()):
            return_code = process.poll()
            if return_code is not None:
                self.processes.pop(id, None)
                command = self.commands.pop(id, None)
                self.exit_codes[id] = return_code
                _logger.info("Child %s exited: %s", id, return_code)
                if self.exit_handler:
                    self.exit_handler(id, command, return_code)
        if not self.processes and self._polling:
            self._engine.remove_timer_handler(self._poll)
            self._polling = False
