"""Node state machine primitives.

Reference semantics: src/node/state/state.go:10-101 — six states, an
atomically-updated current state, and a bounded pool of background
routines (WGLIMIT=20) that can be waited on.
"""

from __future__ import annotations

import enum
import threading
from typing import Callable, List


class State(enum.IntEnum):
    """reference: state/state.go:10-36."""

    BABBLING = 0
    CATCHING_UP = 1
    JOINING = 2
    LEAVING = 3
    SHUTDOWN = 4
    SUSPENDED = 5

    def __str__(self) -> str:
        return {
            State.BABBLING: "Babbling",
            State.CATCHING_UP: "CatchingUp",
            State.JOINING: "Joining",
            State.LEAVING: "Leaving",
            State.SHUTDOWN: "Shutdown",
            State.SUSPENDED: "Suspended",
        }[self]


# Maximum concurrently running background routines
# (reference: state/state.go:41).
WGLIMIT = 20


class StateManager:
    """Current state + bounded background-routine pool
    (reference: state/state.go:62-101)."""

    def __init__(self) -> None:
        self._state = State.BABBLING
        self._state_lock = threading.Lock()
        self._routines_lock = threading.Lock()
        self._routines: List[threading.Thread] = []
        self._live = 0

    def get_state(self) -> State:
        with self._state_lock:
            return self._state

    def set_state(self, s: State) -> None:
        with self._state_lock:
            self._state = s

    def go_func(self, f: Callable[[], None]) -> bool:
        """Run f on a background thread if fewer than WGLIMIT are live;
        returns False when the task was declined at the cap
        (reference: state/state.go:86-97; live count mirrors its wgCount
        atomic rather than scanning threads)."""

        def wrapped() -> None:
            try:
                f()
            finally:
                with self._routines_lock:
                    self._live -= 1

        with self._routines_lock:
            if self._live >= WGLIMIT:
                return False
            self._live += 1
            if len(self._routines) >= WGLIMIT:
                self._routines = [t for t in self._routines if t.is_alive()]
            t = threading.Thread(target=wrapped, daemon=True)
            try:
                t.start()
            except Exception:
                # wrapped() never ran, so undo its accounting here or the
                # counter saturates and declines work forever.
                self._live -= 1
                return False
            self._routines.append(t)
        return True

    def wait_routines(self, timeout: float = 10.0) -> None:
        """Wait up to ``timeout`` total for live background routines
        (reference: state/state.go:99-101).

        Deliberately WALL time, not the node clock (audited for the
        babblelint clock pass, docs/static_analysis.md): the routines
        are real OS threads even under sim, and ``Thread.join`` blocks
        in wall time — a virtual deadline would never advance while
        joining and hang shutdown."""
        from ..common.clock import WALL

        deadline = WALL.monotonic() + timeout
        with self._routines_lock:
            routines = list(self._routines)
        for t in routines:
            remaining = deadline - WALL.monotonic()
            if remaining <= 0:
                break
            t.join(timeout=remaining)
