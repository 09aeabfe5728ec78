"""Reference "chat" application used by tests and the demo
(reference: src/dummy/)."""

from .state import State

__all__ = ["State"]
