"""Node runtime: state machine, gossip scheduler, core façade
(reference: src/node/)."""

from .state import State, StateManager
from .validator import Validator
from .core import Core
from .node import Node
from .sentry import EquivocationProof, Sentry

__all__ = [
    "State",
    "StateManager",
    "Validator",
    "Core",
    "Node",
    "Sentry",
    "EquivocationProof",
]
