"""Node configuration (reference: src/config/)."""

from .config import Config

__all__ = ["Config"]
