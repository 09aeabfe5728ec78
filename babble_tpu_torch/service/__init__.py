"""HTTP observability service (reference: src/service/)."""

from .service import Service

__all__ = ["Service"]
