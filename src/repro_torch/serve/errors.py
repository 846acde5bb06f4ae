"""Typed failures for the serving stack (the JAX package's six, copied).

Every way a submitted request can fail *without* its solve raising is a
distinct exception type, so callers can branch on failure mode instead
of string-matching messages.  All of them subclass :class:`ServeError`
(itself a ``RuntimeError``, which keeps pre-typed callers that caught
``RuntimeError`` working).
"""
from __future__ import annotations

__all__ = ["ServeError", "DeadlineExceeded", "Overloaded", "ServerClosed",
           "WorkerCrashed", "CircuitOpen"]


class ServeError(RuntimeError):
    """Base class for serving-layer failures."""


class DeadlineExceeded(ServeError):
    """The request's deadline passed while it waited in the queue (or
    while its submit was blocked on admission)."""


class Overloaded(ServeError):
    """The bounded queue was full: the request was rejected at submit
    (``overload="reject"``) or shed from the queue head to admit a newer
    one (``overload="shed_oldest"``)."""


class ServerClosed(ServeError):
    """The server is closed (or its worker is down): the request was not
    accepted, or was dropped un-served during a non-flushing close."""


class WorkerCrashed(ServeError):
    """The worker thread crashed while this request's batch was in
    flight; the request was not served."""


class CircuitOpen(ServeError):
    """The bucket's circuit breaker is open and no fallback backend
    could serve the batch."""
