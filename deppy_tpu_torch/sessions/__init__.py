"""Stateful resolution sessions (counterpart: ``deppy_tpu/sessions/__init__.py``).

The interactive twin of a stateless resolve: a client creates a session
pinned to a catalog (the encoded problem and its decode vocabulary
retained under a lease), then drives gini-style ``assume`` / ``test`` /
``untest`` / ``resolve`` / ``explain`` ops against the retained state
instead of re-sending the whole catalog per question.  Every solve
routes through the request scheduler's session lanes
(:meth:`deppy_tpu_torch.sched.Scheduler.submit_session`) — warm-started
from the session's own last model, cold ones on the scheduler's device
in their own size class — and answers byte-identically to the
equivalent one-shot cold resolve.

Sessions are warm state like the scheduler's index and cache: exported
and imported through the checksummed snapshot stream
(:mod:`deppy_tpu_torch.fleet.snapshot`), expired by lease with a
sweeper, and bounded globally and per tenant.
"""

from .store import (Session, SessionError, SessionLost, SessionShed,
                    SessionStore)

__all__ = ["Session", "SessionError", "SessionLost", "SessionShed",
           "SessionStore"]
