"""Session stickiness that composes with host-tier hibernation (port of
``bigdl_tpu/serving/router/sessions.py``).

A session is a caller-given identity spanning requests (the turns of a
chat).  The table remembers which replica last served each session and
which replica's host tier holds a hibernated stream's ``("session",
rid)`` entry.  Stickiness is a preference: a dead or breaker-open
sticky replica is skipped, the request re-routes and re-prefills
(bit-exact: deterministic prefill and the seeded key chain), and the
table is repointed.  The table is a bounded LRU: a forgotten session
degrades to a cold, affinity-scored dispatch.
"""
from __future__ import annotations

import threading
from collections import OrderedDict
from typing import Optional


class _Session:
    __slots__ = ("replica", "hibernated_on", "turns")

    def __init__(self, replica: str):
        self.replica = replica
        self.hibernated_on: Optional[str] = None
        self.turns = 0


class SessionTable:
    """Thread-safe session → replica affinity map (bounded LRU)."""

    def __init__(self, max_sessions: int = 4096):
        self.max_sessions = int(max_sessions)
        self._lock = threading.Lock()
        self._table: "OrderedDict[str, _Session]" = OrderedDict()
        self.sticky_hits = 0
        self.re_routes = 0
        self.evicted = 0

    def record(self, session_id: str, replica: str) -> None:
        """A request for ``session_id`` was dispatched to ``replica``
        (repointing clears any hibernation marker — the live stream is
        wherever it runs now)."""
        with self._lock:
            s = self._table.pop(session_id, None)
            if s is None:
                s = _Session(replica)
                while len(self._table) >= self.max_sessions:
                    self._table.popitem(last=False)
                    self.evicted += 1
            else:
                s.replica = replica
                s.hibernated_on = None
            s.turns += 1
            self._table[session_id] = s

    def lookup(self, session_id: Optional[str]) -> Optional[str]:
        """Preferred replica for the session (refreshes LRU), or None."""
        if session_id is None:
            return None
        with self._lock:
            s = self._table.pop(session_id, None)
            if s is None:
                return None
            self._table[session_id] = s
            return s.hibernated_on or s.replica

    def mark_hibernated(self, session_id: str, replica: str) -> None:
        """The session's stream hibernated into ``replica``'s host
        tier: resuming THERE promotes the chain back through the 32 MB
        chunked path instead of re-prefilling."""
        with self._lock:
            s = self._table.get(session_id)
            if s is None:
                s = _Session(replica)
                self._table[session_id] = s
            s.hibernated_on = replica

    def note_sticky_hit(self) -> None:
        with self._lock:
            self.sticky_hits += 1

    def note_re_route(self) -> None:
        with self._lock:
            self.re_routes += 1

    def forget(self, session_id: str) -> None:
        with self._lock:
            self._table.pop(session_id, None)

    def __len__(self) -> int:
        with self._lock:
            return len(self._table)

    def stats(self) -> dict:
        with self._lock:
            return {"sessions": len(self._table),
                    "max_sessions": self.max_sessions,
                    "sticky_hits": self.sticky_hits,
                    "re_routes": self.re_routes,
                    "evicted": self.evicted}
