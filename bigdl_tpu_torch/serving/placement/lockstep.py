"""Lockstep: what one scheduler round of a tensor-parallel slot runs, the
same on every rank of the slot.

Every rank of a ``tp > 1`` slot runs the same engine over its shard of
the parameters, and a step's collectives pair up across the ranks only
if every rank runs the same rounds on the same requests.  The ranks are
handed the same requests in the same order, but each sees them arrive,
expire and get cancelled at its own time, on its own clock.  So no rank
acts on what it sees alone.  At the top of every round each rank reports
what it sees, the reports are gathered over the slot's host-side group
(``MeshSlice.control``, gloo: no device sync), and every rank derives
the same :class:`Round` from them:

- a request is named by its *key*, the index of its submission to the
  scheduler (drawn under the scheduler's lock, in queue order), which is
  the same on every rank;
- ``dead``: the requests some rank saw cancelled, past their deadline,
  or refused at submission (its queue was full, say), with the reason of
  the lowest rank that reported it.  Every rank retires them, also one
  that reaches a rank only after the verdict;
- ``admit``: the queued requests, in order, that every rank holds and
  none has retired: those the round may start;
- ``closing``: every rank is closing;
- ``asked``: the union of what the ranks' callers asked for by key (a
  hibernation, a resume);
- ``leader``: the values of the slot's lead rank (its first) for what is
  read off one clock or one gauge: the slot limit, the memory ledger's
  pressure, a batch window that ran out.

A rank with nothing to do still enters a round every :attr:`IDLE_S`:
a rank that holds a request waits in the gather for the others.  One
engine serves a slot at a time: two engines' rounds (and steps) on one
slot's groups would interleave differently on each rank.  Every rank
closes the engine; the rounds end once all of them have.  A rank whose
close gave up waiting for the others leaves them blocked in the next
gather until the process group's timeout.
"""
from __future__ import annotations

import threading
from typing import Dict, Iterable, NamedTuple, Sequence

import torch.distributed as dist


class Round(NamedTuple):
    admit: tuple             # keys every rank holds, in queue order
    dead: Dict[int, str]     # key -> "cancelled" | "deadline" | "refused"
    closing: bool            # every rank is closing
    asked: frozenset         # (what, key) any rank's caller asked for
    leader: dict             # the lead rank's values


class Lockstep:
    """One scheduler's rounds on a ``tp > 1`` slot (see the module
    docstring).  The scheduler draws a key for each submission
    (:meth:`key`), marks a submission it refused (:meth:`refuse`), and
    makes one :meth:`round` call at the top of each round."""

    #: the longest an idle rank waits before entering the next round: a
    #: request that reached one rank first starts within about this of
    #: reaching them all
    IDLE_S = 0.005

    def __init__(self, slot):
        if getattr(slot, "control", None) is None:
            raise ValueError(f"{slot!r} is not a tensor-parallel slot")
        self.slot = slot
        self._lock = threading.Lock()
        self._next = 0
        self._refused: Dict[int, str] = {}
        # verdicts on keys this rank has not drawn yet, kept for the
        # rounds after it draws them
        self._carry: Dict[int, str] = {}

    def key(self) -> int:
        """The next submission's key (call under the scheduler's lock,
        where the request joins the queue or is refused)."""
        with self._lock:
            k = self._next
            self._next += 1
            return k

    def refuse(self, key: int) -> None:
        """This rank refused the submission ``key``: the other ranks
        retire their copy at the next round."""
        with self._lock:
            self._refused[key] = "refused"

    def round(self, queued: Sequence[int], dead: Dict[int, str],
              closing: bool, asked: Iterable = (), **leader) -> Round:
        """Gather this rank's report with the others' and return the
        slot's round.  ``queued``: the keys of this rank's queue, in
        order; ``dead``: key -> reason for the requests this rank sees
        cancelled or expired; ``closing``: this rank is closing;
        ``asked``: ``(what, key)`` pairs its callers asked for;
        ``leader``: values of which only the lead rank's count."""
        with self._lock:
            mine = {**self._refused, **dead}
            self._refused.clear()
        report = (list(queued), mine, bool(closing), frozenset(asked),
                  leader)
        reports = [None] * self.slot.tp
        dist.all_gather_object(reports, report, group=self.slot.control)
        verdicts = dict(self._carry)
        for _, d, _, _, _ in reports:
            for k, why in d.items():
                verdicts.setdefault(k, why)
        with self._lock:
            drawn = self._next
        # every key below ``drawn`` is in this rank's queue (or gone) by
        # the time the scheduler applies the round under its lock
        self._carry = {k: w for k, w in verdicts.items() if k >= drawn}
        admit = []
        for ks in zip(*([k for k in q if k not in verdicts]
                        for q, _, _, _, _ in reports)):
            if any(k != ks[0] for k in ks):
                break
            admit.append(ks[0])
        return Round(tuple(admit), verdicts,
                     all(r[2] for r in reports),
                     frozenset().union(*(r[3] for r in reports)),
                     reports[0][4])
