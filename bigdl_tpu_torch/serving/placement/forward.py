"""Forwarding: a driver rank that carries a serving set's work to slots
held by other ranks.

The reference drives every slot of a replica set or a disaggregated pair
from one process.  The port gives each rank of a process world its own
device, so a set whose slots sit on other ranks is *forwarded*:

- every rank of the world builds the set with the same arguments (the
  channels below are made then, collectively, in the same order on every
  rank), and builds its engines of the slots that hold it.  Building
  ends with every rank's outcome gathered (:meth:`Forwarding.settle`):
  one rank's failure fails the build on every rank, at once;
- world rank 0 is the **driver**.  Only its caller submits.  The driver
  carries each request (a padded batch, a prompt, a cancel, a KV handoff,
  a control message) to the ranks of the slot that serves it, which run
  it and send the answer back;
- ``close()`` is called on every rank; a rank other than the driver
  returns once the driver's close has drained the set.

A :class:`Channel` joins the driver to one slot's ranks over two gloo
groups of its own: ``down`` (driver and the slot's ranks; the driver
broadcasts) and ``up`` (the driver and the slot's lead rank; the lead
broadcasts; none when the driver leads the slot, whose messages up stay
in the process).  On each process one thread sends on a group and one
receives on it, so no gloo group is ever used from two threads at once.
Every rank of the slot, the driver among them when it holds the slot,
runs what the driver sent in the order it was sent, on one executor
thread: the ranks of a tensor-parallel slot pair the same collectives,
and a slot's work never interleaves.

Every wait has a timeout (:attr:`Channel.TIMEOUT_S`, 60 s, against
gloo's 30 minutes): idle ends send a keep-alive every second, so a
silent peer is a lost one, and a reply that never comes is that
replica's death (:class:`~bigdl_tpu_torch.resilience.errors.\
BackendLostError`).  An error comes back as its class and message, and
the driver raises the same class.  A rank that dies is out of scope:
gloo does not survive a dead peer.
"""
from __future__ import annotations

import datetime
import importlib
import itertools
import logging
import queue
import threading
import time
from concurrent.futures import Future, TimeoutError as FutureTimeout
from typing import Callable, Dict, Optional

import torch.distributed as dist

from bigdl_tpu_torch.resilience.errors import BackendLostError
from bigdl_tpu_torch.serving.placement.slicer import PlacementError
from bigdl_tpu_torch.serving.placement.topology import world_rank

log = logging.getLogger("bigdl_tpu_torch.serving")

#: the world rank that takes a forwarded set's requests
DRIVER = 0
#: a control message (build, warmup, close) may take this many waits
CONTROL_WAITS = 10


def forwarded(placement) -> bool:
    """Whether a set placed by ``placement`` (a ``PlacementPolicy``)
    runs forwarded: a process world runs and some slot of the policy is
    not held by every rank of it.  The answer is the same on every rank.
    A set whose every slot holds every rank (a tensor-parallel slot over
    the whole world, or slots of each process's own cards) runs as
    before: every rank's caller submits the same requests."""
    if placement is None or world_rank() is None:
        return False
    world = set(range(dist.get_world_size()))
    return any(s.ranks is not None and set(s.ranks) != world
               for s in placement.slices)


def not_the_driver(what: str) -> PlacementError:
    return PlacementError(
        f"{what} on world rank {world_rank()}: a forwarded set takes its "
        f"requests on the driver, world rank {DRIVER} (build and close the "
        f"set on every rank, submit on rank {DRIVER})")


def no_world(slot, what: str) -> PlacementError:
    return PlacementError(
        f"{slot!r} for {what} is held by ranks {list(slot.ranks)}, not by "
        "this process, and no process world runs: a slot on other ranks is "
        "reached through the driver of a world (bigdl_tpu_torch.parallel."
        "init_world in every rank, or torchrun; then build the set on "
        "every rank)")


def encode_error(e: BaseException) -> tuple:
    return (type(e).__module__, type(e).__qualname__, str(e))


def decode_error(err: tuple) -> BaseException:
    """The driver's copy of an error raised on a slot's rank: the same
    class with the same message where the class can be made so, else a
    ``RuntimeError`` naming it."""
    module, qualname, msg = err
    try:
        cls = importlib.import_module(module)
        for part in qualname.split("."):
            cls = getattr(cls, part)
        if isinstance(cls, type) and issubclass(cls, BaseException):
            return cls(msg)
    except Exception:  # noqa: BLE001 - fall back to a named RuntimeError
        pass
    return RuntimeError(f"{qualname}: {msg}")


def _send(group, src: int, msg) -> None:
    dist.broadcast_object_list([msg], src=src, group=group)


def _recv(group, src: int):
    box = [None]
    dist.broadcast_object_list(box, src=src, group=group)
    return box[0]


def _join(threads, seconds: float, what: str) -> None:
    """Join ``threads`` within ``seconds`` in all; ``BackendLostError``
    naming those still running after it."""
    deadline = time.monotonic() + seconds
    for t in threads:
        t.join(max(0.0, deadline - time.monotonic()))
    alive = [t.name for t in threads if t.is_alive()]
    if alive:
        raise BackendLostError(f"{what}: {alive} still running after "
                               f"{seconds:.0f} s")


class Channel:
    """The driver's link to one slot held by other ranks (see the module
    docstring).  Creating it is collective over the whole world: every
    rank makes the same channels in the same order.  Its threads start
    with :meth:`start`, once the set is built.

    On the driver: :meth:`post` (run in order, no answer), :meth:`call`
    (the lead rank's answer), :meth:`answer` (resolve the lead's
    :meth:`ask`) and :meth:`shutdown`.  On the slot's lead: :meth:`send_up`
    and :meth:`ask`; on the slot's other ranks, :meth:`wait_closed`.
    """

    KEEPALIVE_S = 1.0
    #: seconds a channel waits for a peer (a message, a keep-alive, a
    #: reply)
    TIMEOUT_S = 60.0

    def __init__(self, slot):
        self.slot = slot
        self.lead = slot.lead
        td = datetime.timedelta(seconds=self.TIMEOUT_S)
        # collective: every rank of the world makes both groups
        self._down = dist.new_group(sorted({DRIVER, *slot.ranks}),
                                    backend="gloo", timeout=td)
        self._up = (dist.new_group([DRIVER, self.lead], backend="gloo",
                                   timeout=td)
                    if self.lead != DRIVER else None)
        rank = world_rank()
        self.driver = rank == DRIVER
        self.member = rank in slot.ranks
        self.is_lead = rank == self.lead
        self._down_q: queue.Queue = queue.Queue()   # the driver's sends
        self._up_q: queue.Queue = queue.Queue()     # the lead's sends
        self._inbox: queue.Queue = queue.Queue()    # a member's work
        self._seq = itertools.count()
        self._lock = threading.Lock()
        self._calls = {}        # seq -> Future (driver)
        self._asks = {}         # key -> Future (slot lead)
        self._threads = []
        self._receiver = None   # a member's, other than the driver
        self.broken: Optional[BaseException] = None

    def __repr__(self) -> str:
        role = ("driver" if self.driver else "lead" if self.is_lead
                else "slot" if self.member else "none")
        return f"Channel({self.slot!r}, {role})"

    # -- threads ------------------------------------------------------ #
    def start(self, handler: Callable, on_event: Callable) -> None:
        """Start this end's threads.  A member of the slot runs the
        driver's work in order on one executor thread:
        ``handler(op, *args)``, whose value (or error) the lead sends
        back when the driver waits for one.  The driver hands every
        message of the lead that is not a reply to ``on_event``, on its
        own thread.  A member's executor ends after the driver's
        ``close`` and ``bye``, or once the driver is lost (then
        ``handler("close")`` runs)."""
        def thread(target, name):
            t = threading.Thread(target=target, daemon=True,
                                 name=f"{name}-{self.slot.tag}")
            t.start()
            self._threads.append(t)
            return t

        if self.driver:
            thread(lambda: self._sender(self._down, DRIVER, self._down_q),
                   "fwd-down")
            if self._up is not None:
                thread(lambda: self._driver_up(
                    lambda: _recv(self._up, self.lead), on_event), "fwd-up")
            else:
                thread(lambda: self._driver_up(self._up_q.get, on_event),
                       "fwd-up")
        elif self.member:
            self._receiver = thread(self._slot_receiver, "fwd-down")
            if self.is_lead:
                thread(lambda: self._sender(self._up, self.lead,
                                            self._up_q), "fwd-up")
        if self.member:
            thread(lambda: self._execute(handler), "fwd-exec")

    def _sender(self, group, src, q):
        while True:
            try:
                msg = q.get(timeout=self.KEEPALIVE_S)
            except queue.Empty:
                msg = ("ping",)
            try:
                _send(group, src, msg)
            except Exception as e:  # noqa: BLE001 - the peer is gone
                self._break(e)
                return
            if self.driver and self.member:
                # the driver's share of a slot it holds: the same order
                self._deliver(msg)
            if msg[0] == "bye":
                return

    def _break(self, e: BaseException) -> None:
        with self._lock:
            if self.broken is None:
                self.broken = e
                log.warning("%r: lost (%s)", self, e)
            calls, self._calls = self._calls, {}
            asks, self._asks = self._asks, {}
        lost = BackendLostError(f"{self!r} lost its peer: {e}")
        for fut in list(calls.values()) + list(asks.values()):
            if not fut.done():
                fut.set_exception(lost)
        self._inbox.put(("lost",))

    def _deliver(self, msg) -> None:
        """A member: take one message of the driver."""
        kind = msg[0]
        if kind == "ping":
            return
        if kind == "answer":
            with self._lock:
                fut = self._asks.pop(msg[1], None)
            if fut is not None:
                fut.set_result(msg[2])
            return
        self._inbox.put(msg)

    # -- the driver's end --------------------------------------------- #
    def _driver_up(self, take, on_event):
        while True:
            try:
                msg = take()
            except Exception as e:  # noqa: BLE001 - the lead is gone
                self._break(e)
                return
            kind = msg[0]
            if kind == "ping":
                continue
            if kind == "bye":
                return
            if kind == "reply":
                _, seq, ok, value = msg
                with self._lock:
                    fut = self._calls.pop(seq, None)
                if fut is not None:
                    if ok:
                        fut.set_result(value)
                    else:
                        fut.set_exception(decode_error(value))
                continue
            try:
                on_event(msg)
            except Exception:  # noqa: BLE001 - one bad event, not the link
                log.exception("%r: handling %s failed", self, kind)

    def _check(self) -> None:
        if self.broken is not None:
            raise BackendLostError(f"{self!r} is lost: {self.broken}")
        if not self._threads:
            raise BackendLostError(f"{self!r} is not started")

    def post(self, op: str, *args) -> None:
        """Hand ``op`` to the slot's ranks, to run after everything posted
        before it; nothing comes back."""
        self._check()
        self._down_q.put(("call", None, op, args))

    def call(self, op: str, *args, timeout: Optional[float] = None):
        """:meth:`post` ``op`` and wait for the lead rank's answer: its
        value, or its error raised again here.  No answer within
        ``timeout`` (default :attr:`TIMEOUT_S`) raises
        ``BackendLostError``."""
        fut = Future()
        with self._lock:
            self._check()
            seq = next(self._seq)
            self._calls[seq] = fut
        self._down_q.put(("call", seq, op, args))
        wait = self.TIMEOUT_S if timeout is None else timeout
        try:
            return fut.result(wait)
        except FutureTimeout:
            with self._lock:
                self._calls.pop(seq, None)
            raise BackendLostError(
                f"{self!r}: no answer to {op!r} within {wait:.0f} s") \
                from None

    def control(self, op: str, *args):
        """:meth:`call` with the longer wait of a control message."""
        return self.call(op, *args, timeout=CONTROL_WAITS * self.TIMEOUT_S)

    def answer(self, key, value) -> None:
        """Resolve the slot lead's :meth:`ask` for ``key``."""
        self._down_q.put(("answer", key, value))

    def shutdown(self) -> None:
        """Close the slot's side (its ``close`` op), then stop every
        thread of the channel on both ends."""
        try:
            if self.broken is None:
                self.control("close")
        finally:
            self._down_q.put(("bye",))
            _join(self._threads, CONTROL_WAITS * self.TIMEOUT_S, repr(self))

    # -- a slot rank's end -------------------------------------------- #
    def _slot_receiver(self):
        while True:
            try:
                msg = _recv(self._down, DRIVER)
            except Exception as e:  # noqa: BLE001 - the driver is gone
                self._break(e)
                return
            self._deliver(msg)
            if msg[0] == "bye":
                return

    def _execute(self, handler):
        closed = False
        while True:
            msg = self._inbox.get()
            if msg[0] in ("bye", "lost"):
                break
            _, seq, op, args = msg
            try:
                value, ok = handler(op, *args), True
            except Exception as e:  # noqa: BLE001 - sent back
                if seq is None or not self.is_lead:
                    log.warning("%r: %s failed: %s", self, op, e)
                value, ok = encode_error(e), False
            closed = closed or op == "close"
            if seq is not None and self.is_lead:
                self._up_q.put(("reply", seq, ok, value))
        if not closed:
            try:
                handler("close")
            except Exception:  # noqa: BLE001 - closing after a loss
                log.exception("%r: close after the driver was lost", self)
        if self.is_lead:
            self._up_q.put(("bye",))

    def send_up(self, msg) -> None:
        """The lead rank: send ``msg`` (a tuple) to the driver."""
        self._up_q.put(msg)

    def ask(self, key, msg):
        """The lead rank: send ``msg`` up and wait for the driver's
        :meth:`answer` for ``key``."""
        fut = Future()
        with self._lock:
            if self.broken is not None:
                raise BackendLostError(f"{self!r} is lost: {self.broken}")
            self._asks[key] = fut
        self._up_q.put(msg)
        wait = self.TIMEOUT_S
        try:
            return fut.result(wait)
        except FutureTimeout:
            with self._lock:
                self._asks.pop(key, None)
            raise BackendLostError(
                f"{self!r}: the driver did not answer {msg[0]!r} within "
                f"{wait:.0f} s") from None

    def wait_closed(self) -> None:
        """A slot rank other than the driver: wait until the driver
        closed the channel (or was lost) and every thread of this end
        stopped.  The receiver runs as long as the driver serves, and
        ends at most :attr:`TIMEOUT_S` after the driver falls silent;
        the rest then have the wait of a control message."""
        self._receiver.join()
        _join(self._threads, CONTROL_WAITS * self.TIMEOUT_S, repr(self))


class Forwarding:
    """What a forwarded set (a ``ReplicaSet`` or a ``DisaggCoordinator``)
    holds of the world on this rank: a :class:`Channel` for every slot
    held by a rank other than the driver, this rank's engine of each
    such slot that holds it (:attr:`engines`, by slot id), and their
    lifecycle.  Creating it is collective over the whole world.

    ``build(slot, *args)`` makes this rank's engine of a replica on a
    slot (``args`` as given to :meth:`add`).  ``handle(link, engine, op,
    *args)`` runs one of the driver's ops on it (default
    ``engine.forwarded(op, *args)``); ``on_event(link, msg)`` takes, on
    the driver, a slot lead's messages that are not replies.  Building,
    dropping and closing a slot's engine are this class's.
    """

    def __init__(self, placement, build: Callable, *,
                 handle: Optional[Callable] = None,
                 on_event: Optional[Callable] = None):
        self.driver = world_rank() == DRIVER
        self._build = build
        self._handle = handle or (lambda link, eng, op, *a:
                                  eng.forwarded(op, *a))
        self._on_event = on_event or (lambda link, msg: None)
        # collective, like every group below: the outcome of a build
        self._all = dist.new_group(
            list(range(dist.get_world_size())), backend="gloo",
            timeout=datetime.timedelta(
                seconds=CONTROL_WAITS * Channel.TIMEOUT_S))
        self.links: Dict[int, Channel] = {
            s.slot_id: Channel(s) for s in placement.slices
            if s.ranks is not None and any(r != DRIVER for r in s.ranks)}
        self.engines: dict = {}
        self._started = False

    def link(self, slot) -> Optional[Channel]:
        """``slot``'s channel; None for a slot the driver alone holds."""
        return self.links.get(slot.slot_id) if slot is not None else None

    def require_driver(self, what: str) -> None:
        if not self.driver:
            raise not_the_driver(what)

    def add(self, link: Channel, *args, initial: bool) -> None:
        """This rank's part of a new replica on ``link``'s slot.
        ``initial`` (the set's constructor, run by every rank): a member
        of the slot builds its engine now.  Else (a scale-up, on the
        driver): every member builds it on its executor, in order."""
        if initial:
            if link.member:
                self.engines[link.slot.slot_id] = self._build(link.slot,
                                                              *args)
        else:
            link.control("build", *args)

    def _op(self, link: Channel, op: str, *args):
        sid = link.slot.slot_id
        if op == "build":
            self.engines[sid] = self._build(link.slot, *args)
            return None
        if op in ("drop", "close"):
            eng = self.engines.pop(sid, None)
            if eng is not None:
                eng.close(*args)
            return None
        return self._handle(link, self.engines[sid], op, *args)

    def settle(self, err: Optional[BaseException]):
        """Collective, at the end of the set's build: gather every
        rank's outcome.  Returns ``err`` (this rank's failure), else the
        first other rank's failure (its class, its message naming the
        rank), else None, the channels then started.  A rank that never
        reports fails it within the wait of a control message."""
        got = [None] * dist.get_world_size(group=self._all)
        try:
            dist.all_gather_object(
                got, None if err is None else encode_error(err),
                group=self._all)
        except Exception as e:  # noqa: BLE001 - the world is gone
            return err or BackendLostError(
                f"building a forwarded set: the world did not report ({e})")
        if err is not None:
            return err
        for rank, e in enumerate(got):
            if e is not None:
                module, qualname, msg = e
                return decode_error((module, qualname,
                                     f"world rank {rank} could not build "
                                     f"its part of the set: {msg}"))
        for link in self.links.values():
            link.start(lambda op, *a, link=link: self._op(link, op, *a),
                       lambda msg, link=link: self._on_event(link, msg))
        self._started = True
        return None

    def close_engines(self) -> None:
        """Close this rank's engines (a build that failed)."""
        for eng in self.engines.values():
            eng.close()
        self.engines.clear()

    def shutdown(self) -> None:
        """The driver closes every channel (each slot's ranks close what
        they hold); any other rank waits until the driver did."""
        first = None
        for link in self.links.values() if self._started else ():
            try:
                if self.driver:
                    link.shutdown()
                elif link.member:
                    link.wait_closed()
            except BackendLostError as e:
                first = first or e
        self.close_engines()
        if first is not None:
            raise first
