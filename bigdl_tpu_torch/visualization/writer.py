"""tfevents FileWriter with an async flush thread (port of
``bigdl_tpu/visualization/writer.py``).

Rebuild of ``visualization/tensorboard/FileWriter.scala:29-70`` +
``EventWriter.scala:30-68``: events are queued; a daemon thread drains the
queue into a ``events.out.tfevents.<ts>.<host>`` file and flushes every
``flush_millis`` (default 10 s).  The first record is a version Event
(``file_version = "brain.Event:2"``).
"""
from __future__ import annotations

import os
import queue
import socket
import threading
import time
from typing import Optional

from .proto import Event
from .record import RecordWriter


class EventWriter:
    _SENTINEL = object()

    def __init__(self, log_dir: str, flush_millis: int = 10000):
        os.makedirs(log_dir, exist_ok=True)
        fname = "events.out.tfevents.%d.%s" % (int(time.time()),
                                               socket.gethostname())
        self.path = os.path.join(log_dir, fname)
        self._writer = RecordWriter(self.path)
        self._queue: "queue.Queue" = queue.Queue()
        self._flush_secs = flush_millis / 1000.0
        self._closed = False
        self.add_event(Event(wall_time=time.time(), file_version="brain.Event:2"))
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name="bigdl-torch-event-writer")
        self._thread.start()

    def add_event(self, event: Event) -> "EventWriter":
        if not self._closed:
            self._queue.put(event)
        return self

    def flush_barrier(self, timeout: float = 10.0) -> bool:
        """Block until every event queued before this call is on disk (a
        marker rides the queue; the drain thread signals after writing and
        flushing everything ahead of it)."""
        if self._closed:
            return True
        done = threading.Event()
        self._queue.put(done)
        return done.wait(timeout)

    def _handle(self, ev) -> bool:
        """Process one queue item; returns False on the close sentinel."""
        if ev is self._SENTINEL:
            return False
        if isinstance(ev, threading.Event):  # flush barrier marker
            self._writer.flush()
            ev.set()
            return True
        self._writer.write(ev.encode())
        return True

    def _run(self) -> None:
        alive = True
        while alive:
            try:
                ev = self._queue.get(timeout=self._flush_secs)
            except queue.Empty:
                self._writer.flush()
                continue
            alive = self._handle(ev)
            while alive:
                try:
                    ev = self._queue.get_nowait()
                except queue.Empty:
                    break
                alive = self._handle(ev)
            self._writer.flush()
        # drain anything queued behind the sentinel (barriers must not hang)
        while True:
            try:
                ev = self._queue.get_nowait()
            except queue.Empty:
                break
            if isinstance(ev, threading.Event):
                ev.set()
        self._writer.flush()

    def close(self) -> None:
        if self._closed:
            return
        self._closed = True
        self._queue.put(self._SENTINEL)
        self._thread.join(timeout=30)
        self._writer.close()


class FileWriter:
    """Public writer: ``add_summary(values, global_step)`` /
    ``add_event(event)`` (ref FileWriter.scala:46-66)."""

    def __init__(self, log_directory: str, flush_millis: int = 10000):
        self.log_dir = log_directory
        self._event_writer = EventWriter(log_directory, flush_millis)

    def add_summary(self, values, global_step: int) -> "FileWriter":
        if not isinstance(values, (list, tuple)):
            values = [values]
        ev = Event(wall_time=time.time(), step=int(global_step),
                   values=list(values))
        self._event_writer.add_event(ev)
        return self

    def add_event(self, event: Event) -> "FileWriter":
        self._event_writer.add_event(event)
        return self

    def flush(self) -> "FileWriter":
        self._event_writer.flush_barrier()
        return self

    def close(self) -> None:
        self._event_writer.close()
