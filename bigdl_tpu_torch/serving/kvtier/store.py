"""Host-tier KV block store: the memory level below the device arena
(port of ``bigdl_tpu/serving/kvtier/store.py``).

Evicted radix blocks DEMOTE into host RAM (and optionally spill on to a
disk directory) instead of vanishing, whole idle sessions hibernate
here, and an admission whose prefix survived PROMOTES it back into the
arenas through the 32 MB chunked transfer:

    device arena (BlockPool)  -- hot: decoding + radix-shared prefixes
        | demote (radix on_evict / session hibernation)
        v
    host RAM (this store)     -- capacity-bounded, LRU within the tier
        | spill (host tier full, spill_dir configured)
        v
    disk (.npz per entry)     -- capacity-bounded; beyond it, drop

Entries are block-major wire payloads in the ``export_chain`` layout,
``{"k","v": (n, L, H, block_len, D)}`` plus ``"ks"/"vs"`` scales for
int8 pools (scales demote atomically with their rows).  Keys are
hashable tuples: the radix demotion hook keys single blocks by their
token-prefix path (:func:`block_path`), hibernation keys whole chains
by ``("session", request_id)``.

Hit/miss/demote/promote counters and per-tier byte gauges publish into
the registry under ``kvtier/<name>/``.  Every disk read verifies a CRC
recorded at spill time; a corrupted or lost spill file is counted
(``corrupt_reads``), logged, and reads as a miss, so a stream never gets
wrong KV rows.  (The reference also raises a flight-recorder incident
there and attributes host bytes to its memory ledger; neither is ported
yet.)

The store moves host numpy arrays only, and never touches a device;
every mutation holds the store lock, since stats are read from other
threads.
"""
from __future__ import annotations

import hashlib
import logging
import os
import threading
import weakref
import zlib
from collections import OrderedDict
from typing import Dict, Optional, Tuple

import numpy as np

from bigdl_tpu_torch.obs.registry import Counter, FnGauge, get_registry

log = logging.getLogger("bigdl_tpu_torch.serving")

#: payload arrays every entry must carry; scale arrays are optional
#: (present exactly when the source pool is quantized)
_DATA_KEYS = ("k", "v")
_SCALE_KEYS = ("ks", "vs")


def _payload_bytes(payload: dict) -> int:
    return sum(int(payload[key].nbytes)
               for key in (*_DATA_KEYS, *_SCALE_KEYS) if key in payload)


class _Entry:
    __slots__ = ("payload", "nbytes", "where", "path", "crcs", "n_blocks")

    def __init__(self, payload: dict):
        self.payload = payload          # None while spilled to disk
        self.nbytes = _payload_bytes(payload)
        self.n_blocks = int(payload["k"].shape[0])
        self.where = "host"
        self.path: Optional[str] = None
        self.crcs: Optional[Dict[str, int]] = None


class HostBlockStore:
    """Capacity-bounded host-RAM KV tier with optional disk spill.

    Args:
        host_bytes: budget for payloads resident in host RAM.  When an
            insert would exceed it, LRU entries spill to disk (if
            ``spill_dir`` is set) or drop, oldest first.
        spill_dir: directory for the disk tier (created on demand).
            ``None`` disables spilling — host-tier overflow drops.
        disk_bytes: budget for the spill files; beyond it the oldest
            spilled entries are deleted.  Default: 4x ``host_bytes``.
        name: registry namespace — metrics land under
            ``kvtier/<name>/``.
    """

    def __init__(self, *, host_bytes: int, spill_dir: Optional[str] = None,
                 disk_bytes: Optional[int] = None, name: str = "default"):
        if host_bytes < 1:
            raise ValueError(f"host_bytes must be >= 1, got {host_bytes}")
        self.host_bytes = int(host_bytes)
        self.spill_dir = spill_dir
        self.disk_bytes = (int(disk_bytes) if disk_bytes is not None
                           else 4 * self.host_bytes)
        self.name = name
        self._lock = threading.Lock()
        # MRU at the end; one OrderedDict spans both tiers (an entry's
        # ``where`` says which) so LRU age is global, matching the
        # BlockManager's single LRU over memory+disk levels
        self._entries: "OrderedDict[tuple, _Entry]" = OrderedDict()
        self._host_used = 0
        self._disk_used = 0
        # counters (registry-published live objects)
        reg = get_registry()
        p = f"kvtier/{name}/"
        # private Counter objects registered with replace=True (the
        # LMMetrics idiom): a fresh store starts at zero even when an
        # earlier store used the same name in this process
        self.demotions = Counter()
        self.promotions = Counter()
        self.hits = Counter()
        self.misses = Counter()
        self.spills = Counter()
        self.drops = Counter()
        self.corrupt_reads = Counter()
        self.demoted_bytes = Counter(unit="bytes")
        self.promoted_bytes = Counter(unit="bytes")
        for cname in ("demotions", "promotions", "hits", "misses",
                      "spills", "drops", "corrupt_reads",
                      "demoted_bytes", "promoted_bytes"):
            reg.register(p + cname, getattr(self, cname), replace=True)
        # the byte gauges hold the store weakly: the process-wide
        # registry must not keep a dropped store's payloads alive
        ref = weakref.ref(self)
        for gname, read in (("host_bytes", lambda st: st._host_used),
                            ("disk_bytes", lambda st: st._disk_used),
                            ("entries", lambda st: len(st._entries))):
            reg.register(p + gname, FnGauge(
                lambda read=read: (read(ref()) if ref() is not None
                                   else None)), replace=True)
        self._promote_s = 0.0    # cumulative promote host-read seconds

    # -- demotion (pool -> host tier) ----------------------------------- #
    def put(self, key: tuple, payload: dict) -> None:
        """Demote an exported payload into the host tier under ``key``
        (re-putting refreshes content and recency).  Oversized single
        payloads that exceed the whole host budget go straight to the
        disk tier (or drop) rather than flushing everything else."""
        for dk in _DATA_KEYS:
            if dk not in payload:
                raise ValueError(f"payload missing {dk!r}")
        has_scales = all(sk in payload for sk in _SCALE_KEYS)
        if any(sk in payload for sk in _SCALE_KEYS) and not has_scales:
            raise ValueError("payload carries one scale array but not "
                             "the other — scales demote atomically")
        clean = {dk: np.ascontiguousarray(payload[dk])
                 for dk in _DATA_KEYS}
        if has_scales:
            for sk in _SCALE_KEYS:
                clean[sk] = np.ascontiguousarray(payload[sk])
        entry = _Entry(clean)
        with self._lock:
            self._forget(key)
            self._entries[key] = entry
            self._host_used += entry.nbytes
            self.demotions.add(1)
            self.demoted_bytes.add(entry.nbytes)
            self._enforce_host()

    # -- promotion (host tier -> caller, who adopts into the pool) ------ #
    def get(self, key: tuple, *, pop: bool = False) -> Optional[dict]:
        """Look up ``key``; a hit returns the payload (rehydrated from
        disk when spilled) and refreshes recency; ``pop=True`` removes
        the entry (session hibernation consumes its chain on resume).
        A corrupted or lost spill file is counted and reads as a
        miss.  The caller is responsible for calling
        :meth:`record_promote` once the payload actually lands in the arenas.
        """
        with self._lock:
            entry = self._entries.get(key)
            if entry is None:
                self.misses.add(1)
                return None
            if entry.where == "disk":
                payload = self._read_spill(key, entry)
                if payload is None:      # corrupt/lost: already counted
                    self._forget(key)
                    self.misses.add(1)
                    return None
                entry.payload = payload
                entry.where = "host"
                entry.path = None
                entry.crcs = None
                self._disk_used -= entry.nbytes
                self._host_used += entry.nbytes
            self._entries.move_to_end(key)
            self.hits.add(1)
            payload = entry.payload
            if pop:
                self._forget(key)
            self._enforce_host()
            return payload

    def contains(self, key: tuple) -> bool:
        with self._lock:
            return key in self._entries

    def record_promote(self, nbytes: int, seconds: float) -> None:
        """Account one successful re-admission to the arenas (called by the
        engine after ``adopt_chain`` returns) — feeds the promote
        counter and the bandwidth gauge."""
        with self._lock:
            self.promotions.add(1)
            self.promoted_bytes.add(int(nbytes))
            self._promote_s += max(0.0, float(seconds))

    # -- capacity enforcement (callers hold the lock) ------------------- #
    def _enforce_host(self) -> None:
        # oldest-first over entries currently resident in host RAM
        while self._host_used > self.host_bytes:
            victim = next((k for k, e in self._entries.items()
                           if e.where == "host"), None)
            if victim is None:
                break
            entry = self._entries[victim]
            if self.spill_dir is not None:
                self._spill(victim, entry)
            else:
                self._forget(victim)
                self.drops.add(1)
        while self._disk_used > self.disk_bytes:
            victim = next((k for k, e in self._entries.items()
                           if e.where == "disk"), None)
            if victim is None:
                break
            self._forget(victim)
            self.drops.add(1)

    def _forget(self, key: tuple) -> None:
        entry = self._entries.pop(key, None)
        if entry is None:
            return
        if entry.where == "host":
            self._host_used -= entry.nbytes
        else:
            self._disk_used -= entry.nbytes
            if entry.path:
                try:
                    os.unlink(entry.path)
                except OSError:
                    pass

    # -- disk tier ------------------------------------------------------ #
    def _spill_path(self, key: tuple) -> str:
        digest = hashlib.sha1(repr(key).encode()).hexdigest()[:24]
        return os.path.join(self.spill_dir, f"kvtier-{digest}.npz")

    def _spill(self, key: tuple, entry: _Entry) -> None:
        os.makedirs(self.spill_dir, exist_ok=True)
        path = self._spill_path(key)
        try:
            np.savez(path, **entry.payload)
        except OSError:
            # disk unwritable: degrade to a drop, never wedge eviction
            log.exception("kvtier spill write failed (%s)", path)
            self._forget(key)
            self.drops.add(1)
            return
        # CRC over the raw array bytes, recorded at spill time and
        # verified on every read — a torn or tampered file must surface
        # as an incident + miss, not as wrong KV rows in a stream
        entry.crcs = {name: zlib.crc32(arr.tobytes())
                      for name, arr in entry.payload.items()}
        entry.path = path
        entry.payload = None
        entry.where = "disk"
        self._host_used -= entry.nbytes
        self._disk_used += entry.nbytes
        self.spills.add(1)

    def _read_spill(self, key: tuple, entry: _Entry) -> Optional[dict]:
        try:
            with np.load(entry.path) as z:
                payload = {name: z[name] for name in z.files}
            for name, crc in (entry.crcs or {}).items():
                if name not in payload or \
                        zlib.crc32(payload[name].tobytes()) != crc:
                    raise ValueError(f"CRC mismatch on {name!r}")
        except BaseException as e:  # noqa: BLE001 — lost OR corrupt
            self.corrupt_reads.add(1)
            log.warning("kvtier spill read failed (%s): %r", entry.path, e)
            return None
        return payload

    # -- introspection -------------------------------------------------- #
    def _bandwidth(self) -> Optional[float]:
        """MB/s over the lifetime; caller holds ``_lock``."""
        if self._promote_s <= 0.0:
            return None
        return self.promoted_bytes.get()[0] / self._promote_s / (1 << 20)

    def promote_bandwidth_mbs(self) -> Optional[float]:
        """Mean promote bandwidth (MB/s) over the store's lifetime."""
        with self._lock:
            return self._bandwidth()

    def stats(self) -> dict:
        with self._lock:
            return {
                "name": self.name,
                "entries": len(self._entries),
                "host_used_bytes": self._host_used,
                "host_capacity_bytes": self.host_bytes,
                "disk_used_bytes": self._disk_used,
                "disk_capacity_bytes": (self.disk_bytes
                                        if self.spill_dir else 0),
                "spill_dir": self.spill_dir,
                "demotions": self.demotions.get()[0],
                "promotions": self.promotions.get()[0],
                "hits": self.hits.get()[0],
                "misses": self.misses.get()[0],
                "hit_rate": (self.hits.get()[0]
                             / (self.hits.get()[0] + self.misses.get()[0])
                             if (self.hits.get()[0]
                                 + self.misses.get()[0]) else None),
                "spills": self.spills.get()[0],
                "drops": self.drops.get()[0],
                "corrupt_reads": self.corrupt_reads.get()[0],
                "promote_bandwidth_mbs": self._bandwidth(),
            }


def block_path(tokens0, block_len: int, n_blocks: int
               ) -> Tuple[Tuple[int, ...], ...]:
    """The radix-style token-key path of the first ``n_blocks`` full
    blocks of ``tokens0`` — the content address demoted prefix blocks
    are stored (and re-found) under.  Matches ``RadixCache``'s node
    keys exactly, so the demotion hook's paths and the promotion
    probe's paths can never drift apart."""
    B = int(block_len)
    return tuple(tuple(int(x) for x in tokens0[i * B:(i + 1) * B])
                 for i in range(int(n_blocks)))
