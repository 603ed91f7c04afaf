"""JSON artifacts written atomically (port of
``bigdl_tpu/utils/artifacts.py``'s ``write_artifact``,
``load_artifact``, ``index_rows`` and ``load_resumable_rows``), and the
platform stamp.

Every JSON document the port writes (flight bundles, the incident log)
is rewritten atomically (write, then rename), so a process killed
mid-flush never leaves truncated JSON; an unreadable file reads as
absent, with a warning.  :func:`platform_stamp` names the torch device
a document was made on, and on the card the card's name, so a CPU
document never reads as a GPU one.
"""
from __future__ import annotations

import json
import logging
import os
from typing import Callable

log = logging.getLogger("bigdl_tpu_torch.artifacts")


def platform_stamp(device=None) -> dict:
    """``{"platform": "cpu"}`` unless this process has initialised CUDA
    (and ``device``, when given, is a CUDA device), else ``{"platform":
    "gpu", "device": "cuda:<i>", "device_name": <card>}`` for the current
    device.  Reads the device's properties, which PyTorch caches, and
    never a stream, so it is safe on a thread that is capturing a CUDA
    graph."""
    import torch
    if not torch.cuda.is_initialized() or (
            device is not None and torch.device(device).type != "cuda"):
        return {"platform": "cpu"}
    index = torch.cuda.current_device()
    return {"platform": "gpu", "device": f"cuda:{index}",
            "device_name": torch.cuda.get_device_name(index)}


def write_artifact(path: str, result: dict) -> None:
    """Atomic JSON rewrite (no-op when path is falsy)."""
    if not path:
        return
    from bigdl_tpu_torch.utils import fs
    fs.atomic_write(path, (json.dumps(result, indent=2) + "\n").encode())


def load_artifact(path: str):
    """The prior artifact document, or None.  A missing file is a cold
    start; an existing but unparseable one is treated as absent with a
    warning."""
    if path and os.path.exists(path):
        try:
            with open(path) as f:
                return json.load(f)
        except (OSError, ValueError) as e:
            log.warning(
                "artifact %s exists but is unreadable (%s: %s), treating "
                "it as absent", path, type(e).__name__, e)
    return None


def index_rows(doc, *, match: Callable[[dict, dict], bool],
               key: Callable[[dict], object],
               section: str = "rows") -> dict:
    """Reusable rows of one section, keyed by ``key(row)``.
    ``match(document, row)`` decides reuse: it sees the whole document,
    so platform and config headers gate every row.  A document that is
    not a dict (absent, unreadable) reuses nothing."""
    prev: dict = {}
    if isinstance(doc, dict):
        for r in doc.get(section, []):
            if match(doc, r):
                prev[key(r)] = r
    return prev


def load_resumable_rows(path: str, *, match: Callable[[dict, dict], bool],
                        key: Callable[[dict], object],
                        section: str = "rows") -> dict:
    """:func:`load_artifact`, then :func:`index_rows`."""
    return index_rows(load_artifact(path), match=match, key=key,
                      section=section)
