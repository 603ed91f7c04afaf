"""tfevents FileReader (ref visualization/tensorboard/FileReader.scala; port of
``bigdl_tpu/visualization/reader.py``).

``read_scalar(path_or_dir, tag)`` returns a list of
``(step, value, wall_time)`` triples, sorted by step, concatenated over all
``*tfevents*`` files found recursively — mirroring FileReader.scala:47-98.
"""
from __future__ import annotations

import os
import re
from typing import List, Tuple

from .proto import decode_event
from .record import read_records

_EVENT_RE = re.compile(r"tfevents")


def list_files(path: str) -> List[str]:
    if os.path.isfile(path):
        return [path]
    out = []
    for root, _dirs, files in os.walk(path):
        for f in files:
            if _EVENT_RE.search(f):
                out.append(os.path.join(root, f))
    return sorted(out)


def list_tags(path: str) -> List[str]:
    tags = set()
    for fpath in list_files(path):
        for payload in read_records(fpath):
            for v in decode_event(payload).values:
                tags.add(v.tag)
    return sorted(tags)


def read_scalar(path: str, tag: str) -> List[Tuple[int, float, float]]:
    out: List[Tuple[int, float, float]] = []
    for fpath in list_files(path):
        for payload in read_records(fpath):
            ev = decode_event(payload)
            for v in ev.values:
                if v.tag == tag and v.simple_value is not None:
                    out.append((ev.step, v.simple_value, ev.wall_time))
    out.sort(key=lambda t: t[0])
    return out
