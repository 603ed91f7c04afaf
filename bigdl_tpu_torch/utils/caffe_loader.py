"""Caffe model import (port of ``bigdl_tpu/utils/caffe_loader.py``; ref
utils/CaffeLoader.scala:38-160).

The reference depends on 95,952 LoC of generated protobuf Java
(``caffe/Caffe.java``); here the needed subset of ``caffe.proto`` is decoded
directly from the wire format (with the port's own
``bigdl_tpu_torch.visualization.proto`` decoder):

  NetParameter: name=1, layers=2 (repeated V1LayerParameter),
                input=3, layer=100 (repeated LayerParameter)
  V1LayerParameter: bottom=2, top=3, name=4, type=5 (enum), blobs=6
  LayerParameter:   name=1, type=2 (string), bottom=3, top=4, blobs=7
  BlobProto: num=1, channels=2, height=3, width=4,
             data=5 (repeated float), shape=7 (BlobShape: dim=1 int64)

``load(model, def_path, model_path, match_all)`` copies blob 0 -> weight and
blob 1 -> bias into same-named modules of the given model, matching the
reference's element-count-checked flat copy (CaffeLoader.scala:86-125).
Each blob is written into the module's existing tensor, on its device.
"""
from __future__ import annotations

import logging
import struct
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional

import numpy as np

from bigdl_tpu_torch.visualization.proto import _iter_fields, _read_varint

log = logging.getLogger("bigdl_tpu_torch.caffe")


@dataclass
class BlobProto:
    shape: List[int] = field(default_factory=list)
    data: Optional[np.ndarray] = None


@dataclass
class CaffeLayer:
    name: str = ""
    type: Any = None  # string (V2) or enum int (V1)
    bottom: List[str] = field(default_factory=list)
    top: List[str] = field(default_factory=list)
    blobs: List[BlobProto] = field(default_factory=list)


@dataclass
class CaffeNet:
    name: str = ""
    layers_v1: List[CaffeLayer] = field(default_factory=list)
    layers_v2: List[CaffeLayer] = field(default_factory=list)

    def by_name(self) -> Dict[str, CaffeLayer]:
        # V2 wins on duplicate names, like the reference's lookup order
        out = {l.name: l for l in self.layers_v1}
        out.update({l.name: l for l in self.layers_v2})
        return out


def _floats(wt: int, v) -> np.ndarray:
    if wt == 2:  # packed
        return np.frombuffer(v, dtype="<f4").copy()
    return np.array([struct.unpack("<f", v)[0]], np.float32)


def _parse_blob(buf: bytes) -> BlobProto:
    blob = BlobProto()
    legacy = {}
    chunks = []
    for fnum, wt, v in _iter_fields(buf):
        if fnum in (1, 2, 3, 4) and wt == 0:
            legacy[fnum] = v
        elif fnum == 5:
            chunks.append(_floats(wt, v))
        elif fnum == 7 and wt == 2:  # BlobShape
            dims = []
            for f2, w2, v2 in _iter_fields(v):
                if f2 == 1:
                    if w2 == 2:  # packed int64
                        pos = 0
                        while pos < len(v2):
                            d, pos = _read_varint(v2, pos)
                            dims.append(d)
                    elif w2 == 0:
                        dims.append(v2)
            blob.shape = dims
        elif fnum == 8 and wt == 2:  # double_data
            chunks.append(np.frombuffer(v, dtype="<f8").astype(np.float32))
    if chunks:
        blob.data = np.concatenate(chunks) if len(chunks) > 1 else chunks[0]
    if not blob.shape and legacy:
        blob.shape = [legacy.get(1, 1), legacy.get(2, 1),
                      legacy.get(3, 1), legacy.get(4, 1)]
    return blob


def _parse_layer(buf: bytes, v1: bool) -> CaffeLayer:
    layer = CaffeLayer()
    if v1:
        f_bottom, f_top, f_name, f_type, f_blobs = 2, 3, 4, 5, 6
    else:
        f_name, f_type, f_bottom, f_top, f_blobs = 1, 2, 3, 4, 7
    for fnum, wt, v in _iter_fields(buf):
        if fnum == f_name and wt == 2:
            layer.name = v.decode("utf-8", "replace")
        elif fnum == f_type:
            layer.type = (v if wt == 0 else v.decode("utf-8", "replace"))
        elif fnum == f_bottom and wt == 2:
            layer.bottom.append(v.decode("utf-8", "replace"))
        elif fnum == f_top and wt == 2:
            layer.top.append(v.decode("utf-8", "replace"))
        elif fnum == f_blobs and wt == 2:
            layer.blobs.append(_parse_blob(v))
    return layer


def parse_caffemodel(data: bytes) -> CaffeNet:
    net = CaffeNet()
    for fnum, wt, v in _iter_fields(data):
        if fnum == 1 and wt == 2:
            net.name = v.decode("utf-8", "replace")
        elif fnum == 2 and wt == 2:
            net.layers_v1.append(_parse_layer(v, v1=True))
        elif fnum == 100 and wt == 2:
            net.layers_v2.append(_parse_layer(v, v1=False))
    return net


# ------------------------- prototxt (text format) ----------------------- #

def parse_prototxt(text: str) -> Dict[str, Any]:
    """Minimal protobuf text-format parser: returns a nested dict; repeated
    fields become lists.  Handles ``key: value``, ``key { ... }``, quoted
    strings, comments."""
    import re
    tokens = re.findall(
        r'"(?:[^"\\]|\\.)*"|[{}]|[^\s{}:#]+|:|#[^\n]*', text)
    tokens = [t for t in tokens if not t.startswith("#")]
    pos = 0

    def parse_value(tok: str):
        if tok.startswith('"'):
            return tok[1:-1].encode().decode("unicode_escape")
        if tok in ("true", "false"):
            return tok == "true"
        try:
            return int(tok)
        except ValueError:
            try:
                return float(tok)
            except ValueError:
                return tok  # enum identifier

    def parse_message() -> Dict[str, Any]:
        nonlocal pos
        msg: Dict[str, Any] = {}

        def put(key, value):
            if key in msg:
                if not isinstance(msg[key], list):
                    msg[key] = [msg[key]]
                msg[key].append(value)
            else:
                msg[key] = value

        while pos < len(tokens) and tokens[pos] != "}":
            key = tokens[pos]
            pos += 1
            if pos < len(tokens) and tokens[pos] == ":":
                pos += 1
                put(key, parse_value(tokens[pos]))
                pos += 1
            elif pos < len(tokens) and tokens[pos] == "{":
                pos += 1
                put(key, parse_message())
                pos += 1  # closing }
            else:
                raise ValueError(f"prototxt parse error at token {key!r}")
        return msg

    return parse_message()


# ------------------------------ loader ---------------------------------- #

class CaffeLoader:
    """Copy caffe blobs into same-named modules (ref CaffeLoader.scala)."""

    def __init__(self, def_path: str, model_path: str, match_all: bool = True):
        self.def_path = def_path
        self.model_path = model_path
        self.match_all = match_all
        self._net: Optional[CaffeNet] = None
        self._prototxt: Optional[dict] = None

    @property
    def prototxt(self) -> dict:
        """The parsed network definition (structure only; weights come from
        the binary).  Parsed lazily — weight copying never needs it."""
        if self._prototxt is None:
            with open(self.def_path) as f:
                self._prototxt = parse_prototxt(f.read())
        return self._prototxt

    @property
    def net(self) -> CaffeNet:
        if self._net is None:
            log.info("start loading caffe model from %s", self.model_path)
            with open(self.model_path, "rb") as f:
                self._net = parse_caffemodel(f.read())
            log.info("load caffe model done")
        return self._net

    def copy_parameters(self, model):
        """Copy every matched blob into ``model``'s tensors; all blobs are
        checked before the first is written."""
        from bigdl_tpu_torch.utils.torch_import import chunked_device_array
        copies = []
        self._copy_module(model, model.params, self.net.by_name(), copies)
        for target, data in copies:
            chunked_device_array(data.reshape(tuple(target.shape)),
                                 out=target)
        return model

    def _copy_module(self, module, params, by_name, copies):
        from bigdl_tpu_torch.nn.containers import Container
        if isinstance(module, Container):
            for i, child in enumerate(module.modules):
                key = str(i)
                if isinstance(params, dict) and key in params:
                    self._copy_module(child, params[key], by_name, copies)
            return
        if not isinstance(params, dict) or not (
                "weight" in params or "bias" in params):
            return
        name = module.get_name()
        layer = by_name.get(name)
        if layer is None:
            if self.match_all:
                raise ValueError(
                    f"module {name} cannot map a layer in caffe model")
            log.info("%s uses initialized parameters", name)
            return
        for idx, pname in ((0, "weight"), (1, "bias")):
            if len(layer.blobs) <= idx:
                continue
            blob = layer.blobs[idx]
            if pname not in params:
                raise ValueError(f"{name} should contain {pname}")
            target = params[pname]
            if blob.data is None or blob.data.size != target.numel():
                got = 0 if blob.data is None else blob.data.size
                raise ValueError(
                    f"{pname} element number is not equal between caffe layer "
                    f"and module {name}: caffe {got} (shape {blob.shape}), "
                    f"module {list(target.shape)}")
            log.info("load parameters for %s ...", name)
            copies.append((target, blob.data))


def load(model, def_path: str, model_path: str, match_all: bool = True):
    """ref CaffeLoader.load / Module.loadCaffe (nn/Module.scala:35-39)."""
    return CaffeLoader(def_path, model_path, match_all).copy_parameters(model)
