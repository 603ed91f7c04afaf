"""Binary-compatible Torch7 ``.t7`` serialization (port of
``bigdl_tpu/utils/torch_file.py``).

Rebuild of ``utils/TorchFile.scala:36-330``: the t7 format is a little-endian
stream of tagged objects (NIL=0, NUMBER=1 f64, STRING=2, TABLE=3, TORCH=4,
BOOLEAN=5); TABLE and TORCH objects carry a heap index for shared-reference
memoization; TORCH objects carry a version string ("V 1") + class name, then
a class-specific payload.  Tensors are (i32 ndim, i64 sizes, i64 strides,
i64 offset(1-based), Storage object); Storages are (i64 n, raw data).

``load``/``save`` handle the raw object graph (numbers, strings, booleans,
tables, numpy tensors; a torch tensor is written as its float32 or
float64 values).  ``load_model``/``save_model`` map torch ``nn.*``
module tables onto ``bigdl_tpu_torch.nn`` layers with the same class
coverage as the reference reader (TorchFile.scala:144-161) and writer
(:257-290): a loaded model's parameters are tensors on ``device`` (the
card unless the caller names another), and a saved model's are read
back to the host.  The parsers are host code and import no layer until
a module is read or written.
"""
from __future__ import annotations

import struct
from dataclasses import dataclass, field
from typing import Any, BinaryIO, Dict, Optional

import numpy as np
import torch

TYPE_NIL = 0
TYPE_NUMBER = 1
TYPE_STRING = 2
TYPE_TABLE = 3
TYPE_TORCH = 4
TYPE_BOOLEAN = 5
TYPE_FUNCTION = 6
LEGACY_TYPE_RECUR_FUNCTION = 7
TYPE_RECUR_FUNCTION = 8


@dataclass
class TorchObject:
    """A torch class instance that has no native mapping here — carries the
    class name and its element table so nothing is lost on load."""
    class_name: str
    elements: Dict[str, Any] = field(default_factory=dict)

    def get(self, key, default=None):
        return self.elements.get(key, default)

    def __getitem__(self, key):
        return self.elements[key]


# ----------------------------------------------------------------------- #
# reader                                                                  #
# ----------------------------------------------------------------------- #

class _Reader:
    def __init__(self, f: BinaryIO):
        self.f = f
        self.memo: Dict[int, Any] = {}

    def _i32(self) -> int:
        return struct.unpack("<i", self.f.read(4))[0]

    def _i64(self) -> int:
        return struct.unpack("<q", self.f.read(8))[0]

    def _f64(self) -> float:
        return struct.unpack("<d", self.f.read(8))[0]

    def _string(self) -> str:
        n = self._i32()
        return self.f.read(n).decode("utf-8", "replace")

    def read_object(self) -> Any:
        type_id = self._i32()
        if type_id == TYPE_NIL:
            return None
        if type_id == TYPE_NUMBER:
            v = self._f64()
            return int(v) if v.is_integer() and abs(v) < 2**53 else v
        if type_id == TYPE_STRING:
            return self._string()
        if type_id == TYPE_BOOLEAN:
            return self._i32() != 0
        if type_id == TYPE_TABLE:
            idx = self._i32()
            if idx in self.memo:
                return self.memo[idx]
            result: Dict[Any, Any] = {}
            self.memo[idx] = result  # pre-register: tables may self-reference
            n = self._i32()
            for _ in range(n):
                k = self.read_object()
                v = self.read_object()
                result[k] = v
            return result
        if type_id == TYPE_TORCH:
            idx = self._i32()
            if idx in self.memo:
                return self.memo[idx]
            version = self._string()
            if version.startswith("V "):
                class_name = self._string()
            else:  # legacy files have no version record
                class_name = version
            result = self._read_torch(class_name, idx)
            self.memo[idx] = result
            return result
        if type_id in (TYPE_FUNCTION, TYPE_RECUR_FUNCTION,
                       LEGACY_TYPE_RECUR_FUNCTION):
            raise NotImplementedError("t7 serialized lua functions")
        raise ValueError(f"unknown t7 type tag {type_id}")

    _TENSOR_DTYPES = {
        "torch.FloatTensor": np.float32, "torch.DoubleTensor": np.float64,
        "torch.LongTensor": np.int64, "torch.IntTensor": np.int32,
        "torch.ByteTensor": np.uint8, "torch.CharTensor": np.int8,
        "torch.ShortTensor": np.int16,
        "torch.CudaTensor": np.float32, "torch.CudaDoubleTensor": np.float64,
        "torch.CudaLongTensor": np.int64,
    }
    _STORAGE_DTYPES = {
        "torch.FloatStorage": np.float32, "torch.DoubleStorage": np.float64,
        "torch.LongStorage": np.int64, "torch.IntStorage": np.int32,
        "torch.ByteStorage": np.uint8, "torch.CharStorage": np.int8,
        "torch.ShortStorage": np.int16,
        "torch.CudaStorage": np.float32, "torch.CudaDoubleStorage": np.float64,
        "torch.CudaLongStorage": np.int64,
    }

    def _read_torch(self, class_name: str, idx: int) -> Any:
        if class_name in self._TENSOR_DTYPES:
            return self._read_tensor()
        if class_name in self._STORAGE_DTYPES:
            dtype = self._STORAGE_DTYPES[class_name]
            n = self._i64()
            return np.frombuffer(self.f.read(n * np.dtype(dtype).itemsize),
                                 dtype=dtype).copy()
        # any other torch class: its payload is one element table
        elements = self.read_object() or {}
        str_elems = {k: v for k, v in elements.items() if isinstance(k, str)}
        # keep the integer-keyed array part too (e.g. container "modules")
        for k, v in elements.items():
            if not isinstance(k, str):
                str_elems[str(k)] = v
        obj = TorchObject(class_name, str_elems)
        self.memo[idx] = obj
        return obj

    def _read_tensor(self) -> Optional[np.ndarray]:
        ndim = self._i32()
        sizes = [self._i64() for _ in range(ndim)]
        strides = [self._i64() for _ in range(ndim)]
        offset = self._i64()  # 1-based
        storage = self.read_object()
        if storage is None or ndim == 0:
            return np.zeros(sizes, dtype=np.float32) if ndim else None
        base = storage[offset - 1:]
        itemsize = base.dtype.itemsize
        out = np.lib.stride_tricks.as_strided(
            base, shape=sizes, strides=[s * itemsize for s in strides])
        return out.copy()


# ----------------------------------------------------------------------- #
# writer                                                                  #
# ----------------------------------------------------------------------- #

class _Writer:
    def __init__(self, f: BinaryIO):
        self.f = f
        self._next_index = 1
        self._indices: Dict[int, int] = {}  # id(obj) -> heap index
        self._keepalive = []  # ids are only stable while objects live

    def _i32(self, v: int):
        self.f.write(struct.pack("<i", v))

    def _i64(self, v: int):
        self.f.write(struct.pack("<q", v))

    def _f64(self, v: float):
        self.f.write(struct.pack("<d", v))

    def _string(self, s: str):
        b = s.encode("utf-8")
        self._i32(len(b))
        self.f.write(b)

    def _heap(self, obj) -> Optional[int]:
        """Returns the index to write, or None if already memoized (in which
        case the caller writes just the index and stops)."""
        key = id(obj)
        if key in self._indices:
            self._i32(self._indices[key])
            return None
        idx = self._next_index
        self._next_index += 1
        self._indices[key] = idx
        self._keepalive.append(obj)
        self._i32(idx)
        return idx

    def write_object(self, obj: Any):
        from bigdl_tpu_torch.nn.module import Module
        if isinstance(obj, torch.Tensor):
            obj = _host(obj)
        if obj is None:
            self._i32(TYPE_NIL)
        elif isinstance(obj, bool):
            self._i32(TYPE_BOOLEAN)
            self._i32(1 if obj else 0)
        elif isinstance(obj, (int, float)):
            self._i32(TYPE_NUMBER)
            self._f64(float(obj))
        elif isinstance(obj, str):
            self._i32(TYPE_STRING)
            self._string(obj)
        elif isinstance(obj, np.ndarray) and obj.dtype == np.int64:
            # LongStorage (torch stores shape vectors this way)
            self._i32(TYPE_TORCH)
            if self._heap(obj) is None:
                return
            self._string("V 1")
            self._string("torch.LongStorage")
            self._i64(obj.size)
            self.f.write(np.ascontiguousarray(obj).tobytes())
        elif hasattr(obj, "shape"):  # numpy array -> tensor
            self._write_tensor(np.asarray(obj))
        elif isinstance(obj, Module):
            write_module(self, obj)
        elif isinstance(obj, TorchObject):
            self._i32(TYPE_TORCH)
            if self._heap(obj) is None:
                return
            self._string("V 1")
            self._string(obj.class_name)
            self.write_object(dict(obj.elements))
        elif isinstance(obj, (dict,)):
            self._i32(TYPE_TABLE)
            if self._heap(obj) is None:
                return
            self._i32(len(obj))
            for k, v in obj.items():
                self.write_object(k)
                self.write_object(v)
        elif isinstance(obj, (list, tuple)):
            # lua array-style table, 1-based keys (shares the heap with
            # dicts so aliased/cyclic lists memoize correctly)
            self._i32(TYPE_TABLE)
            if self._heap(obj) is None:
                return
            self._i32(len(obj))
            for i, v in enumerate(obj):
                self.write_object(i + 1)
                self.write_object(v)
        else:
            raise TypeError(f"cannot serialize {type(obj).__name__} to .t7")

    def _write_tensor(self, arr: np.ndarray):
        if arr.dtype == np.float32:
            cls, scls = "torch.FloatTensor", "torch.FloatStorage"
        elif arr.dtype == np.float64:
            cls, scls = "torch.DoubleTensor", "torch.DoubleStorage"
        else:
            arr = arr.astype(np.float64)
            cls, scls = "torch.DoubleTensor", "torch.DoubleStorage"
        self._i32(TYPE_TORCH)
        if self._heap(arr) is None:
            return
        self._string("V 1")
        self._string(cls)
        arr = np.ascontiguousarray(arr)
        self._i32(arr.ndim)
        for s in arr.shape:
            self._i64(s)
        # contiguous strides in elements
        stride = 1
        strides = []
        for s in reversed(arr.shape):
            strides.append(stride)
            stride *= s
        for s in reversed(strides):
            self._i64(s)
        self._i64(1)  # storage offset, 1-based
        # storage sub-object
        self._i32(TYPE_TORCH)
        self._i32(self._next_index)
        self._next_index += 1
        self._string("V 1")
        self._string(scls)
        self._i64(arr.size)
        self.f.write(arr.tobytes())


# ----------------------------------------------------------------------- #
# public API                                                              #
# ----------------------------------------------------------------------- #

def load(path: str) -> Any:
    """Load the first object of a .t7 file (ref TorchFile.load)."""
    with open(path, "rb") as f:
        return _Reader(f).read_object()


def save(obj: Any, path: str, overwrite: bool = True):
    import os
    if not overwrite and os.path.exists(path):
        raise FileExistsError(path)
    with open(path, "wb") as f:
        _Writer(f).write_object(obj)


def load_model(path: str, device=None):
    """Load a torch nn model saved as .t7 into bigdl_tpu_torch layers on
    ``device``, the card by default (ref Module.loadTorch,
    nn/Module.scala:31)."""
    obj = load(path)
    return module_from_torch(obj, device)


def _sync_child_shells(m) -> None:
    """Containers hold the whole params pytree ({"0": ..., "1": ...}) on
    their own shell; push the slices down so each child's shell sees its own
    weights (children are exported individually)."""
    from bigdl_tpu_torch.nn.containers import Container
    if isinstance(m, Container) and isinstance(m.params, dict):
        for i, c in enumerate(m.modules):
            key = str(i)
            if c.params is None and key in m.params:
                c.params = m.params[key]
            if not c.buffers and isinstance(m.buffers, dict) and m.buffers.get(key):
                c.buffers = m.buffers[key]
            _sync_child_shells(c)


def save_model(model, path: str, overwrite: bool = True):
    """Save a bigdl_tpu_torch model as a torch-readable .t7 (ref
    module.saveTorch); its tensors are read back to the host."""
    import os
    if not overwrite and os.path.exists(path):
        raise FileExistsError(path)
    _sync_child_shells(model)
    with open(path, "wb") as f:
        write_module(_Writer(f), model)


# -- torch nn.* <-> bigdl_tpu.nn mapping -------------------------------- #

def _num(elements, key, default=None):
    v = elements.get(key, default)
    return int(v) if v is not None else default


def _copy_filter_2d_or_4d(w: np.ndarray, n_out, n_in, kh, kw,
                          groups: int = 1) -> np.ndarray:
    """Accept both SpatialConvolutionMM 2-D (out, in*kh*kw) and 4-D layouts
    (grouped weights reshape to (out, in/groups, kh, kw))."""
    return np.asarray(w, np.float32).reshape(n_out, n_in // groups, kh, kw)


def _host(a) -> np.ndarray:
    """A tensor or array as a host numpy array: a torch tensor is read
    back (bfloat16 widened to float32, which holds it exactly)."""
    if isinstance(a, torch.Tensor):
        a = a.detach().cpu()
        if a.dtype == torch.bfloat16:
            a = a.float()
        return a.numpy()
    return np.asarray(a)


def _f32(a) -> np.ndarray:
    return np.asarray(_host(a), np.float32)


def module_from_torch(obj, device=None) -> "Any":
    """The bigdl_tpu_torch module of a torch ``nn.*`` object read from a
    .t7 file, its parameters and buffers tensors on ``device`` (the card
    unless the caller names another)."""
    from bigdl_tpu_torch.device import resolve_device
    device = resolve_device(device)
    return _built(_module_from_torch(obj, device), device)


def _built(m, device):
    if m.params is None:  # parameterless leaves still need a built shell
        m.build(seed=0, device=device)
    return m


def _module_from_torch(obj, device) -> "Any":
    from bigdl_tpu_torch import nn
    if not isinstance(obj, TorchObject):
        raise ValueError(f"not a torch module object: {type(obj).__name__}")
    cls = obj.class_name
    el = obj.elements

    def seq_children(container):
        mods = el.get("modules", {})
        n = len(mods)
        for i in range(1, n + 1):
            key = i if i in mods else (str(i) if str(i) in mods else float(i))
            container.add(_built(_module_from_torch(mods[key], device),
                                 device))
        # assemble container params from the already-loaded children —
        # container.build() would re-randomize them
        container.params = {str(i): c.params for i, c in enumerate(container.modules)}
        container.buffers = {str(i): c.buffers for i, c in enumerate(container.modules)}
        container.device = device
        container.zero_grad_parameters()
        return container

    def put(arr):
        return torch.from_numpy(np.array(arr, np.float32)).to(device)

    def with_params(m, **arrays):
        m.build(seed=0, device=device)
        for name, arr in arrays.items():
            if arr is not None:
                m.params[name] = put(arr)
        return m

    if cls.startswith("cudnn."):
        # the reference maps cudnn.* onto the plain module set the same way
        # (TorchFile.scala:138-142)
        cls = "nn." + cls[len("cudnn."):]

    if cls == "nn.Sequential":
        return seq_children(nn.Sequential())
    if cls == "nn.Concat":
        return seq_children(nn.Concat(_num(el, "dimension", 2)))
    if cls == "nn.DepthConcat":
        return seq_children(nn.DepthConcat())
    if cls == "nn.ConcatTable":
        return seq_children(nn.ConcatTable())
    if cls == "nn.ParallelTable":
        return seq_children(nn.ParallelTable())
    if cls == "nn.CAddTable":
        return nn.CAddTable()
    if cls == "nn.Linear":
        w = np.asarray(el["weight"], np.float32)
        m = nn.Linear(w.shape[1], w.shape[0], with_bias="bias" in el)
        return with_params(m, weight=w, bias=el.get("bias"))
    if cls in ("nn.SpatialConvolution", "nn.SpatialConvolutionMM"):
        n_in, n_out = _num(el, "nInputPlane"), _num(el, "nOutputPlane")
        kw_, kh = _num(el, "kW"), _num(el, "kH")
        groups = _num(el, "nGroup", _num(el, "groups", 1)) or 1
        m = nn.SpatialConvolution(
            n_in, n_out, kw_, kh, _num(el, "dW", 1), _num(el, "dH", 1),
            _num(el, "padW", 0), _num(el, "padH", 0), n_group=groups,
            with_bias="bias" in el and el["bias"] is not None)
        w = _copy_filter_2d_or_4d(el["weight"], n_out, n_in, kh, kw_, groups)
        return with_params(m, weight=w, bias=el.get("bias"))
    if cls == "nn.SpatialFullConvolution":
        n_in, n_out = _num(el, "nInputPlane"), _num(el, "nOutputPlane")
        kw_, kh = _num(el, "kW"), _num(el, "kH")
        groups = _num(el, "nGroup", 1) or 1
        m = nn.SpatialFullConvolution(
            n_in, n_out, kw_, kh, _num(el, "dW", 1), _num(el, "dH", 1),
            _num(el, "padW", 0), _num(el, "padH", 0),
            _num(el, "adjW", 0), _num(el, "adjH", 0), n_group=groups,
            no_bias=el.get("bias") is None)
        # torch layout: (nInput, nOutput/group, kH, kW)
        w = np.asarray(el["weight"], np.float32).reshape(
            n_in, n_out // groups, kh, kw_)
        return with_params(m, weight=w, bias=el.get("bias"))
    if cls == "nn.SpatialDilatedConvolution":
        n_in, n_out = _num(el, "nInputPlane"), _num(el, "nOutputPlane")
        kw_, kh = _num(el, "kW"), _num(el, "kH")
        m = nn.SpatialDilatedConvolution(
            n_in, n_out, kw_, kh, _num(el, "dW", 1), _num(el, "dH", 1),
            _num(el, "padW", 0), _num(el, "padH", 0),
            _num(el, "dilationW", 1), _num(el, "dilationH", 1))
        w = _copy_filter_2d_or_4d(el["weight"], n_out, n_in, kh, kw_)
        m = with_params(m, weight=w, bias=el.get("bias"))
        if el.get("bias") is None:
            m.with_bias = False
            m.params.pop("bias", None)
            m.zero_grad_parameters()
        return m
    if cls == "nn.SpatialConvolutionMap":
        conn = np.asarray(el["connTable"], np.float32).astype(np.int32)
        kw_, kh = _num(el, "kW"), _num(el, "kH")
        m = nn.SpatialConvolutionMap(
            conn, kw_, kh, _num(el, "dW", 1), _num(el, "dH", 1),
            _num(el, "padW", 0), _num(el, "padH", 0))
        m.build(seed=0, device=device)
        # torch stores (nConn, kH, kW); scatter into our dense masked layout
        wt = np.asarray(el["weight"], np.float32).reshape(len(conn), kh, kw_)
        dense = np.zeros((m.n_output_plane, m.n_input_plane, kh, kw_), np.float32)
        for k, (i, o) in enumerate(conn):
            dense[o - 1, i - 1] = wt[k]
        m.params["weight"] = put(dense)
        if el.get("bias") is not None:
            m.params["bias"] = put(el["bias"])
        return m
    if cls == "nn.SpatialMaxPooling":
        m = nn.SpatialMaxPooling(_num(el, "kW"), _num(el, "kH"),
                                 _num(el, "dW"), _num(el, "dH"),
                                 _num(el, "padW", 0), _num(el, "padH", 0))
        return m.ceil() if el.get("ceil_mode", False) else m.floor()
    if cls == "nn.SpatialAveragePooling":
        return nn.SpatialAveragePooling(
            _num(el, "kW"), _num(el, "kH"), _num(el, "dW", 1),
            _num(el, "dH", 1), _num(el, "padW", 0), _num(el, "padH", 0),
            ceil_mode=el.get("ceil_mode", False),
            count_include_pad=el.get("count_include_pad", True),
            divide=el.get("divide", True))
    if cls in ("nn.BatchNormalization", "nn.SpatialBatchNormalization"):
        mean = np.asarray(el["running_mean"], np.float32)
        layer_cls = (nn.SpatialBatchNormalization
                     if cls == "nn.SpatialBatchNormalization"
                     else nn.BatchNormalization)
        m = layer_cls(mean.shape[0], eps=float(el.get("eps", 1e-5)),
                      momentum=float(el.get("momentum", 0.1)),
                      affine="weight" in el and el["weight"] is not None)
        m = with_params(m, weight=el.get("weight"), bias=el.get("bias"))
        m.buffers["running_mean"] = put(mean)
        if el.get("running_var") is not None:
            var = np.asarray(el["running_var"], np.float32)
        elif el.get("running_std") is not None:
            # legacy torch stored running_std = 1/sqrt(var + eps)
            std = np.asarray(el["running_std"], np.float64)
            var = (std ** -2 - float(el.get("eps", 1e-5))).astype(np.float32)
        else:
            var = np.ones_like(mean)
        m.buffers["running_var"] = put(var)
        return m
    if cls == "nn.ReLU":
        return nn.ReLU(bool(el.get("inplace", False)))
    if cls == "nn.Tanh":
        return nn.Tanh()
    if cls == "nn.Sigmoid":
        return nn.Sigmoid()
    if cls == "nn.LogSoftMax":
        return nn.LogSoftMax()
    if cls == "nn.SoftMax":
        return nn.SoftMax()
    if cls == "nn.Threshold":
        return nn.Threshold(float(el.get("threshold", 1e-6)),
                            float(el.get("val", 0.0)),
                            bool(el.get("inplace", False)))
    if cls == "nn.Dropout":
        return nn.Dropout(float(el.get("p", 0.5)),
                          inplace=bool(el.get("inplace", False)))
    if cls == "nn.View":
        return nn.View(tuple(int(s) for s in np.asarray(el["size"]).ravel()))
    if cls == "nn.Reshape":
        return nn.Reshape(tuple(int(s) for s in np.asarray(el["size"]).ravel()))
    if cls == "nn.SpatialZeroPadding":
        return nn.SpatialZeroPadding(_num(el, "pad_l"), _num(el, "pad_r"),
                                     _num(el, "pad_t"), _num(el, "pad_b"))
    if cls == "nn.SpatialCrossMapLRN":
        return nn.SpatialCrossMapLRN(
            _num(el, "size", 5), float(el.get("alpha", 1.0)),
            float(el.get("beta", 0.75)), float(el.get("k", 1.0)))
    if cls == "nn.LookupTable":
        w = np.asarray(el["weight"], np.float32)
        m = nn.LookupTable(w.shape[0], w.shape[1],
                           padding_value=float(el.get("paddingValue", 0)),
                           max_norm=float(el.get("maxNorm") or float("inf")),
                           norm_type=float(el.get("normType", 2.0)))
        return with_params(m, weight=w)
    if cls == "nn.PReLU":
        w = np.asarray(el["weight"], np.float32).ravel()
        m = nn.PReLU(_num(el, "nOutputPlane", 0))
        return with_params(m, weight=w)
    if cls == "nn.Mul":
        return with_params(nn.Mul(), weight=np.asarray(el["weight"]).ravel())
    if cls == "nn.Add":
        b = np.asarray(el["bias"], np.float32).ravel()
        return with_params(nn.Add(b.shape[0]), bias=b)
    if cls == "nn.CMul":
        w = np.asarray(el["weight"], np.float32)
        return with_params(nn.CMul(w.shape), weight=w)
    if cls == "nn.CAdd":
        b = np.asarray(el["bias"], np.float32)
        return with_params(nn.CAdd(b.shape), bias=b)
    if cls == "nn.Euclidean":
        w = np.asarray(el["weight"], np.float32)
        # torch stores (inputSize, outputSize); ours is (out, in)
        return with_params(nn.Euclidean(w.shape[0], w.shape[1]), weight=w.T)
    if cls == "nn.LeakyReLU":
        return nn.LeakyReLU(float(el.get("negval", 0.01)),
                            bool(el.get("inplace", False)))
    if cls == "nn.ELU":
        return nn.ELU(float(el.get("alpha", 1.0)), bool(el.get("inplace", False)))
    if cls == "nn.SoftPlus":
        return nn.SoftPlus(float(el.get("beta", 1.0)))
    if cls == "nn.HardTanh":
        return nn.HardTanh(float(el.get("min_val", -1.0)),
                           float(el.get("max_val", 1.0)),
                           bool(el.get("inplace", False)))
    if cls == "nn.Power":
        return nn.Power(float(el.get("pow", 1.0)), float(el.get("scale", 1.0)),
                        float(el.get("shift", 0.0)))
    if cls == "nn.MulConstant":
        return nn.MulConstant(float(el.get("constant_scalar", 1.0)))
    if cls == "nn.AddConstant":
        return nn.AddConstant(float(el.get("constant_scalar", 0.0)))
    if cls == "nn.Mean":
        return nn.Mean(_num(el, "dimension", 1), _num(el, "nInputDims", -1))
    if cls == "nn.Sum":
        return nn.Sum(_num(el, "dimension", 1), _num(el, "nInputDims", -1),
                      size_average=bool(el.get("sizeAverage", False)))
    if cls == "nn.Max":
        return nn.Max(_num(el, "dim", 1), _num(el, "numInputDims", -1))
    if cls == "nn.Min":
        return nn.Min(_num(el, "dim", 1), _num(el, "numInputDims", -1))
    if cls == "nn.Select":
        return nn.Select(_num(el, "dimension"), _num(el, "index"))
    if cls == "nn.Narrow":
        return nn.Narrow(_num(el, "dimension"), _num(el, "index"),
                         _num(el, "length", 1))
    if cls == "nn.Replicate":
        return nn.Replicate(_num(el, "nfeatures"), _num(el, "dim", 1),
                            _num(el, "ndim", -1))
    if cls == "nn.Transpose":
        perms = el.get("permutations", {})
        pairs = []
        for i in range(1, len(perms) + 1):
            p = perms.get(i, perms.get(float(i), perms.get(str(i))))
            vals = ([p[k] for k in sorted(p, key=float)]
                    if isinstance(p, dict) else list(p))
            pairs.append((int(vals[0]), int(vals[1])))
        return nn.Transpose(pairs)
    if cls == "nn.Squeeze":
        return nn.Squeeze(_num(el, "dim"), _num(el, "numInputDims", -1))
    if cls == "nn.Unsqueeze":
        return nn.Unsqueeze(_num(el, "pos"), _num(el, "numInputDims", -1))
    if cls == "nn.Padding":
        return nn.Padding(_num(el, "dim"), _num(el, "pad"),
                          _num(el, "nInputDim", -1),
                          float(el.get("value", 0.0)), _num(el, "index", 1))
    if cls == "nn.JoinTable":
        return nn.JoinTable(_num(el, "dimension"), _num(el, "nInputDims", -1))
    if cls == "nn.SplitTable":
        return nn.SplitTable(_num(el, "dimension"), _num(el, "nInputDims", -1))
    if cls == "nn.Normalize":
        return nn.Normalize(float(el.get("p", 2.0)), float(el.get("eps", 1e-10)))

    # reflection-style fallback for parameter-free modules, mirroring the
    # reference's createInstanceFor path (TorchFile.scala:163-177): any
    # nn.<Name> whose constructor needs no arguments loads by name.
    if cls.startswith("nn."):
        layer_cls = getattr(nn, cls[3:], None)
        from bigdl_tpu_torch.nn.module import Module as _Module
        if (isinstance(layer_cls, type) and issubclass(layer_cls, _Module)):
            try:
                return layer_cls()
            except TypeError:
                pass  # requires constructor args we don't know
    raise NotImplementedError(f"t7 import of {cls}")


def _grad_like(params, name):
    arr = params.get(name)
    return np.zeros_like(_f32(arr)) if arr is not None else None


def _grouped_conv_as_concat(m, params):
    """Grouped conv -> Concat(channel){Sequential{Narrow(ch), conv_g}}:
    the Torch-readable rendering of feature groups (torch's own AlexNet
    reimplementations used exactly this shape before cunn grew a groups
    arg).  Forward-equivalent to the fused grouped conv."""
    from bigdl_tpu_torch import nn
    in_per, out_per = m.n_input_plane // m.n_group, m.n_output_plane // m.n_group
    w4 = _f32(params["weight"])  # (O, I/g, kH, kW)
    bias = _f32(params["bias"]) if "bias" in params else None
    cat = nn.Concat(2)
    for g in range(m.n_group):
        conv = nn.SpatialConvolution(
            in_per, out_per, m.kernel_w, m.kernel_h, m.stride_w, m.stride_h,
            m.pad_w, m.pad_h, with_bias=bias is not None)
        # host shells: they are only written
        conv.build(seed=0, device="cpu")
        conv.params["weight"] = w4[g * out_per:(g + 1) * out_per]
        if bias is not None:
            conv.params["bias"] = bias[g * out_per:(g + 1) * out_per]
        nar = nn.Narrow(2, g * in_per + 1, in_per)
        nar.build(seed=0, device="cpu")
        branch = nn.Sequential(nar, conv)
        branch.params = {"0": nar.params, "1": conv.params}
        branch.buffers = {"0": nar.buffers, "1": conv.buffers}
        cat.add(branch)
    cat.params = {str(i): c.params for i, c in enumerate(cat.modules)}
    cat.buffers = {str(i): c.buffers for i, c in enumerate(cat.modules)}
    return cat


def write_module(w: _Writer, m) -> None:
    """Write one bigdl_tpu_torch module as a torch nn.* object (same
    writable set as the reference, TorchFile.scala:257-290, plus a few
    extras)."""
    from bigdl_tpu_torch import nn
    params = m._built()

    def header(cls_name) -> bool:
        w._i32(TYPE_TORCH)
        if w._heap(m) is None:
            return False
        w._string("V 1")
        w._string(cls_name)
        return True

    def body(**el):
        el.setdefault("train", bool(m.train))
        w.write_object({k: v for k, v in el.items()})

    if isinstance(m, nn.DepthConcat):
        if not header("nn.DepthConcat"):
            return
        body(modules={i + 1: c for i, c in enumerate(m.modules)},
             dimension=float(m.dimension))
    elif isinstance(m, nn.Concat):
        if not header("nn.Concat"):
            return
        body(modules={i + 1: c for i, c in enumerate(m.modules)},
             dimension=float(m.dimension))
    elif isinstance(m, nn.Sequential):
        if not header("nn.Sequential"):
            return
        body(modules={i + 1: c for i, c in enumerate(m.modules)})
    elif isinstance(m, nn.Linear):
        if not header("nn.Linear"):
            return
        weight = _f32(params["weight"])
        body(weight=weight, bias=_f32(params["bias"])
             if "bias" in params else None,
             gradWeight=np.zeros_like(weight),
             gradBias=_grad_like(params, "bias"))
    elif isinstance(m, nn.SpatialDilatedConvolution):
        if not header("nn.SpatialDilatedConvolution"):
            return
        w4 = _f32(params["weight"])
        body(nInputPlane=float(m.n_input_plane),
             nOutputPlane=float(m.n_output_plane),
             kW=float(m.kernel_w), kH=float(m.kernel_h),
             dW=float(m.stride_w), dH=float(m.stride_h),
             padW=float(m.pad_w), padH=float(m.pad_h),
             dilationW=float(m.dilation_w), dilationH=float(m.dilation_h),
             weight=w4, gradWeight=np.zeros_like(w4),
             bias=_f32(params["bias"])
             if "bias" in params else None,
             gradBias=_grad_like(params, "bias"))
    elif isinstance(m, nn.SpatialConvolutionMap):
        if not header("nn.SpatialConvolutionMap"):
            return
        conn = np.asarray(m.conn_table, np.int64)
        dense = _f32(params["weight"])
        wt = np.stack([dense[o - 1, i - 1] for i, o in conn])  # (nConn,kH,kW)
        body(connTable=conn.astype(np.float32),
             kW=float(m.kernel_w), kH=float(m.kernel_h),
             dW=float(m.stride_w), dH=float(m.stride_h),
             padW=float(m.pad_w), padH=float(m.pad_h),
             nInputPlane=float(m.n_input_plane),
             nOutputPlane=float(m.n_output_plane),
             weight=wt, gradWeight=np.zeros_like(wt),
             bias=_f32(params["bias"]),
             gradBias=_grad_like(params, "bias"))
    elif isinstance(m, nn.SpatialFullConvolution):
        if not header("nn.SpatialFullConvolution"):
            return
        w4 = _f32(params["weight"])  # (I, O/g, kH, kW)
        body(nInputPlane=float(m.n_input_plane),
             nOutputPlane=float(m.n_output_plane),
             kW=float(m.kernel_w), kH=float(m.kernel_h),
             dW=float(m.stride_w), dH=float(m.stride_h),
             padW=float(m.pad_w), padH=float(m.pad_h),
             adjW=float(m.adj_w), adjH=float(m.adj_h),
             nGroup=float(m.n_group),
             weight=w4, gradWeight=np.zeros_like(w4),
             bias=_f32(params["bias"])
             if "bias" in params else None,
             gradBias=_grad_like(params, "bias"))
    elif isinstance(m, nn.SpatialConvolution):
        if m.n_group != 1:
            # standard Torch7 has no grouped SpatialConvolutionMM: emit
            # the classic decomposition instead — Concat over groups of
            # (Narrow the input channels -> per-group conv) — which any
            # Torch-era loader (and our importer) reads as plain modules
            # with identical forward semantics
            write_module(w, _grouped_conv_as_concat(m, params))
            return
        if not header("nn.SpatialConvolutionMM"):
            return
        w4 = _f32(params["weight"])
        w2 = w4.reshape(m.n_output_plane, -1)  # MM layout (out, in*kh*kw)
        body(nInputPlane=float(m.n_input_plane),
             nOutputPlane=float(m.n_output_plane),
             kW=float(m.kernel_w), kH=float(m.kernel_h),
             dW=float(m.stride_w), dH=float(m.stride_h),
             padW=float(m.pad_w), padH=float(m.pad_h),
             weight=w2, gradWeight=np.zeros_like(w2),
             bias=_f32(params["bias"])
             if "bias" in params else None,
             gradBias=_grad_like(params, "bias"))
    elif isinstance(m, nn.SpatialMaxPooling):
        if not header("nn.SpatialMaxPooling"):
            return
        body(kW=float(m.kernel_w), kH=float(m.kernel_h),
             dW=float(m.stride_w), dH=float(m.stride_h),
             padW=float(m.pad_w), padH=float(m.pad_h),
             ceil_mode=bool(m.ceil_mode))
    elif isinstance(m, nn.ReLU):
        if not header("nn.ReLU"):
            return
        body(inplace=bool(m.ip), threshold=0.0, val=0.0)
    elif isinstance(m, nn.Threshold):
        if not header("nn.Threshold"):
            return
        body(threshold=float(m.th), val=float(m.v), inplace=bool(m.ip))
    elif isinstance(m, nn.Dropout):
        if not header("nn.Dropout"):
            return
        body(p=float(m.p), inplace=bool(m.inplace), v2=True)
    elif isinstance(m, nn.View):
        if not header("nn.View"):
            return
        size = np.asarray(m.sizes, np.int64)
        body(size=size, numElements=float(int(np.prod(m.sizes))))
    elif isinstance(m, nn.Reshape):
        if not header("nn.Reshape"):
            return
        size = np.asarray(m.size, np.int64)
        body(size=size, nelement=float(int(np.prod(m.size))),
             batchMode=m.batch_mode)
    elif isinstance(m, nn.LogSoftMax):
        if not header("nn.LogSoftMax"):
            return
        body()
    elif isinstance(m, nn.Tanh):
        if not header("nn.Tanh"):
            return
        body()
    elif isinstance(m, nn.Sigmoid):
        if not header("nn.Sigmoid"):
            return
        body()
    elif isinstance(m, (nn.BatchNormalization,)):
        cls = ("nn.SpatialBatchNormalization"
               if isinstance(m, nn.SpatialBatchNormalization)
               else "nn.BatchNormalization")
        if not header(cls):
            return
        buf = m.buffers or m.init_buffers()
        body(running_mean=_f32(buf["running_mean"]),
             running_var=_f32(buf["running_var"]),
             weight=_f32(params["weight"])
             if "weight" in params else None,
             bias=_f32(params["bias"])
             if "bias" in params else None,
             eps=float(m.eps), momentum=float(m.momentum),
             affine=bool(m.affine))
    elif isinstance(m, nn.SpatialAveragePooling):
        if not header("nn.SpatialAveragePooling"):
            return
        body(kW=float(m.kernel_w), kH=float(m.kernel_h),
             dW=float(m.stride_w), dH=float(m.stride_h),
             padW=float(m.pad_w), padH=float(m.pad_h),
             ceil_mode=bool(m.ceil_mode),
             count_include_pad=bool(m.count_include_pad),
             divide=bool(m.divide))
    elif isinstance(m, nn.ConcatTable):
        if not header("nn.ConcatTable"):
            return
        body(modules={i + 1: c for i, c in enumerate(m.modules)})
    elif isinstance(m, nn.ParallelTable):
        if not header("nn.ParallelTable"):
            return
        body(modules={i + 1: c for i, c in enumerate(m.modules)})
    elif isinstance(m, nn.CAddTable):
        if not header("nn.CAddTable"):
            return
        body(inplace=bool(getattr(m, "inplace", False)))
    elif isinstance(m, nn.SpatialCrossMapLRN):
        if not header("nn.SpatialCrossMapLRN"):
            return
        body(size=float(m.size), alpha=float(m.alpha), beta=float(m.beta),
             k=float(m.k))
    elif isinstance(m, nn.LookupTable):
        if not header("nn.LookupTable"):
            return
        wt_ = _f32(params["weight"])
        body(weight=wt_, gradWeight=np.zeros_like(wt_),
             paddingValue=float(m.padding_value),
             maxNorm=(float(m.max_norm)
                      if m.max_norm != float("inf") else None),
             normType=float(m.norm_type))
    elif isinstance(m, nn.PReLU):
        if not header("nn.PReLU"):
            return
        wt_ = _f32(params["weight"])
        body(weight=wt_, gradWeight=np.zeros_like(wt_),
             nOutputPlane=float(m.n_output_plane))
    elif isinstance(m, nn.Euclidean):
        if not header("nn.Euclidean"):
            return
        wt_ = _f32(params["weight"]).T  # (in, out) torch layout
        body(weight=wt_, gradWeight=np.zeros_like(wt_))
    elif isinstance(m, nn.Mul):
        if not header("nn.Mul"):
            return
        wt_ = _f32(params["weight"])
        body(weight=wt_, gradWeight=np.zeros_like(wt_))
    elif isinstance(m, nn.Add):
        if not header("nn.Add"):
            return
        b = _f32(params["bias"])
        body(bias=b, gradBias=np.zeros_like(b))
    elif isinstance(m, nn.CMul):
        if not header("nn.CMul"):
            return
        wt_ = _f32(params["weight"])
        body(weight=wt_, gradWeight=np.zeros_like(wt_),
             size=np.asarray(m.size, np.int64))
    elif isinstance(m, nn.CAdd):
        if not header("nn.CAdd"):
            return
        b = _f32(params["bias"])
        body(bias=b, gradBias=np.zeros_like(b),
             size=np.asarray(m.size, np.int64))
    elif isinstance(m, nn.LeakyReLU):
        if not header("nn.LeakyReLU"):
            return
        body(negval=float(m.negval))
    elif isinstance(m, nn.ELU):
        if not header("nn.ELU"):
            return
        body(alpha=float(m.alpha))
    elif isinstance(m, nn.SoftPlus):
        if not header("nn.SoftPlus"):
            return
        body(beta=float(m.beta))
    elif isinstance(m, nn.Clamp):
        if not header("nn.HardTanh"):
            return
        body(min_val=float(m.min_value), max_val=float(m.max_value))
    elif isinstance(m, nn.HardTanh):
        if not header("nn.HardTanh"):
            return
        body(min_val=float(m.min_value), max_val=float(m.max_value))
    elif isinstance(m, nn.Power):
        if not header("nn.Power"):
            return
        body(pow=float(m.power), scale=float(m.scale), shift=float(m.shift))
    elif isinstance(m, nn.MulConstant):
        if not header("nn.MulConstant"):
            return
        body(constant_scalar=float(m.scalar))
    elif isinstance(m, nn.AddConstant):
        if not header("nn.AddConstant"):
            return
        body(constant_scalar=float(m.constant_scalar))
    elif isinstance(m, nn.Mean):
        if not header("nn.Mean"):
            return
        body(dimension=float(m.dimension), nInputDims=float(m.n_input_dims))
    elif isinstance(m, nn.Sum):
        if not header("nn.Sum"):
            return
        body(dimension=float(m.dimension), nInputDims=float(m.n_input_dims),
             sizeAverage=bool(m.size_average))
    elif isinstance(m, nn.Max):
        if not header("nn.Max"):
            return
        body(dim=float(m.dim), numInputDims=float(m.num_input_dims))
    elif isinstance(m, nn.Min):
        if not header("nn.Min"):
            return
        body(dim=float(m.dim), numInputDims=float(m.num_input_dims))
    elif isinstance(m, nn.Select):
        if not header("nn.Select"):
            return
        body(dimension=float(m.dimension), index=float(m.index))
    elif isinstance(m, nn.Narrow):
        if not header("nn.Narrow"):
            return
        body(dimension=float(m.dimension), index=float(m.offset),
             length=float(m.length))
    elif isinstance(m, nn.Replicate):
        if not header("nn.Replicate"):
            return
        body(nfeatures=float(m.n_features), dim=float(m.dim),
             ndim=float(m.n_dim))
    elif isinstance(m, nn.Transpose):
        if not header("nn.Transpose"):
            return
        body(permutations={i + 1: {1: float(a), 2: float(b)}
                           for i, (a, b) in enumerate(m.permutations)})
    elif isinstance(m, nn.Squeeze):
        if not header("nn.Squeeze"):
            return
        body(dim=(float(m.dim) if m.dim is not None else None),
             numInputDims=float(m.num_input_dims))
    elif isinstance(m, nn.Unsqueeze):
        if not header("nn.Unsqueeze"):
            return
        body(pos=float(m.pos), numInputDims=float(m.num_input_dims))
    elif isinstance(m, nn.Padding):
        if not header("nn.Padding"):
            return
        body(dim=float(m.dim), pad=float(m.pad),
             nInputDim=float(m.n_input_dim), value=float(m.value),
             index=float(m.n_index))
    elif isinstance(m, nn.JoinTable):
        if not header("nn.JoinTable"):
            return
        body(dimension=float(m.dimension), nInputDims=float(m.n_input_dims))
    elif isinstance(m, nn.SplitTable):
        if not header("nn.SplitTable"):
            return
        body(dimension=float(m.dimension), nInputDims=float(m.n_input_dims))
    elif isinstance(m, nn.Normalize):
        if not header("nn.Normalize"):
            return
        body(p=float(m.p), eps=float(m.eps))
    elif isinstance(m, nn.SpatialZeroPadding):
        if not header("nn.SpatialZeroPadding"):
            return
        body(pad_l=float(m.pad_left), pad_r=float(m.pad_right),
             pad_t=float(m.pad_top), pad_b=float(m.pad_bottom))
    elif (not params and not getattr(m, "modules", None)
          and type(m).__init__ is nn.Module.__init__):
        # parameter-free, hyperparameter-free leaf: export by class name,
        # the mirror of the reflection-based import fallback (ref
        # TorchFile.scala:163-177).  Classes with their OWN __init__ carry
        # constructor hyperparameters this fallback would silently drop
        # (e.g. GradientReversal.the_lambda) — those need an explicit
        # handler above and refuse loudly here.
        if not header(f"nn.{type(m).__name__}"):
            return
        body()
    else:
        raise NotImplementedError(f"t7 export of {type(m).__name__}")
