"""Torch-verb Tensor facade (port of ``bigdl_tpu/tensor/__init__.py``;
ref tensor/Tensor.scala:35, TensorMath.scala:28).

The reference's tensor layer is a strided view over a flat array with
Torch semantics: 1-based dimensions and indices, ``narrow`` / ``select``
/ ``view`` aliasing one storage, in-place math that every aliasing view
sees.  Here a :class:`Storage` holds a flat CPU ``torch.Tensor`` and a
:class:`Tensor` is ``torch.as_strided`` over it, so the aliasing is the
storage's own.  It is a host-side facade (the interop loaders, the data
pipeline, user code written against the Torch API); ``to_torch(device)``
and ``from_torch`` cross to and from the device tensors the model runs
on.

Negative dimensions are not supported, as in Torch7.  Random fills
(``rand``, ``randn``, ``bernoulli``) draw from the thread's
:class:`~bigdl_tpu_torch.utils.rng.RNG`, so a fill is the reference's
bit for bit for the same seed.
"""
from __future__ import annotations

from typing import Optional, Sequence, Union

import numpy as np
import torch

from bigdl_tpu_torch.utils.rng import RNG

__all__ = ["Tensor", "Storage"]

Number = Union[int, float]


def _torch_dtype(dtype) -> torch.dtype:
    if isinstance(dtype, torch.dtype):
        return dtype
    return torch.from_numpy(np.zeros(0, dtype=np.dtype(dtype))).dtype


def _flat_owned(t: torch.Tensor) -> torch.Tensor:
    """``t`` flattened into a contiguous tensor whose view starts at its
    storage's first element (``as_strided`` offsets are absolute)."""
    t = t.reshape(-1)
    if not t.is_contiguous() or t.storage_offset() != 0:
        t = t.clone()
    return t


class Storage:
    """Flat 1-D storage (ref tensor/Storage.scala) over a CPU tensor."""

    def __init__(self, data: Union[int, Sequence, np.ndarray, torch.Tensor],
                 dtype=np.float32):
        dt = _torch_dtype(dtype)
        if isinstance(data, (int, np.integer)):
            self._data = torch.zeros(int(data), dtype=dt)
        elif isinstance(data, torch.Tensor):
            self._data = _flat_owned(data.detach().cpu().to(dt))
        else:
            np_dtype = None if isinstance(dtype, torch.dtype) else dtype
            arr = np.ascontiguousarray(np.asarray(data, dtype=np_dtype))
            self._data = _flat_owned(torch.as_tensor(arr).to(dt))

    def array(self) -> torch.Tensor:
        return self._data

    def __len__(self) -> int:
        return self._data.numel()

    def __getitem__(self, i: int):  # 1-based
        return self._data[i - 1].item()

    def __setitem__(self, i: int, v) -> None:  # 1-based
        self._data[i - 1] = v

    def copy(self, other: "Storage") -> "Storage":
        self._data.copy_(other._data)
        return self

    def fill(self, v, offset: int = 1, length: Optional[int] = None
             ) -> "Storage":
        length = len(self) - offset + 1 if length is None else length
        self._data[offset - 1:offset - 1 + length] = v
        return self


def _as_t(x):
    if isinstance(x, Tensor):
        return x._t()
    if isinstance(x, np.ndarray):
        return torch.as_tensor(x)
    return x


class Tensor:
    """N-d strided tensor with Torch verbs over a flat Storage.

    Constructors::

        Tensor()                      # empty
        Tensor(3, 4)                  # zeros of shape (3,4)
        Tensor([3, 4])                # zeros of shape (3,4)
        Tensor(array)                 # copy of an ndarray or torch.Tensor
        Tensor(storage, offset, sizes, strides)  # aliasing view
    """

    def __init__(self, *args, dtype=np.float32):
        if len(args) == 0:
            self._set_view(Storage(0, dtype), 1, (), ())
            return
        a0 = args[0]
        if isinstance(a0, Storage):
            offset = args[1] if len(args) > 1 else 1
            sizes = (tuple(args[2]) if len(args) > 2 and args[2] is not None
                     else (len(a0),))
            strides = (tuple(args[3]) if len(args) > 3 and args[3] is not None
                       else _contiguous_strides(sizes))
            self._set_view(a0, offset, sizes, strides)
        elif isinstance(a0, Tensor):
            self._from_tensor(a0._t().clone())
        elif isinstance(a0, torch.Tensor):
            t = a0.detach().cpu()
            if not (t.is_floating_point() or t.dtype in _INT_DTYPES):
                t = t.to(_torch_dtype(dtype))
            self._from_tensor(t.clone())
        elif isinstance(a0, np.ndarray):
            keep = a0.dtype.kind in "fiu"
            self._from_tensor(torch.as_tensor(np.array(
                a0, dtype=a0.dtype if keep else dtype)))
        elif isinstance(a0, (list, tuple)) and len(args) == 1:
            arr0 = np.asarray(a0)
            if arr0.dtype.kind in "iu" and arr0.ndim == 1 and not any(
                    isinstance(e, (list, tuple, np.ndarray, float))
                    for e in a0):
                # Tensor([3,4]) = zeros of that shape (Torch convention)
                self._zeros(tuple(int(s) for s in a0), dtype)
            else:
                self._from_tensor(torch.as_tensor(np.asarray(a0,
                                                             dtype=dtype)))
        else:  # Tensor(3, 4, ...)
            self._zeros(tuple(int(s) for s in args), dtype)

    # ---------------------------------------------------------------- #
    # internals                                                        #
    # ---------------------------------------------------------------- #
    def _zeros(self, sizes, dtype) -> None:
        st = Storage(int(np.prod(sizes)) if sizes else 0, dtype)
        self._set_view(st, 1, sizes, _contiguous_strides(sizes))

    def _set_view(self, storage: Storage, offset: int, sizes, strides
                  ) -> None:
        self._storage = storage
        self._offset = int(offset)
        self._sizes = tuple(int(s) for s in sizes)
        self._strides = tuple(int(s) for s in strides)

    def _from_tensor(self, t: torch.Tensor) -> None:
        shape = tuple(t.shape)
        st = Storage(t.contiguous(), dtype=t.dtype)
        self._set_view(st, 1, shape, _contiguous_strides(shape))

    def _t(self) -> torch.Tensor:
        """A (possibly aliasing) torch view of this tensor."""
        base = self._storage.array()
        if self.dim() == 0:
            return base[self._offset - 1:self._offset - 1]
        return torch.as_strided(base, self._sizes, self._strides,
                                self._offset - 1)

    # ---------------------------------------------------------------- #
    # shape / metadata (ref Tensor.scala:35-200)                       #
    # ---------------------------------------------------------------- #
    def dim(self) -> int:
        return len(self._sizes)

    n_dimension = dim
    nDimension = dim

    def size(self, dim: Optional[int] = None):
        if dim is None:
            return tuple(self._sizes)
        return self._sizes[dim - 1]

    def stride(self, dim: Optional[int] = None):
        if dim is None:
            return tuple(self._strides)
        return self._strides[dim - 1]

    def n_element(self) -> int:
        return int(np.prod(self._sizes)) if self._sizes else 0

    nElement = n_element

    def storage(self) -> Storage:
        return self._storage

    def storage_offset(self) -> int:
        return self._offset

    def is_contiguous(self) -> bool:
        return self._strides == _contiguous_strides(self._sizes)

    def contiguous(self) -> "Tensor":
        if self.is_contiguous():
            return self
        return Tensor(self._t())

    @property
    def dtype(self) -> torch.dtype:
        return self._storage.array().dtype

    # ---------------------------------------------------------------- #
    # element access (1-based)                                         #
    # ---------------------------------------------------------------- #
    def value_at(self, *indices: int):
        return float(self._t()[tuple(i - 1 for i in indices)])

    valueAt = value_at

    def set_value(self, *args) -> "Tensor":
        *indices, v = args
        self._t()[tuple(i - 1 for i in indices)] = v
        return self

    setValue = set_value

    def __getitem__(self, idx):
        if isinstance(idx, int):
            if self.dim() == 1:
                return self.value_at(idx)
            return self.select(1, idx)
        if isinstance(idx, tuple):
            return self.value_at(*idx)
        raise TypeError(f"unsupported index {idx!r}")

    def __setitem__(self, idx, v) -> None:
        if isinstance(idx, int):
            if self.dim() == 1:
                self.set_value(idx, v)
            else:
                self.select(1, idx).copy(
                    v if isinstance(v, Tensor) else Tensor(np.asarray(v)))
        elif isinstance(idx, tuple):
            self.set_value(*idx, v)
        else:
            raise TypeError(f"unsupported index {idx!r}")

    # ---------------------------------------------------------------- #
    # views (aliasing, ref Tensor.scala narrow/select/view/…)          #
    # ---------------------------------------------------------------- #
    def narrow(self, dim: int, index: int, size: int) -> "Tensor":
        d = dim - 1
        assert 1 <= index and index + size - 1 <= self._sizes[d], \
            "narrow out of range"
        offset = self._offset + (index - 1) * self._strides[d]
        sizes = list(self._sizes)
        sizes[d] = size
        return Tensor(self._storage, offset, sizes, self._strides)

    def select(self, dim: int, index: int) -> "Tensor":
        d = dim - 1
        assert self.dim() > 0, "cannot select on a scalar"
        offset = self._offset + (index - 1) * self._strides[d]
        sizes = self._sizes[:d] + self._sizes[d + 1:]
        strides = self._strides[:d] + self._strides[d + 1:]
        return Tensor(self._storage, offset, sizes, strides)

    def view(self, *sizes) -> "Tensor":
        sizes = _infer_size(_unpack_sizes(sizes), self.n_element())
        assert self.is_contiguous(), "view requires a contiguous tensor"
        return Tensor(self._storage, self._offset, sizes,
                      _contiguous_strides(sizes))

    def reshape(self, *sizes) -> "Tensor":
        sizes = _infer_size(_unpack_sizes(sizes), self.n_element())
        return Tensor(self._t().reshape(sizes))

    def transpose(self, dim1: int, dim2: int) -> "Tensor":
        d1, d2 = dim1 - 1, dim2 - 1
        sizes = list(self._sizes)
        strides = list(self._strides)
        sizes[d1], sizes[d2] = sizes[d2], sizes[d1]
        strides[d1], strides[d2] = strides[d2], strides[d1]
        return Tensor(self._storage, self._offset, sizes, strides)

    def t(self) -> "Tensor":
        assert self.dim() == 2, "t() expects a 2D tensor"
        return self.transpose(1, 2)

    def unfold(self, dim: int, size: int, step: int) -> "Tensor":
        d = dim - 1
        n = (self._sizes[d] - size) // step + 1
        sizes = self._sizes[:d] + (n,) + self._sizes[d + 1:] + (size,)
        strides = (self._strides[:d] + (self._strides[d] * step,)
                   + self._strides[d + 1:] + (self._strides[d],))
        return Tensor(self._storage, self._offset, sizes, strides)

    def expand(self, *sizes) -> "Tensor":
        sizes = _unpack_sizes(sizes)
        assert len(sizes) == self.dim()
        strides = list(self._strides)
        for i, (have, want) in enumerate(zip(self._sizes, sizes)):
            if have != want:
                assert have == 1, \
                    f"cannot expand dim {i + 1} from {have} to {want}"
                strides[i] = 0
        return Tensor(self._storage, self._offset, sizes, strides)

    def expand_as(self, other: "Tensor") -> "Tensor":
        return self.expand(*other.size())

    def squeeze(self, dim: Optional[int] = None) -> "Tensor":
        if dim is None:
            keep = [i for i, s in enumerate(self._sizes) if s != 1]
        else:
            keep = [i for i in range(self.dim())
                    if not (i == dim - 1 and self._sizes[i] == 1)]
        sizes = tuple(self._sizes[i] for i in keep)
        strides = tuple(self._strides[i] for i in keep)
        return Tensor(self._storage, self._offset, sizes, strides)

    def unsqueeze(self, dim: int) -> "Tensor":
        d = dim - 1
        sizes = self._sizes[:d] + (1,) + self._sizes[d:]
        stride_here = (self._strides[d] * self._sizes[d]
                       if d < self.dim() else 1)
        strides = self._strides[:d] + (stride_here,) + self._strides[d:]
        return Tensor(self._storage, self._offset, sizes, strides)

    def split(self, size: int, dim: int = 1) -> list:
        out, i = [], 1
        total = self._sizes[dim - 1]
        while i <= total:
            out.append(self.narrow(dim, i, min(size, total - i + 1)))
            i += size
        return out

    def set(self, other: Optional["Tensor"] = None,
            storage: Optional[Storage] = None, storage_offset: int = 1,
            sizes=None, strides=None) -> "Tensor":
        """Re-point this tensor at another tensor's storage (ref
        Tensor.set)."""
        if other is not None:
            self._set_view(other._storage, other._offset, other._sizes,
                           other._strides)
        elif storage is not None:
            sizes = tuple(sizes) if sizes is not None else (len(storage),)
            strides = (tuple(strides) if strides is not None
                       else _contiguous_strides(sizes))
            self._set_view(storage, storage_offset, sizes, strides)
        else:
            self._set_view(Storage(0, self.dtype), 1, (), ())
        return self

    def resize(self, *sizes) -> "Tensor":
        sizes = _unpack_sizes(sizes)
        n = int(np.prod(sizes)) if sizes else 0
        if n > len(self._storage) - self._offset + 1 \
                or not self.is_contiguous():
            self._set_view(Storage(n, self.dtype), 1, sizes,
                           _contiguous_strides(sizes))
        else:
            self._set_view(self._storage, self._offset, sizes,
                           _contiguous_strides(sizes))
        return self

    def resize_as(self, other: "Tensor") -> "Tensor":
        return self.resize(*other.size())

    resizeAs = resize_as

    # ---------------------------------------------------------------- #
    # fill / randomization (in-place)                                  #
    # ---------------------------------------------------------------- #
    def fill(self, v: Number) -> "Tensor":
        self._t().fill_(v)
        return self

    def zero(self) -> "Tensor":
        return self.fill(0)

    def copy(self, other: "Tensor") -> "Tensor":
        self._t().copy_(torch.broadcast_to(_as_t(other), self._sizes))
        return self

    def rand(self) -> "Tensor":
        self._assign_flat(RNG.current().uniform_array(self.n_element()))
        return self

    def randn(self) -> "Tensor":
        self._assign_flat(RNG.current().normal_array(self.n_element()))
        return self

    def bernoulli(self, p: float) -> "Tensor":
        self._assign_flat(RNG.current().bernoulli_array(self.n_element(),
                                                        p))
        return self

    def _assign_flat(self, vals) -> None:
        self._t().copy_(torch.as_tensor(np.asarray(vals)).to(
            self.dtype).reshape(self._sizes))

    def apply1(self, fn) -> "Tensor":
        view = self._t()
        vals = [fn(float(x)) for x in view.reshape(-1).tolist()]
        view.copy_(torch.tensor(vals, dtype=torch.float64).to(
            self.dtype).reshape(self._sizes))
        return self

    # ---------------------------------------------------------------- #
    # math (ref TensorMath.scala:28-642) — out-of-place unless noted   #
    # ---------------------------------------------------------------- #
    def _wrap(self, t) -> "Tensor":
        return Tensor(torch.as_tensor(t).to(self.dtype))

    def __add__(self, other):
        return self._wrap(self._t() + _as_t(other))

    def __radd__(self, other):
        return self._wrap(_as_t(other) + self._t())

    def __sub__(self, other):
        return self._wrap(self._t() - _as_t(other))

    def __rsub__(self, other):
        return self._wrap(_as_t(other) - self._t())

    def __mul__(self, other):
        return self._wrap(self._t() * _as_t(other))

    def __rmul__(self, other):
        return self._wrap(_as_t(other) * self._t())

    def __truediv__(self, other):
        return self._wrap(self._t() / _as_t(other))

    def __neg__(self):
        return self._wrap(-self._t())

    # in-place accumulate family (Torch add/cmul/… mutate the receiver)
    def add(self, *args) -> "Tensor":
        """add(value) | add(tensor) | add(alpha, tensor) — in place."""
        if len(args) == 1:
            self._t().add_(_as_t(args[0]))
        else:
            alpha, t = args
            self._t().add_(alpha * _as_t(t))
        return self

    def sub(self, *args) -> "Tensor":
        if len(args) == 1:
            self._t().sub_(_as_t(args[0]))
        else:
            alpha, t = args
            self._t().sub_(alpha * _as_t(t))
        return self

    def cmul(self, other: "Tensor") -> "Tensor":
        self._t().mul_(_as_t(other))
        return self

    def cdiv(self, other: "Tensor") -> "Tensor":
        self._t().div_(_as_t(other))
        return self

    def mul(self, v: Number) -> "Tensor":
        self._t().mul_(v)
        return self

    def div(self, v: Number) -> "Tensor":
        self._t().div_(v)
        return self

    def addcmul(self, value: Number, t1: "Tensor", t2: "Tensor") -> "Tensor":
        self._t().add_(value * (_as_t(t1) * _as_t(t2)))
        return self

    def addcdiv(self, value: Number, t1: "Tensor", t2: "Tensor") -> "Tensor":
        self._t().add_(value * (_as_t(t1) / _as_t(t2)))
        return self

    # BLAS family
    def addmm(self, *args) -> "Tensor":
        """addmm([beta,] [alpha,] mat1, mat2): self = beta*self +
        alpha*mat1@mat2."""
        beta, alpha, m1, m2 = _parse_blas_args(args)
        view = self._t()
        view.copy_(beta * view + alpha * (_as_t(m1) @ _as_t(m2)))
        return self

    def addmv(self, *args) -> "Tensor":
        beta, alpha, m, v = _parse_blas_args(args)
        view = self._t()
        view.copy_(beta * view + alpha * (_as_t(m) @ _as_t(v)))
        return self

    def addr(self, *args) -> "Tensor":
        beta, alpha, v1, v2 = _parse_blas_args(args)
        view = self._t()
        view.copy_(beta * view + alpha * torch.outer(_as_t(v1), _as_t(v2)))
        return self

    def baddbmm(self, *args) -> "Tensor":
        beta, alpha, b1, b2 = _parse_blas_args(args)
        view = self._t()
        view.copy_(beta * view + alpha * torch.matmul(_as_t(b1),
                                                      _as_t(b2)))
        return self

    def _assign_result(self, r: torch.Tensor) -> "Tensor":
        self.resize(*r.shape)
        self._t().copy_(r)
        return self

    def mm(self, m1: "Tensor", m2: "Tensor") -> "Tensor":
        return self._assign_result(_as_t(m1) @ _as_t(m2))

    def mv(self, m: "Tensor", v: "Tensor") -> "Tensor":
        return self._assign_result(_as_t(m) @ _as_t(v))

    def bmm(self, b1: "Tensor", b2: "Tensor") -> "Tensor":
        return self._assign_result(torch.matmul(_as_t(b1), _as_t(b2)))

    def dot(self, other: "Tensor") -> float:
        return float(torch.dot(self._t().reshape(-1),
                               _as_t(other).reshape(-1)))

    # elementwise transcendental (in place)
    def pow(self, n: Number) -> "Tensor":
        self._t().pow_(n)
        return self

    def log(self) -> "Tensor":
        self._t().log_()
        return self

    def exp(self) -> "Tensor":
        self._t().exp_()
        return self

    def sqrt(self) -> "Tensor":
        self._t().sqrt_()
        return self

    def log1p(self) -> "Tensor":
        self._t().log1p_()
        return self

    def abs(self) -> "Tensor":
        self._t().abs_()
        return self

    # reductions
    def sum(self, dim: Optional[int] = None):
        if dim is None:
            return float(self._t().sum())
        return self._wrap(self._t().sum(dim=dim - 1, keepdim=True))

    def mean(self, dim: Optional[int] = None):
        if dim is None:
            return float(self._t().mean())
        return self._wrap(self._t().mean(dim=dim - 1, keepdim=True))

    def max(self, dim: Optional[int] = None):
        if dim is None:
            return float(self._t().max())
        a = self._t()
        vals = a.amax(dim=dim - 1, keepdim=True)
        idx = torch.argmax(a, dim=dim - 1, keepdim=True) + 1  # 1-based
        return self._wrap(vals), Tensor(idx.to(torch.float32))

    def min(self, dim: Optional[int] = None):
        if dim is None:
            return float(self._t().min())
        a = self._t()
        vals = a.amin(dim=dim - 1, keepdim=True)
        idx = torch.argmin(a, dim=dim - 1, keepdim=True) + 1
        return self._wrap(vals), Tensor(idx.to(torch.float32))

    def topk(self, k: int, dim: Optional[int] = None, increase: bool = True):
        """(values, 1-based indices) of the k smallest (increase) or
        largest; ties keep the reference's order (a stable ascending
        sort, reversed for the largest)."""
        a = self._t()
        d = (dim if dim is not None else self.dim()) - 1
        order = torch.argsort(a, dim=d, stable=True)
        if not increase:
            order = torch.flip(order, dims=(d,))
        idx = torch.narrow(order, d, 0, k)
        vals = torch.gather(a, d, idx)
        return self._wrap(vals), Tensor((idx + 1).to(torch.float32))

    def norm(self, p: Number = 2) -> float:
        a = self._t().reshape(-1)
        if p == 1:
            return float(a.abs().sum())
        return float(torch.pow(torch.pow(a.abs(), p).sum(), 1.0 / p))

    def dist(self, other: "Tensor", p: Number = 2) -> float:
        return (self - other).norm(p)

    def uniform(self, a: float = 0.0, b: float = 1.0) -> float:
        return RNG.uniform(a, b)

    # comparison masks (out-of-place, 0/1 tensors like the reference)
    def gt(self, other) -> "Tensor":
        return self._wrap(self._t() > _as_t(other))

    def lt(self, other) -> "Tensor":
        return self._wrap(self._t() < _as_t(other))

    def le(self, other) -> "Tensor":
        return self._wrap(self._t() <= _as_t(other))

    def ge(self, other) -> "Tensor":
        return self._wrap(self._t() >= _as_t(other))

    def eq(self, other) -> "Tensor":
        return self._wrap(self._t() == _as_t(other))

    def masked_fill(self, mask: "Tensor", v: Number) -> "Tensor":
        self._t()[_as_t(mask).bool()] = v
        return self

    maskedFill = masked_fill

    def masked_copy(self, mask: "Tensor", src: "Tensor") -> "Tensor":
        m = _as_t(mask).bool()
        self._t()[m] = _as_t(src).reshape(-1)[: int(m.sum())].to(self.dtype)
        return self

    maskedCopy = masked_copy

    def masked_select(self, mask: "Tensor") -> "Tensor":
        return self._wrap(self._t()[_as_t(mask).bool()])

    maskedSelect = masked_select

    # scatter / gather (1-based index tensors, ref TensorMath.scala)
    def gather(self, dim: int, index: "Tensor") -> "Tensor":
        idx = (_as_t(index) - 1).to(torch.int64)
        return self._wrap(torch.gather(self._t(), dim - 1, idx))

    def scatter(self, dim: int, index: "Tensor", src: "Tensor") -> "Tensor":
        idx = (_as_t(index) - 1).to(torch.int64)
        src_t = torch.broadcast_to(torch.as_tensor(_as_t(src)),
                                   idx.shape).to(self.dtype)
        self._t().scatter_(dim - 1, idx, src_t)
        return self

    def index_select(self, dim: int, indices: "Tensor") -> "Tensor":
        idx = _as_t(indices).to(torch.int64).reshape(-1) - 1
        return self._wrap(torch.index_select(self._t(), dim - 1, idx))

    # conv2 / xcorr2 (ref DenseTensorConv.scala — 'valid' mode)
    def conv2(self, kernel: "Tensor") -> "Tensor":
        return self._wrap(_corr2(self._t(), torch.flip(_as_t(kernel),
                                                       dims=(0, 1))))

    def xcorr2(self, kernel: "Tensor") -> "Tensor":
        return self._wrap(_corr2(self._t(), _as_t(kernel)))

    # ---------------------------------------------------------------- #
    # interop                                                          #
    # ---------------------------------------------------------------- #
    def numpy(self) -> np.ndarray:
        return np.array(self._t().numpy())

    def to_torch(self, device=None) -> torch.Tensor:
        """A contiguous copy on ``device`` (the card unless it names the
        CPU)."""
        from bigdl_tpu_torch.device import resolve_device
        return self._t().contiguous().to(resolve_device(device), copy=True)

    @staticmethod
    def from_torch(t: torch.Tensor) -> "Tensor":
        """A host copy of a (device) tensor."""
        return Tensor(t)

    def clone(self) -> "Tensor":
        return Tensor(self._t().clone())

    def __eq__(self, other) -> bool:
        if not isinstance(other, Tensor):
            return NotImplemented
        return self._sizes == other._sizes and torch.equal(self._t(),
                                                           other._t())

    def __hash__(self):
        return id(self)

    def almost_equal(self, other: "Tensor", tol: float = 1e-6) -> bool:
        return self._sizes == other._sizes and torch.allclose(
            self._t(), other._t().to(self.dtype), atol=tol, rtol=0)

    def __repr__(self) -> str:
        return f"Tensor(size={self._sizes})\n{self._t()!r}"

    # ---------------------------------------------------------------- #
    # factories (ref Tensor object, Tensor.scala:610-897)              #
    # ---------------------------------------------------------------- #
    @staticmethod
    def ones(*sizes, dtype=np.float32) -> "Tensor":
        return Tensor(torch.ones(_unpack_sizes(sizes),
                                 dtype=_torch_dtype(dtype)))

    @staticmethod
    def zeros(*sizes, dtype=np.float32) -> "Tensor":
        return Tensor(torch.zeros(_unpack_sizes(sizes),
                                  dtype=_torch_dtype(dtype)))

    @staticmethod
    def arange(xmin: Number, xmax: Number, step: Number = 1) -> "Tensor":
        """Inclusive range like Torch's torch.range."""
        # epsilon guards float quotients that land just below an integer
        # (e.g. 0.3/0.1 -> 2.9999...), which would drop the endpoint
        n = int(np.floor((xmax - xmin) / step + 1e-7)) + 1
        return Tensor((xmin + step * np.arange(n)).astype(np.float32))

    range = arange

    @staticmethod
    def randperm(n: int) -> "Tensor":
        """1-based random permutation drawn from the shared Torch RNG."""
        return Tensor(RNG.current().randperm(n).astype(np.float32))

    @staticmethod
    def gaussian1D(size: int = 3, sigma: float = 0.25,
                   amplitude: float = 1.0, normalize: bool = False,
                   mean: float = 0.5, tensor=None) -> "Tensor":
        """1-D gaussian kernel (ref Tensor.scala:827-897)."""
        center = mean * size + 0.5
        x = np.arange(1, size + 1, dtype=np.float64)
        g = amplitude * np.exp(-(((x - center) / (sigma * size)) ** 2) / 2)
        if normalize:
            g = g / g.sum()
        out = Tensor(g.astype(np.float32))
        if tensor is not None:
            tensor.resize(size)
            tensor._t().copy_(out._t())
            return tensor
        return out


_INT_DTYPES = (torch.int8, torch.uint8, torch.int16, torch.int32,
               torch.int64)


def _contiguous_strides(sizes) -> tuple:
    strides, acc = [], 1
    for s in reversed(sizes):
        strides.append(acc)
        acc *= s
    return tuple(reversed(strides))


def _unpack_sizes(sizes):
    if len(sizes) == 1 and isinstance(sizes[0], (list, tuple)):
        return tuple(int(s) for s in sizes[0])
    return tuple(int(s) for s in sizes)


def _infer_size(sizes, numel):
    sizes = list(sizes)
    if -1 in sizes:
        i = sizes.index(-1)
        rest = int(np.prod([s for s in sizes if s != -1])) or 1
        sizes[i] = numel // rest
    return tuple(sizes)


def _parse_blas_args(args):
    """[beta,] [alpha,] t1, t2 → (beta, alpha, t1, t2)."""
    nums = [a for a in args if isinstance(a, (int, float))]
    tensors = [a for a in args
               if isinstance(a, (Tensor, np.ndarray, torch.Tensor))]
    assert len(tensors) == 2, "expected two tensor operands"
    if len(nums) == 0:
        return 1.0, 1.0, tensors[0], tensors[1]
    if len(nums) == 1:
        return 1.0, nums[0], tensors[0], tensors[1]
    return nums[0], nums[1], tensors[0], tensors[1]


def _corr2(a: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """2-D 'valid' cross-correlation (ref DenseTensorConv.scala:262)."""
    kh, kw = k.shape
    win = a.unfold(0, kh, 1).unfold(1, kw, 1)   # (oh, ow, kh, kw)
    return torch.einsum("ijkl,kl->ij", win, k.to(a.dtype))
