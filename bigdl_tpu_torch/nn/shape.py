"""Shape-manipulation layers (port of ``bigdl_tpu/nn/shape.py``: Identity,
Echo, Contiguous, Copy, Reshape, InferReshape, View, Squeeze, Unsqueeze,
Transpose, Replicate, Padding, SpatialZeroPadding, Narrow, Select, Index,
MaskedSelect, Reverse).

All dims are 1-based as in Torch/BigDL.  Most are views of the input
(``reshape``, ``transpose``, ``narrow``, ``select``); ``Copy`` and
``Contiguous`` copy.
"""
from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.nn.functional as F

from bigdl_tpu_torch.nn._util import to_axis
from bigdl_tpu_torch.nn.module import Module
from bigdl_tpu_torch.utils.table import Table


def _pair(x):
    return x.to_seq() if isinstance(x, Table) else list(x)


class Identity(Module):
    def f(self, params, x, **kw):
        return x


class Echo(Module):
    """Identity that prints its input's shape (ref nn/Echo.scala)."""

    def f(self, params, x, **kw):
        print(f"Echo: shape {tuple(x.shape) if hasattr(x, 'shape') else None}")
        return x


class Contiguous(Module):
    """The input in packed row-major memory (ref nn/Contiguous.scala)."""

    def f(self, params, x, **kw):
        return x.contiguous()


class Copy(Module):
    def f(self, params, x, **kw):
        return x.clone()


class Reshape(Module):
    """Reshape non-batch dims to ``size``; ``batch_mode`` None detects a
    leading batch dim as Torch does (ref nn/Reshape.scala)."""

    def __init__(self, size: Sequence[int], batch_mode: Optional[bool] = None):
        super().__init__()
        self.size = tuple(size)
        self.batch_mode = batch_mode
        self._n = 1
        for s in self.size:
            self._n *= s

    def f(self, params, x, **kw):
        # an explicit batch_mode wins; with None the input is unbatched
        # only when the element counts match and its first dim is not a
        # singleton batch dim
        if self.batch_mode is False or (
                self.batch_mode is None and x.numel() == self._n
                and x.shape[0] != 1):
            return x.reshape(self.size)
        return x.reshape((x.shape[0],) + self.size)


class InferReshape(Module):
    """Reshape with -1 (infer) and 0 (copy the input dim) entries
    (ref nn/InferReshape.scala)."""

    def __init__(self, size: Sequence[int], batch_mode: bool = False):
        super().__init__()
        self.size = tuple(size)
        self.batch_mode = batch_mode

    def f(self, params, x, **kw):
        in_shape = x.shape[1:] if self.batch_mode else x.shape
        out = tuple(in_shape[i] if s == 0 else s
                    for i, s in enumerate(self.size))
        if self.batch_mode:
            return x.reshape((x.shape[0],) + out)
        return x.reshape(out)


class View(Module):
    """View with fixed sizes; -1 allowed (ref nn/View.scala)."""

    def __init__(self, *sizes: int):
        super().__init__()
        if len(sizes) == 1 and isinstance(sizes[0], (tuple, list)):
            sizes = tuple(sizes[0])
        self.sizes = tuple(sizes)
        self.num_input_dims = 0

    def set_num_input_dims(self, n: int) -> "View":
        self.num_input_dims = n
        return self

    def f(self, params, x, **kw):
        n = 1
        for s in self.sizes:
            n *= s
        if n > 0 and (x.numel() != n or x.shape[0] == 1):
            return x.reshape((x.shape[0],) + self.sizes)  # leading batch dim
        return x.reshape(self.sizes)


class Squeeze(Module):
    def __init__(self, dim: Optional[int] = None, num_input_dims: int = -1):
        super().__init__()
        self.dim = dim
        self.num_input_dims = num_input_dims

    def f(self, params, x, **kw):
        if self.dim is None:
            return torch.squeeze(x)
        nid = self.num_input_dims if self.num_input_dims > 0 else None
        axis = to_axis(self.dim, x.ndim, nid)
        return torch.squeeze(x, dim=axis) if x.shape[axis] == 1 else x


class Unsqueeze(Module):
    def __init__(self, pos: int, num_input_dims: int = -1):
        super().__init__()
        self.pos = pos
        self.num_input_dims = num_input_dims

    def f(self, params, x, **kw):
        nid = self.num_input_dims if self.num_input_dims > 0 else None
        axis = to_axis(self.pos, x.ndim + 1, (nid + 1) if nid else None)
        return torch.unsqueeze(x, axis)


class Transpose(Module):
    """A sequence of pairwise 1-based dim swaps (ref nn/Transpose.scala)."""

    def __init__(self, permutations: Sequence[tuple[int, int]]):
        super().__init__()
        self.permutations = [tuple(p) for p in permutations]

    def f(self, params, x, **kw):
        for d1, d2 in self.permutations:
            x = torch.transpose(x, to_axis(d1, x.ndim), to_axis(d2, x.ndim))
        return x


class Replicate(Module):
    """Insert a new dim of size ``n_features`` at 1-based position
    ``dim`` (ref nn/Replicate.scala)."""

    def __init__(self, n_features: int, dim: int = 1, n_dim: int = -1):
        super().__init__()
        self.n_features = n_features
        self.dim = dim
        self.n_dim = n_dim

    def f(self, params, x, **kw):
        nid = self.n_dim if self.n_dim > 0 else None
        axis = to_axis(self.dim, x.ndim + 1, (nid + 1) if nid else None)
        return torch.repeat_interleave(torch.unsqueeze(x, axis),
                                       self.n_features, dim=axis)


class Padding(Module):
    """Pad ``pad`` slots (before the data if negative) along a 1-based
    dim with ``value`` (ref nn/Padding.scala)."""

    def __init__(self, dim: int, pad: int, n_input_dim: int = -1,
                 value: float = 0.0, n_index: int = 1):
        super().__init__()
        self.dim = dim
        self.pad = pad
        self.n_input_dim = n_input_dim
        self.value = value
        self.n_index = n_index

    def f(self, params, x, **kw):
        nid = self.n_input_dim if self.n_input_dim > 0 else None
        axis = to_axis(self.dim, x.ndim, nid)
        # F.pad takes (before, after) pairs from the last axis backwards
        widths = [0, 0] * (x.ndim - 1 - axis) + (
            [-self.pad, 0] if self.pad < 0 else [0, self.pad])
        return F.pad(x, widths, value=self.value)


class SpatialZeroPadding(Module):
    def __init__(self, pad_left: int, pad_right: int = None,
                 pad_top: int = None, pad_bottom: int = None):
        super().__init__()
        self.pad_left = pad_left
        self.pad_right = pad_right if pad_right is not None else pad_left
        self.pad_top = pad_top if pad_top is not None else pad_left
        self.pad_bottom = pad_bottom if pad_bottom is not None else pad_left

    def f(self, params, x, **kw):
        return F.pad(x, (self.pad_left, self.pad_right, self.pad_top,
                         self.pad_bottom))


class Narrow(Module):
    """Slice [offset, offset+length) along a 1-based dim; a negative
    offset counts from the end (ref nn/Narrow.scala)."""

    def __init__(self, dimension: int, offset: int, length: int = 1):
        super().__init__()
        self.dimension = dimension
        self.offset = offset
        self.length = length

    def f(self, params, x, **kw):
        axis = to_axis(self.dimension, x.ndim)
        size = x.shape[axis]
        start = self.offset - 1 if self.offset > 0 else size + self.offset
        length = (self.length if self.length > 0
                  else size - start + self.length + 1)
        return torch.narrow(x, axis, start, length)


class Select(Module):
    """Select one 1-based index along a 1-based dim, dropping that dim
    (ref nn/Select.scala)."""

    def __init__(self, dimension: int, index: int):
        super().__init__()
        self.dimension = dimension
        self.index = index

    def f(self, params, x, **kw):
        axis = to_axis(self.dimension, x.ndim)
        idx = self.index - 1 if self.index > 0 else x.shape[axis] + self.index
        return torch.select(x, axis, idx)


class Index(Module):
    """Gather along a 1-based dim with a 1-based index tensor, from a
    table {tensor, indices} (ref nn/Index.scala)."""

    def __init__(self, dimension: int):
        super().__init__()
        self.dimension = dimension

    def f(self, params, x, **kw):
        t, idx = _pair(x)
        axis = to_axis(self.dimension, t.ndim)
        idx = torch.as_tensor(idx, device=t.device).to(torch.int64) - 1
        return torch.index_select(t, axis, idx.reshape(-1)).reshape(
            t.shape[:axis] + idx.shape + t.shape[axis + 1:])


class MaskedSelect(Module):
    """The elements where the mask is nonzero, flattened
    (ref nn/MaskedSelect.scala); the output length depends on the
    data."""

    def f(self, params, x, **kw):
        t, mask = _pair(x)
        mask = torch.as_tensor(mask, device=t.device)
        return t[mask != 0]


class Reverse(Module):
    def __init__(self, dimension: int = 1):
        super().__init__()
        self.dimension = dimension

    def f(self, params, x, **kw):
        return torch.flip(x, dims=(to_axis(self.dimension, x.ndim),))
