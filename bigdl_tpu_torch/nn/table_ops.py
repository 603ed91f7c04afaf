"""Elementwise table-combining layers and reductions over one tensor
(port of ``bigdl_tpu/nn/table_ops.py``: CAddTable, CSubTable, CMulTable,
CDivTable, CMaxTable, CMinTable, Sum, Mean, Max, Min)."""
from __future__ import annotations

import torch

from bigdl_tpu_torch.nn._util import to_axis
from bigdl_tpu_torch.nn.module import Module
from bigdl_tpu_torch.utils.table import Table


def _seq(x):
    return x.to_seq() if isinstance(x, Table) else list(x)


def _fold(x, op):
    xs = _seq(x)
    out = xs[0]
    for t in xs[1:]:
        out = op(out, t)
    return out


class CAddTable(Module):
    def __init__(self, inplace: bool = False):
        super().__init__()

    def f(self, params, x, **kw):
        return _fold(x, torch.add)


class CSubTable(Module):
    def f(self, params, x, **kw):
        a, b = _seq(x)
        return a - b


class CMulTable(Module):
    def f(self, params, x, **kw):
        return _fold(x, torch.mul)


class CDivTable(Module):
    def f(self, params, x, **kw):
        a, b = _seq(x)
        return a / b


class CMaxTable(Module):
    def f(self, params, x, **kw):
        return _fold(x, torch.maximum)


class CMinTable(Module):
    def f(self, params, x, **kw):
        return _fold(x, torch.minimum)


def _axis(dim, x, n_input_dims):
    return to_axis(dim, x.ndim, n_input_dims if n_input_dims > 0 else None)


class Sum(Module):
    """Sum over a 1-based dim; ``size_average`` divides by its size;
    ``squeeze`` drops it (ref nn/Sum.scala)."""

    def __init__(self, dimension: int = 1, n_input_dims: int = -1,
                 size_average: bool = False, squeeze: bool = True):
        super().__init__()
        self.dimension = dimension
        self.n_input_dims = n_input_dims
        self.size_average = size_average
        self.squeeze = squeeze

    def f(self, params, x, **kw):
        axis = _axis(self.dimension, x, self.n_input_dims)
        y = torch.sum(x, dim=axis, keepdim=not self.squeeze)
        if self.size_average:
            y = y / x.shape[axis]
        return y


class Mean(Module):
    def __init__(self, dimension: int = 1, n_input_dims: int = -1,
                 squeeze: bool = True):
        super().__init__()
        self.dimension = dimension
        self.n_input_dims = n_input_dims
        self.squeeze = squeeze

    def f(self, params, x, **kw):
        axis = _axis(self.dimension, x, self.n_input_dims)
        return torch.mean(x, dim=axis, keepdim=not self.squeeze)


class Max(Module):
    """Max values over a 1-based dim (ref nn/Max.scala)."""

    def __init__(self, dim: int = 1, num_input_dims: int = -1):
        super().__init__()
        self.dim = dim
        self.num_input_dims = num_input_dims

    def f(self, params, x, **kw):
        return torch.amax(x, dim=_axis(self.dim, x, self.num_input_dims))


class Min(Module):
    def __init__(self, dim: int = 1, num_input_dims: int = -1):
        super().__init__()
        self.dim = dim
        self.num_input_dims = num_input_dims

    def f(self, params, x, **kw):
        return torch.amin(x, dim=_axis(self.dim, x, self.num_input_dims))
