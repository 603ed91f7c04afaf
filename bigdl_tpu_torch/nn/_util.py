"""Shared helpers for the nn layer zoo (port of ``bigdl_tpu/nn/_util.py``)."""
from __future__ import annotations

from typing import Optional

import torch

from bigdl_tpu_torch.utils import keychain
from bigdl_tpu_torch.utils.pytree import tree_map


def to_axis(dim: int, ndim: int, n_input_dims: Optional[int] = None) -> int:
    """Convert a 1-based Torch/BigDL dimension to a 0-based axis.

    ``n_input_dims`` reproduces the reference's nInputDims convention: when
    the actual rank exceeds it, leading dims are batch dims and the 1-based
    ``dim`` counts from after them (e.g. JoinTable, SplitTable).
    Negative dims count from the end (Torch allows -1 = last).
    """
    if dim < 0:
        return ndim + dim
    axis = dim - 1
    if n_input_dims is not None and ndim > n_input_dims:
        axis += ndim - n_input_dims
    return axis


def fold_rng(rng, i: int):
    """Child ``i``'s key: ``jax.random.fold_in`` through the key chain
    (None stays None)."""
    return None if rng is None else keychain.fold_in(rng, i)


def cast_f32_leaves(tree, dtype):
    """The mixed-precision param cast: float32 leaves to the compute
    dtype, everything else untouched."""
    return tree_map(lambda a: a.to(dtype) if a.dtype == torch.float32
                    else a, tree)


def match_compute_dtype(x, w):
    """Cast a float input to a float weight's dtype when they differ, so
    the product runs in the weight's type (a QTensor weight aligns in
    its own product)."""
    wdt = getattr(w, "dtype", None)
    if (isinstance(wdt, torch.dtype) and x.is_floating_point()
            and wdt.is_floating_point and x.dtype != wdt):
        return x.to(wdt)
    return x


def same_pad(size: int, kernel: int, stride: int) -> tuple[int, int]:
    """SAME-style padding pair for one spatial dim."""
    out = -(-size // stride)
    total = max(0, (out - 1) * stride + kernel - size)
    return total // 2, total - total // 2


def one_based_index(idx: int, length: int) -> int:
    """1-based index with negative-from-end semantics (ref SelectTable)."""
    return idx - 1 if idx > 0 else length + idx
