"""Parameter trees between numpy and torch.

The port keeps the JAX package's parameter layout: the same nested dict
keys, ``blocks`` stacked on a leading layer axis, weights ``(in, out)``.
A reference tree therefore crosses over leaf by leaf with no remapping,
quantized trees included: a reference ``QTensor`` leaf (any object with
its ``q``/``scale``/``orig_dtype``/``native``/``compute``/``act_scale``
fields) becomes the port's :class:`~bigdl_tpu_torch.quant.QTensor`.  A
QTensor is a leaf of ``tree_map`` and ``tree_leaves`` (re-exported from
:mod:`bigdl_tpu_torch.utils.pytree`, the port's one tree walker), and
:func:`layer_params` slices it per layer.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from bigdl_tpu_torch.utils.pytree import tree_leaves, tree_map  # noqa: F401


def _leaf_to_torch(x, device, dtype):
    a = np.asarray(x)
    if a.dtype.name == "bfloat16":
        # numpy has no bfloat16 of its own (ml_dtypes provides it);
        # float32 holds every bfloat16 value exactly
        t = torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16)
    else:
        t = torch.from_numpy(np.array(a))  # a writable copy
    if dtype is not None and t.is_floating_point():
        t = t.to(dtype)
    return t.to(device)


_QFIELDS = ("q", "scale", "orig_dtype", "native", "compute", "act_scale")


def _is_quantized(x) -> bool:
    return all(hasattr(x, f) for f in _QFIELDS)


def params_from_numpy(tree, device, dtype: Optional[torch.dtype] = None):
    """Nested dicts of numpy arrays -> the same dicts of torch tensors on
    ``device``; ``dtype`` recasts the floating leaves (a quantized
    leaf's int8 values and float32 scales stay as they are)."""
    if isinstance(tree, dict):
        return {k: params_from_numpy(v, device, dtype) for k, v in tree.items()}
    if _is_quantized(tree):
        from bigdl_tpu_torch.quant.qtensor import QTensor
        return QTensor(_leaf_to_torch(tree.q, device, None),
                       _leaf_to_torch(tree.scale, device, None),
                       tree.orig_dtype, tree.native, tree.compute,
                       tree.act_scale)
    return _leaf_to_torch(tree, device, dtype)


def _leaf_to_numpy(t):
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        t = t.float()
    return t.numpy()


def params_to_numpy(tree):
    """Inverse of :func:`params_from_numpy`: tensors -> numpy arrays on
    the host (bfloat16 leaves come back as float32; a QTensor comes back
    as a QTensor of numpy arrays)."""
    if isinstance(tree, dict):
        return {k: params_to_numpy(v) for k, v in tree.items()}
    if _is_quantized(tree):
        from bigdl_tpu_torch.quant.qtensor import QTensor
        return QTensor(_leaf_to_numpy(tree.q), _leaf_to_numpy(tree.scale),
                       tree.orig_dtype, tree.native, tree.compute,
                       tree.act_scale)
    return _leaf_to_numpy(tree)


def layer_params(blocks: dict, layer: int) -> dict:
    """One layer's slice of the stacked ``blocks`` tree (views, no
    copies; a QTensor slices its values and scales)."""
    return {k: (layer_params(v, layer) if isinstance(v, dict) else v[layer])
            for k, v in blocks.items()}
