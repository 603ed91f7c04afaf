"""bigdl_tpu_torch: the PyTorch/CUDA port of ``bigdl_tpu``.

The JAX package ``bigdl_tpu`` stays the reference; this package serves
the same ``TransformerLM`` on an NVIDIA H100 through hand-written CUDA
kernels (``bigdl_tpu_torch.ops``).  It imports ``torch`` and never
``jax`` or ``bigdl_tpu``; parameter trees keep the JAX package's keys
and layouts, so a reference tree converts with
:func:`bigdl_tpu_torch.utils.params.params_from_numpy` and no remapping.

Entry points take ``device=`` and default to ``"cuda"``; without a card
they raise unless the caller asks for ``device="cpu"``
(:func:`bigdl_tpu_torch.device.resolve_device`).
"""
from bigdl_tpu_torch.device import resolve_device
from bigdl_tpu_torch.utils.engine import Engine
from bigdl_tpu_torch.utils.table import T, Table

__all__ = ["Engine", "T", "Table", "resolve_device"]
