"""Mixture-of-experts blocks (port of ``bigdl_tpu/parallel/expert.py``'s
single-device half: ``init_moe_params`` and ``switch_mlp``)."""
from bigdl_tpu_torch.parallel.expert import init_moe_params, switch_mlp

__all__ = ["init_moe_params", "switch_mlp"]
