"""The port's hand-written CUDA kernels, each beside its plain PyTorch
version and its launch counter (``FLASH_FWD.launches``,
``FLASH_BWD_DKV.launches``, ``FLASH_BWD_DQ.launches``,
``PAGED_DECODE.launches``)."""
from bigdl_tpu_torch.ops.flash_attention import (
    FLASH_BWD_DKV, FLASH_BWD_DQ, FLASH_FWD, flash_attention,
    flash_attention_backward_reference, flash_attention_reference,
    flash_attention_with_lse)
from bigdl_tpu_torch.ops.paged_attention import (
    PAGED_DECODE, paged_decode_attention, paged_decode_attention_reference)

KERNELS = (FLASH_FWD, FLASH_BWD_DKV, FLASH_BWD_DQ, PAGED_DECODE)

__all__ = ["FLASH_BWD_DKV", "FLASH_BWD_DQ", "FLASH_FWD", "KERNELS",
           "PAGED_DECODE", "flash_attention",
           "flash_attention_backward_reference", "flash_attention_reference",
           "flash_attention_with_lse", "paged_decode_attention",
           "paged_decode_attention_reference"]
