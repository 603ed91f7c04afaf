"""The port's hand-written CUDA kernels, each beside its plain PyTorch
version and its launch counter (``FLASH_FWD.launches``,
``FLASH_BWD_DKV.launches``, ``FLASH_BWD_DQ.launches``,
``PAGED_DECODE.launches``, ``F32_GEMM.launches`` with its split-K adds
in ``F32_GEMM_REDUCE.launches``), the forward's tiles (``FLASH_TILES``) and
the crossover dispatch that reads the autotune cache
(``resolve_attention_plan``, ``use_flash_auto``; ``ops.autotune``)."""
from bigdl_tpu_torch.ops.flash_attention import (
    FLASH_BWD_DKV, FLASH_BWD_DQ, FLASH_FWD, FLASH_TILES, AttentionPlan,
    flash_attention, flash_attention_backward_reference,
    flash_attention_reference, flash_attention_with_lse, flash_tiles,
    resolve_attention_plan, use_flash_auto)
from bigdl_tpu_torch.ops.f32_gemm import F32_GEMM, F32_GEMM_REDUCE, matmul_f32
from bigdl_tpu_torch.ops.paged_attention import (
    PAGED_DECODE, paged_decode_attention, paged_decode_attention_reference)

KERNELS = (FLASH_FWD, FLASH_BWD_DKV, FLASH_BWD_DQ, PAGED_DECODE, F32_GEMM,
           F32_GEMM_REDUCE)

__all__ = ["AttentionPlan", "F32_GEMM", "F32_GEMM_REDUCE", "FLASH_BWD_DKV",
           "FLASH_BWD_DQ", "FLASH_FWD", "FLASH_TILES", "KERNELS",
           "PAGED_DECODE", "flash_attention",
           "flash_attention_backward_reference", "flash_attention_reference",
           "flash_attention_with_lse", "flash_tiles", "matmul_f32",
           "paged_decode_attention", "paged_decode_attention_reference",
           "resolve_attention_plan", "use_flash_auto"]
