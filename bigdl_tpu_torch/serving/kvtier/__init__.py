"""bigdl_tpu_torch.serving.kvtier: tiered KV memory below the device
arena (port of ``bigdl_tpu/serving/kvtier``).

    from bigdl_tpu_torch.serving import LMServingEngine
    from bigdl_tpu_torch.serving.kvtier import HostBlockStore

    tier = HostBlockStore(host_bytes=256 << 20, spill_dir="/tmp/kv")
    eng = LMServingEngine(model, kvtier=tier)
    s = eng.submit(prompt)
    ...                       # read a few tokens
    eng.hibernate(s)          # slot and blocks freed; chain in the tier
    eng.resume(s)             # the stream continues bit-exactly
"""
from bigdl_tpu_torch.serving.kvtier.store import HostBlockStore, block_path

__all__ = ["HostBlockStore", "block_path"]
