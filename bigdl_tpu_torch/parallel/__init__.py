"""parallel: the distributed engine (port of ``bigdl_tpu/parallel``;
ref parameters/ and optim/DistriOptimizer.scala).

The reference's transport is a hand-rolled FP16 all-reduce over Spark's
BlockManager (reduce-scatter, the slice owner's update, all-gather,
parameters/AllReduceParameter.scala:99-228).  Here the same cycle runs
over ``torch.distributed``, one rank per device: a bf16
``reduce_scatter_tensor`` of the gradients, the ZeRO-1 update of each
rank's float32 slice, a bf16 ``all_gather_into_tensor`` of the weights.
The mixture-of-experts blocks (``init_moe_params``, ``switch_mlp``) run
on one device; the tensor-, pipeline- and sequence-parallel pieces are
not ported yet.
"""
from bigdl_tpu_torch.parallel.distri_optimizer import (DistriOptimizer,
                                                       DistriValidator)
from bigdl_tpu_torch.parallel.expert import init_moe_params, switch_mlp
from bigdl_tpu_torch.parallel.mesh import (DATA_AXIS, EXPERT_AXIS,
                                           MODEL_AXIS, PIPELINE_AXIS,
                                           SEQUENCE_AXIS, create_mesh,
                                           data_parallel_mesh, init_world,
                                           shutdown_world)
from bigdl_tpu_torch.parallel.parameters import (AllReduceParameter,
                                                 CompressedTensor)

__all__ = ["AllReduceParameter", "CompressedTensor", "DATA_AXIS",
           "DistriOptimizer", "DistriValidator", "EXPERT_AXIS", "MODEL_AXIS",
           "PIPELINE_AXIS", "SEQUENCE_AXIS", "create_mesh",
           "data_parallel_mesh", "init_moe_params", "init_world",
           "shutdown_world", "switch_mlp"]
