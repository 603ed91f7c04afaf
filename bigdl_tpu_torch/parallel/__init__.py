"""parallel: the distributed engine and the model-parallel strategies
(port of ``bigdl_tpu/parallel``; ref parameters/ and
optim/DistriOptimizer.scala).

The reference's transport is a hand-rolled FP16 all-reduce over Spark's
BlockManager (reduce-scatter, the slice owner's update, all-gather,
parameters/AllReduceParameter.scala:99-228).  Here the same cycle runs
over ``torch.distributed``, one rank per device: a bf16
``reduce_scatter_tensor`` of the gradients, the ZeRO-1 update of each
rank's float32 slice, a bf16 ``all_gather_into_tensor`` of the weights.
The strategies the reference adds on its mesh run over the same world:
sequence parallelism (ring attention and Ulysses, ``sequence``), tensor
parallelism (DTensor placements, ``tensor_parallel``), pipeline
parallelism (GPipe, ``pipeline``) and expert parallelism (``expert``).
"""
from bigdl_tpu_torch.parallel.distri_optimizer import (DistriOptimizer,
                                                       DistriValidator)
from bigdl_tpu_torch.parallel.expert import (init_moe_params, moe_apply,
                                             moe_apply_local, switch_mlp)
from bigdl_tpu_torch.parallel.mesh import (DATA_AXIS, EXPERT_AXIS,
                                           MODEL_AXIS, PIPELINE_AXIS,
                                           SEQUENCE_AXIS, MeshAxis,
                                           NamedSharding, create_mesh,
                                           data_parallel_mesh, init_world,
                                           ring_permute, shutdown_world)
from bigdl_tpu_torch.parallel.parameters import (AllReduceParameter,
                                                 CompressedTensor)
from bigdl_tpu_torch.parallel.pipeline import (pipeline_apply,
                                               pipeline_apply_hetero,
                                               pipeline_apply_local,
                                               split_sequential)
from bigdl_tpu_torch.parallel.sequence import (
    ring_attention, ring_attention_local, sequence_parallel_self_attention,
    ulysses_attention, ulysses_attention_local)
from bigdl_tpu_torch.parallel.tensor_parallel import (
    column_parallel_spec, constrain_batch, mha_tp_rules, mlp_tp_rules,
    pin_xla_attention, row_parallel_spec, shard_params,
    transformer_lm_tp_rules)

__all__ = ["AllReduceParameter", "CompressedTensor", "DATA_AXIS",
           "DistriOptimizer", "DistriValidator", "EXPERT_AXIS", "MODEL_AXIS",
           "MeshAxis", "NamedSharding", "PIPELINE_AXIS", "SEQUENCE_AXIS",
           "column_parallel_spec", "constrain_batch", "create_mesh",
           "data_parallel_mesh", "init_moe_params", "init_world",
           "mha_tp_rules", "mlp_tp_rules", "moe_apply", "moe_apply_local",
           "pin_xla_attention", "pipeline_apply", "pipeline_apply_hetero",
           "pipeline_apply_local", "ring_attention", "ring_attention_local",
           "ring_permute", "row_parallel_spec",
           "sequence_parallel_self_attention", "shard_params",
           "shutdown_world", "split_sequential", "switch_mlp",
           "transformer_lm_tp_rules", "ulysses_attention",
           "ulysses_attention_local"]
