"""Sharded parameter machinery: the AllReduceParameter equivalent (port
of ``bigdl_tpu/parallel/parameters.py``; ref
parameters/AllReduceParameter.scala:53-228 and the Parameter.scala FP16
codec).

The reference slices the global flattened parameter vector into
``partitionNum`` contiguous slices; slice p is owned by partition p,
which keeps the float32 master copy, receives everyone's half-precision
gradient chunk for p (reduce), applies the optimizer to its slice only
(ZeRO-1) and republishes a half-precision weight copy (all-gather).
Here a partition is a rank of the data axis and the transport is a
``torch.distributed`` collective in bfloat16:

  ``gather_weights``     bf16 ``all_gather_into_tensor`` of this rank's
                         float32 master slice, widened back to float32;
  ``scatter_gradients``  bf16 ``reduce_scatter_tensor`` of the padded
                         flat gradient, widened, then the mean.

The flat vector is the reference's ``ravel_pytree`` order (leaves in
sorted-key order, each row-major) padded with zeros to a multiple of
the partition count.  Every collective the cycle issues is noted in a
:class:`CollectiveRecord` (op, dtype, element count of its result), the
port's counterpart of reading them out of the compiled HLO
(``utils.profiling.collective_footprint``).
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

from bigdl_tpu_torch.utils import pytree

# the collectives' current names, falling back to the older spellings
# (same arguments) on a torch that lacks them
_all_gather_single = getattr(dist, "all_gather_single", None) \
    or dist.all_gather_into_tensor
_reduce_scatter_single = getattr(dist, "reduce_scatter_single", None) \
    or dist.reduce_scatter_tensor


def all_gather_flat(out: torch.Tensor, inp: torch.Tensor, group=None):
    _all_gather_single(out, inp, group=group)
    return out


def reduce_scatter_flat(out: torch.Tensor, inp: torch.Tensor, group=None):
    _reduce_scatter_single(out, inp, op=dist.ReduceOp.SUM, group=group)
    return out


class CollectiveRecord:
    """The collectives one step issued: ``(op, dtype, numel)`` of each
    result, op in the reference's HLO names (``all-gather``,
    ``reduce-scatter``, ``all-reduce``, …)."""

    def __init__(self):
        self.ops: list = []
        self.enabled = True

    def add(self, op: str, t: torch.Tensor) -> None:
        if self.enabled:
            self.ops.append((op, t.dtype, int(t.numel())))

    def clear(self) -> None:
        self.ops = []


class CompressedTensor:
    """Half-precision codec for host-side transport/storage parity
    (ref parameters/Parameter.scala:25-46 CompressedTensor).  Values go
    through float32 first, as the reference's ``jnp.asarray`` does."""

    def __init__(self, values, dtype: str = "bf16"):
        if dtype == "bf16":
            tdt = torch.bfloat16
        elif dtype == "fp16":
            tdt = torch.float16
        else:
            raise ValueError(f"unsupported compression {dtype!r} (bf16|fp16)")
        self._compressed = torch.as_tensor(np.asarray(values)).float().to(tdt)
        self.dtype = dtype

    def decompress(self) -> torch.Tensor:
        return self._compressed.float()

    def add(self, other: "CompressedTensor") -> "CompressedTensor":
        """Pairwise add in compressed space (ref
        FP16CompressedTensor.parAdd)."""
        out = CompressedTensor.__new__(CompressedTensor)
        out._compressed = self._compressed + other._compressed
        out.dtype = self.dtype
        return out

    def bytes_size(self) -> int:
        return self._compressed.numel() * 2


class AllReduceParameter:
    """Flat-vector sharding bookkeeping for the ZeRO-1 cycle: pads the
    flattened parameters to a multiple of ``partition_num`` and runs the
    two transport collectives over ``group`` (default: the world)."""

    def __init__(self, params_pytree, partition_num: int,
                 transport_dtype=torch.bfloat16,
                 record: Optional[CollectiveRecord] = None):
        leaves, self._treedef = pytree.tree_flatten(params_pytree)
        self._shapes = [tuple(a.shape) for a in leaves]
        self.size = int(sum(int(np.prod(s, dtype=np.int64))
                            for s in self._shapes))
        self.partition_num = int(partition_num)
        self.transport_dtype = transport_dtype
        self.padded_size = -(-self.size // self.partition_num) \
            * self.partition_num
        self.slice_size = self.padded_size // self.partition_num
        self.record = record if record is not None else CollectiveRecord()

    # -- layout ------------------------------------------------------------ #
    def flatten(self, tree) -> torch.Tensor:
        """The float32 flat vector of ``tree`` (the reference's
        ``ravel_pytree`` order), padded with zeros to ``padded_size``."""
        leaves = pytree.tree_leaves(tree)
        flat = torch.cat([a.detach().reshape(-1).float() for a in leaves])
        pad = self.padded_size - self.size
        if pad:
            flat = torch.cat([flat, flat.new_zeros(pad)])
        return flat

    def unravel(self, flat: torch.Tensor):
        """A params tree of views into ``flat`` (length >= ``size``)."""
        out, i = [], 0
        for s in self._shapes:
            n = int(np.prod(s, dtype=np.int64))
            out.append(flat[i:i + n].reshape(s))
            i += n
        return pytree.tree_unflatten(self._treedef, out)

    def init_shards(self, params_pytree) -> torch.Tensor:
        """Full params -> (partition_num, slice_size) float32 master
        shards (ref init(parameter): each partition stores its slice)."""
        return self.flatten(params_pytree).reshape(self.partition_num,
                                                   self.slice_size)

    def to_pytree(self, shards):
        """(partition_num, slice_size) -> params tree (the reference's
        getModel, ref DistriOptimizer.scala:534-564)."""
        return self.unravel(torch.as_tensor(shards).reshape(-1)[: self.size])

    # -- the transport cycle ------------------------------------------------ #
    def gather_weights(self, my_shard: torch.Tensor, group=None):
        """bf16 all-gather of the weight slices -> the full float32 flat
        vector, ``size`` long (ref getWeights :134-159)."""
        compressed = my_shard.to(self.transport_dtype)
        out = torch.empty(self.padded_size, dtype=self.transport_dtype,
                          device=my_shard.device)
        all_gather_flat(out, compressed, group)
        self.record.add("all-gather", out)
        return out.float()[: self.size]

    def scatter_gradients(self, grad_pytree, group=None, mean: bool = True):
        """Flatten the gradients, bf16 reduce-scatter -> this rank's
        float32 gradient slice (ref putGradients +
        aggregrateGradientPartition :161-215), divided by the partition
        count when ``mean``."""
        padded = self.flatten(grad_pytree).to(self.transport_dtype)
        out = torch.empty(self.slice_size, dtype=self.transport_dtype,
                          device=padded.device)
        reduce_scatter_flat(out, padded, group)
        self.record.add("reduce-scatter", out)
        g = out.float()
        if mean:
            g = g / torch.full_like(g, float(self.partition_num))
        return g
