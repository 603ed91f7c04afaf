"""Composite modules (port of ``bigdl_tpu/nn/containers.py``; ref
nn/Container.scala and the structural zoo: Sequential, Concat,
ConcatTable, ParallelTable, MapTable, Bottle, FlattenTable, SplitTable,
JoinTable, MixtureTable, NarrowTable, SelectTable).

Parameters of a container are the dict ``{str(i): child_params}``; child
``i`` draws from ``fold_rng(rng, i)``, the reference's key, so a built
tree is the reference's.  ``checkpoint()`` recomputes each child's
activations in the backward pass (``torch.utils.checkpoint``, the
counterpart of ``jax.checkpoint``).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint as _recompute

from bigdl_tpu_torch.nn._util import fold_rng, one_based_index, to_axis
from bigdl_tpu_torch.nn.module import Buffers, Module, Params
from bigdl_tpu_torch.utils.table import T, Table


def _seq(x):
    return x.to_seq() if isinstance(x, Table) else list(x)


class Container(Module):
    """Base of composites: owns an ordered child list; parameters are the
    dict {index: child_params} (ref nn/Container.scala)."""

    def __init__(self, *modules: Module):
        super().__init__()
        self.modules: list[Module] = list(modules)
        self.remat: bool = False

    def add(self, module: Module) -> "Container":
        self.modules.append(module)
        return self

    def checkpoint(self, enable: bool = True) -> "Container":
        """Recompute each child's activations in the backward pass
        (``torch.utils.checkpoint`` per child): trades recompute for
        device memory."""
        self.remat = enable
        return self

    def __len__(self) -> int:
        return len(self.modules)

    def get(self, index: int) -> Module:
        """1-based child access."""
        return self.modules[index - 1]

    def init(self, rng) -> Params:
        return {str(i): m.init(fold_rng(rng, i))
                for i, m in enumerate(self.modules)}

    def init_buffers(self) -> Buffers:
        return {str(i): m.init_buffers() for i, m in enumerate(self.modules)}

    def _child_apply(self, i, params, x, buffers, training, rng):
        p = params.get(str(i), {}) if params else {}
        b_in = buffers.get(str(i), {}) if buffers else {}
        r = fold_rng(rng, i)
        child = self.modules[i]
        if Module._probe is not None:
            Module._probe(self, i, child, x, p, b_in)
        if self.remat and torch.is_grad_enabled():
            def run(p, x, b_in):
                return child.apply(p, x, buffers=b_in, training=training,
                                   rng=r)
            return _recompute(run, p, x, b_in, use_reentrant=False)
        return child.apply(p, x, buffers=b_in, training=training, rng=r)

    # OO-shell aggregation (ref Container aggregates over children)
    def training(self) -> "Container":
        super().training()
        for m in self.modules:
            m.training()
        return self

    def evaluate(self) -> "Container":
        super().evaluate()
        for m in self.modules:
            m.evaluate()
        return self

    def get_times(self):
        out = super().get_times()
        for m in self.modules:
            out.extend(m.get_times())
        return out

    def reset_times(self) -> None:
        super().reset_times()
        for m in self.modules:
            m.reset_times()

    def _collect_param_table(self, table, name, params, grads):
        for i, m in enumerate(self.modules):
            child_g = grads[str(i)] if grads is not None else None
            m._collect_param_table(
                table, m.get_name() if m._name else f"{m.get_name()}@{i}",
                params[str(i)], child_g)

    def __repr__(self) -> str:
        inner = "\n".join(f"  ({i}): " + repr(m).replace("\n", "\n  ")
                          for i, m in enumerate(self.modules))
        return f"{type(self).__name__} {{\n{inner}\n}}"


class Sequential(Container):
    """Feed-forward chain (ref nn/Sequential.scala)."""

    def apply(self, params, x, *, buffers=None, training=False, rng=None):
        buffers = buffers or {}
        new_buffers = {}
        for i in range(len(self.modules)):
            x, b = self._child_apply(i, params, x, buffers, training, rng)
            new_buffers[str(i)] = b
        return x, new_buffers


class Concat(Container):
    """Apply every child to the same input; concatenate outputs along a
    1-based dimension (ref nn/Concat.scala)."""

    def __init__(self, dimension: int, *modules: Module):
        super().__init__(*modules)
        self.dimension = dimension

    def _branches(self, params, x, buffers, training, rng):
        buffers = buffers or {}
        outs, new_buffers = [], {}
        for i in range(len(self.modules)):
            y, b = self._child_apply(i, params, x, buffers, training, rng)
            outs.append(y)
            new_buffers[str(i)] = b
        return outs, new_buffers

    def apply(self, params, x, *, buffers=None, training=False, rng=None):
        outs, new_buffers = self._branches(params, x, buffers, training, rng)
        axis = to_axis(self.dimension, outs[0].ndim)
        return torch.cat(outs, dim=axis), new_buffers


class DepthConcat(Concat):
    """Concat along the channel dim with spatial zero-padding to the
    largest branch output (torch nn.DepthConcat).  Odd size differences
    pad like torch: the extra row/column goes after the centered map."""

    def __init__(self, *modules: Module):
        super().__init__(2, *modules)

    def apply(self, params, x, *, buffers=None, training=False, rng=None):
        outs, new_buffers = self._branches(params, x, buffers, training, rng)
        spatial_axes = list(range(2, outs[0].ndim))
        if spatial_axes:
            targets = [max(o.shape[a] for o in outs) for a in spatial_axes]
            padded = []
            for o in outs:
                # F.pad takes (before, after) pairs from the last axis
                widths = []
                for a, t in reversed(list(zip(spatial_axes, targets))):
                    lead = (t - o.shape[a]) // 2
                    widths += [lead, t - o.shape[a] - lead]
                padded.append(F.pad(o, widths) if any(widths) else o)
            outs = padded
        axis = to_axis(self.dimension, outs[0].ndim)
        return torch.cat(outs, dim=axis), new_buffers


class ConcatTable(Container):
    """Apply every child to the same input; collect outputs into a Table
    (ref nn/ConcatTable.scala)."""

    def apply(self, params, x, *, buffers=None, training=False, rng=None):
        buffers = buffers or {}
        out, new_buffers = T(), {}
        for i in range(len(self.modules)):
            y, b = self._child_apply(i, params, x, buffers, training, rng)
            out.insert(y)
            new_buffers[str(i)] = b
        return out, new_buffers


class ParallelTable(Container):
    """Child i applied to input table element i
    (ref nn/ParallelTable.scala)."""

    def apply(self, params, x, *, buffers=None, training=False, rng=None):
        buffers = buffers or {}
        xs = _seq(x)
        out, new_buffers = T(), {}
        for i in range(len(self.modules)):
            y, b = self._child_apply(i, params, xs[i], buffers, training, rng)
            out.insert(y)
            new_buffers[str(i)] = b
        return out, new_buffers


class MapTable(Container):
    """One shared child applied to every element of the input table
    (ref nn/MapTable.scala: clones share weights; here the same params
    tree is reused)."""

    def __init__(self, module: Module):
        super().__init__(module)

    def apply(self, params, x, *, buffers=None, training=False, rng=None):
        buffers = buffers or {}
        out = T()
        b = buffers.get("0", {})
        for i, xi in enumerate(_seq(x)):
            if Module._probe is not None:
                Module._probe(self, 0, self.modules[0], xi, params["0"], b)
            y, b = self.modules[0].apply(params["0"], xi, buffers=b,
                                         training=training,
                                         rng=fold_rng(rng, i))
            out.insert(y)
        return out, {"0": b}


class Bottle(Container):
    """Collapse leading dims to run an n-D module over higher-rank input
    (ref nn/Bottle.scala)."""

    def __init__(self, module: Module, n_input_dim: int = 2,
                 n_output_dim: int = 2):
        super().__init__(module)
        self.n_input_dim = n_input_dim
        self.n_output_dim = n_output_dim

    def apply(self, params, x, *, buffers=None, training=False, rng=None):
        buffers = buffers or {}
        in_shape = tuple(x.shape)
        lead = in_shape[: x.ndim - self.n_input_dim + 1]
        squashed = x.reshape((-1,) + in_shape[x.ndim - self.n_input_dim + 1:])
        y, b = self._child_apply(0, params, squashed, buffers, training, rng)
        return y.reshape(lead + tuple(y.shape[1:])), {"0": b}


class FlattenTable(Module):
    """Nested table -> flat table (ref nn/FlattenTable.scala)."""

    def f(self, params, x, **kw):
        out = T()

        def rec(v):
            if isinstance(v, Table):
                for item in v.to_seq():
                    rec(item)
            elif isinstance(v, (list, tuple)):
                for item in v:
                    rec(item)
            else:
                out.insert(v)

        rec(x)
        return out


class SplitTable(Module):
    """Tensor -> table of slices along a 1-based dim
    (ref nn/SplitTable.scala)."""

    def __init__(self, dimension: int, n_input_dims: int = -1):
        super().__init__()
        self.dimension = dimension
        self.n_input_dims = n_input_dims

    def f(self, params, x, **kw):
        nid = self.n_input_dims if self.n_input_dims > 0 else None
        axis = to_axis(self.dimension, x.ndim, nid)
        return T(*torch.unbind(x, dim=axis))


class JoinTable(Module):
    """Table of tensors -> one tensor concatenated along a 1-based dim
    (ref nn/JoinTable.scala)."""

    def __init__(self, dimension: int, n_input_dims: int = -1):
        super().__init__()
        self.dimension = dimension
        self.n_input_dims = n_input_dims

    def f(self, params, x, **kw):
        xs = _seq(x)
        nid = self.n_input_dims if self.n_input_dims > 0 else None
        axis = to_axis(self.dimension, xs[0].ndim, nid)
        return torch.cat(xs, dim=axis)


class MixtureTable(Module):
    """Mixture-of-experts blend: input {gater, experts-table}; output =
    sum_i gater[:, i] * expert_i (ref nn/MixtureTable.scala)."""

    def __init__(self, dim: int = -1):
        super().__init__()
        self.dim = dim

    def f(self, params, x, **kw):
        gater, experts = _seq(x)[:2]
        out = None
        for i, e in enumerate(_seq(experts)):
            g = gater[:, i].reshape((-1,) + (1,) * (e.ndim - 1))
            out = g * e if out is None else out + g * e
        return out


class NarrowTable(Module):
    """Sub-table [offset, offset+length) with 1-based offset
    (ref nn/NarrowTable.scala)."""

    def __init__(self, offset: int, length: int = 1):
        super().__init__()
        self.offset = offset
        self.length = length

    def f(self, params, x, **kw):
        xs = _seq(x)
        n = len(xs)
        length = (self.length if self.length > 0
                  else n + self.length - self.offset + 2)
        return T(*xs[self.offset - 1:self.offset - 1 + length])


class SelectTable(Module):
    """Select one table element, 1-based, negative from end
    (ref nn/SelectTable.scala)."""

    def __init__(self, index: int):
        super().__init__()
        self.index = index

    def f(self, params, x, **kw):
        xs = _seq(x)
        return xs[one_based_index(self.index, len(xs))]
