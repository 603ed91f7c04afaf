"""Pipeline parallelism: GPipe microbatches over the ``pipeline`` mesh
axis (port of ``bigdl_tpu/parallel/pipeline.py``).

Each rank owns one stage.  The schedule runs ``M + N - 1`` ticks; after
each tick the activations move to the next stage through
``parallel.mesh.ring_permute`` (point to point), so every stage is busy
once the pipeline fills.  Two schedules:

- :func:`pipeline_apply`: homogeneous stages (one ``stage_fn``, params
  stacked on a leading stage axis, shape-preserving activations).
  Autograd runs straight through the ticks and the permutes: every rank
  builds the same graph (stage 0 selects its microbatch with a
  ``torch.where`` that keeps the received buffer in it, and every
  stage's outputs reach the final all-reduce, masked to the last
  stage's), so every rank's backward runs the same reverse permutes in
  the same order.
- :func:`pipeline_apply_hetero`: a function and a parameter tree per
  stage and any activation shapes (a stem, downsampling, a head: a
  ResNet).  Each rank runs only its own stage; activations cross a
  boundary flattened into one buffer of the largest boundary's size.
  The backward is GPipe's, a ``torch.autograd.Function`` that walks the
  ticks in reverse, recomputes each stage from its stashed input and
  sends the input's cotangent to the previous stage (the reference's
  ``custom_vjp``).  :func:`split_sequential` cuts a built
  ``nn.Sequential`` into flop-balanced stages for it.
"""
from __future__ import annotations

import math
from typing import Callable

import numpy as np
import torch
import torch.distributed as dist

from bigdl_tpu_torch.parallel.mesh import (PIPELINE_AXIS, MeshAxis,
                                           _send_recv, copy_to_axis,
                                           reduce_from_axis, ring_permute,
                                           scatter_to_axis)
from bigdl_tpu_torch.utils.pytree import (tree_flatten, tree_leaves,
                                          tree_map, tree_unflatten)


def pipeline_apply_local(stage_fn: Callable, stage_params, x_micro, *,
                         axis: MeshAxis):
    """Per-rank body over ``axis``: ``stage_params`` are this stage's,
    ``x_micro`` (M, mb, ...) the microbatched input, the same on every
    rank.  Returns the (M, mb, ...) outputs of the last stage on every
    rank."""
    stage, n = axis.index, axis.size
    m = x_micro.shape[0]
    first = torch.full((), stage == 0, dtype=torch.bool,
                       device=x_micro.device)
    buf = torch.zeros_like(x_micro[0])
    outs = []
    for t in range(m + n - 1):
        x_t = x_micro[min(t, m - 1)]
        # stage 0 injects a microbatch, the others consume the buffer;
        # a select keeps both in every rank's graph
        inp = x_t if n == 1 else torch.where(first, x_t, buf)
        y = stage_fn(stage_params, inp)
        if y.shape != inp.shape:
            raise ValueError("pipeline stages must preserve activation "
                             f"shape (got {tuple(y.shape)} vs "
                             f"{tuple(inp.shape)})")
        if t >= n - 1:
            outs.append(y)      # the microbatch leaving the last stage
        if t < m + n - 2:
            buf = ring_permute(y, axis)
    outs = torch.stack(outs)
    if n == 1:
        return outs
    # only the last stage's outputs are real; the sum broadcasts them
    return reduce_from_axis(outs * float(stage == n - 1), axis.mesh, axis)


def pipeline_apply(stage_fn: Callable, stacked_params, x, mesh, *,
                   n_microbatches: int, axis: str = PIPELINE_AXIS):
    """Global-view GPipe: ``stacked_params`` has a leading stage axis of
    the ``axis`` size (stage i's params at index i); ``x`` (batch, ...)
    splits into ``n_microbatches`` that go through the stages.  Every
    rank passes the same tensors and gets the (batch, ...) outputs.
    ``stage_fn(params_i, x_mb) -> y_mb`` must preserve the shape."""
    b = x.shape[0]
    if b % n_microbatches:
        raise ValueError(f"batch {b} does not divide into "
                         f"{n_microbatches} microbatches")
    pax = MeshAxis(mesh, axis)
    x_micro = x.reshape((n_microbatches, b // n_microbatches)
                        + tuple(x.shape[1:]))
    local = tree_map(lambda a: scatter_to_axis(a, mesh, pax, 0)[0],
                     stacked_params)
    if x_micro.requires_grad:
        x_micro = copy_to_axis([x_micro], mesh, pax)[0]
    y = pipeline_apply_local(stage_fn, local, x_micro, axis=pax)
    return y.reshape((b,) + tuple(y.shape[2:]))


# --------------------------------------------------------------------- #
# heterogeneous-stage GPipe                                             #
# --------------------------------------------------------------------- #
def _boundary_shapes(stage_fns, stage_params, x0):
    """[(shape, dtype)] of every stage boundary, input first, by running
    the stages on fake tensors (no device work)."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    out = [(tuple(x0.shape), x0.dtype)]
    with torch.no_grad(), FakeTensorMode(allow_non_fake_inputs=True) as mode:
        cur = mode.from_tensor(x0)
        for f, p in zip(stage_fns, stage_params):
            cur = f(p, cur)
            out.append((tuple(cur.shape), cur.dtype))
    return out


class _Plan:
    """What both passes of the hetero pipeline share."""

    def __init__(self, axis, stage_fns, stage_params, shapes, m):
        self.axis, self.fns, self.shapes, self.m = axis, stage_fns, shapes, m
        self.sizes = [max(1, math.prod(s)) for s, _ in shapes]
        self.dbuf = max(self.sizes)
        self.dtype = shapes[0][1]
        self.defs, self.counts = [], []
        for p in stage_params:
            leaves, treedef = tree_flatten(p)
            self.defs.append(treedef)
            self.counts.append(len(leaves))
        self.offsets = np.concatenate([[0], np.cumsum(self.counts)]).tolist()

    def stage_leaves(self, leaves, j):
        return list(leaves[self.offsets[j]:self.offsets[j + 1]])

    def run(self, j, leaves, inp):
        return self.fns[j](tree_unflatten(self.defs[j], leaves), inp)

    def flat(self, y, like):
        out = like.new_zeros(self.dbuf)
        out[:y.numel()] = y.reshape(-1)
        return out

    def unflat(self, buf, j):
        return buf[:self.sizes[j]].view(self.shapes[j][0])


class _HeteroPipe(torch.autograd.Function):
    @staticmethod
    def forward(ctx, plan, x_micro, *leaves):
        axis, m = plan.axis, plan.m
        stage, n = axis.index, axis.size
        mine = plan.stage_leaves(leaves, stage)
        buf = x_micro.new_zeros(plan.dbuf)
        outs = x_micro.new_zeros((m,) + plan.shapes[n][0])
        stash = {}
        for t in range(m + n - 1):
            mb = t - stage
            y_flat = buf.new_zeros(plan.dbuf)
            if 0 <= mb < m:
                inp = x_micro[mb] if stage == 0 else plan.unflat(buf, stage)
                stash[t] = inp  # the backward recomputes the stage from it
                y = plan.run(stage, mine, inp)
                if stage == n - 1:
                    outs[mb] = y
                y_flat = plan.flat(y, y_flat)
            if t < m + n - 2 and n > 1:
                buf = _send_recv([y_flat], axis, 1)[0]
        if n > 1:
            dist.broadcast(outs, axis.ranks[n - 1], group=axis.group)
        ctx.plan, ctx.stash = plan, stash
        ctx.save_for_backward(x_micro, *leaves)
        return outs

    @staticmethod
    def backward(ctx, dy):
        plan, stash = ctx.plan, ctx.stash
        x_micro, *leaves = ctx.saved_tensors
        axis, m = plan.axis, plan.m
        stage, n = axis.index, axis.size
        live = [t.detach().requires_grad_(t.is_floating_point())
                for t in plan.stage_leaves(leaves, stage)]
        wants = [t for t in live if t.requires_grad]
        dp = [torch.zeros_like(t) for t in wants]
        dxs = torch.zeros_like(x_micro) if stage == 0 else None
        dcarry = dy.new_zeros(plan.dbuf)
        for s in reversed(range(m + n - 1)):
            mb = s - stage
            d_flat = dcarry.new_zeros(plan.dbuf)
            if 0 <= mb < m:
                # my output's cotangent: the loss's for the last stage,
                # else the next stage's input cotangent from tick s + 1
                dy_mine = (dy[mb] if stage == n - 1
                           else plan.unflat(dcarry, stage + 1))
                inp = stash[s].detach().requires_grad_(True)
                with torch.enable_grad():
                    y = plan.run(stage, live, inp)
                    grads = torch.autograd.grad(y, wants + [inp], dy_mine,
                                                allow_unused=True)
                for acc, g in zip(dp, grads[:-1]):
                    if g is not None:
                        acc += g
                d_inp = grads[-1]
                if d_inp is not None:
                    if stage == 0:
                        dxs[mb] = d_inp
                    d_flat = plan.flat(d_inp, d_flat)
            if s > 0 and n > 1:
                dcarry = _send_recv([d_flat], axis, -1)[0]
        # every stage's parameter gradients onto every rank: one gather
        # of each stage's flat gradient, padded to the longest
        mine_flat = (torch.cat([g.float().reshape(-1) for g in dp])
                     if dp else dy.new_zeros(0, dtype=torch.float32))
        sizes = [sum(t.numel() for t in plan.stage_leaves(leaves, j)
                     if t.is_floating_point()) for j in range(n)]
        pbuf = max(max(sizes), 1)
        flat = mine_flat.new_zeros(pbuf)
        flat[:mine_flat.numel()] = mine_flat
        if n > 1:
            parts = [torch.empty_like(flat) for _ in range(n)]
            dist.all_gather(parts, flat, group=axis.group)
        else:
            parts = [flat]
        out = []
        for j in range(n):
            pos = 0
            for t in plan.stage_leaves(leaves, j):
                if not t.is_floating_point():
                    out.append(None)
                    continue
                out.append(parts[j][pos:pos + t.numel()].view(t.shape)
                           .to(t.dtype))
                pos += t.numel()
        dx = None
        if ctx.needs_input_grad[1]:
            dx = dxs if stage == 0 else torch.empty_like(x_micro)
            if n > 1:
                dist.broadcast(dx, axis.ranks[0], group=axis.group)
        return (None, dx, *out)


def pipeline_apply_hetero(stage_fns, stage_params, x, mesh, *,
                          n_microbatches: int, axis: str = PIPELINE_AXIS):
    """GPipe over stages with different functions and activation shapes.

    ``stage_fns``: n callables ``f_j(params_j, x_j) -> y_j``, one a rank
    of the ``axis``; the boundary shapes come from running the chain on
    fake tensors.  ``stage_params``: n per-stage trees, the same on
    every rank (heterogeneous trees cannot be stacked; each rank
    computes with its own stage's, and the backward gathers every
    stage's gradient onto every rank).  ``x``: (batch, ...) input to
    stage 0.  Returns the last stage's (batch, ...) outputs on every
    rank."""
    pax = MeshAxis(mesh, axis)
    n = pax.size
    if len(stage_fns) != n or len(stage_params) != n:
        raise ValueError(f"{len(stage_fns)} stages for a {n}-rank "
                         f"{axis!r} axis")
    b = x.shape[0]
    if b % n_microbatches:
        raise ValueError(f"batch {b} does not divide into "
                         f"{n_microbatches} microbatches")
    m = n_microbatches
    x_micro = x.reshape((m, b // m) + tuple(x.shape[1:]))
    shapes = _boundary_shapes(stage_fns, stage_params, x_micro[0])
    dtypes = {d for _, d in shapes}
    if len(dtypes) != 1:
        raise ValueError(f"stage boundaries must share a dtype: {dtypes}")
    plan = _Plan(pax, stage_fns, stage_params, shapes, m)
    leaves = [t for p in stage_params for t in tree_leaves(p)]
    y = _HeteroPipe.apply(plan, x_micro, *leaves)
    return y.reshape((b,) + tuple(y.shape[2:]))


def split_sequential(model, n_stages: int, x, *, by: str = "flops",
                     training: bool = False):
    """Cut a built ``nn.Sequential`` into ``n_stages`` contiguous stages
    balanced by forward FLOPs (``utils.profiling``) or by parameter
    count, for :func:`pipeline_apply_hetero`.  Returns ``(stage_fns,
    stage_params)``: stage j applies its group of children with the
    model's buffers frozen (eval mode: GPipe's microbatches change batch
    statistics anyway)."""
    from bigdl_tpu_torch.nn.containers import Sequential

    if not isinstance(model, Sequential):
        raise TypeError("split_sequential wants a Sequential")
    model._built()
    children = list(model.modules)
    n_children = len(children)
    if n_stages > n_children:
        raise ValueError("more stages than layers")

    if by == "flops":
        from bigdl_tpu_torch.utils import profiling
        rows = profiling.profile_layers(model, x, training=training,
                                        include_train=False)
        cost_by_module = {id(r["module"]): max(r["flops_fwd"], 1.0)
                          for r in rows}

        def child_cost(c):
            if getattr(c, "modules", None):
                return sum(cost_by_module.get(id(leaf), 1.0)
                           for leaf in _leaves_of(c))
            return cost_by_module.get(id(c), 1.0)
        costs = [child_cost(c) for c in children]
    else:
        costs = [sum(t.numel() for t in tree_leaves(model.params[str(i)]))
                 + 1.0 for i in range(n_children)]

    # greedy contiguous partition: cut when a stage reaches total/n, or
    # when exactly enough children remain to fill the remaining stages
    target = sum(costs) / n_stages
    bounds, acc, start = [], 0.0, 0
    for i, c in enumerate(costs):
        acc += c
        remaining_stages = n_stages - len(bounds) - 1
        children_left_after = n_children - (i + 1)
        if remaining_stages > 0 and children_left_after >= remaining_stages \
                and (acc >= target or children_left_after == remaining_stages):
            bounds.append((start, i + 1))
            start, acc = i + 1, 0.0
    bounds.append((start, n_children))

    stage_fns, stage_params = [], []
    for a, bnd in bounds:
        group = children[a:bnd]
        g_params = {str(k): model.params[str(a + k)]
                    for k in range(len(group))}
        g_buffers = {str(k): (model.buffers or {}).get(str(a + k), {})
                     for k in range(len(group))}

        def make_fn(group=group, g_buffers=g_buffers):
            def fn(p, xx):
                for k, child in enumerate(group):
                    xx, _ = child.apply(p.get(str(k), {}), xx,
                                        buffers=g_buffers.get(str(k), {}),
                                        training=False)
                return xx
            return fn

        stage_fns.append(make_fn())
        stage_params.append(g_params)
    return stage_fns, stage_params


def _leaves_of(container):
    out = []
    for c in container.modules:
        if getattr(c, "modules", None):
            out.extend(_leaves_of(c))
        else:
            out.append(c)
    return out
