"""bigdl_tpu_torch's tensor, pipeline and expert parallelism against the
JAX package's, on the CPU: ``shard_params`` with the Megatron rules on
``MultiHeadAttention`` and ``TransformerLM`` (DTensor placements),
``pipeline_apply`` (GPipe through the ring permute's autograd),
``pipeline_apply_hetero`` and ``split_sequential`` (a ResNet in four
stages, a toy that changes shape), and ``moe_apply`` over the expert
axis (dense and capacity dispatch, a data x expert mesh).

The reference runs in this process on the conftest's virtual CPU
devices, on meshes of 2 and 4; the port on gloo worlds of 2 and 4
ranks, each spawned once for the module (``torch.multiprocessing``,
``spawn``; this module imports nothing of JAX at its top), meeting over
a ``file://`` store.  Every rank passes the same global tensors, made
from a seed with numpy; weights cross from the reference through
``params_from_numpy``.  Tolerances: outputs within 1e-5 of their
largest magnitude (the ResNet's logits 1e-4: thirteen float32
convolutions summed in another order); gradients within 1e-4 of each
leaf's largest |g|, that largest taken no lower than 1e-3 of the case's
largest |g| (``bk``'s gradient is zero in exact arithmetic).
"""
import os
import pickle
import time
import traceback

import numpy as np
import pytest
import torch

TOL_FWD, TOL_GRAD = 1e-5, 1e-4
WORLDS = (2, 4)


def _tp_axes(n):
    return {"data": n // 2, "model": 2}


def _pipe_params(n, d, seed):
    r = np.random.RandomState(seed)
    return {"w": r.randn(n, d, d).astype(np.float32) * 0.1,
            "b": r.randn(n, d).astype(np.float32) * 0.1}


#: the homogeneous pipeline cases: (stage width, params seed, batch,
#: microbatches, x seed, with gradients)
PIPE_CASES = {"matches_sequential": (16, 0, 8, 4, 1, False),
              "one_microbatch": (8, 2, 4, 1, 2, False),
              "backprop": (8, 3, 8, 2, 3, True)}


def _toy_widths(n):
    return [6, 12] + [4] * (n - 1)


def _toy(n):
    r = np.random.RandomState(7)
    w = _toy_widths(n)
    ws = [r.randn(w[i], w[i + 1]).astype(np.float32) * 0.3 for i in range(n)]
    return ws, r.randn(8, 6).astype(np.float32)


#: the MoE cases: (experts, d, hidden, key seed, tokens shape, x seed,
#: capacity factor, mesh axes by world size, data axis)
MOE_CASES = {
    "dense": (8, 16, 32, 0, (24, 16), 4, None, None, None),
    "grads": (4, 8, 16, 2, (12, 8), 6, None, None, None),
    "full_capacity": (4, 8, 16, 0, (32, 8), 0, 4.0, None, None),
    "capacity_grads": (2, 8, 16, 0, (32, 8), 0, 1.25, 2, None),
    "tight_capacity": (2, 8, 16, 0, (16, 8), 0, 0.25, 2, None),
    "data_x_expert": (4, 8, 16, 1, (2, 8, 8), 5, None, 4, "data"),
    "data_x_expert_capacity": (4, 8, 16, 1, (2, 8, 8), 5, 2.0, 4, "data"),
}


def _moe_cases(n):
    return {k: c for k, c in MOE_CASES.items() if c[7] in (None, n)}


def _moe_axes(case, n):
    return {"data": 2, "expert": n // 2} if case[8] else {"expert": n}


def _moe_x(case):
    return np.random.RandomState(case[5]).randn(*case[4]).astype(np.float32)


# --------------------------------------------------------------------- #
# the ranks (this module's top imports no JAX)                          #
# --------------------------------------------------------------------- #
def _np(t):
    if type(t).__name__ == "DTensor":
        t = t.full_tensor()
    return t.detach().float().numpy()


def _live(tree):
    from bigdl_tpu_torch.utils.params import params_from_numpy
    from bigdl_tpu_torch.utils.pytree import tree_leaves
    p = params_from_numpy(tree, "cpu")
    for t in tree_leaves(p):
        t.requires_grad_(True)
    return p, tree_leaves(p)


def port_tp(rank, world, mha, mha2, lm):
    from bigdl_tpu_torch import nn
    from bigdl_tpu_torch.models import TransformerLM
    from bigdl_tpu_torch.parallel import (constrain_batch, create_mesh,
                                          mha_tp_rules, shard_params,
                                          transformer_lm_tp_rules)
    from bigdl_tpu_torch.utils.pytree import tree_leaves
    mesh = create_mesh(_tp_axes(world), "cpu")
    out = {}
    x = torch.tensor(np.random.RandomState(0).randn(4, 8, 32)
                     .astype(np.float32))
    p, _ = _live(mha)
    tp = shard_params(p, mha_tp_rules(mesh), mesh)
    y = nn.MultiHeadAttention(32, 4, causal=True).f(tp, constrain_batch(
        x, mesh))
    out["mha"] = (_np(y), [])
    p, _ = _live(mha2)
    tp = shard_params(p, mha_tp_rules(mesh), mesh)
    y = nn.MultiHeadAttention(16, 4).f(tp, constrain_batch(
        torch.ones(2, 4, 16), mesh))
    g = torch.autograd.grad((y ** 2).sum(), tree_leaves(tp))
    out["mha_grads"] = (_np(y), [_np(t) for t in g])
    m = TransformerLM(vocab_size=11, hidden_size=16, n_head=4, n_layers=2,
                      max_len=8, device="cpu")
    p, _ = _live(lm)
    tp = shard_params(p, transformer_lm_tp_rules(mesh), mesh)
    ids = torch.tensor(np.random.RandomState(0).randint(1, 12, size=(4, 8))
                       .astype(np.float32))
    y, _ = m.apply(tp, constrain_batch(ids, mesh))
    loss = (y ** 2).mean()
    g = torch.autograd.grad(loss, tree_leaves(tp))
    out["lm"] = (_np(y), [_np(t) for t in g])
    out["lm_loss"] = float(_np(loss))
    out["wq_placements"] = str(tp["blocks"]["attn"]["wq"].placements)
    out["batch_placements"] = str(constrain_batch(ids, mesh).placements)
    return out


def _stage_fn(p, x):
    return x + torch.tanh(x @ p["w"] + p["b"])


def port_pipeline(rank, world, toy_ws, toy_x, resnet=None):
    from bigdl_tpu_torch.parallel import (create_mesh, pipeline_apply,
                                          pipeline_apply_hetero,
                                          split_sequential)
    mesh = create_mesh({"pipeline": world}, "cpu")
    out = {}
    for name, (d, seed, b, m, xseed, grads) in PIPE_CASES.items():
        p, leaves = _live(_pipe_params(world, d, seed))
        x = torch.tensor(np.random.RandomState(xseed).randn(b, d)
                         .astype(np.float32), requires_grad=grads)
        y = pipeline_apply(_stage_fn, p, x, mesh, n_microbatches=m)
        g = (torch.autograd.grad((y ** 2).sum(), leaves + [x]) if grads
             else [])
        out[name] = (_np(y), [_np(t) for t in g])
    ws = [torch.tensor(w, requires_grad=True) for w in toy_ws]
    x = torch.tensor(toy_x, requires_grad=True)
    fns = [lambda p, h: torch.tanh(h @ p)] * world
    y = pipeline_apply_hetero(fns, ws, x, mesh, n_microbatches=2)
    g = torch.autograd.grad((y ** 2).mean(), ws + [x])
    out["toy"] = (_np(y), [_np(t) for t in g])
    if resnet is not None:
        from bigdl_tpu_torch.models import ResNet
        from bigdl_tpu_torch.utils.params import params_from_numpy
        model = ResNet(class_num=10, depth=8, dataset="cifar10")
        model.device = torch.device("cpu")
        model.params = params_from_numpy(resnet["params"], "cpu")
        model.buffers = params_from_numpy(resnet["buffers"], "cpu")
        x = torch.tensor(resnet["x"])
        stage_fns, stage_params = split_sequential(model, world, x)
        from bigdl_tpu_torch.utils.pytree import tree_leaves
        leaves = []
        for sp in stage_params:
            for k in sorted(sp, key=int):
                for t in tree_leaves(sp[k]):
                    t.requires_grad_(True)
                    leaves.append(t)
        y = pipeline_apply_hetero(stage_fns, stage_params, x, mesh,
                                  n_microbatches=4)
        g = torch.autograd.grad((y ** 2).mean(), leaves)
        out["resnet"] = (_np(y), [_np(t) for t in g])
        out["resnet_bounds"] = [sorted(sp, key=int) for sp in stage_params]
    return out


def port_moe(rank, world, params):
    from torch.utils.flop_counter import FlopCounterMode

    from bigdl_tpu_torch.parallel import create_mesh, moe_apply
    out = {}
    for name, case in _moe_cases(world).items():
        mesh = create_mesh(_moe_axes(case, world), "cpu")
        p, leaves = _live(params[name])
        x = torch.tensor(_moe_x(case), requires_grad=True)
        y, aux = moe_apply(p, x, mesh, data_axis=case[8],
                           capacity_factor=case[6])
        g = torch.autograd.grad((y ** 2).sum() + 0.01 * aux, leaves + [x])
        out[name] = (_np(y), [_np(t) for t in g])
        out[name + "_aux"] = float(aux)
    if world == 2:
        # the scaling claim: dense dispatch's products grow with the
        # expert count, capacity dispatch's stay flat
        mesh = create_mesh({"expert": 2}, "cpu")
        flops = {}
        for e in (2, 8):
            r = np.random.RandomState(0)
            p = {"gate": torch.tensor(r.randn(16, e).astype(np.float32)),
                 "w1": torch.tensor(r.randn(e, 16, 64).astype(np.float32)),
                 "w2": torch.tensor(r.randn(e, 64, 16).astype(np.float32))}
            x = torch.tensor(r.randn(128, 16).astype(np.float32))
            for cf in (None, 1.0):
                counter = FlopCounterMode(display=False)
                with counter, torch.no_grad():
                    moe_apply(p, x, mesh, capacity_factor=cf)
                flops[(e, cf)] = counter.get_total_flops()
        out["flops"] = flops
    return out


def _rank_main(rank, world, store, out_dir, jobs):
    torch.set_num_threads(1)
    from bigdl_tpu_torch.parallel.mesh import init_world, shutdown_world
    init_world("cpu", init_method=store, rank=rank, world_size=world)
    try:
        for name, fn, kwargs in jobs:
            try:
                res = {"ok": globals()[fn](rank, world, **kwargs)}
            except Exception:
                res = {"error": traceback.format_exc()}
            with open(os.path.join(out_dir, f"{name}.{rank}.pkl"), "wb") as f:
                pickle.dump(res, f)
    finally:
        shutdown_world()


def _start(world, jobs, out_dir):
    import torch.multiprocessing as mp
    store = f"file://{os.path.join(out_dir, 'store')}"
    return mp.start_processes(_rank_main, args=(world, store, str(out_dir),
                                                jobs),
                              nprocs=world, join=False, start_method="spawn")


def _join(ctx, world, deadline):
    while not ctx.join(timeout=1.0):
        if time.monotonic() > deadline:
            for p in ctx.processes:
                p.kill()
            raise AssertionError(f"the {world} ranks did not finish in time")


# --------------------------------------------------------------------- #
# the reference's side                                                  #
# --------------------------------------------------------------------- #
def _ref_mesh(axes):
    import jax
    from bigdl_tpu.parallel import create_mesh
    n = int(np.prod(list(axes.values())))
    return create_mesh(axes, devices=jax.devices()[:n])


def _tree_np(tree):
    import jax
    return jax.tree_util.tree_map(np.asarray, tree)


def _leaves_np(tree):
    import jax
    return [np.asarray(t) for t in jax.tree_util.tree_leaves(tree)]


def _ref_models():
    from bigdl_tpu import nn as jnn
    from bigdl_tpu.models import TransformerLM as JaxLM
    return (jnn.MultiHeadAttention(32, 4, causal=True).build(seed=1),
            jnn.MultiHeadAttention(16, 4).build(seed=2),
            JaxLM(vocab_size=11, hidden_size=16, n_head=4, n_layers=2,
                  max_len=8).build(seed=1))


def ref_tp(n, models):
    import jax
    import jax.numpy as jnp
    from bigdl_tpu.parallel.tensor_parallel import (constrain_batch,
                                                    mha_tp_rules,
                                                    shard_params,
                                                    transformer_lm_tp_rules)
    mesh = _ref_mesh(_tp_axes(n))
    mha, mha2, lm = models
    out = {}
    x = jnp.asarray(np.random.RandomState(0).randn(4, 8, 32), jnp.float32)
    tp = shard_params(mha.params, mha_tp_rules(mesh), mesh)
    y = jax.jit(lambda p, x: mha.f(p, constrain_batch(x, mesh)))(tp, x)
    out["mha"] = (np.asarray(y), [])
    tp = shard_params(mha2.params, mha_tp_rules(mesh), mesh)

    def loss2(p):
        y = mha2.f(p, jnp.ones((2, 4, 16), jnp.float32))
        return jnp.sum(y ** 2), y
    (_, y), g = jax.jit(jax.value_and_grad(loss2, has_aux=True))(tp)
    out["mha_grads"] = (np.asarray(y), _leaves_np(g))
    ids = jnp.asarray(np.random.RandomState(0).randint(1, 12, size=(4, 8))
                      .astype(np.float32))
    tp = shard_params(lm.params, transformer_lm_tp_rules(mesh), mesh)

    def loss(p, x):
        y, _ = lm.apply(p, constrain_batch(x, mesh))
        return jnp.mean(y ** 2), y
    (value, y), g = jax.jit(jax.value_and_grad(loss, has_aux=True))(tp, ids)
    out["lm"] = (np.asarray(y), _leaves_np(g))
    out["lm_loss"] = float(value)
    return out


def _jnp_stage(p, x):
    import jax.numpy as jnp
    return x + jnp.tanh(x @ p["w"] + p["b"])


def _ref_resnet():
    from bigdl_tpu.models import ResNet
    m = ResNet(class_num=10, depth=8, dataset="cifar10").build(seed=3)
    x = np.random.RandomState(42).randn(8, 3, 32, 32).astype(np.float32)
    return m, x


def ref_pipeline(n, resnet_model=None):
    import jax
    import jax.numpy as jnp
    from bigdl_tpu.parallel.pipeline import (pipeline_apply,
                                             pipeline_apply_hetero,
                                             split_sequential)
    mesh = _ref_mesh({"pipeline": n})
    out = {}
    for name, (d, seed, b, m, xseed, grads) in PIPE_CASES.items():
        p = jax.tree_util.tree_map(jnp.asarray, _pipe_params(n, d, seed))
        x = jnp.asarray(np.random.RandomState(xseed).randn(b, d)
                        .astype(np.float32))

        def loss(p, x, m=m):
            y = pipeline_apply(_jnp_stage, p, x, mesh, n_microbatches=m)
            return jnp.sum(y ** 2), y
        if grads:
            (_, y), g = jax.jit(jax.value_and_grad(
                loss, argnums=(0, 1), has_aux=True))(p, x)
            out[name] = (np.asarray(y), _leaves_np(g[0]) + [
                np.asarray(g[1])])
        else:
            out[name] = (np.asarray(jax.jit(loss)(p, x)[1]), [])
    ws, x = _toy(n)
    fns = [lambda p, h: jnp.tanh(h @ p)] * n

    def loss(ws, x):
        y = pipeline_apply_hetero(fns, ws, x, mesh, n_microbatches=2)
        return jnp.mean(y ** 2), y
    (_, y), g = jax.value_and_grad(loss, argnums=(0, 1), has_aux=True)(
        [jnp.asarray(w) for w in ws], jnp.asarray(x))
    out["toy"] = (np.asarray(y), _leaves_np(g[0]) + [np.asarray(g[1])])
    if resnet_model is not None:
        model, x = resnet_model
        x = jnp.asarray(x)
        stage_fns, stage_params = split_sequential(model, n, x)

        def loss(ps):
            y = pipeline_apply_hetero(stage_fns, ps, x, mesh,
                                      n_microbatches=4)
            return jnp.mean(y ** 2), y
        (_, y), g = jax.jit(jax.value_and_grad(loss, has_aux=True))(
            stage_params)
        grads = []
        for stage in g:
            for k in sorted(stage, key=int):
                grads += _leaves_np(stage[k])
        out["resnet"] = (np.asarray(y), grads)
        out["resnet_bounds"] = [sorted(sp, key=int) for sp in stage_params]
        y_seq, _ = model.apply(model.params, x, buffers=model.buffers,
                               training=False)
        out["resnet_sequential"] = np.asarray(y_seq)
    return out


def _ref_moe_params(case):
    import jax
    from bigdl_tpu.parallel.expert import init_moe_params
    e, d, h, seed = case[:4]
    return _tree_np(init_moe_params(jax.random.PRNGKey(seed), e, d, h))


def ref_moe(n):
    import jax
    import jax.numpy as jnp
    from bigdl_tpu.parallel.expert import moe_apply
    out = {}
    for name, case in _moe_cases(n).items():
        mesh = _ref_mesh(_moe_axes(case, n))
        p = jax.tree_util.tree_map(jnp.asarray, _ref_moe_params(case))

        def loss(p, x, case=case, mesh=mesh):
            y, aux = moe_apply(p, x, mesh, data_axis=case[8],
                               capacity_factor=case[6])
            return jnp.sum(y ** 2) + 0.01 * aux, (y, aux)
        (_, (y, aux)), g = jax.jit(jax.value_and_grad(
            loss, argnums=(0, 1), has_aux=True))(p, jnp.asarray(_moe_x(case)))
        out[name] = (np.asarray(y), _leaves_np(g[0]) + [np.asarray(g[1])])
        out[name + "_aux"] = float(aux)
    return out


def _close(got, want, tol, name="", scale=None):
    """max |got - want| <= tol * scale (default: max |want|)."""
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, (name, got.shape, want.shape)
    assert np.isfinite(got).all(), name
    err = np.abs(got - want).max() if got.size else 0.0
    bound = tol * (np.abs(want).max() if scale is None else scale)
    assert err <= bound, f"{name}: {err} > {bound}"


def _check(got, want, name, tol_fwd=TOL_FWD):
    (y, g), (y_ref, g_ref) = got, want
    _close(y, y_ref, tol_fwd, f"{name} output")
    assert len(g) == len(g_ref)
    if not g:
        return
    top = max(np.abs(w).max() for w in g_ref)
    for i, (a, b) in enumerate(zip(g, g_ref)):
        _close(a, b, TOL_GRAD, f"{name} gradient {i}",
               scale=max(np.abs(b).max(), 1e-3 * top))


# --------------------------------------------------------------------- #
# fixtures                                                              #
# --------------------------------------------------------------------- #
@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    """The worlds of 2 and 4 ranks, each spawned once; the reference's
    runs for the same inputs are computed here while the ranks run."""
    models = _ref_models()
    resnet = _ref_resnet()
    resnet_kw = dict(params=_tree_np(resnet[0].params),
                     buffers=_tree_np(resnet[0].buffers), x=resnet[1])
    outs, ctxs = {}, {}
    for n in WORLDS:
        toy_ws, toy_x = _toy(n)
        jobs = [("tp", "port_tp", dict(
                    mha=_tree_np(models[0].params),
                    mha2=_tree_np(models[1].params),
                    lm=_tree_np(models[2].params))),
                ("pipeline", "port_pipeline", dict(
                    toy_ws=toy_ws, toy_x=toy_x,
                    resnet=resnet_kw if n == 4 else None)),
                ("moe", "port_moe", dict(params={
                    name: _ref_moe_params(case)
                    for name, case in _moe_cases(n).items()}))]
        outs[n] = tmp_path_factory.mktemp(f"world{n}")
        ctxs[n] = _start(n, jobs, outs[n])
    deadline = time.monotonic() + 400
    try:
        refs = {n: {"tp": ref_tp(n, models),
                    "pipeline": ref_pipeline(n, resnet if n == 4 else None),
                    "moe": ref_moe(n)} for n in WORLDS}
    finally:
        for n in WORLDS:
            _join(ctxs[n], n, deadline)

    def world(n):
        def result(name, rank=0):
            path = outs[n] / f"{name}.{rank}.pkl"
            assert path.exists(), f"rank {rank} wrote no result for {name}"
            with open(path, "rb") as f:
                res = pickle.load(f)
            assert "error" not in res, res.get("error")
            return res["ok"]
        result.refs = refs[n]
        return result
    return {n: world(n) for n in WORLDS}


# --------------------------------------------------------------------- #
# tensor parallelism                                                    #
# --------------------------------------------------------------------- #
@pytest.mark.parametrize("n", WORLDS)
@pytest.mark.parametrize("case", ["mha", "mha_grads", "lm"])
def test_tp_matches_the_reference(worlds, n, case):
    w = worlds[n]
    _check(w("tp")[case], w.refs["tp"][case], case)


@pytest.mark.parametrize("n", WORLDS)
def test_tp_lm_loss_and_placements(worlds, n):
    """The sharded LM's loss is the reference's, a block's ``wq`` is
    split over the model axis on its third dim (the stacked layer axis
    shifts the Megatron dims right by one), and the batch over data."""
    got = worlds[n]("tp")
    np.testing.assert_allclose(got["lm_loss"], worlds[n].refs["tp"]["lm_loss"],
                               rtol=TOL_FWD)
    assert got["wq_placements"] == "(Replicate(), Shard(dim=2))"
    assert got["batch_placements"] == "(Shard(dim=0), Replicate())"
    # every rank holds the same global result
    np.testing.assert_array_equal(got["lm"][0], worlds[n]("tp", n - 1)["lm"][0])


def test_pin_xla_attention():
    from bigdl_tpu_torch.models import TransformerLM
    from bigdl_tpu_torch.parallel import pin_xla_attention
    m = TransformerLM(vocab_size=11, hidden_size=16, n_head=4, n_layers=1,
                      max_len=8, device="cpu")
    pin_xla_attention(m)
    assert m._mha.attention_impl == "xla"
    flash = TransformerLM(vocab_size=11, hidden_size=16, n_head=4,
                          n_layers=1, max_len=8, attention_impl="flash",
                          device="cpu")
    with pytest.raises(ValueError, match="flash"):
        pin_xla_attention(flash)


def test_rules_match_the_references_by_key_path():
    """Every rule, on every leaf of the LM's tree, names the reference's
    spec (the port's key paths print as ``jax.tree_util.keystr``)."""
    import jax
    from bigdl_tpu.models import TransformerLM as JaxLM
    from bigdl_tpu.parallel import tensor_parallel as jtp

    from bigdl_tpu_torch.parallel import tensor_parallel as tp
    ref = JaxLM(vocab_size=11, hidden_size=16, n_head=4, n_layers=2,
                max_len=8, moe_experts=2).build(seed=1)
    mesh = _ref_mesh({"data": 2, "model": 2})

    class _Mesh:
        mesh_dim_names = ("data", "model")

    want = {}
    for rules, prules in ((jtp.transformer_lm_tp_rules(mesh),
                           tp.transformer_lm_tp_rules(_Mesh())),
                          (jtp.mha_tp_rules(mesh), tp.mha_tp_rules(_Mesh())),
                          (jtp.mlp_tp_rules(mesh, "w1", "w2"),
                           tp.mlp_tp_rules(_Mesh(), "w1", "w2"))):
        for path, leaf in jax.tree_util.tree_flatten_with_path(
                ref.params)[0]:
            keys = tuple(k.key for k in path)
            assert tp.keystr(keys) == jax.tree_util.keystr(path)
            spec = tuple(rules(path, leaf).spec)
            got = prules(keys, leaf).spec
            assert got + (None,) * (len(spec) - len(got)) == spec + (None,) * (
                len(got) - len(spec)), (keys, got, spec)
            want.setdefault(keys, spec)
    # the first rules are the LM's: MoE stacks stay replicated
    assert want[("blocks", "moe", "w1")] == ()
    assert want[("blocks", "attn", "wq")] == (None, None, "model")


# --------------------------------------------------------------------- #
# pipeline parallelism                                                  #
# --------------------------------------------------------------------- #
@pytest.mark.parametrize("n", WORLDS)
@pytest.mark.parametrize("case", sorted(PIPE_CASES) + ["toy"])
def test_pipeline_matches_the_reference(worlds, n, case):
    w = worlds[n]
    _check(w("pipeline")[case], w.refs["pipeline"][case], case)


def test_hetero_resnet_four_stages_matches_the_reference(worlds):
    """ResNet-8 cut into four stages by FLOPs: the port's cut is the
    reference's, and its pipelined forward and backward (every
    module's gradients, in order) match the reference's pipeline, whose
    forward is the sequential model's."""
    w = worlds[4]
    got, ref = w("pipeline"), w.refs["pipeline"]
    assert got["resnet_bounds"] == ref["resnet_bounds"]
    _close(ref["resnet"][0], ref["resnet_sequential"], 2e-4, "reference")
    _check(got["resnet"], ref["resnet"], "resnet", tol_fwd=1e-4)


def test_split_sequential_is_the_references_cut():
    from bigdl_tpu_torch.models import ResNet
    from bigdl_tpu_torch.parallel import split_sequential
    m = ResNet(class_num=10, depth=8, dataset="cifar10").build(
        seed=3, device="cpu")
    x = torch.tensor(np.random.RandomState(42).randn(8, 3, 32, 32)
                     .astype(np.float32))
    for by in ("flops", "params"):
        fns, params = split_sequential(m, 4, x, by=by)
        assert len(fns) == len(params) == 4
        assert sum(len(p) for p in params) == len(m.modules)
        assert all(len(p) for p in params)
    with pytest.raises(ValueError, match="more stages"):
        split_sequential(m, 11, x)


@pytest.fixture(scope="module")
def world1(tmp_path_factory):
    """A gloo world of one in this process, torn down after the module."""
    from bigdl_tpu_torch.parallel.mesh import init_world, shutdown_world
    store = tmp_path_factory.mktemp("world1") / "store"
    init_world("cpu", init_method=f"file://{store}", rank=0, world_size=1)
    yield
    shutdown_world()


def test_pipeline_refusals(world1):
    from bigdl_tpu_torch.parallel import (create_mesh, pipeline_apply,
                                          pipeline_apply_hetero)
    mesh = create_mesh({"pipeline": 1}, "cpu")
    p = {"w": torch.zeros(1, 4, 4), "b": torch.zeros(1, 4)}
    with pytest.raises(ValueError, match="microbatches"):
        pipeline_apply(_stage_fn, p, torch.zeros(6, 4), mesh,
                       n_microbatches=4)
    with pytest.raises(ValueError, match="stages"):
        pipeline_apply_hetero([_stage_fn] * 2, [p, p], torch.zeros(4, 4),
                              mesh, n_microbatches=2)
    with pytest.raises(ValueError, match="preserve"):
        pipeline_apply(lambda p, x: x[:, :2], p, torch.zeros(4, 4), mesh,
                       n_microbatches=2)


# --------------------------------------------------------------------- #
# expert parallelism                                                    #
# --------------------------------------------------------------------- #
@pytest.mark.parametrize("n, case", [(n, c) for n in WORLDS
                                     for c in sorted(_moe_cases(n))])
def test_moe_matches_the_reference(worlds, n, case):
    w = worlds[n]
    _check(w("moe")[case], w.refs["moe"][case], case)
    np.testing.assert_allclose(w("moe")[case + "_aux"],
                               w.refs["moe"][case + "_aux"], rtol=TOL_FWD)
    assert w("moe")[case + "_aux"] > 0.0


def test_moe_tight_capacity_drops_tokens(worlds):
    """Capacity 0.25 drops some tokens: their rows are zero, and the
    kept ones equal dense dispatch's."""
    got = worlds[2]("moe")
    cap = got["tight_capacity"][0]
    kept = np.abs(cap).sum(axis=1) > 0
    assert 0 < kept.sum() < len(kept)


def test_moe_capacity_flops_stay_flat_in_the_expert_count(worlds):
    flops = worlds[2]("moe")["flops"]
    assert flops[(8, None)] > 2.5 * flops[(2, None)]
    assert flops[(8, 1.0)] < 1.6 * flops[(2, 1.0)]


def test_switch_mlp_balance_axis_of_one_rank_is_the_plain_loss():
    from bigdl_tpu_torch.parallel import switch_mlp

    class _Axis:
        size = 1

    r = np.random.RandomState(0)
    p = {"gate": torch.tensor(r.randn(8, 4).astype(np.float32)),
         "w1": torch.tensor(r.randn(4, 8, 16).astype(np.float32)),
         "w2": torch.tensor(r.randn(4, 16, 8).astype(np.float32))}
    x = torch.tensor(r.randn(12, 8).astype(np.float32))
    y1, a1 = switch_mlp(p, x, balance_axis=_Axis())
    y2, a2 = switch_mlp(p, x)
    assert torch.equal(y1, y2) and torch.equal(a1, a2)
