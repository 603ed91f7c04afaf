"""bigdl_tpu_torch's sequence parallelism against the JAX package's, on
the CPU: ring attention (blocks and flash), Ulysses, the
sequence-parallel self-attention, the sequence-parallel TransformerLM
(``models/transformer/sp.py``) and the ``long_context_lm`` CLI.

The reference runs in this process on the conftest's virtual CPU
devices, on meshes of 2 and 4.  The port runs one rank per device under
gloo: a world of 2 and a world of 4 ranks, each started once for the
module with ``torch.multiprocessing`` (``spawn``; the ranks import this
module, which imports nothing of JAX at its top), meeting over a
``file://`` store.  Every rank passes the same global tensors, made
from a seed with numpy; weights cross from the reference through
``params_from_numpy``.  Tolerances: outputs within 1e-5 of their
largest magnitude; gradients within 1e-4 of each leaf's largest |g|,
that largest taken no lower than 1e-3 of the case's largest |g| (``bk``'s
gradient is zero in exact arithmetic: rounding noise on both sides).
"""
import os
import pickle
import time
import traceback

import numpy as np
import pytest
import torch

B, H, T, D = 2, 4, 32, 16
TOL_FWD, TOL_GRAD = 1e-5, 1e-4
WORLDS = (2, 4)


# --------------------------------------------------------------------- #
# shared inputs                                                         #
# --------------------------------------------------------------------- #
def _qkv(seed):
    r = np.random.RandomState(seed)
    return [r.randn(B, H, T, D).astype(np.float32) for _ in range(3)]


def _segs(n_docs, seed, t=T):
    """(B, t) int32 ids of ``n_docs`` documents cut at seeded places."""
    r = np.random.RandomState(seed)
    cuts = np.sort(r.choice(np.arange(1, t), n_docs - 1, replace=False))
    seg = np.zeros((B, t), np.int32)
    for c in cuts:
        seg[:, c:] += 1
    return seg


def _attention_cases():
    cases = {}
    for causal in (False, True):
        c = "causal" if causal else "full"
        for impl in ("blocks", "flash"):
            cases[f"ring_{impl}_{c}"] = dict(kind="ring", impl=impl,
                                            causal=causal, seg=None, seed=3)
            cases[f"ring_{impl}_seg_{c}"] = dict(
                kind="ring", impl=impl, causal=causal, seg=_segs(4, 12),
                seed=11)
        cases[f"ulysses_{c}"] = dict(kind="ulysses", causal=causal, seg=None,
                                     seed=5)
        cases[f"ulysses_seg_{c}"] = dict(kind="ulysses", causal=causal,
                                         seg=_segs(3, 14), seed=13)
    for c in cases.values():
        c["qkv"] = _qkv(c["seed"])
    return cases


ATTENTION = _attention_cases()

#: the sequence-parallel LM cases, each on one world size (the
#: reference's compile time bounds the file's): model config, build seed,
#: apply, whether the mesh has a data axis
LM_CASES = {
    "ring": dict(model=dict(vocab_size=11, hidden_size=16, n_head=2,
                            n_layers=2, max_len=16), seed=1, apply="ring",
                 n=4),
    "ring_flash_remat": dict(model=dict(vocab_size=11, hidden_size=16,
                                        n_head=2, n_layers=2, max_len=16,
                                        attention_impl="flash", remat=True),
                             seed=3, apply="ring", n=2),
    "ulysses": dict(model=dict(vocab_size=11, hidden_size=16, n_head=4,
                               n_layers=2, max_len=16), seed=1,
                    apply="ulysses", n=4),
    "isolation_ring": dict(model=dict(vocab_size=24, hidden_size=16,
                                      n_head=4, n_layers=2, max_len=32,
                                      pos_encoding="rope", doc_start_id=7),
                           seed=5, apply="ring", n=2),
    "isolation_ring_flash": dict(model=dict(
        vocab_size=24, hidden_size=16, n_head=4, n_layers=2, max_len=32,
        pos_encoding="rope", doc_start_id=7, attention_impl="flash"),
        seed=5, apply="ring", n=4),
    "isolation_ulysses": dict(model=dict(vocab_size=24, hidden_size=16,
                                         n_head=4, n_layers=2, max_len=32,
                                         pos_encoding="rope",
                                         doc_start_id=7),
                              seed=5, apply="ulysses", n=2),
    "data_x_sequence": dict(model=dict(vocab_size=11, hidden_size=16,
                                       n_head=2, n_layers=2, max_len=16),
                            seed=1, apply="ring", data=True, n=4),
}


def _lm_cases(n):
    return {k: c for k, c in LM_CASES.items() if c["n"] == n}


def _lm_ids(case):
    cfg = case["model"]
    if "doc_start_id" in cfg:
        # markers only where placed: the first token and three more a row
        start, t = cfg["doc_start_id"], cfg["max_len"]
        r = np.random.RandomState(6)
        ids = r.randint(2, 20, size=(2, t)).astype(np.float32)
        ids[ids == start] = 2
        for b in range(2):
            for pos in r.choice(np.arange(1, t), 3, replace=False):
                ids[b, pos] = start
        ids[:, 0] = start
        return ids
    rows = 4 if case.get("data") else 2
    return np.random.RandomState(0).randint(
        1, cfg["vocab_size"] + 1, size=(rows, cfg["max_len"])
    ).astype(np.float32)


def _lm_axes(case, n):
    if case.get("data"):
        return {"data": 2, "sequence": n // 2}
    return {"sequence": n}


#: the CLI at a small width: ids and labels from the CLI's own seed
CLI = ["-t", "32", "-b", "2", "--vocabSize", "50", "--hiddenSize", "32",
       "--nHead", "4", "--nLayers", "1", "-i", "2"]


# --------------------------------------------------------------------- #
# the ranks (this module's top imports no JAX)                          #
# --------------------------------------------------------------------- #
def _np(t):
    return t.detach().float().numpy()


def port_attention(rank, world):
    from bigdl_tpu_torch.parallel import (create_mesh, ring_attention,
                                          ulysses_attention)
    mesh = create_mesh({"sequence": world}, "cpu")
    out = {}
    for name, c in ATTENTION.items():
        q, k, v = (torch.tensor(a, requires_grad=True) for a in c["qkv"])
        seg = None if c["seg"] is None else torch.tensor(c["seg"])
        if c["kind"] == "ring":
            y = ring_attention(q, k, v, mesh, causal=c["causal"],
                               impl=c["impl"], segment_ids=seg)
        else:
            y = ulysses_attention(q, k, v, mesh, causal=c["causal"],
                                  segment_ids=seg)
        g = torch.autograd.grad((y ** 2).sum(), (q, k, v))
        out[name] = (_np(y), [_np(t) for t in g])
    return out


def port_self_attention(rank, world, params, x):
    from bigdl_tpu_torch import nn
    from bigdl_tpu_torch.parallel import (create_mesh,
                                          sequence_parallel_self_attention)
    from bigdl_tpu_torch.utils.params import params_from_numpy
    from bigdl_tpu_torch.utils.pytree import tree_leaves
    mesh = create_mesh({"sequence": world}, "cpu")
    mha = nn.MultiHeadAttention(32, 8, causal=True)
    out = {}
    for kind in ("ring", "ulysses"):
        p = params_from_numpy(params, "cpu")
        leaves = tree_leaves(p)
        xt = torch.tensor(x, requires_grad=True)
        for t in leaves:
            t.requires_grad_(True)
        y = sequence_parallel_self_attention(mha, p, xt, mesh, kind=kind)
        g = torch.autograd.grad((y ** 2).sum(), leaves + [xt])
        out[kind] = (_np(y), [_np(t) for t in g])
    return out


def port_lm(rank, world, params):
    from bigdl_tpu_torch.models import TransformerLM
    from bigdl_tpu_torch.models.transformer.sp import (ring_lm_apply,
                                                       ulysses_lm_apply)
    from bigdl_tpu_torch.parallel import create_mesh
    from bigdl_tpu_torch.utils.params import params_from_numpy
    from bigdl_tpu_torch.utils.pytree import tree_leaves
    out = {}
    for name, case in _lm_cases(world).items():
        mesh = create_mesh(_lm_axes(case, world), "cpu")
        m = TransformerLM(device="cpu", **case["model"])
        m.params = params_from_numpy(params[name], "cpu")
        leaves = tree_leaves(m.params)
        for t in leaves:
            t.requires_grad_(True)
        ids = torch.tensor(_lm_ids(case))
        if case["apply"] == "ring":
            y = ring_lm_apply(m, m.params, ids, mesh,
                              data_axis="data" if case.get("data") else None)
        else:
            y = ulysses_lm_apply(m, m.params, ids, mesh)
        g = torch.autograd.grad((y ** 2).mean(), leaves)
        out[name] = (_np(y), [_np(t) for t in g])
    # Ulysses refuses a head count the axis does not divide
    m = TransformerLM(vocab_size=11, hidden_size=18, n_head=3, n_layers=1,
                      max_len=16, device="cpu").build(0)
    try:
        ulysses_lm_apply(m, m.params, torch.ones(2, 16), create_mesh(
            {"sequence": world}, "cpu"))
        out["refusal"] = None
    except ValueError as e:
        out["refusal"] = str(e)
    return out


def port_cli(rank, world):
    from bigdl_tpu_torch.example import long_context_lm
    return {mode: long_context_lm.main(CLI + ["--sp", str(world),
                                              "--device", "cpu"] + flags)
            for mode, flags in (("ring_flash", ["--flash"]),
                                ("ulysses", ["--ulysses", "--remat"]))}


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


def ref_attention(n):
    import jax
    import jax.numpy as jnp
    from bigdl_tpu.parallel import ring_attention, ulysses_attention
    mesh = _ref_mesh({"sequence": n})
    out = {}
    for name, c in ATTENTION.items():
        seg = None if c["seg"] is None else jnp.asarray(c["seg"])

        def loss(q, k, v, c=c, seg=seg):
            if c["kind"] == "ring":
                y = ring_attention(q, k, v, mesh, causal=c["causal"],
                                   impl=c["impl"], segment_ids=seg,
                                   block_size=T // n)
            else:
                y = ulysses_attention(q, k, v, mesh, causal=c["causal"],
                                      segment_ids=seg)
            return jnp.sum(y ** 2), y
        (_, y), g = jax.jit(jax.value_and_grad(
            loss, argnums=(0, 1, 2), has_aux=True))(
            *map(jnp.asarray, c["qkv"]))
        out[name] = (np.asarray(y), [np.asarray(t) for t in g])
    return out


def _ref_mha():
    from bigdl_tpu import nn as jnn
    return jnn.MultiHeadAttention(32, 8, causal=True).build(seed=3)


def _self_attention_x():
    return np.random.RandomState(3).randn(2, T, 32).astype(np.float32)


def ref_self_attention(n):
    import jax
    import jax.numpy as jnp
    from bigdl_tpu.parallel import sequence_parallel_self_attention
    mesh = _ref_mesh({"sequence": n})
    mha = _ref_mha()
    out = {}
    for kind in ("ring", "ulysses"):
        def loss(p, xx, kind=kind):
            y = sequence_parallel_self_attention(mha, p, xx, mesh, kind=kind)
            return jnp.sum(y ** 2), y
        (_, y), g = jax.jit(jax.value_and_grad(
            loss, argnums=(0, 1), has_aux=True))(
            mha.params, jnp.asarray(_self_attention_x()))
        out[kind] = (np.asarray(y), _leaves_np(g[0]) + [np.asarray(g[1])])
    return out


def _ref_lm_model(case):
    from bigdl_tpu.models import TransformerLM as JaxLM
    return JaxLM(**case["model"]).build(seed=case["seed"])


def ref_lm(n):
    import jax
    import jax.numpy as jnp
    from bigdl_tpu.models.transformer.sp import (ring_lm_apply,
                                                 ulysses_lm_apply)
    out = {}
    for name, case in _lm_cases(n).items():
        m = _ref_lm_model(case)
        mesh = _ref_mesh(_lm_axes(case, n))
        ids = jnp.asarray(_lm_ids(case))

        def loss(p, m=m, mesh=mesh, ids=ids, case=case):
            if case["apply"] == "ring":
                y = ring_lm_apply(m, p, ids, mesh, data_axis=(
                    "data" if case.get("data") else None))
            else:
                y = ulysses_lm_apply(m, p, ids, mesh)
            return jnp.mean(y ** 2), y
        (_, y), g = jax.jit(jax.value_and_grad(loss, has_aux=True))(
            m.params)
        out[name] = (np.asarray(y), _leaves_np(g))
    return out


def _jobs(n):
    """The ranks' jobs, with the reference's weights for their inputs."""
    return [("attention", "port_attention", {}),
            ("self_attention", "port_self_attention",
             dict(params=_tree_np(_ref_mha().params),
                  x=_self_attention_x())),
            ("lm", "port_lm", dict(params={
                name: _tree_np(_ref_lm_model(case).params)
                for name, case in _lm_cases(n).items()})),
            ("cli", "port_cli", {})]


def _close(got, want, tol, name="", scale=None):
    """max |got - want| <= tol * scale (default: max |want|)."""
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, (name, got.shape, want.shape)
    assert np.isfinite(got).all(), name
    err = np.abs(got - want).max() if got.size else 0.0
    bound = tol * (np.abs(want).max() if scale is None else scale)
    assert err <= bound, f"{name}: {err} > {bound}"


def _check_grads(got, want, name):
    """Each leaf within TOL_GRAD of its max |g|, that max taken no lower
    than 1e-3 of the largest |g| of the case (a gradient that is zero in
    exact arithmetic, ``bk``'s, is rounding noise on both sides)."""
    assert len(got) == len(want)
    top = max(np.abs(w).max() for w in want)
    for i, (a, b) in enumerate(zip(got, want)):
        _close(a, b, TOL_GRAD, f"{name} gradient {i}",
               scale=max(np.abs(b).max(), 1e-3 * top))


def _check(got, want, name):
    (y, g), (y_ref, g_ref) = got, want
    _close(y, y_ref, TOL_FWD, f"{name} output")
    _check_grads(g, g_ref, name)


# --------------------------------------------------------------------- #
# fixtures                                                              #
# --------------------------------------------------------------------- #
@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    """The worlds of 2 and 4 ranks, each spawned once; the reference's
    runs for the same inputs are computed here while the ranks run."""
    outs, ctxs = {}, {}
    for n in WORLDS:
        outs[n] = tmp_path_factory.mktemp(f"world{n}")
        ctxs[n] = _start(n, _jobs(n), outs[n])
    deadline = time.monotonic() + 400
    try:
        refs = {n: {"attention": ref_attention(n),
                    "self_attention": ref_self_attention(n),
                    "lm": ref_lm(n)} for n in WORLDS}
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


@pytest.fixture(scope="module")
def world1(tmp_path_factory):
    """A gloo world of one in this process, torn down after the module."""
    from bigdl_tpu_torch.parallel.mesh import init_world, shutdown_world
    store = tmp_path_factory.mktemp("world1") / "store"
    init_world("cpu", init_method=f"file://{store}", rank=0, world_size=1)
    yield
    shutdown_world()


@pytest.fixture(scope="module")
def ref_cli_loss():
    """The reference CLI's printed final loss and its model's step-0 loss
    on the CLI's ids, at the CLI's small width (every mode computes the
    same function, so one single-device run serves them all)."""
    import contextlib
    import io

    import jax.numpy as jnp
    from bigdl_tpu import nn as jnn
    from bigdl_tpu.example import long_context_lm
    from bigdl_tpu.models import TransformerLM as JaxLM
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        long_context_lm.main(CLI)
    final = float(buf.getvalue().rsplit("loss", 1)[1])
    m = JaxLM(vocab_size=50, hidden_size=32, n_head=4, n_layers=1,
              max_len=32).build(seed=1)
    rng = np.random.RandomState(0)
    ids = rng.randint(1, 51, size=(2, 32)).astype(np.float32)
    labels = rng.randint(1, 51, size=(2, 32)).astype(np.float32)
    crit = jnn.TimeDistributedCriterion(jnn.ClassNLLCriterion(), True)
    first = float(crit.loss(m.apply(m.params, jnp.asarray(ids))[0],
                            jnp.asarray(labels)))
    return first, final


def _check_cli(run, ref):
    first, final = ref
    np.testing.assert_allclose(run["first_loss"], first, rtol=1e-5)
    # the reference prints four decimals
    assert abs(run["loss"] - final) <= 5e-5 + 1e-5 * abs(final), \
        (run["loss"], final)


# --------------------------------------------------------------------- #
# ring and Ulysses attention                                            #
# --------------------------------------------------------------------- #
@pytest.mark.parametrize("n", WORLDS)
@pytest.mark.parametrize("case", sorted(ATTENTION))
def test_attention_matches_the_reference(worlds, n, case):
    w = worlds[n]
    _check(w("attention")[case], w.refs["attention"][case], case)


@pytest.mark.parametrize("n", WORLDS)
def test_every_rank_returns_the_global_output(worlds, n):
    first, last = worlds[n]("attention"), worlds[n]("attention", n - 1)
    for case in ATTENTION:
        np.testing.assert_array_equal(first[case][0], last[case][0])
        for a, b in zip(first[case][1], last[case][1]):
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("n", WORLDS)
@pytest.mark.parametrize("kind", ["ring", "ulysses"])
def test_sequence_parallel_self_attention(worlds, n, kind):
    w = worlds[n]
    _check(w("self_attention")[kind], w.refs["self_attention"][kind], kind)


def _hop_inputs(seed=21):
    r = np.random.RandomState(seed)
    q, k, v = (r.randn(1, 2, 32, 16).astype(np.float32) for _ in range(3))
    # document 1 starts at 20: rows 20..31 of shard 1 see no key of shard 0
    seg = np.zeros((1, 32), np.int32)
    seg[:, 20:] = 1
    return q, k, v, seg


@pytest.mark.parametrize("impl", ["blocks", "flash"])
@pytest.mark.parametrize("scenario", ["late_first_key", "skipped_hop"])
def test_ring_hop_merges_from_the_empty_state(impl, scenario):
    """The merge's identity is -inf: a hop that shard 1's rows 20..31 see
    nothing of (their document starts in shard 1, and the hop from shard
    0 comes first), and a causal hop from the future that is skipped,
    both leave finite values and gradients equal to plain attention's
    over the whole sequence."""
    import jax
    import jax.numpy as jnp
    from bigdl_tpu.nn.attention import dot_product_attention as jdpa

    from bigdl_tpu_torch.parallel.sequence import (ring_finish, ring_hop,
                                                   ring_init)
    q, k, v, seg = _hop_inputs()
    if scenario == "late_first_key":
        rank, order, causal = 1, (0, 1), False
    else:
        rank, order, causal = 0, (1, 0), True
    lo, hi = 16 * rank, 16 * rank + 16
    blocks = {s: (torch.tensor(k[:, :, 16 * s:16 * s + 16], requires_grad=True),
                  torch.tensor(v[:, :, 16 * s:16 * s + 16], requires_grad=True))
              for s in (0, 1)}
    qt = torch.tensor(q[:, :, lo:hi], requires_grad=True)
    seg_t = torch.tensor(seg)
    state = ring_init(qt, impl)
    for src in order:
        state = ring_hop(state, qt, *blocks[src], rank=rank, src=src,
                         causal=causal, impl=impl,
                         segment_ids=seg_t[:, lo:hi],
                         kv_segment_ids=seg_t[:, 16 * src:16 * src + 16])
    o = ring_finish(state, qt, impl)
    leaves = [qt] + [t for s in (0, 1) for t in blocks[s]]
    grads = torch.autograd.grad((o ** 2).sum(), leaves, allow_unused=True)
    # a block only a skipped hop held gets no gradient at all
    grads = [torch.zeros_like(t) if g is None else g
             for t, g in zip(leaves, grads)]

    mask = jnp.asarray(seg[:, None, :, None] == seg[:, None, None, :])

    def loss(q, k, v):
        y = jdpa(q, k, v, causal=causal, mask=mask)[:, :, lo:hi]
        return jnp.sum(y ** 2), y
    (_, want), g = jax.value_and_grad(loss, argnums=(0, 1, 2), has_aux=True)(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    _close(_np(o), np.asarray(want), TOL_FWD, "output")
    g = [np.asarray(t) for t in g]
    wants = [g[0][:, :, lo:hi]] + [
        t[:, :, 16 * s:16 * s + 16] for s in (0, 1) for t in g[1:]]
    _check_grads([_np(a) for a in grads], wants, scenario)
    if scenario == "skipped_hop":
        # the future block was never read: its gradient is zero
        assert not _np(grads[3]).any() and not _np(grads[4]).any()


def test_one_rank_collectives_are_the_identity(world1):
    """On an axis of one rank the ring permute and the region functions
    return their inputs: nothing is copied or launched (the card's world
    of one)."""
    from bigdl_tpu_torch.parallel import MeshAxis, create_mesh, ring_permute
    from bigdl_tpu_torch.parallel.mesh import (copy_to_axis,
                                               gather_from_axis,
                                               reduce_from_axis,
                                               scatter_to_axis)
    mesh = create_mesh({"sequence": 1}, "cpu")
    axis = MeshAxis(mesh, "sequence")
    assert (axis.size, axis.index, axis.ranks) == (1, 0, [0])
    x = torch.ones(2, 3, requires_grad=True)
    seg = torch.zeros(2, 3, dtype=torch.int32)
    assert ring_permute(x, axis) is x
    assert all(a is b for a, b in zip(ring_permute((x, seg), axis),
                                      (x, seg)))
    assert scatter_to_axis(x, mesh, "sequence", 1) is x
    assert gather_from_axis(x, mesh, "sequence", 1) is x
    assert reduce_from_axis(x, mesh, "sequence") is x
    assert copy_to_axis([x], mesh, "sequence")[0] is x


def test_ring_refuses_an_unknown_impl(world1):
    from bigdl_tpu_torch.parallel import create_mesh, ring_attention
    mesh = create_mesh({"sequence": 1}, "cpu")
    q = torch.zeros(1, 1, 4, 8)
    with pytest.raises(ValueError, match="impl"):
        ring_attention(q, q, q, mesh, impl="pallas")


# --------------------------------------------------------------------- #
# the sequence-parallel LM                                              #
# --------------------------------------------------------------------- #
@pytest.mark.parametrize("case", sorted(LM_CASES))
def test_sp_lm_matches_the_reference(worlds, case):
    w = worlds[LM_CASES[case]["n"]]
    _check(w("lm")[case], w.refs["lm"][case], case)


@pytest.mark.parametrize("n", WORLDS)
def test_ulysses_lm_refuses_heads_the_axis_does_not_divide(worlds, n):
    msg = worlds[n]("lm")["refusal"]
    assert msg is not None and "divisible" in msg


def _tiny_lm(**kw):
    from bigdl_tpu_torch.models import TransformerLM
    cfg = dict(vocab_size=5, hidden_size=8, n_head=2, n_layers=1, max_len=8)
    cfg.update(kw)
    return TransformerLM(device="cpu", **cfg).build(0)


@pytest.mark.parametrize("what", ["dropout", "MoE", "max_len"])
def test_sp_lm_refusals(world1, what):
    from bigdl_tpu_torch.models.transformer.sp import ring_lm_apply
    from bigdl_tpu_torch.parallel import create_mesh
    mesh = create_mesh({"sequence": 1}, "cpu")
    if what == "dropout":
        m, ids = _tiny_lm(dropout=0.1), torch.ones(2, 8)
    elif what == "MoE":
        m, ids = _tiny_lm(moe_experts=2), torch.ones(2, 8)
    else:
        m, ids = _tiny_lm(), torch.ones(2, 16)
    with pytest.raises(ValueError, match=what):
        ring_lm_apply(m, m.params, ids, mesh)


# --------------------------------------------------------------------- #
# the long_context_lm CLI                                               #
# --------------------------------------------------------------------- #
@pytest.mark.parametrize("flags", [["--flash", "--remat"], ["--sp", "1"],
                                   ["--sp", "1", "--flash"],
                                   ["--sp", "1", "--ulysses"]],
                         ids=["single_flash_remat", "sp1_ring",
                              "sp1_ring_flash", "sp1_ulysses"])
def test_cli_matches_the_reference(world1, ref_cli_loss, flags, capsys):
    from bigdl_tpu_torch.example import long_context_lm
    run = long_context_lm.main(CLI + ["--device", "cpu"] + flags)
    _check_cli(run, ref_cli_loss)
    line = capsys.readouterr().out
    assert "ms/step" in line and "tokens/s" in line and "loss" in line
    assert run["mode"] == ("single-device" if "--sp" not in flags else
                           f"sp=1 ({'ulysses' if '--ulysses' in flags else 'ring'})")


@pytest.mark.parametrize("n", WORLDS)
@pytest.mark.parametrize("mode", ["ring_flash", "ulysses"])
def test_cli_over_a_world_matches_the_reference(worlds, ref_cli_loss, n,
                                                mode):
    run = worlds[n]("cli")[mode]
    assert run["mode"] == f"sp={n} ({mode.split('_')[0]})"
    _check_cli(run, ref_cli_loss)


def test_cli_without_a_world_says_how_to_start_one(monkeypatch):
    import torch.distributed as dist

    from bigdl_tpu_torch.example import long_context_lm
    monkeypatch.setattr(dist, "is_initialized", lambda: False)
    monkeypatch.delenv("WORLD_SIZE", raising=False)
    with pytest.raises(ValueError, match="torchrun --nproc_per_node 4"):
        long_context_lm.main(CLI + ["--sp", "4", "--device", "cpu"])


def test_cli_refuses_a_world_of_another_size(world1):
    from bigdl_tpu_torch.example import long_context_lm
    with pytest.raises(ValueError, match="world of 2 ranks"):
        long_context_lm.main(CLI + ["--sp", "2", "--device", "cpu"])
