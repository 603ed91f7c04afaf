"""bigdl_tpu_torch's data-parallel engine against the JAX package's, on
the CPU: the mesh, ``CompressedTensor``, ``AllReduceParameter``,
``DistriOptimizer``/``DistriValidator``, ``DistributedDataSet``,
``Metrics.aggregate``, ``Optimizer.create``, the collective footprint,
the traced run and every ``--distributed`` entry point.

The reference runs in this process on a ``data_parallel_mesh(n)`` of
the conftest's virtual CPU devices.  The port runs one rank per device
under gloo: a world of two ranks started once for the module with
``torch.multiprocessing`` (``spawn``: this process has imported JAX and
its threads; the ranks import this module, which imports the port and
nothing of JAX at its top), and a world of one in this process.  Both
meet over a ``file://`` store under the test's temporary directory, so
no TCP port is taken.  The port's ranks read the same global batch
split into contiguous row blocks, rank order.
"""
import logging
import os
import pickle
import time
import traceback

import numpy as np
import pytest
import torch

# --------------------------------------------------------------------- #
# shared by the ranks and the reference (the nn module is a parameter)  #
# --------------------------------------------------------------------- #
LR = 1e-3
STEPS = 3
GLOBAL_BATCH = 8


def _model(nn, name):
    if name == "lenet":
        from importlib import import_module
        pkg = nn.__name__.split(".")[0]
        return import_module(f"{pkg}.models.lenet").LeNet5(10)
    if name == "bn":
        # no bias ahead of the batch norm: its gradient is 0 in exact
        # arithmetic, so its Adam steps would follow rounding noise
        return nn.Sequential(
            nn.SpatialConvolution(1, 4, 3, 3, 1, 1, 1, 1, with_bias=False),
            nn.SpatialBatchNormalization(4), nn.ReLU(),
            nn.SpatialMaxPooling(2, 2, 2, 2), nn.Reshape((4 * 4 * 4,)),
            nn.Linear(64, 10), nn.LogSoftMax())
    if name == "mlp":
        return nn.Sequential(nn.Linear(16, 32), nn.ReLU(), nn.Linear(32, 4),
                             nn.LogSoftMax())
    if name == "mlp_bn":
        return nn.Sequential(nn.Linear(16, 32), nn.BatchNormalization(32),
                             nn.ReLU(), nn.Linear(32, 4), nn.LogSoftMax())
    raise ValueError(name)


def _batches(name, seed=0):
    """STEPS global batches of seeded inputs and 1-based labels."""
    rs = np.random.RandomState(seed)
    shape = {"lenet": (1, 28, 28), "bn": (1, 8, 8), "mlp": (16,),
             "mlp_bn": (16,)}[name]
    classes = 4 if name.startswith("mlp") else 10
    return [(rs.randn(GLOBAL_BATCH, *shape).astype(np.float32),
             (rs.randint(0, classes, GLOBAL_BATCH) + 1).astype(np.float32))
            for _ in range(STEPS)]


def _fixed_dataset(base, minibatch, batches, rank, world):
    """A dataset of fixed batches, rank ``rank``'s row block of each,
    in order, never shuffled: the same global batches on both sides."""

    class Fixed(base):
        def size(self):
            return sum(len(x) for x, _ in batches)

        def data(self, train):
            def blocks():
                for x, y in batches:
                    b = len(x) // world
                    yield minibatch(x[rank * b:(rank + 1) * b],
                                    y[rank * b:(rank + 1) * b])

            def forever():
                while True:
                    yield from blocks()
            return forever() if train else blocks()
    return Fixed()


class _Losses(logging.Handler):
    def __init__(self):
        super().__init__(logging.INFO)
        self.losses = []

    def emit(self, record):
        if str(record.msg).startswith("Epoch %d iteration %d"):
            self.losses.append(float(record.args[2]))


def _capture_losses(logger_name):
    logger = logging.getLogger(logger_name)
    h = _Losses()
    logger.setLevel(logging.INFO)
    logger.addHandler(h)
    return logger, h


# --------------------------------------------------------------------- #
# the port's side (runs in the ranks and in this process)               #
# --------------------------------------------------------------------- #
def port_parity(rank, world, name, params, buffers, batches, mesh_n=None):
    from bigdl_tpu_torch import nn
    from bigdl_tpu_torch.dataset.dataset import AbstractDataSet
    from bigdl_tpu_torch.dataset.types import MiniBatch
    from bigdl_tpu_torch.optim import Adam, Trigger
    from bigdl_tpu_torch.parallel import DistriOptimizer
    from bigdl_tpu_torch.utils.params import (params_from_numpy,
                                              params_to_numpy)
    model = _model(nn, name).build(seed=1, device="cpu")
    model.params = params_from_numpy(params, "cpu")
    model.buffers = params_from_numpy(buffers, "cpu")
    ds = _fixed_dataset(AbstractDataSet, MiniBatch, batches, rank, world)
    opt = DistriOptimizer(model, ds, nn.ClassNLLCriterion())
    opt.set_optim_method(Adam(learning_rate=LR)) \
       .set_end_when(Trigger.max_iteration(STEPS))
    logger, h = _capture_losses("bigdl_tpu_torch.optim")
    try:
        opt.optimize()
    finally:
        logger.removeHandler(h)
    state = opt.optim_method._state
    return {"losses": h.losses, "params": params_to_numpy(model.params),
            "buffers": params_to_numpy(model.buffers),
            "m": state["m"].numpy(), "v": state["v"].numpy(),
            "iteration": int(state["iteration"])}


def port_cycle(rank, world, w, grads):
    from bigdl_tpu_torch.parallel import AllReduceParameter
    params = {"w": torch.from_numpy(w)}
    arp = AllReduceParameter(params, world)
    shard = arp.init_shards(params)[rank].clone()
    w_full = arp.gather_weights(shard)
    g = arp.scatter_gradients({"w": torch.from_numpy(grads[: arp.size])})
    return {"w_full": w_full.numpy(), "g_slice": g.numpy(),
            "slice_size": arp.slice_size, "padded": arp.padded_size,
            "ops": [(op, str(dt), n) for op, dt, n in arp.record.ops]}


def port_metrics(rank, world):
    from bigdl_tpu_torch.optim.metrics import Metrics
    m = Metrics()
    m.set("computing time", float(rank + 1), parallel=2)
    m.add("records", 10.0 * (rank + 1), unit="")
    out = m.aggregate()
    return {"computing": out.get("computing time"),
            "records": out.get("records"), "summary": out.summary()}


def port_mesh(rank, world):
    from bigdl_tpu_torch.parallel import (DATA_AXIS, MODEL_AXIS, create_mesh,
                                          data_parallel_mesh)
    mesh = data_parallel_mesh()
    out = {"default": (int(mesh.size()), tuple(mesh.mesh_dim_names)),
           "multi": tuple(create_mesh({DATA_AXIS: 1, MODEL_AXIS: 2})
                          .mesh.shape),
           "minus_one": tuple(create_mesh({DATA_AXIS: -1, MODEL_AXIS: 2})
                              .mesh.shape)}
    try:
        create_mesh({DATA_AXIS: 3})
        out["bad"] = "no error"
    except ValueError as e:
        out["bad"] = str(e)
    sub = data_parallel_mesh(1)
    out["sub_member"] = sub.get_coordinate() is not None
    return out


def port_footprint(rank, world, name, params, buffers, batches, clip):
    """One SGD iteration with L2 clipping: the footprint, its wire bytes
    and the phase summary."""
    from bigdl_tpu_torch import nn
    from bigdl_tpu_torch.dataset.dataset import AbstractDataSet
    from bigdl_tpu_torch.dataset.types import MiniBatch
    from bigdl_tpu_torch.optim import SGD, Trigger
    from bigdl_tpu_torch.parallel import DistriOptimizer
    from bigdl_tpu_torch.utils import profiling
    from bigdl_tpu_torch.utils.params import params_from_numpy
    model = _model(nn, name).build(seed=1, device="cpu")
    model.params = params_from_numpy(params, "cpu")
    model.buffers = params_from_numpy(buffers, "cpu")
    ds = _fixed_dataset(AbstractDataSet, MiniBatch, batches, rank, world)
    opt = DistriOptimizer(model, ds, nn.ClassNLLCriterion())
    opt.set_optim_method(SGD(learning_rate=0.1)) \
       .set_end_when(Trigger.max_iteration(2))
    if clip:
        opt.set_gradient_clipping_by_l2_norm(1.0)
    opt.optimize()
    fp = opt.collective_footprint()
    return {"footprint": fp, "wire": profiling.wire_bytes(fp, world),
            "summary": opt.metrics.summary()}


def _classification_samples(n=128, dim=6, seed=3):
    from bigdl_tpu_torch.dataset import Sample
    rs = np.random.RandomState(seed)
    return [Sample(rs.randn(dim).astype(np.float32) + (i % 2) * 2.0,
                   np.asarray(i % 2 + 1.0, dtype=np.float32))
            for i in range(n)]


def port_convergence(rank, world):
    """test_parallel's convergence run: a DistributedDataSet of 128
    records, 16 a rank a step, 5 epochs; DistriValidator sums the
    ranks' shards."""
    from bigdl_tpu_torch import nn
    from bigdl_tpu_torch.dataset import DataSet, SampleToBatch
    from bigdl_tpu_torch.optim import SGD, Optimizer, Top1Accuracy, Trigger
    from bigdl_tpu_torch.parallel import DistriOptimizer, DistriValidator
    ds = DataSet.array(_classification_samples(), distributed=True, seed=1) \
        >> SampleToBatch(16, drop_last=True)
    model = nn.Sequential(nn.Linear(6, 8), nn.Tanh(), nn.Linear(8, 2),
                          nn.LogSoftMax()).build(seed=1, device="cpu")
    opt = Optimizer.create(model, ds, nn.ClassNLLCriterion())
    assert isinstance(opt, DistriOptimizer)
    opt.set_optim_method(SGD(learning_rate=0.5)) \
       .set_end_when(Trigger.max_epoch(5))
    trained = opt.optimize()
    (_, res), = DistriValidator(trained, ds).test([Top1Accuracy()])
    return {"accuracy": res.result()[0], "count": res.count,
            "neval": opt.state["neval"], "epoch": opt.state["epoch"],
            "local_size": ds.source.local_size()}


def port_traced(rank, world, path):
    from bigdl_tpu_torch import nn
    from bigdl_tpu_torch.dataset import DataSet, Sample, SampleToBatch
    from bigdl_tpu_torch.obs import get_tracer
    from bigdl_tpu_torch.optim import SGD, Trigger
    from bigdl_tpu_torch.parallel import DistriOptimizer
    rs = np.random.RandomState(0)
    samples = [Sample(rs.randn(4).astype(np.float32),
                      np.asarray(float(i % 2) + 1, np.float32))
               for i in range(24)]
    ds = DataSet.array(samples) >> SampleToBatch(4, drop_last=True)
    m = nn.Sequential(nn.Linear(4, 8), nn.Tanh(), nn.Linear(8, 2),
                      nn.LogSoftMax()).build(seed=1, device="cpu")
    tr = get_tracer()
    tr.clear()
    tr.enable()
    opt = DistriOptimizer(m, ds, nn.ClassNLLCriterion())
    opt.set_optim_method(SGD(learning_rate=0.1)) \
       .set_end_when(Trigger.max_iteration(3))
    opt.optimize()
    doc = tr.export_chrome(f"{path}.{rank}")
    tr.enabled = False
    events = doc["traceEvents"]
    return {"names": sorted({e["name"] for e in events if e["ph"] == "X"}),
            "steps": [e["args"] for e in events
                      if e["name"] == "train/step"]}


def port_sweep(rank, world):
    from bigdl_tpu_torch.models.utils import perf
    r = perf.run_scaling_sweep("lenet5", 4, 1, [1, 2], warmup=1,
                               device="cpu", predict_sizes=(8,))
    return {"sweep": [{k: row[k] for k in (
        "mesh", "global_batch", "mean_step_s", "measured_efficiency",
        "collective_bytes_produced", "collective_wire_bytes_per_chip",
        "predicted_efficiency_interval")} for row in r["sweep"]],
        "predicted": r["predicted"], "ici_model": r["ici_model"]}


def _rank_main(rank, world, store, out_dir, jobs):
    torch.set_num_threads(2)
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


def _spawn(world, jobs, out_dir, timeout=300):
    import torch.multiprocessing as mp
    store = f"file://{os.path.join(out_dir, 'store')}"
    ctx = mp.start_processes(_rank_main, args=(world, store, str(out_dir),
                                               jobs),
                             nprocs=world, join=False, start_method="spawn")
    deadline = time.monotonic() + timeout
    while not ctx.join(timeout=1.0):
        if time.monotonic() > deadline:
            for p in ctx.processes:
                p.kill()
            raise AssertionError(f"the {world} ranks did not finish in "
                                 f"{timeout} s")


# --------------------------------------------------------------------- #
# the reference's side                                                  #
# --------------------------------------------------------------------- #
def _ref_build(name):
    import jax
    from bigdl_tpu import nn as jnn
    m = _model(jnn, name).build(seed=1)
    to_np = lambda t: jax.tree_util.tree_map(np.asarray, t)  # noqa: E731
    return m, to_np(m.params), to_np(m.buffers)


def _ref_dataset(batches):
    from bigdl_tpu.dataset.dataset import AbstractDataSet
    from bigdl_tpu.dataset.types import MiniBatch
    return _fixed_dataset(AbstractDataSet, MiniBatch, batches, 0, 1)


def _ref_mesh(n):
    import jax
    from bigdl_tpu.parallel import create_mesh
    from bigdl_tpu.parallel.mesh import DATA_AXIS
    return create_mesh({DATA_AXIS: n}, devices=jax.devices()[:n])


def ref_parity(name, n):
    import jax
    from bigdl_tpu import nn as jnn
    from bigdl_tpu.optim import Adam, Trigger
    from bigdl_tpu.parallel import DistriOptimizer
    m, params, buffers = _ref_build(name)
    batches = _batches(name)
    opt = DistriOptimizer(m, _ref_dataset(batches), jnn.ClassNLLCriterion(),
                          mesh=_ref_mesh(n))
    opt.set_optim_method(Adam(learning_rate=LR)) \
       .set_end_when(Trigger.max_iteration(STEPS))
    logger, h = _capture_losses("bigdl_tpu.optim")
    try:
        opt.optimize()
    finally:
        logger.removeHandler(h)
    to_np = lambda t: jax.tree_util.tree_map(np.asarray, t)  # noqa: E731
    state = opt.optim_method._state
    return ({"losses": h.losses, "params": to_np(m.params),
             "buffers": to_np(m.buffers), "m": np.asarray(state["m"]),
             "v": np.asarray(state["v"]),
             "iteration": int(state["iteration"])},
            dict(name=name, params=params, buffers=buffers, batches=batches))


def ref_footprint(name, n, clip):
    from bigdl_tpu import nn as jnn
    from bigdl_tpu.optim import SGD, Trigger
    from bigdl_tpu.parallel import DistriOptimizer
    m, params, buffers = _ref_build(name)
    batches = _batches(name, seed=1)
    opt = DistriOptimizer(m, _ref_dataset(batches), jnn.ClassNLLCriterion(),
                          mesh=_ref_mesh(n))
    opt.set_optim_method(SGD(learning_rate=0.1)) \
       .set_end_when(Trigger.max_iteration(2))
    if clip:
        opt.set_gradient_clipping_by_l2_norm(1.0)
    opt.optimize()
    return (opt.collective_footprint(),
            dict(name=name, params=params, buffers=buffers, batches=batches,
                 clip=clip))


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], f"{prefix}/{k}")
    else:
        yield prefix, np.asarray(tree)


def _assert_parity(got, want):
    """Loss within 1e-5 relative; every weight and buffer within 1e-5 +
    1e-5 relative (a tenth of LR: three Adam steps move a weight by up to
    3 x LR, and the two gradients meet bf16 transport rounding of their
    own float32 sums, so a rare element rounds to the neighbouring bf16
    value); the Adam moments within 1e-2 of each moment's largest value
    (that same rounding, 2^-8 relative, in one element of g)."""
    np.testing.assert_allclose(got["losses"], want["losses"], rtol=1e-5)
    for key in ("params", "buffers"):
        pairs = list(zip(_leaves(got[key]), _leaves(want[key])))
        assert [a for (a, _), _ in pairs] == [b for _, (b, _) in pairs]
        for (path, a), (_, b) in pairs:
            np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-5,
                                       err_msg=f"{key}{path}")
    for key in ("m", "v"):
        assert got[key].shape == want[key].shape
        np.testing.assert_allclose(got[key], want[key], rtol=0,
                                   atol=1e-2 * np.abs(want[key]).max())
    assert got["iteration"] == want["iteration"] == STEPS


# --------------------------------------------------------------------- #
# fixtures                                                              #
# --------------------------------------------------------------------- #
@pytest.fixture(scope="module")
def world2(tmp_path_factory):
    """Spawn the world of two once; every rank-side check writes its
    result, and the reference's run for the same inputs rides along."""
    out = tmp_path_factory.mktemp("world2")
    refs, jobs = {}, []
    for name in ("lenet", "bn"):
        refs[f"parity_{name}"], kw = ref_parity(name, 2)
        jobs.append((f"parity_{name}", "port_parity", kw))
    for name, clip in (("mlp", True), ("mlp_bn", True), ("mlp", False)):
        key = f"footprint_{name}_{clip}"
        refs[key], kw = ref_footprint(name, 2, clip)
        jobs.append((key, "port_footprint", kw))
    rs = np.random.RandomState(0)
    w = rs.randn(23).astype(np.float32)
    grads = np.arange(24, dtype=np.float32)
    refs["cycle"] = (w, grads)
    jobs += [("cycle", "port_cycle", dict(w=w, grads=grads)),
             ("metrics", "port_metrics", {}), ("mesh", "port_mesh", {}),
             ("convergence", "port_convergence", {}),
             ("traced", "port_traced",
              dict(path=str(out / "TRACE_TRAIN.json"))),
             ("sweep", "port_sweep", {})]
    _spawn(2, jobs, out)

    def result(name, rank=0):
        path = out / f"{name}.{rank}.pkl"
        assert path.exists(), f"rank {rank} wrote no result for {name}"
        with open(path, "rb") as f:
            res = pickle.load(f)
        assert "error" not in res, res.get("error")
        return res["ok"]
    result.refs = refs
    return result


@pytest.fixture(scope="module")
def world1(tmp_path_factory):
    """A gloo world of one in this process, torn down after the module."""
    from bigdl_tpu_torch.parallel.mesh import init_world, shutdown_world
    store = tmp_path_factory.mktemp("world1") / "store"
    init_world("cpu", init_method=f"file://{store}", rank=0, world_size=1)
    yield
    shutdown_world()


# --------------------------------------------------------------------- #
# mesh, codec, AllReduceParameter                                       #
# --------------------------------------------------------------------- #
class TestMesh:
    def test_default_all_devices(self, world2):
        assert world2("mesh")["default"] == (2, ("data",))
        assert world2("mesh", 1)["default"] == (2, ("data",))

    def test_multi_axis(self, world2):
        assert world2("mesh")["multi"] == (1, 2)

    def test_minus_one_axis(self, world2):
        assert world2("mesh")["minus_one"] == (1, 2)

    def test_bad_sizes(self, world2):
        assert "!= 2 ranks" in world2("mesh")["bad"]
        # a sub-mesh: rank 0 is in it, rank 1 is not
        assert world2("mesh", 0)["sub_member"]
        assert not world2("mesh", 1)["sub_member"]


class TestCompressedTensor:
    """Bitwise the reference's codec (both round through float32)."""

    def test_roundtrip_precision(self):
        from bigdl_tpu.parallel import CompressedTensor as J
        from bigdl_tpu_torch.parallel import CompressedTensor
        x = np.random.RandomState(0).randn(100)
        for dtype in ("bf16", "fp16"):
            back = CompressedTensor(x, dtype).decompress().numpy()
            np.testing.assert_allclose(back, x, rtol=2e-2, atol=1e-2)
            np.testing.assert_array_equal(back, J(x, dtype).decompress())

    def test_add(self):
        from bigdl_tpu_torch.parallel import CompressedTensor
        a = CompressedTensor(np.ones(10, np.float32))
        b = CompressedTensor(2 * np.ones(10, np.float32))
        np.testing.assert_allclose(a.add(b).decompress().numpy(), 3.0)

    def test_bytes(self):
        from bigdl_tpu_torch.parallel import CompressedTensor
        assert CompressedTensor(np.ones(10, np.float32)).bytes_size() == 20

    def test_bad_dtype(self):
        from bigdl_tpu_torch.parallel import CompressedTensor
        with pytest.raises(ValueError):
            CompressedTensor(np.ones(2), "fp8")


class TestAllReduceParameter:
    def test_shard_roundtrip_in_the_references_order(self):
        """init_shards / to_pytree: the reference's flat layout, bitwise
        (ravel_pytree order, zero padding to 8 slots)."""
        from bigdl_tpu import nn as jnn
        from bigdl_tpu.parallel import AllReduceParameter as J
        from bigdl_tpu_torch.parallel import AllReduceParameter
        from bigdl_tpu_torch.utils.params import params_from_numpy
        m = jnn.Sequential(jnn.Linear(5, 7), jnn.Linear(7, 3)).build(seed=0)
        jarp = J(m.params, 8)
        want = np.asarray(jarp.init_shards(m.params))
        params = params_from_numpy(m.params, "cpu")
        arp = AllReduceParameter(params, 8)
        shards = arp.init_shards(params)
        assert (arp.size, arp.padded_size, arp.slice_size) == (
            jarp.size, jarp.padded_size, jarp.slice_size)
        np.testing.assert_array_equal(shards.numpy(), want)
        back = arp.to_pytree(shards)
        for (pa, a), (pb, b) in zip(_leaves(back), _leaves(params)):
            assert pa == pb
            np.testing.assert_array_equal(a, b)

    def test_collective_cycle_over_two_ranks(self, world2):
        """gather -> scatter on 2 ranks: the full weights through bf16,
        and the mean of two equal gradient vectors is that vector
        through bf16 (bitwise: one rounding each way)."""
        import torch as t
        w, grads = world2.refs["cycle"]
        bf = lambda a: t.from_numpy(a).to(t.bfloat16).float().numpy()  # noqa
        for rank in (0, 1):
            r = world2("cycle", rank)
            assert r["padded"] == 24 and r["slice_size"] == 12
            np.testing.assert_array_equal(r["w_full"], bf(w))
            lo = rank * 12
            want = bf(np.pad(grads[:23], (0, 1)))[lo:lo + 12]
            np.testing.assert_array_equal(r["g_slice"], want)
            assert r["ops"] == [("all-gather", "torch.bfloat16", 24),
                                ("reduce-scatter", "torch.bfloat16", 12)]


# --------------------------------------------------------------------- #
# DistriOptimizer against the reference                                 #
# --------------------------------------------------------------------- #
@pytest.mark.parametrize("name", ["lenet", "bn"])
def test_distri_optimizer_matches_the_reference_on_two_ranks(world2, name):
    """Three Adam steps of a global batch of 8, 4 rows a rank, against
    the reference on a mesh of 2: losses, weights, BN buffers and the
    Adam moments (tolerances in ``_assert_parity``); both ranks publish
    the same model."""
    want = world2.refs[f"parity_{name}"]
    got0, got1 = world2(f"parity_{name}", 0), world2(f"parity_{name}", 1)
    _assert_parity(got0, want)
    for (p, a), (_, b) in zip(_leaves(got0["params"]),
                              _leaves(got1["params"])):
        np.testing.assert_array_equal(a, b, err_msg=p)
    np.testing.assert_array_equal(got0["m"], got1["m"])


@pytest.mark.parametrize("name", ["lenet", "bn"])
def test_distri_optimizer_matches_the_reference_on_one_rank(world1, name):
    """The same against a mesh of 1, the port a world of one in this
    process."""
    want, kw = ref_parity(name, 1)
    _assert_parity(port_parity(0, 1, **kw), want)


def test_step_gradients_is_the_training_steps_first_half(world1):
    """``step_gradients`` runs the code a training step runs: its loss is
    the first step's, its reduced slice (a world of one) is the bf16
    rounding of its local gradients, and one SGD step of that slice is
    the weights ``optimize()`` publishes (float32 within 1e-7)."""
    from bigdl_tpu_torch import nn
    from bigdl_tpu_torch.dataset.dataset import AbstractDataSet
    from bigdl_tpu_torch.dataset.types import MiniBatch
    from bigdl_tpu_torch.optim import SGD, Trigger
    from bigdl_tpu_torch.parallel import AllReduceParameter, DistriOptimizer
    batches = _batches("bn")
    model = _model(nn, "bn").build(seed=1, device="cpu")
    ds = _fixed_dataset(AbstractDataSet, MiniBatch, batches, 0, 1)
    opt = DistriOptimizer(model, ds, nn.ClassNLLCriterion()) \
        .set_optim_method(SGD(learning_rate=0.1)) \
        .set_end_when(Trigger.max_iteration(1))
    x, y = (torch.from_numpy(a) for a in batches[0])
    loss, grads, g_slice = opt.step_gradients(x, y)
    arp = AllReduceParameter(model.params, 1)
    w0 = arp.flatten(model.params).clone()
    assert torch.equal(g_slice, arp.flatten(grads).to(torch.bfloat16).float())
    opt.optimize()
    assert opt.state["loss"] == float(loss)
    # the step's own record holds one step, not step_gradients' calls
    assert [op for op, _, _ in opt._record.ops][:2] == ["all-gather",
                                                        "reduce-scatter"]
    torch.testing.assert_close(arp.flatten(model.params),
                               w0 - 0.1 * g_slice, rtol=0, atol=1e-7)


def test_convergence_over_a_distributed_dataset(world2):
    """test_parallel's convergence run on 2 ranks: every epoch is 4
    steps of 2 x 16 records, the validator sums both shards."""
    for rank in (0, 1):
        r = world2("convergence", rank)
        assert r["local_size"] == 64
        assert r["epoch"] == 6 and r["neval"] == 21
        assert r["count"] == 128 and r["accuracy"] > 0.95


def test_footprint_is_the_references_per_collective(world2, world1):
    """Bytes produced per collective in one step, for the same model and
    slot count: equal to the reference's (its HLO's) on 2 ranks and on
    1; and the phase metrics are kept."""
    for key, want in world2.refs.items():
        if not key.startswith("footprint_"):
            continue
        got = world2(key)
        assert got["footprint"] == want, key
        assert "shard data time" in got["summary"]
        assert "computing time" in got["summary"]
    want, kw = ref_footprint("mlp_bn", 1, True)
    assert port_footprint(0, 1, **kw)["footprint"] == want


def test_collective_bytes_follow_ring_allreduce_law(world2):
    """The ZeRO-1 cycle's wire volume on 2 ranks is 2(N-1)/N x the
    padded parameter bytes in bf16, plus the scalar all-reduces."""
    from bigdl_tpu_torch.utils import profiling
    got = world2("footprint_mlp_False")["footprint"]
    n_params = 16 * 32 + 32 + 32 * 4 + 4
    padded = -(-n_params // 2) * 2
    expected = 2 * (2 - 1) / 2 * padded * 2
    ring = profiling.wire_bytes({k: v for k, v in got.items()
                                 if k in ("all-gather", "reduce-scatter")}, 2)
    assert ring == expected
    assert got["all-reduce"] == 4       # the loss, float32


def test_traced_run_emits_the_training_phases(world2):
    """test_obs's traced DistriOptimizer run: fetch, h2d, step and
    publish spans, one step span an iteration with its loss."""
    r = world2("traced")
    for phase in ("train/fetch", "train/h2d", "train/step",
                  "train/publish"):
        assert phase in r["names"], (phase, r["names"])
    assert [a["iteration"] for a in r["steps"]] == [1, 2, 3]
    assert all("loss" in a for a in r["steps"])


def test_metrics_aggregate_averages_across_ranks(world2):
    for rank in (0, 1):
        r = world2("metrics", rank)
        assert r["computing"] == (1.5, 2)
        assert r["records"] == (15.0, 1)


def test_scaling_sweep_over_the_ranks_that_exist(world2):
    """perf's --mesh 1,2 on two ranks: a row for each size, the mesh of
    2 moving the bf16 parameters both ways, and an extrapolated row."""
    r = world2("sweep")
    rows = r["sweep"]
    assert [x["mesh"] for x in rows] == [1, 2]
    assert [x["global_batch"] for x in rows] == [4, 8]
    assert rows[0]["collective_wire_bytes_per_chip"] == 0.0
    fp = rows[1]["collective_bytes_produced"]
    assert fp["all-gather"] == 2 * fp["reduce-scatter"]
    assert rows[1]["collective_wire_bytes_per_chip"] > 0
    assert r["predicted"][0]["mesh"] == 8
    assert "H100" in r["ici_model"]["ici_gbps_source"]


# --------------------------------------------------------------------- #
# in this process: dispatch, datasets, refusals, the entry points        #
# --------------------------------------------------------------------- #
def test_factory_dispatch_distributed():
    from bigdl_tpu_torch import nn
    from bigdl_tpu_torch.dataset import DistributedDataSet, SampleToBatch
    from bigdl_tpu_torch.optim import LocalOptimizer, Optimizer
    from bigdl_tpu_torch.parallel import DistriOptimizer
    samples = _classification_samples(32)
    ds = DistributedDataSet(samples, process_index=0, process_count=1)
    lin = nn.Linear(6, 2).build(0, device="cpu")
    opt = Optimizer.create(lin, ds >> SampleToBatch(16), nn.MSECriterion())
    assert isinstance(opt, DistriOptimizer)
    opt = Optimizer.create(lin, ds.local >> SampleToBatch(16),
                           nn.MSECriterion())
    assert isinstance(opt, LocalOptimizer)


def test_distributed_dataset_is_the_references_shard():
    """Rank r of W holds records r, r+W, ... shuffled from seed + r:
    the reference's DistributedDataSet, record for record."""
    from bigdl_tpu.dataset.dataset import DistributedDataSet as J
    from bigdl_tpu_torch.dataset import DistributedDataSet
    records = list(range(11))
    for pi in range(3):
        ds = DistributedDataSet(records, process_index=pi, process_count=3,
                                seed=4)
        jd = J(records, process_index=pi, process_count=3, seed=4)
        assert ds.size() == 11 and ds.local_size() == jd.local_size()
        ds.shuffle()
        jd.shuffle()
        got, want = ds.data(train=True), jd.data(train=True)
        assert [next(got) for _ in range(8)] == [next(want)
                                                 for _ in range(8)]


def test_repad_refuses_foreign_larger_state():
    from bigdl_tpu_torch.parallel import AllReduceParameter, DistriOptimizer
    arp = AllReduceParameter({"w": torch.zeros(10)}, 4)  # padded 12
    ok = torch.arange(10.0)
    out = DistriOptimizer._repad_flat_leaf(
        torch.cat([ok, torch.zeros(5)]), arp)
    assert out.shape == (12,)
    assert torch.equal(out[:10], ok) and not out[10:].any()
    with pytest.raises(ValueError, match="larger model"):
        DistriOptimizer._repad_flat_leaf(torch.cat([ok, torch.ones(5)]), arp)
    with pytest.raises(ValueError, match="different model"):
        DistriOptimizer._repad_flat_leaf(torch.zeros(7), arp)


def test_scaling_sweep_refuses_more_ranks_than_the_world(world1):
    from bigdl_tpu_torch.models.utils import perf
    with pytest.raises(SystemExit, match="this world has 1"):
        perf.main(["-m", "lenet5", "--mesh", "1,2", "--device", "cpu"])


def test_running_world_refuses_a_device_it_does_not_carry(world1):
    """A gloo world already running serves the CPU; asking it for the
    card raises (no quiet drop to the CPU or to gloo), whether through
    init_world, a mesh or a distributed measurement."""
    from bigdl_tpu_torch.parallel.mesh import (create_mesh,
                                               data_parallel_mesh,
                                               init_world)
    assert init_world("cpu") == torch.device("cpu")
    with pytest.raises(RuntimeError, match="has no nccl"):
        init_world("cuda")
    with pytest.raises(RuntimeError, match="has no nccl"):
        create_mesh(device_type="cuda")
    with pytest.raises(RuntimeError, match="has no nccl"):
        data_parallel_mesh(device_type="cuda")
    from unittest import mock
    from bigdl_tpu_torch.models.utils import perf
    # the card is present as far as resolve_device is concerned
    with mock.patch("bigdl_tpu_torch.device.resolve_device",
                    lambda d=None: torch.device("cuda")), \
            pytest.raises(RuntimeError, match="has no nccl"):
        perf.run_perf("lenet5", 8, 1, distributed=True, warmup=0,
                      device="cuda")
    assert init_world("cpu") == torch.device("cpu")


def test_perf_distributed_runs_distri_optimizer(world1):
    from bigdl_tpu_torch.models.utils import perf
    r = perf.run_perf("lenet5", 8, 2, distributed=True, warmup=1,
                      device="cpu")
    assert r["distributed"] and len(r["step_s"]) == 2
    assert r["throughput_rec_s"] > 0


@pytest.fixture
def small_cifar(monkeypatch):
    """The CIFAR CLIs' synthetic records cut to 64 (the CLIs take no
    record count)."""
    from bigdl_tpu_torch.dataset import cifar
    real = cifar.synthetic
    monkeypatch.setattr(cifar, "synthetic",
                        lambda n, seed=0: real(64, seed=seed))


@pytest.mark.parametrize("cli", ["lenet", "vgg", "resnet", "inception",
                                 "transformer"])
def test_cli_distributed_trains(world1, small_cifar, cli):
    """Every training CLI's --distributed trains through DistriOptimizer
    (a world of one here) with finite losses."""
    from importlib import import_module
    from bigdl_tpu_torch.parallel import DistriOptimizer
    argv = {"lenet": ["--synthetic", "-e", "1", "-b", "512"],
            "vgg": ["--synthetic", "-e", "1", "-b", "32"],
            "resnet": ["--synthetic", "--depth", "8", "-e", "1", "-b", "32"],
            "inception": ["--synthetic", "-b", "2", "-i", "2",
                          "--modelName", "inception_v1"],
            "transformer": ["--synthetic", "-e", "1", "-b", "8",
                            "--hiddenSize", "16", "--nHead", "2",
                            "--nLayers", "1", "--seqLength", "16"]}[cli]
    main = import_module(f"bigdl_tpu_torch.models.{cli}.train").main
    opt = main(argv + ["--distributed", "--device", "cpu"])
    assert isinstance(opt, DistriOptimizer)
    assert np.isfinite(opt.state["loss"]) and opt.state["neval"] > 1
