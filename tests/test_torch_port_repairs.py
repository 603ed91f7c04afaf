"""The port's ``TransformerLM`` against the JAX package's on the key chain,
the reference's arguments, and the names the reference exports.

- ``TransformerLM(...).build(seed)`` (dense, MoE, rope with an untied
  head) is the reference's tree: uniform leaves bitwise, the embedding
  and positions (normal draws) within 4 ulp; ``init_moe_params`` bitwise.
- Training-mode dropout under ``rng=`` draws the reference's masks,
  bitwise, and ``f(..., training=True, rng=)`` matches the reference's
  forward within 1e-5 (it is differentiable, as ``apply`` is).
- ``block_size=`` reaches the attention and pins the flash tile.
- Every name a reference package exports (``__all__``, else its
  ``__init__``'s imports and definitions) exists in the port, but for
  the names that wait for ROADMAP Queue 1, listed here by item.
- ``OptimMethod.optimize`` and the renamed ``save_module`` /
  ``module_spec`` parameter.
"""
import ast
import importlib
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bigdl_tpu.models.transformer import TransformerLM as JaxLM
from bigdl_tpu.parallel import expert as jexpert

from bigdl_tpu_torch.models.transformer import TransformerLM
from bigdl_tpu_torch.parallel import init_moe_params
from bigdl_tpu_torch.utils import keychain
from bigdl_tpu_torch.utils.params import params_from_numpy, params_to_numpy

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MAX_ULP = 4
SMALL = dict(vocab_size=50, hidden_size=16, n_head=2, n_layers=3, max_len=24)
CONFIGS = {
    "dense": {},
    "moe": dict(moe_experts=4),
    "rope_untied": dict(pos_encoding="rope", tie_embeddings=False),
}


def _ulps(a, b):
    return np.abs(a.view(np.int32).astype(np.int64)
                  - b.view(np.int32).astype(np.int64))


def _assert_tree(ref_tree, port_tree, normal=("embed", "pos")):
    ref = jax.tree_util.tree_leaves_with_path(ref_tree)
    assert len(ref) == len(jax.tree_util.tree_leaves(port_tree))
    for path, a in ref:
        b = port_tree
        for k in path:
            b = b[k.key]
        a = np.asarray(a)
        assert a.shape == b.shape and a.dtype == b.dtype == np.float32
        if path[0].key in normal:
            assert _ulps(a, b).max() <= MAX_ULP, path
        else:
            np.testing.assert_array_equal(b, a, err_msg=str(path))


@pytest.mark.parametrize("name", sorted(CONFIGS))
@pytest.mark.parametrize("seed", [0, 1])
def test_build_is_the_references_tree(name, seed):
    cfg = dict(SMALL, **CONFIGS[name])
    ref = JaxLM(**cfg).build(seed)
    port = TransformerLM(device="cpu", **cfg).build(seed)
    _assert_tree(ref.params, params_to_numpy(port.params))
    assert jax.tree_util.tree_map(lambda a: tuple(a.shape),
                                  params_to_numpy(port.params)) \
        == port.param_shapes()
    assert port.grad_params is None  # no second copy of the weights
    if name == "moe":
        assert float(port.buffers["aux_loss"]) == 0.0


@pytest.mark.parametrize("d_model", [3, 7, 10, 48, 768])
def test_init_moe_params_bitwise(d_model):
    """The float32 scale 1/sqrt(d): a float64 bound can round to another
    float32 and move every uniform draw."""
    key = keychain.prng_key(d_model)
    got = init_moe_params(key, 3, d_model, 5)
    ref = jexpert.init_moe_params(jax.random.PRNGKey(d_model), 3, d_model, 5)
    assert list(got) == list(ref)
    for k in ref:
        np.testing.assert_array_equal(got[k], np.asarray(ref[k]))


def _dropout_pair(rate=0.3, impl="xla"):
    cfg = dict(SMALL, dropout=rate)
    ref = JaxLM(attention_impl=impl, **cfg).build(2)
    port = TransformerLM(attention_impl=impl, device="cpu", **cfg)
    port.params = params_from_numpy(
        jax.tree_util.tree_map(np.asarray, ref.params), "cpu")
    return ref, port


def _ids(seed=4, shape=(2, 12)):
    return np.random.RandomState(seed).randint(1, 51, size=shape) \
        .astype(np.float32)


def test_training_dropout_masks_are_the_references(monkeypatch):
    """The masks the port draws under ``rng=`` equal jax.random's
    bernoulli draws along the reference's chain (one key per layer,
    a split before each of the block's two sites), bitwise."""
    ref, port = _dropout_pair()
    x = _ids()
    seen = []
    keep_masks = TransformerLM._keep_masks

    def record(self, h, drop):
        masks = keep_masks(self, h, drop)
        seen.append([m.numpy() for m in masks])
        return masks
    monkeypatch.setattr(TransformerLM, "_keep_masks", record)
    port.f(port.params, x, training=True, rng=keychain.prng_key(9))
    shape = (2, 12, SMALL["hidden_size"])
    layer_keys = jax.random.split(jax.random.PRNGKey(9), SMALL["n_layers"])
    assert len(seen) == SMALL["n_layers"]
    for k, masks in zip(layer_keys, seen):
        for m in masks:
            k, sub = jax.random.split(k)
            want = np.asarray(jax.random.bernoulli(sub, 0.7, shape))
            np.testing.assert_array_equal(m, want)


@pytest.mark.parametrize("seed", [0, 9])
def test_f_training_matches_the_reference(seed):
    ref, port = _dropout_pair()
    x = _ids(seed)
    want = np.asarray(ref.f(ref.params, jnp.asarray(x), training=True,
                            rng=jax.random.PRNGKey(seed)))
    key = keychain.prng_key(seed)
    leaves = [p.requires_grad_(True) for p in
              jax.tree_util.tree_leaves(port.params)]
    got = port.f(port.params, x, training=True, rng=key)
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=1e-5,
                               atol=1e-5)
    got.sum().backward()  # differentiable, as apply is
    assert all(p.grad is not None for p in leaves)
    applied, _ = port.apply(port.params, x, training=True, rng=key)
    np.testing.assert_array_equal(applied.detach().numpy(),
                                  got.detach().numpy())
    # eval mode: no autograd, no dropout
    ev = port.f(port.params, x)
    assert not ev.requires_grad
    np.testing.assert_allclose(ev.numpy(), np.asarray(
        ref.f(ref.params, jnp.asarray(x))), rtol=1e-5, atol=1e-5)
    with pytest.raises(ValueError, match="rng"):
        port.f(port.params, x, training=True)


def test_remat_replays_the_reference_masks():
    """A recomputed block draws its masks again from the same key."""
    ref, port = _dropout_pair()
    port.remat = True
    x = _ids(5)
    got = port.f(port.params, x, training=True, rng=keychain.prng_key(3))
    want = np.asarray(ref.f(ref.params, jnp.asarray(x), training=True,
                            rng=jax.random.PRNGKey(3)))
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=1e-5,
                               atol=1e-5)


def test_isolation_through_flash_path_with_block_size():
    """Mirror of tests/test_transformer.py::test_isolation_through_flash_path:
    ``block_size=`` reaches the attention, which pins that flash tile
    (the kernel is built for key tiles 32 and 64 at block_q 64, so the
    mirror pins 64 where the reference's interpret mode takes 8); the
    documents stay isolated and the log-probs match the reference's
    within 1e-5."""
    start = 7
    base = np.array([[start, 3, 4, 5, start, 8, 9, 10]], np.float32)
    pert = base.copy()
    pert[0, 1:4] = [11, 12, 13]
    cfg = dict(vocab_size=50, hidden_size=16, n_head=2, n_layers=1,
               max_len=32, attention_impl="flash", doc_start_id=start)
    iso = TransformerLM(block_size=64, device="cpu", **cfg).build(seed=3)
    assert iso._mha.block_size == 64
    assert iso._mha.pinned_tile(torch.float32) == (64, 64)
    out_a, out_b = iso.f(iso.params, base).numpy(), \
        iso.f(iso.params, pert).numpy()
    np.testing.assert_allclose(out_a[0, 4:], out_b[0, 4:], atol=1e-5,
                               rtol=1e-5)
    ref = JaxLM(block_size=8, **cfg).build(seed=3)
    np.testing.assert_allclose(out_a, np.asarray(
        ref.f(ref.params, jnp.asarray(base))), atol=1e-5, rtol=1e-5)
    with pytest.raises(ValueError, match="tile"):
        bad = TransformerLM(block_size=8, device="cpu", **cfg).build(seed=3)
        bad.f(bad.params, base)


def test_block_size_survives_save_and_load(tmp_path):
    cfg = dict(vocab_size=50, hidden_size=16, n_head=2, n_layers=1,
               max_len=32, attention_impl="flash", block_size=64)
    m = TransformerLM(device="cpu", **cfg).build(1)
    p = str(tmp_path / "lm.bin")
    m.save(p)
    assert TransformerLM.load(p, device="cpu")._mha.block_size == 64


# --------------------------------------------------------------------- #
# the names the reference exports                                       #
# --------------------------------------------------------------------- #
#: names of the reference packages that wait for ROADMAP Queue 1, by item
WAITING = {
    "12-DIST": {
        "bigdl_tpu.parallel": "*",
        "bigdl_tpu.dataset": {"DistributedDataSet"},
    },
    "12-DATA": {
        "bigdl_tpu.models.utils": {"IMAGENET_BGR_MEAN", "IMAGENET_BGR_STD",
                                   "imagenet_seq_datasets", "imagenet_shards",
                                   "imagenet_val_pipe"},
    },
    "12-HOST": {
        "bigdl_tpu.tensor": "*",
        "bigdl_tpu.native": "*",
        "bigdl_tpu.quant": {"qconv", "qconv_i8"},
    },
    "11.7": {
        "bigdl_tpu.serving.placement": "*",
        "bigdl_tpu.serving": {"DeviceTopology", "MeshSlice", "MeshSlicer",
                              "PlacementError", "PlacementPolicy",
                              "serving_tp_rules", "shard_params_chunked"},
    },
}


def _waiting(module: str) -> set:
    out = set()
    for mods in WAITING.values():
        names = mods.get(module)
        if names == "*":
            return {"*"}
        out |= set(names or ())
    return out


def _exports(path: str) -> list:
    """A reference ``__init__``'s exports: its ``__all__``, else the
    names its from-imports bind and its top-level definitions."""
    tree = ast.parse(open(path).read())
    for node in tree.body:
        if isinstance(node, ast.Assign) and any(
                getattr(t, "id", None) == "__all__" for t in node.targets):
            return list(ast.literal_eval(node.value))
    names = []
    for node in tree.body:
        if isinstance(node, ast.ImportFrom) and (node.level or (
                node.module or "").startswith("bigdl_tpu")):
            names += [a.asname or a.name for a in node.names]
        elif isinstance(node, (ast.ClassDef, ast.FunctionDef)):
            names.append(node.name)
    return [n for n in names if not n.startswith("_")]


def _reference_packages():
    out = []
    for root, _, files in os.walk(os.path.join(ROOT, "bigdl_tpu")):
        if "__init__.py" in files:
            rel = os.path.relpath(root, ROOT).replace(os.sep, ".")
            out.append((rel, os.path.join(root, "__init__.py")))
    return sorted(out)


def test_port_has_every_name_the_reference_exports():
    missing = []
    for module, path in _reference_packages():
        waiting = _waiting(module)
        if "*" in waiting:
            continue
        port_name = "bigdl_tpu_torch" + module[len("bigdl_tpu"):]
        port = importlib.import_module(port_name)
        ref = importlib.import_module(module)
        for name in _exports(path):
            if name in waiting or hasattr(port, name):
                continue
            if type(getattr(ref, name, None)).__name__ == "module" and \
                    not name.startswith(("torch_", "utils")):
                continue  # a subpackage alias, not an export
            missing.append(f"{port_name}.{name}")
    assert not missing, missing


def test_waiting_names_are_really_missing():
    """The list holds only what the port lacks: a name that gets ported
    leaves it."""
    for module, names in {m: n for mods in WAITING.values()
                          for m, n in mods.items()}.items():
        port_name = "bigdl_tpu_torch" + module[len("bigdl_tpu"):]
        try:
            port = importlib.import_module(port_name)
        except ModuleNotFoundError:
            continue
        if names == "*":
            ref = importlib.import_module(module)
            names = [n for n in getattr(ref, "__all__", ())
                     if n not in ("init_moe_params", "switch_mlp", "expert")]
        for name in names:
            assert not hasattr(port, name), f"{port_name}.{name} is ported"


@pytest.mark.parametrize("name", ["SGD", "Adam", "AdamW", "Adagrad"])
def test_optim_method_optimize_matches_the_reference(name):
    """``optimize(feval, x)``: three steps on one quadratic from seeded
    x, each x within rtol 1e-6 / atol 1e-7 of the reference's (the
    tolerance of ``test_staged_update_equals_the_reference_step``: the
    port's Adam takes its bias corrections in float64, the reference's
    in float32) and each loss within 1e-6; the caller's x is not
    written."""
    from bigdl_tpu import optim as joptim
    from bigdl_tpu_torch import optim
    kw = {"SGD": dict(learning_rate=0.1, momentum=0.9),
          "Adam": dict(learning_rate=3e-3, weight_decay=1e-2),
          "AdamW": dict(learning_rate=3e-3, weight_decay=1e-2),
          "Adagrad": dict(learning_rate=0.1)}[name]
    port, ref = getattr(optim, name)(**kw), getattr(joptim, name)(**kw)
    rs = np.random.RandomState(3)
    target = rs.randn(5).astype(np.float32)
    x0 = rs.randn(5).astype(np.float32)
    x, xr = torch.from_numpy(x0.copy()), jnp.asarray(x0)
    tt = torch.from_numpy(target)
    for _ in range(3):
        before = x.clone()
        x1, (loss,) = port.optimize(
            lambda v: (float(((v - tt) ** 2).sum()), 2 * (v - tt)), x)
        assert torch.equal(x, before)
        xr, (lref,) = ref.optimize(
            lambda v: (jnp.sum((v - target) ** 2), 2 * (v - target)), xr)
        np.testing.assert_allclose(x1.numpy(), np.asarray(xr), rtol=1e-6,
                                   atol=1e-7)
        assert loss == pytest.approx(float(lref), rel=1e-6)
        x = x1


def test_save_module_and_module_spec_take_module(tmp_path):
    import inspect

    from bigdl_tpu.utils import file_io as jfile_io
    from bigdl_tpu_torch import nn
    from bigdl_tpu_torch.utils import file_io
    for fn in ("save_module", "module_spec"):
        assert list(inspect.signature(getattr(file_io, fn)).parameters)[0] \
            == list(inspect.signature(getattr(jfile_io, fn)).parameters)[0] \
            == "module"
    m = nn.Linear(3, 2).build(0, device="cpu")
    file_io.save_module(module=m, path=str(tmp_path / "m.bin"))
    assert file_io.module_spec(module=m)["class"].endswith("Linear")
