"""bigdl_tpu_torch's quantization (``bigdl_tpu_torch/quant``) on the CPU,
against the JAX package's ``bigdl_tpu/quant`` on the same numpy inputs.

Held bitwise: the int8 payloads and scales of ``quantize_array``,
per-token activation quantization, the int32 accumulators of the int8
product and ``_kv_quantize_rows``.  Held to a stated tolerance: the
products' float outputs and the int8 LM's logits.  Held exactly: the
quant report's leaf set and byte counts, greedy int8 ``generate``, the
int8-KV engine's stream, and the default int8 drafter's greedy and
sampled spec streams.  Reference QTensor trees cross over through
``params_from_numpy``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import lax

from bigdl_tpu import quant as jq
from bigdl_tpu.models.transformer import TransformerLM as JaxLM
from bigdl_tpu.models.transformer import generate as jgen
from bigdl_tpu.serving import LMServingEngine as JaxEngine
from bigdl_tpu.serving.kvcache.blocks import BlockPool as JaxPool

from bigdl_tpu_torch import quant as tq
from bigdl_tpu_torch.models.transformer import TransformerLM
from bigdl_tpu_torch.models.transformer import generate as tgen
from bigdl_tpu_torch.serving import LMServingEngine, SpecConfig
from bigdl_tpu_torch.serving.compile_cache import (CompileCache, GraphPool,
                                                   params_dtype_tag)
from bigdl_tpu_torch.serving.kvcache import BlockPool
from bigdl_tpu_torch.utils.params import (layer_params, params_from_numpy,
                                          params_to_numpy, tree_leaves)

RNG = np.random.RandomState(11)
# hidden 64: the stacked layer norms (L, 64) reach the policy's min_size, as
# at GPT-2 widths; an untied head, so the head is quantized and goes
# through qmatmul
LM_KW = dict(vocab_size=31, hidden_size=64, n_head=2, n_layers=2, max_len=64,
             pos_encoding="rope", tie_embeddings=False)
ENGINE_KW = dict(slots=2, cache_len=48, block_len=4, max_new_tokens=8,
                 prefill_buckets=(8,))


@pytest.fixture(scope="module")
def pair():
    jm = JaxLM(attention_impl="xla", **LM_KW).build(seed=0)
    tm = TransformerLM(device="cpu", **LM_KW)
    tm.params = params_from_numpy(
        jax.tree_util.tree_map(np.asarray, jm.params), "cpu")
    return jm, tm


def _np(x):
    return np.asarray(x)


def _jax_logits(model, x):
    """The reference's forward behind its entry seam (as its jitted
    ``forward`` runs it)."""
    return _np(model.f(jq.dequantize_entry(model.params), jnp.asarray(x)))


def _jax_generate(model, prompt, max_new, temperature=0.0, seed=None):
    kw = dict(temperature=temperature)
    if seed is not None:
        kw["rng"] = jax.random.PRNGKey(seed)
    return _np(jgen.generate(model, model.params,
                             np.asarray(prompt)[None].astype(np.int32),
                             max_new, **kw))[0]


# --------------------------------------------------------------------------- #
# QTensor storage                                                             #
# --------------------------------------------------------------------------- #

@pytest.mark.parametrize("case", ["stacked", "per_tensor", "zero_channel"])
def test_quantize_array_bitwise(case):
    w = RNG.randn(3, 24, 40).astype(np.float32)
    axes = (-2,)
    if case == "per_tensor":
        axes = None
    if case == "zero_channel":
        w[1, :, 7] = 0.0
    want = jq.quantize_array(w, axes)
    got = tq.quantize_array(w, axes)
    np.testing.assert_array_equal(got.q.numpy(), _np(want.q))
    np.testing.assert_array_equal(got.scale.numpy(), _np(want.scale))
    assert got.nbytes == want.nbytes and got.orig_dtype == want.orig_dtype
    np.testing.assert_array_equal(got.dequantize().numpy(),
                                  _np(want.dequantize()))
    # one layer of the stack: views of q and scale, equal to the stacked
    # dequantization's slice; q's last two axes column-major
    layer = got[1]
    np.testing.assert_array_equal(layer.dequantize().numpy(),
                                  _np(want.dequantize())[1])
    assert layer.q.data_ptr() != 0 and layer.q.transpose(0, 1).is_contiguous()
    if case == "zero_channel":
        assert np.all(got.q.numpy()[1, :, 7] == 0)


def test_qtensor_crosses_over_and_back():
    jt = jq.quantize_array(RNG.randn(2, 16, 8).astype(np.float32), (-2,),
                           compute="int8")
    tree = params_from_numpy({"blocks": {"w1": jt}}, "cpu")
    leaf = tree["blocks"]["w1"]
    assert tq.is_qtensor(leaf) and leaf.compute == "int8"
    assert leaf.q.dtype == torch.int8 and leaf.scale.dtype == torch.float32
    np.testing.assert_array_equal(leaf.q.numpy(), _np(jt.q))
    back = params_to_numpy(tree)["blocks"]["w1"]
    np.testing.assert_array_equal(back.q, _np(jt.q))
    np.testing.assert_array_equal(back.scale, _np(jt.scale))
    # the stacked (L, h) layer-norm leaf: its scale reduced the layer axis
    ln = tq.quantize_array(RNG.randn(3, 256).astype(np.float32), (-2,))
    assert ln.scale.shape == (1, 256)
    np.testing.assert_array_equal(layer_params({"w": ln}, 2)["w"].dequantize(),
                                  ln.dequantize()[2])


@pytest.mark.parametrize("compute", ["dequant", "int8"])
def test_quantize_params_report_matches_reference(pair, compute):
    """The 2-layer LM's quantized leaves (the stacked layer norms among
    them), byte counts, ratio, errors and overflow risk."""
    jm, tm = pair
    jr, tr = {}, {}
    jp = jq.quantize_params(jm.params, "int8",
                            policy=jq.QuantPolicy(compute=compute),
                            module=jm, report=jr)
    tp = tq.quantize_params(tm.params, "int8",
                            policy=tq.QuantPolicy(compute=compute), report=tr)
    assert set(tr["per_layer_max_abs_err"]) == set(jr["per_layer_max_abs_err"])
    assert {"blocks/ln1/weight", "blocks/ln2/weight", "blocks/attn/wq",
            "blocks/w2", "head"} <= set(tr["per_layer_max_abs_err"])
    for key in ("bytes_orig", "bytes_quant", "bytes_saved", "quantized_leaves",
                "skipped_leaves", "payload_ratio", "overflow_risk", "dtype",
                "compute_mode"):
        assert tr[key] == jr[key], key
    assert tr["per_layer_overflow_risk"] == jr["per_layer_overflow_risk"]
    for key, err in jr["per_layer_max_abs_err"].items():
        assert abs(tr["per_layer_max_abs_err"][key] - err) <= 1e-7, key
    assert tq.params_nbytes(tp) == jq.params_nbytes(jp)
    assert tq.params_compute_tag(tp) == jq.params_compute_tag(jp)
    ln = tp["blocks"]["ln1"]["weight"]
    assert tq.is_qtensor(ln) and ln.compute == "dequant"
    np.testing.assert_array_equal(ln.q.numpy(),
                                  _np(jp["blocks"]["ln1"]["weight"].q))


def test_bf16_quantize_matches_reference(pair):
    jm, tm = pair
    jb, tb = jm.quantize("bf16"), tm.quantize("bf16")
    assert tb.quant_report["bytes_quant"] == jb.quant_report["bytes_quant"]
    assert tb.params["blocks"]["w1"].dtype == torch.bfloat16
    x = RNG.randint(1, 32, size=(2, 7))
    # the attention projections run in bf16 on both sides, each rounding
    # its outputs once (bf16's epsilon is 2**-7); the rest in float32
    np.testing.assert_allclose(tb.f(tb.params, torch.as_tensor(x)).numpy(),
                               _jax_logits(jb, x), rtol=0, atol=1e-2)


# --------------------------------------------------------------------------- #
# activation quantization and the products                                    #
# --------------------------------------------------------------------------- #

@pytest.mark.parametrize("static", [False, True])
def test_quantize_per_token_bitwise(static):
    x = (RNG.randn(3, 6, 40) * 3.0).astype(np.float32)
    x[1, 2] = 0.0                                   # an all-zero token
    scale = float(np.abs(x).max()) / 127.0 if static else None
    jqv, jsv = jq.quantize_per_token(jnp.asarray(x), scale=scale)
    tqv, tsv = tq.quantize_per_token(torch.from_numpy(x), scale=scale)
    np.testing.assert_array_equal(tqv.numpy(), _np(jqv))
    np.testing.assert_array_equal(tsv.numpy(), _np(jsv))


@pytest.mark.parametrize("act_scale", [None, 0.05])
def test_qmatmul_i8_accumulators_and_output(act_scale):
    x = RNG.randn(2, 5, 64).astype(np.float32)
    w = RNG.randn(64, 96).astype(np.float32)
    jw = jq.quantize_array(w, (0,), compute="int8")
    tw = tq.quantize_array(w, (0,), compute="int8")
    if act_scale is not None:
        jw = jw.with_compute("int8", act_scale=act_scale)
        tw = tw.with_compute("int8", act_scale=act_scale)
    jxq, _ = jq.quantize_per_token(jnp.asarray(x), scale=act_scale)
    txq, _ = tq.quantize_per_token(torch.from_numpy(x), scale=act_scale)
    want_acc = lax.dot_general(jxq, jw.q, (((2,), (0,)), ((), ())),
                               preferred_element_type=jnp.int32)
    got_acc = tq.int_mm(txq.reshape(-1, 64), tw.q).reshape(2, 5, 96)
    assert got_acc.dtype == torch.int32
    np.testing.assert_array_equal(got_acc.numpy(), _np(want_acc))
    want = _np(jq.qmatmul_i8(jnp.asarray(x), jw))
    got = tq.qmatmul_i8(torch.from_numpy(x), tw).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)
    # qmatmul dispatches on the compute mode, the same numbers
    np.testing.assert_array_equal(tq.qmatmul(torch.from_numpy(x), tw).numpy(),
                                  got)


def test_qmatmul_dequant_and_plain_match_reference():
    x = RNG.randn(4, 32).astype(np.float32)
    w = RNG.randn(32, 48).astype(np.float32)
    for jw, tw in ((jnp.asarray(w), torch.from_numpy(w)),
                   (jq.quantize_array(w, (0,)), tq.quantize_array(w, (0,))),
                   (jq.quantize_array(w, (0,), compute="auto"),
                    tq.quantize_array(w, (0,), compute="auto"))):
        np.testing.assert_allclose(
            tq.qmatmul(torch.from_numpy(x), tw).numpy(),
            _np(jq.qmatmul(jnp.asarray(x), jw)), rtol=0, atol=1e-5)
    # "auto" has no autotune verdict in the port: dequant, as the
    # reference's rule gives without one
    assert tq.resolve_compute(tq.quantize_array(w, (0,), compute="auto"),
                              (4, 32)) == "dequant"


def test_qmatmul_f8_forced_matches_reference():
    from bigdl_tpu.quant.kernels import qmatmul_f8 as jax_f8
    x = RNG.randn(6, 64).astype(np.float32)
    w = RNG.randn(64, 40).astype(np.float32)
    want = _np(jax_f8(jnp.asarray(x), jq.quantize_array(w, (0,))))
    got = tq.qmatmul_f8(torch.from_numpy(x),
                        tq.quantize_array(w, (0,))).numpy()
    assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max()


def test_fp8_gates_on_device_kind():
    if not torch.cuda.is_available():
        assert not tq.fp8_supported()
        with pytest.raises(NotImplementedError):
            tq.quantize_per_token_fp8(torch.ones(2, 4))
        with pytest.raises(NotImplementedError):
            tq.QuantPolicy("int8", compute="fp8")
    q, s = tq.quantize_per_token_fp8(torch.ones(2, 4), force=True)
    assert q.dtype == torch.float8_e4m3fn and s.shape == (2, 1)
    with pytest.raises(ValueError):
        tq.QuantPolicy("int8", compute="bf16")
    with pytest.raises(ValueError):
        tq.QuantPolicy("bf16", compute="int8")


def test_act_calibrator_freezes_absmax_scales_onto_leaves():
    jcal, tcal = jq.ActCalibrator(), tq.ActCalibrator()
    for batch in (np.ones((2, 4)) * 2.0, np.ones((2, 4)) * 5.0):
        jcal.observe("blocks/attn/wq", batch)
        tcal.observe("blocks/attn/wq", batch)
    assert tcal.scales() == jcal.scales()
    assert tcal.describe() == jcal.describe()
    w = RNG.randn(8, 8).astype(np.float32)
    tree = {"blocks": {"attn": {"wq": tq.quantize_array(w, (0,),
                                                        compute="int8")}}}
    pinned = tq.attach_act_scales(tree, tcal.scales())
    qt = pinned["blocks"]["attn"]["wq"]
    assert qt.act_scale == pytest.approx(5.0 / 127.0)
    assert qt.q is tree["blocks"]["attn"]["wq"].q
    assert tq.attach_act_scales(tree, {"nope": 1.0})["blocks"]["attn"][
        "wq"].act_scale is None


# --------------------------------------------------------------------------- #
# tree functions                                                              #
# --------------------------------------------------------------------------- #

def test_set_compute_mode_entry_and_tags(pair):
    """Mirrors tests/test_qcompute.py's compute-mode plumbing: the entry
    seam expands dequant leaves only, set_compute_mode rewrites the mode
    and shares every int8 tensor."""
    _, tm = pair
    dq = tm.quantize("int8").params
    i8 = tm.quantize("int8", compute="int8").params
    assert not any(tq.is_qtensor(v) for v in
                   tq.dequantize_entry(dq)["blocks"]["attn"].values())
    entry_i8 = tq.dequantize_entry(i8)
    assert tq.is_qtensor(entry_i8["blocks"]["attn"]["wq"])
    assert not tq.is_qtensor(entry_i8["blocks"]["ln1"]["weight"])
    retag = tq.set_compute_mode(dq, "int8")
    assert tq.params_compute_tag(retag) == "int8"
    assert tq.params_compute_tag(dq) == "dequant"
    assert tq.params_compute_tag(tm.params) is None
    assert retag["blocks"]["ln1"]["weight"].compute == "dequant"
    for name in ("wq", "wk", "wv", "wo"):
        a, b = dq["blocks"]["attn"][name], retag["blocks"]["attn"][name]
        assert b.compute == "int8"
        assert b.q.data_ptr() == a.q.data_ptr()
        assert b.scale.data_ptr() == a.scale.data_ptr()
    assert params_dtype_tag(dq) == "int8" == jq.params_dtype_tag(
        jq.quantize_params({"w": jnp.ones((16, 16))}, "int8"))
    assert params_dtype_tag(tm.params) == "f32"
    with pytest.raises(ValueError):
        tq.set_compute_mode(dq, "int4")
    full = tq.dequantize_params(i8)
    assert not any(tq.is_qtensor(leaf) for leaf in
                   (full["blocks"]["w1"], full["blocks"]["attn"]["wq"]))
    staged, moved = tq.stage_quantized_params(dq, device="cpu")
    assert moved == sum(leaf.nbytes for leaf in tree_leaves(dq)
                        if tq.is_qtensor(leaf))
    assert tq.is_qtensor(staged["blocks"]["w1"])


def test_graph_cache_keys_int8_trees_apart(pair):
    """A float tree, its int8 clone and the clone's int8-compute retag
    each make their own entry at one input shape."""
    _, tm = pair
    calls = []
    cache = CompileCache(lambda p, b, x: calls.append(1),
                         graphs=GraphPool("cpu", capture=False))
    dq = tm.quantize("int8").params
    x = {"ids": np.zeros((1, 8), np.int64)}
    for params in (tm.params, dq, tq.set_compute_mode(dq, "int8"), dq):
        cache(params, None, x)
    assert cache.stats()["entries"] == 3 and cache.stats()["hits"] == 1


# --------------------------------------------------------------------------- #
# the int8 LM                                                                 #
# --------------------------------------------------------------------------- #

@pytest.mark.parametrize("compute", ["dequant", "int8"])
def test_int8_lm_logits_and_generate_match_reference(pair, compute):
    jm, tm = pair
    jqm = jm.quantize("int8", compute=compute)
    tqm = tm.quantize("int8", compute=compute)
    assert tqm.params is not tm.params and not tq.is_qtensor(
        tm.params["blocks"]["w1"])
    assert tqm.params["head"].compute == compute
    x = RNG.randint(1, 32, size=(2, 11))
    np.testing.assert_allclose(
        tqm.f(tqm.params, torch.as_tensor(x)).numpy(),
        _jax_logits(jqm, x), rtol=0, atol=1e-4)
    # the reference's own quantized tree, carried over, gives the same
    crossed = params_from_numpy(jqm.params, "cpu")
    np.testing.assert_allclose(
        tqm.f(crossed, torch.as_tensor(x)).numpy(),
        _jax_logits(jqm, x), rtol=0, atol=1e-4)
    p = np.asarray([3, 9, 14, 2, 6, 1])
    np.testing.assert_array_equal(
        tgen.generate(tqm, tqm.params, p[None], 10, device="cpu").numpy()[0],
        _jax_generate(jqm, p, 10))


# --------------------------------------------------------------------------- #
# int8 KV arenas                                                              #
# --------------------------------------------------------------------------- #

def test_kv_quantize_rows_bitwise():
    x = (RNG.randn(2, 3, 5, 16) * 2).astype(np.float32)
    x[0, 1, 2] = 0.0
    jqv, jsv = jgen._kv_quantize_rows(jnp.asarray(x))
    tqv, tsv = tgen._kv_quantize_rows(torch.from_numpy(x))
    np.testing.assert_array_equal(tqv.numpy(), _np(jqv))
    np.testing.assert_array_equal(tsv.numpy(), _np(jsv))


def test_blockpool_int8_arenas():
    """Mirrors tests/test_qcompute.py's int8 pool check (export/adopt
    wait for disaggregated serving)."""
    kw = dict(n_layers=1, n_heads=2, head_dim=8, block_len=4, num_blocks=6)
    pool = BlockPool(kv_quant="int8", **kw)
    ref = JaxPool(kv_quant="int8", dtype=np.float32, **kw)
    assert pool.k.dtype == torch.int8 and pool.ks.dtype == torch.float32
    assert pool.ks.shape == pool.shape[:4] == ref.ks.shape
    assert pool.stats()["kv_quant"] == "int8"
    assert pool.arena_bytes == ref.arena_bytes
    assert pool.scale_arena_bytes == ref.scale_arena_bytes
    plain = BlockPool(**kw)
    assert pool.arena_bytes < plain.arena_bytes
    assert plain.stats()["kv_quant"] == "none" and plain.ks is None
    with pytest.raises(ValueError):
        BlockPool(kv_quant="int4", **kw)


def _quant_arenas(seed):
    rng = np.random.RandomState(seed)
    shape = (2, 9, 2, 4, 32)
    k, ks = jgen._kv_quantize_rows(jnp.asarray(rng.randn(*shape),
                                               jnp.float32))
    v, vs = jgen._kv_quantize_rows(jnp.asarray(rng.randn(*shape),
                                               jnp.float32))
    tables = np.asarray([[1, 2, 3, 4], [5, 6, 7, 8], [0, 0, 0, 0]], np.int32)
    return [_np(a) for a in (k, v, ks, vs)], tables


def test_int8_kv_verify_and_commit_match_reference(pair):
    """A tree verify step on int8 arenas (rows quantized on write, the
    gather dequantizing), then the accepted-path commit, which moves the
    scale rows with the int8 rows: bitwise on the reference's arenas."""
    from bigdl_tpu_torch.serving.spec import default_tree_shapes
    jm, tm = pair
    shp = default_tree_shapes(3)[-1]
    arenas, tables = _quant_arenas(3)
    tokens = RNG.randint(0, 29, size=(3, shp.width)).astype(np.int32)
    pos = np.asarray([5, 9, 0], np.int32)
    n_cand = np.asarray([shp.width, shp.width, 0], np.int32)
    rl, *rar = jgen._tree_verify_step_paged(
        jm, jm.params, jnp.asarray(tokens), jnp.asarray(pos),
        jnp.asarray(n_cand), jnp.asarray(tables),
        *(jnp.asarray(a) for a in arenas),
        depths=np.asarray(shp.depths, np.int32), anc=shp.anc)
    tar = [torch.from_numpy(a.copy()) for a in arenas]
    out = tgen._tree_verify_step_paged(
        tm, tm.params, *(torch.from_numpy(a) for a in
                         (tokens, pos, n_cand, tables)),
        *tar, depths=shp.depths, anc=shp.anc)
    assert len(out) == 5 and all(a is b for a, b in zip(out[1:], tar))
    want = _np(rl)
    for s in (0, 1):
        np.testing.assert_allclose(out[0][s].numpy(), want[s], rtol=0,
                                   atol=1e-4 * np.abs(want[s]).max())
    # int8 rows within one step of rounding, scales within float32 noise
    for got, ref in zip(tar[:2], rar[:2]):
        assert np.abs(got.numpy().astype(int) - _np(ref).astype(int)).max() <= 1
    for got, ref in zip(tar[2:], rar[2:]):
        np.testing.assert_allclose(got.numpy(), _np(ref), rtol=1e-5, atol=0)
    src = np.tile(np.arange(1, 4, dtype=np.int32), (3, 1))
    src[0, 1], src[1, 0] = 5, 4
    commit = jgen._tree_commit_paged(jnp.asarray(src), jnp.asarray(pos),
                                     jnp.asarray(tables), *rar)
    tar = [torch.from_numpy(_np(a).copy()) for a in rar]
    tgen._tree_commit_paged(torch.from_numpy(src), torch.from_numpy(pos),
                            torch.from_numpy(tables), *tar)
    for got, ref in zip(tar, commit):
        np.testing.assert_array_equal(got.numpy(), _np(ref))


def test_engine_kv_quant_int8_stream_matches_reference(pair):
    """Mirrors tests/test_qcompute.py's int8-KV engine check: the gather
    decode, and the stream equal to the reference engine's int8-KV
    stream (a radix hit included, so the suffix prefill gathers int8
    prefix rows)."""
    jm, tm = pair
    prompts = [np.asarray([3, 9, 14, 2, 6, 1, 8, 4], np.int32),
               np.asarray([3, 9, 14, 2, 6, 1, 8, 4, 11, 5], np.int32)]
    jeng = JaxEngine(jm, kv_quant="int8", **ENGINE_KW)
    try:
        want = [jeng.submit(p).result(timeout=60) for p in prompts]
    finally:
        jeng.close()
    with LMServingEngine(tm, kv_quant="int8", device="cpu",
                         **ENGINE_KW) as eng:
        eng.warmup()
        assert eng.decode_attn == "gather" and eng.kv_quant == "int8"
        assert eng.stats()["kvcache"]["kv_quant"] == "int8"
        got = [eng.submit(p).result(timeout=60) for p in prompts]
        assert eng.stats()["kvcache"]["prefix_cache"]["hits"] >= 1
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    with pytest.raises(ValueError, match="gather"):
        LMServingEngine(tm, kv_quant="int8", decode_attn="paged_kernel",
                        device="cpu", **ENGINE_KW)


def test_int8_target_engine_streams_match_reference(pair):
    """An int8 target (dequant) served through the paged steps, one layer
    expanded at a time: its streams equal the reference engine's over the
    same int8 tree."""
    jm, tm = pair
    jqm, tqm = jm.quantize("int8"), tm.quantize("int8")
    p = np.asarray([7, 3, 3, 12, 30, 2], np.int32)
    jeng = JaxEngine(jqm, **ENGINE_KW)
    try:
        want = jeng.submit(p).result(timeout=60)
    finally:
        jeng.close()
    with LMServingEngine(tqm, device="cpu", **ENGINE_KW) as eng:
        got = eng.submit(p).result(timeout=60)
        assert eng.stats()["quant_dtype"] == "int8"
    np.testing.assert_array_equal(got, want)


# --------------------------------------------------------------------------- #
# the default int8 drafter                                                    #
# --------------------------------------------------------------------------- #

def test_default_int8_drafter_streams_exact(pair):
    """Mirrors tests/test_qcompute.py's int8-compute drafter check:
    ``spec=3`` builds the target's int8 clone (dequant), and
    ``drafter_compute="int8"`` streams, greedy and sampled, equal the
    reference's offline float32 generate."""
    jm, tm = pair
    with LMServingEngine(tm, spec=3, device="cpu", **ENGINE_KW) as eng:
        assert isinstance(eng.spec, SpecConfig) and eng.spec.k == 3
        assert eng.draft.compute_mode == "dequant"
        assert eng.draft.dtype_tag == "int8"
        assert eng.draft.model is not tm
    cfg = SpecConfig(k=3, drafter_compute="int8")
    with LMServingEngine(tm, spec=cfg, device="cpu",
                         **dict(ENGINE_KW, prefill_buckets=(8, 16))) as eng:
        eng.warmup()
        base = np.random.default_rng(2).integers(1, 32, size=8).astype(
            np.int32)
        cases = [(base, 0.0, 0), (base.copy(), 0.7, 3),
                 (np.concatenate([base, [5, 7]]).astype(np.int32), 0.9, 4)]
        streams = [eng.submit(p, temperature=t, rng=s) for p, t, s in cases]
        for (p, t, s), stm in zip(cases, streams):
            np.testing.assert_array_equal(
                stm.result(timeout=60),
                _jax_generate(jm, p, 8, t, s if t > 0 else None))
        spec = eng.stats()["spec"]
        assert spec["compute_mode"] == "int8" == eng.draft.compute_mode
        assert spec["drafted"] > 0 and spec["demotions"] == 0
        assert 0.0 < spec["overflow_risk"] < 1.0
        assert eng.radix.stats()["hits"] > 0


def test_int8_target_drafts_with_its_own_weights(pair):
    """An int8 target's default drafter is the target (dequant) or an
    aux-only clone (int8 compute): one set of int8 tensors either way."""
    _, tm = pair
    tqm = tm.quantize("int8")
    with LMServingEngine(tqm, spec=SpecConfig(k=2), device="cpu",
                         **ENGINE_KW) as eng:
        assert eng.draft.model is tqm
    with LMServingEngine(tqm, spec=SpecConfig(k=2, drafter_compute="int8"),
                         device="cpu", **ENGINE_KW) as eng:
        draft = eng.draft.model
        assert draft is not tqm and eng.draft.compute_mode == "int8"
        for name in ("wq", "wo"):
            assert (draft.params["blocks"]["attn"][name].q.data_ptr()
                    == tqm.params["blocks"]["attn"][name].q.data_ptr())
        p = np.asarray([4, 19, 2, 30, 8], np.int32)
        np.testing.assert_array_equal(
            eng.submit(p).result(timeout=60),
            tgen.generate(tqm, tqm.params, p[None], 8,
                          device="cpu").numpy()[0])


@pytest.mark.parametrize("tree", [False, True])
def test_spec_int8_target_with_radix_sharing(pair, tree):
    """Mirrors tests/test_spec_decode.py:121 and tests/test_spec_tree.py:151:
    the target is an int8 clone, its default drafter the target itself,
    radix sharing on, greedy and sampled, linear and tree verify: every
    stream is the offline trajectory of the same int8 model (the port's
    ``generate``, held to the reference's above)."""
    _, tm = pair
    tqm = tm.quantize("int8")
    with LMServingEngine(tqm, spec=SpecConfig(k=3, tree=tree), device="cpu",
                         **dict(ENGINE_KW, slots=4,
                                prefill_buckets=(8, 16))) as eng:
        eng.warmup()
        assert eng.draft.model is tqm
        base = np.random.default_rng(2).integers(1, 32, size=8).astype(
            np.int32)
        cases = [(base, 0.0, None), (base.copy(), 0.7, 3),
                 (np.concatenate([base, [5, 7]]).astype(np.int32), 0.9, 4)]
        streams = [eng.submit(p, temperature=t, rng=s) for p, t, s in cases]
        for (p, t, s), stm in zip(cases, streams):
            np.testing.assert_array_equal(
                stm.result(timeout=60),
                tgen.generate(tqm, tqm.params, p[None], 8, temperature=t,
                              rng=s, device="cpu").numpy()[0])
        st = eng.stats()
        assert st["kvcache"]["prefix_cache"]["hits"] > 0
        assert st["spec"]["drafted"] > 0
        if tree:
            assert st["spec"]["tree_rounds"] > 0
