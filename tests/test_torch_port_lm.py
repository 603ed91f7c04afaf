"""bigdl_tpu_torch TransformerLM and its decoding functions against the
JAX package, on the same weights (the JAX init carried over with
``params_from_numpy``) and the same numpy inputs, on the CPU."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bigdl_tpu.models.transformer import TransformerLM as JaxLM
from bigdl_tpu.models.transformer import generate as jgen

from bigdl_tpu_torch.models.transformer import TransformerLM
from bigdl_tpu_torch.models.transformer import generate as tgen
from bigdl_tpu_torch.utils import keychain
from bigdl_tpu_torch.utils.params import params_from_numpy

CONFIGS = {
    "learned": dict(pos_encoding="learned"),
    "rope": dict(pos_encoding="rope"),
    "doc_start": dict(pos_encoding="learned", doc_start_id=3),
    "untied": dict(pos_encoding="rope", tie_embeddings=False),
}


def _pair(name="learned", layers=2, seed=0, **over):
    kw = dict(vocab_size=29, hidden_size=32, n_head=4, n_layers=layers,
              max_len=48)
    kw.update(CONFIGS[name])
    kw.update(over)
    jm = JaxLM(attention_impl="xla", **kw).build(seed=seed)
    tm = TransformerLM(attention_impl="xla", device="cpu", **kw)
    tm.params = params_from_numpy(
        jax.tree_util.tree_map(np.asarray, jm.params), "cpu")
    return jm, tm


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_logprobs_match_jax(name):
    """Learned and RoPE positions, doc_start_id segments, tied and
    untied heads: float32 log-probs within 1e-4."""
    jm, tm = _pair(name)
    ids = np.random.RandomState(1).randint(1, 30, size=(2, 17))
    ids[:, [0, 6, 11]] = 3                     # document starts
    ref = np.asarray(jm.f(jm.params, jnp.asarray(ids)))
    out = tm.f(tm.params, ids).numpy()
    assert out.shape == (2, 17, 29) and out.dtype == np.float32
    np.testing.assert_allclose(out, ref, atol=1e-4, rtol=1e-4)
    # the plain attention core and the flash plain version agree too
    tm._mha.attention_impl = "flash"
    np.testing.assert_allclose(tm.f(tm.params, ids.astype(np.float32)).numpy(),
                               ref, atol=1e-4, rtol=1e-4)


def test_init_layout_matches_jax_tree():
    """init() builds the reference's keys, shapes and stacked blocks."""
    jm, tm = _pair("untied")
    fresh = tm.init(keychain.prng_key(0))
    ref = jax.tree_util.tree_map(np.asarray, jm.params)
    assert (jax.tree_util.tree_structure(fresh)
            == jax.tree_util.tree_structure(ref))
    for a, b in zip(jax.tree_util.tree_leaves(fresh),
                    jax.tree_util.tree_leaves(ref)):
        assert a.shape == b.shape and a.dtype == b.dtype


@pytest.mark.parametrize("name", ["learned", "rope"])
def test_prefill_parts_matches_jax(name):
    """Bucket-padded prefill: logits at last_index and every k/v row,
    1e-4."""
    jm, tm = _pair(name)
    ids0 = np.zeros((1, 16), np.int64)
    ids0[0, :11] = np.random.RandomState(2).randint(0, 29, size=11)
    rl, rk, rv = jgen._prefill_parts(jm, jm.params, jnp.asarray(ids0), 10)
    logits, k, v = tgen._prefill_parts(tm, tm.params, torch.from_numpy(ids0),
                                       10, attention_impl="flash")
    assert tuple(k.shape) == (2, 1, 4, 16, 8)
    np.testing.assert_allclose(logits.numpy(), np.asarray(rl), atol=1e-4,
                               rtol=1e-4)
    np.testing.assert_allclose(k.numpy(), np.asarray(rk), atol=1e-4,
                               rtol=1e-4)
    np.testing.assert_allclose(v.numpy(), np.asarray(rv), atol=1e-4,
                               rtol=1e-4)


def _arena_state(seed, L=2, N=13, H=4, B=4, D=8, S=3, M=4):
    rng = np.random.RandomState(seed)
    ka = rng.randn(L, N, H, B, D).astype(np.float32)
    va = rng.randn(L, N, H, B, D).astype(np.float32)
    ids = np.arange(1, N)
    rng.shuffle(ids)
    tables = ids[:S * M].reshape(S, M).astype(np.int32)
    tables[2] = 0                                  # an idle slot
    pos = np.asarray([5, 14, 0], np.int32)
    token = np.asarray([3, 17, 0], np.int32)
    return ka, va, tables, pos, token


@pytest.mark.parametrize("attn", ["gather", "paged_kernel"])
def test_decode_step_paged_matches_jax(attn):
    """One paged decode step: logits and both arenas after the in-place
    write (the JAX side returns fresh arrays), 1e-4."""
    jm, tm = _pair("rope")
    ka, va, tables, pos, token = _arena_state(0)
    rl, rka, rva = jgen._decode_step_paged(
        jm, jm.params, jnp.asarray(token), jnp.asarray(pos),
        jnp.asarray(tables), jnp.asarray(ka), jnp.asarray(va),
        attn_impl=attn)
    tka, tva = torch.from_numpy(ka.copy()), torch.from_numpy(va.copy())
    logits, k_out, v_out = tgen._decode_step_paged(
        tm, tm.params, torch.from_numpy(token), torch.from_numpy(pos),
        torch.from_numpy(tables), tka, tva, attn_impl=attn)
    assert k_out is tka and v_out is tva          # updated in place
    # the idle slot's scratch write is garbage on both sides by design;
    # compare the live slots' logits and every block but scratch
    np.testing.assert_allclose(logits.numpy()[:2], np.asarray(rl)[:2],
                               atol=1e-4, rtol=1e-4)
    np.testing.assert_allclose(tka.numpy()[:, 1:], np.asarray(rka)[:, 1:],
                               atol=1e-4, rtol=1e-4)
    np.testing.assert_allclose(tva.numpy()[:, 1:], np.asarray(rva)[:, 1:],
                               atol=1e-4, rtol=1e-4)


def test_prefill_suffix_and_insert_match_jax():
    """Suffix prefill against a cached chain, then the block scatter."""
    jm, tm = _pair("rope")
    ka, va, _, _, _ = _arena_state(1)
    blocks = np.asarray([7, 2, 0, 0], np.int64)    # 2 cached + padding
    ids0 = np.zeros((1, 8), np.int64)
    ids0[0, :5] = [4, 9, 1, 22, 13]
    rl, rk, rv = jgen._prefill_suffix_parts(
        jm, jm.params, jnp.asarray(ids0), 4, 8, jnp.asarray(blocks),
        jnp.asarray(ka), jnp.asarray(va))
    logits, k, v = tgen._prefill_suffix_parts(
        tm, tm.params, torch.from_numpy(ids0), 4, 8,
        torch.from_numpy(blocks), torch.from_numpy(ka),
        torch.from_numpy(va))
    np.testing.assert_allclose(logits.numpy(), np.asarray(rl), atol=1e-4,
                               rtol=1e-4)
    np.testing.assert_allclose(k.numpy(), np.asarray(rk), atol=1e-4,
                               rtol=1e-4)
    dest = np.asarray([5, 11, 0], np.int64)
    rka, rva = jgen._insert_blocks(jnp.asarray(ka), jnp.asarray(va), rk, rv,
                                   jnp.asarray(dest))
    tka, tva = torch.from_numpy(ka.copy()), torch.from_numpy(va.copy())
    tgen._insert_blocks(tka, tva, k, v, torch.from_numpy(dest))
    np.testing.assert_allclose(tka.numpy()[:, 1:], np.asarray(rka)[:, 1:],
                               atol=1e-4, rtol=1e-4)
    np.testing.assert_allclose(tva.numpy()[:, 1:], np.asarray(rva)[:, 1:],
                               atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("name", ["learned", "rope"])
def test_generate_greedy_token_exact_vs_jax(name):
    jm, tm = _pair(name, seed=3)
    ids = np.random.RandomState(4).randint(1, 30, size=(2, 7)).astype(
        np.int32)
    ref = np.asarray(jgen.generate(jm, jm.params, jnp.asarray(ids), 9))
    out = tgen.generate(tm, tm.params, ids, 9, device="cpu")
    assert out.dtype == torch.int64
    np.testing.assert_array_equal(out.numpy(), ref)


def test_unported_options_raise():
    # moe_experts (tests/test_torch_port_moe.py) and train summaries
    # (tests/test_torch_port_summary.py) are ported; placement is not
    from bigdl_tpu_torch.optim import LocalOptimizer
    from bigdl_tpu_torch.serving import LMServingEngine
    opt = LocalOptimizer(None, None, None)
    summary = object()
    assert opt.set_train_summary(summary) is opt
    assert opt.train_summary is summary
    tm = TransformerLM(vocab_size=11, hidden_size=8, n_head=2, n_layers=1,
                       max_len=16, device="cpu").build(0)
    with pytest.raises(NotImplementedError, match="item 11.7"):
        LMServingEngine(tm, placement=object(), device="cpu")
    with pytest.raises(ValueError, match="max_len"):
        tgen.generate(tm, tm.params, np.ones((1, 10), np.int32), 8,
                      device="cpu")
