"""bigdl_tpu_torch's GPT-2 import and export on the CPU: against the
JAX package's ``load_gpt2_state_dict``/``export_gpt2_state_dict`` on a
state dict built in the test, against the live Hugging Face
``GPT2LMHeadModel`` built from a config (mirrors
tests/test_transformer_gpt2_oracle.py), and the example's two modes."""
import os

import jax
import numpy as np
import pytest
import torch

from bigdl_tpu.models.transformer import TransformerLM as JaxLM
from bigdl_tpu.models.transformer import io as jio

from bigdl_tpu_torch.example import gpt2_import
from bigdl_tpu_torch.models.transformer import TransformerLM
from bigdl_tpu_torch.models.transformer import generate as tgen
from bigdl_tpu_torch.models.transformer.io import (export_gpt2_state_dict,
                                                   load_gpt2_state_dict)
from bigdl_tpu_torch.utils.params import params_to_numpy

# transformers imports TensorFlow when it can, which these tests never use
os.environ.setdefault("USE_TF", "0")
transformers = pytest.importorskip("transformers")

V, H, L, HEADS, T = 97, 32, 2, 2, 24


def _model(**over):
    kw = dict(vocab_size=V, hidden_size=H, n_head=HEADS, n_layers=L,
              max_len=64, pos_encoding="learned", attention_impl="xla",
              device="cpu")
    kw.update(over)
    return TransformerLM(**kw)


def _seeded_state_dict(seed=0, prefix="transformer.", head=True):
    """A GPT-2-shaped state dict with HF key names, from a numpy seed."""
    rng = np.random.RandomState(seed)

    def w(*shape):
        return torch.from_numpy(rng.randn(*shape).astype(np.float32) * 0.05)

    sd = {"wte.weight": w(V, H), "wpe.weight": w(64, H),
          "ln_f.weight": 1 + w(H), "ln_f.bias": w(H)}
    for i in range(L):
        p = f"h.{i}."
        sd.update({p + "ln_1.weight": 1 + w(H), p + "ln_1.bias": w(H),
                   p + "attn.c_attn.weight": w(H, 3 * H),
                   p + "attn.c_attn.bias": w(3 * H),
                   p + "attn.c_proj.weight": w(H, H),
                   p + "attn.c_proj.bias": w(H),
                   p + "ln_2.weight": 1 + w(H), p + "ln_2.bias": w(H),
                   p + "mlp.c_fc.weight": w(H, 4 * H),
                   p + "mlp.c_fc.bias": w(4 * H),
                   p + "mlp.c_proj.weight": w(4 * H, H),
                   p + "mlp.c_proj.bias": w(H)})
    sd = {prefix + k: v for k, v in sd.items()}
    if head:
        sd["lm_head.weight"] = sd[prefix + "wte.weight"].clone()
    return sd


@pytest.mark.parametrize("tie", [True, False])
def test_import_matches_jax_importer(tie):
    """Every leaf bitwise the JAX importer's, and the JAX exporter's
    state dict bitwise the port's."""
    sd = _seeded_state_dict(1)
    jm = JaxLM(vocab_size=V, hidden_size=H, n_head=HEADS, n_layers=L,
               max_len=64, tie_embeddings=tie).build(0)
    jio.load_gpt2_state_dict(jm, sd)
    tm = load_gpt2_state_dict(_model(tie_embeddings=tie), sd)
    got = params_to_numpy(tm.params)
    for path, leaf in jax.tree_util.tree_flatten_with_path(jm.params)[0]:
        node = got
        for p in path:
            node = node[p.key]
        np.testing.assert_array_equal(node, np.asarray(leaf),
                                      err_msg=str(path))
    want = jio.export_gpt2_state_dict(jm)
    mine = export_gpt2_state_dict(tm)
    assert sorted(mine) == sorted(want)
    for k in want:
        np.testing.assert_array_equal(mine[k], want[k], err_msg=k)


def test_export_import_roundtrip_bitwise():
    tm = _model().build(7)
    clone = load_gpt2_state_dict(_model(), export_gpt2_state_dict(tm))
    got = params_to_numpy(clone.params)
    for path, leaf in jax.tree_util.tree_flatten_with_path(
            params_to_numpy(tm.params))[0]:
        node = got
        for p in path:
            node = node[p.key]
        np.testing.assert_array_equal(node, leaf, err_msg=str(path))
    ids = torch.from_numpy(np.random.RandomState(4).randint(1, V + 1, (2, T)))
    assert torch.equal(tm.f(tm.params, ids), clone.f(clone.params, ids))


def _hf_model():
    cfg = transformers.GPT2Config(
        vocab_size=V, n_positions=64, n_embd=H, n_layer=L, n_head=HEADS,
        activation_function="gelu_new",
        resid_pdrop=0.0, embd_pdrop=0.0, attn_pdrop=0.0)
    torch.manual_seed(0)
    return transformers.GPT2LMHeadModel(cfg).eval()


@pytest.fixture(scope="module")
def pair():
    hf = _hf_model()
    return load_gpt2_state_dict(_model(), hf.state_dict()), hf


def _hf_logp(hf, ids0):
    with torch.no_grad():
        return torch.log_softmax(hf(torch.from_numpy(ids0)).logits,
                                 dim=-1).numpy()


def test_gpt2_import_logprob_parity(pair):
    model, hf = pair
    ids0 = np.random.RandomState(5).randint(0, V, (3, T))
    ref = _hf_logp(hf, ids0)
    ours = model.f(model.params, torch.from_numpy(ids0 + 1)).numpy()
    np.testing.assert_allclose(ours, ref, rtol=1e-3, atol=1e-4)
    assert (ours.argmax(-1) == ref.argmax(-1)).all()


def test_gpt2_import_shape_mismatch_raises(pair):
    _, hf = pair
    sd = dict(hf.state_dict())
    sd["transformer.wte.weight"] = torch.zeros(V + 1, H)
    with pytest.raises(ValueError, match="wte.weight"):
        load_gpt2_state_dict(_model(), sd)


def test_gpt2_import_rope_model_rejected(pair):
    _, hf = pair
    with pytest.raises(ValueError, match="learned"):
        load_gpt2_state_dict(_model(pos_encoding="rope"), hf.state_dict())


def test_gpt2_import_diverged_head_into_tied_model_rejected(pair):
    _, hf = pair
    sd = {k: v.clone() for k, v in hf.state_dict().items()}
    sd["lm_head.weight"] = sd["lm_head.weight"] + 1.0
    with pytest.raises(ValueError, match="tie_embeddings=False"):
        load_gpt2_state_dict(_model(tie_embeddings=True), sd)


def test_gpt2_import_moe_model_rejected(pair):
    _, hf = pair
    with pytest.raises(ValueError, match="moe"):
        load_gpt2_state_dict(_model(moe_experts=2), hf.state_dict())


def test_gpt2_import_missing_wpe_clear_error(pair):
    _, hf = pair
    sd = {k: v for k, v in hf.state_dict().items() if "wpe" not in k}
    with pytest.raises(ValueError, match="wpe.weight"):
        load_gpt2_state_dict(_model(), sd)


def test_gpt2_import_untied_head():
    hf = _hf_model()
    model = load_gpt2_state_dict(_model(tie_embeddings=False),
                                 hf.state_dict())
    ids0 = np.random.RandomState(6).randint(0, V, (2, T))
    np.testing.assert_allclose(
        model.f(model.params, torch.from_numpy(ids0 + 1)).numpy(),
        _hf_logp(hf, ids0), rtol=1e-3, atol=1e-4)


def test_gpt2_export_loads_into_live_hf():
    """Port weights exported in GPT-2's layout load into a live
    GPT2LMHeadModel and reproduce the port's log-probs."""
    model = _model().build(7)
    sd = export_gpt2_state_dict(model)
    hf = _hf_model()
    hf.transformer.load_state_dict(
        {k: torch.from_numpy(v.copy()) for k, v in sd.items()}, strict=False)
    hf.tie_weights()
    hf.eval()
    ids0 = np.random.RandomState(8).randint(0, V, (2, T))
    np.testing.assert_allclose(
        model.f(model.params, torch.from_numpy(ids0 + 1)).numpy(),
        _hf_logp(hf, ids0), rtol=1e-3, atol=1e-4)


def test_gpt2_export_untied_roundtrip_and_bf16_cast():
    """The untied head's export round-trips; bf16 leaves export as
    float32."""
    model = _model(tie_embeddings=False).build(13)
    model.params = jax.tree_util.tree_map(lambda w: w.to(torch.bfloat16),
                                          model.params)
    sd = export_gpt2_state_dict(model)
    assert all(v.dtype == np.float32 for v in sd.values())
    clone = load_gpt2_state_dict(_model(tie_embeddings=False), sd)
    assert torch.equal(clone.params["head"],
                       model.params["head"].float())


def test_generate_matches_hf_greedy(pair):
    model, hf = pair
    prompt0 = np.array([[5, 17, 42]])
    out = tgen.generate(model, model.params, prompt0 + 1, 10, device="cpu")
    with torch.no_grad():
        ref = hf.generate(torch.from_numpy(prompt0), max_new_tokens=10,
                          do_sample=False, pad_token_id=0)
    np.testing.assert_array_equal(out.numpy() - 1, ref.numpy())


def test_example_demo_and_checkpoint(tmp_path, capsys):
    """The example's --demo holds itself against transformers' greedy
    generate; --checkpoint reads a torch.save'd state dict (wrapped in
    a "state_dict" key) and generates what offline generate does."""
    gpt2_import.main(["--demo", "--device", "cpu", "--maxNewTokens", "6"])
    assert "matches transformers' greedy generate: True" in \
        capsys.readouterr().out
    sd = _seeded_state_dict(3)
    path = tmp_path / "gpt2.pth"
    torch.save({"state_dict": sd}, path)
    got = gpt2_import.main(
        ["--checkpoint", str(path), "--vocab", str(V), "--hidden", str(H),
         "--layers", str(L), "--heads", str(HEADS), "--maxLen", "64",
         "--prompt", "3,9,27", "--maxNewTokens", "8", "--device", "cpu"])
    model = load_gpt2_state_dict(_model(), sd)
    want = tgen.generate(model, model.params, np.array([[4, 10, 28]]), 8,
                         device="cpu")
    assert got == (want.numpy()[0, 3:] - 1).tolist()
    with pytest.raises(SystemExit, match="out of range"):
        gpt2_import.main(["--checkpoint", str(path), "--vocab", str(V),
                          "--hidden", str(H), "--layers", str(L), "--heads",
                          str(HEADS), "--maxLen", "64", "--prompt", "97",
                          "--device", "cpu"])
