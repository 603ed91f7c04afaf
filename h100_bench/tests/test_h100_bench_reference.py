"""The plain reference against the port's ``TransformerLM`` at a tiny
width, and the TF32 rounding the control uses."""
import math

import pytest
import torch

from h100_bench.bench.weights import make_params, sizes
from h100_bench.reference import gpt2

TINY = {"vocab_size": 97, "n_embd": 128, "n_head": 2, "n_layer": 3,
        "n_positions": 64, "layer_norm_epsilon": 1e-5,
        "initializer_range": 0.02}


def port_model(config, params):
    from bigdl_tpu_torch.models.transformer import TransformerLM
    s = sizes(config)
    model = TransformerLM(vocab_size=s["vocab"], hidden_size=s["hidden"],
                          n_head=s["heads"], n_layers=s["layers"],
                          ffn_size=s["ffn"], max_len=s["positions"],
                          attention_impl="xla", device="cpu")
    model.params = params
    return model


@pytest.mark.parametrize("seed", [0, 2 ** 31 + 11])
def test_reference_matches_port_forward(seed):
    params = make_params(TINY, seed, "cpu")
    ids0 = torch.randint(0, 97, (2, 40), generator=torch.Generator()
                         .manual_seed(seed % 1000))
    port = port_model(TINY, params).f(params, ids0 + 1)
    ref = torch.log_softmax(gpt2.logits(params, gpt2.hidden(
        params, ids0, TINY["n_head"], 1e-5)), dim=-1)
    assert port.shape == ref.shape == (2, 40, 97)
    assert float((port - ref).abs().max()) < 2e-5


def test_reference_served_logits_follow_the_sequence():
    params = make_params(TINY, 5, "cpu")
    seq = list(range(3, 30))
    full = gpt2.sequence_logits(params, seq, TINY["n_head"], 1e-5)
    part = gpt2.sequence_logits(params, seq[:10], TINY["n_head"], 1e-5)
    # causal: a prefix's logits do not see what follows
    assert torch.allclose(full[:10], part, atol=1e-5)
    assert float(gpt2.gaps(full, full.argmax(dim=-1)).max()) == 0.0


def test_tf32_rounding_keeps_ten_mantissa_bits():
    x = torch.tensor([1.0, 1.0 + 2.0 ** -10, 1.0 + 2.0 ** -11,
                      1.0 + 3 * 2.0 ** -11, -(1.0 + 2.0 ** -12), 0.0,
                      float("inf")])
    r = gpt2.round_tf32(x)
    assert r.tolist() == [1.0, 1.0 + 2.0 ** -10, 1.0,      # tie to even
                          1.0 + 2.0 ** -9,                 # tie to even
                          -1.0, 0.0, float("inf")]


def test_tf32_control_moves_the_logits_more_than_rounding():
    params = make_params(TINY, 7, "cpu")
    ids0 = torch.randint(0, 97, (1, 48), generator=torch.Generator()
                         .manual_seed(3))
    f32 = gpt2.logits(params, gpt2.hidden(params, ids0, 2, 1e-5))
    tf32 = gpt2.logits(params, gpt2.hidden(params, ids0, 2, 1e-5, "tf32"),
                       "tf32")
    port = torch.log_softmax(port_model(TINY, params).f(params, ids0 + 1),
                             -1)
    ref = torch.log_softmax(f32, -1)
    assert float((torch.log_softmax(tf32, -1) - ref).abs().max()) > \
        10 * float((port - ref).abs().max())


def test_tf32_control_is_differentiable():
    a = torch.randn(3, 4, 5, requires_grad=True)
    b = torch.randn(5, 6, requires_grad=True)
    gpt2.products("tf32")(a, b).sum().backward()
    assert a.grad.shape == a.shape and b.grad.shape == b.shape
    assert torch.allclose(b.grad, (a.detach().sum((0, 1))[:, None]
                                   .expand(5, 6)), rtol=1e-2, atol=1e-2)


def n_params(config: dict) -> int:
    """Parameters of the tied model, from the file's sizes."""
    s = sizes(config)
    h, f, L = s["hidden"], s["ffn"], s["layers"]
    block = 4 * h * h + 4 * h + 2 * h * f + f + h + 4 * h
    return s["vocab"] * h + s["positions"] * h + L * block + 2 * h


def test_gpt2_parameter_counts_are_the_published_ones():
    import json
    from h100_bench.bench.common import ROOT
    xl = json.loads((ROOT / "h100_bench/configs/gpt2-xl.json").read_text())
    small = json.loads((ROOT / "h100_bench/configs/gpt2-small.json")
                       .read_text())
    assert n_params(xl) == 1_557_611_200
    assert n_params(small) == 124_439_808


def test_weights_follow_the_seed_and_the_initialiser():
    a, b = make_params(TINY, 9, "cpu"), make_params(TINY, 9, "cpu")
    c = make_params(TINY, 10, "cpu")
    assert torch.equal(a["embed"], b["embed"])
    assert not torch.equal(a["embed"], c["embed"])
    std_out = 0.02 / math.sqrt(2 * TINY["n_layer"])
    assert abs(float(a["blocks"]["w1"].std()) - 0.02) < 2e-3
    assert abs(float(a["blocks"]["w2"].std()) - std_out) < 2e-3
    assert float(a["blocks"]["b1"].abs().max()) == 0.0
