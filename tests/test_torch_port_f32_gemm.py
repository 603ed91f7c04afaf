"""The float32 weight products of the port: ``ops.f32_gemm``.

CPU cases: every product the seam declines (CPU tensors, bf16, a
QTensor, a DTensor) is ``torch.matmul`` bit for bit and counted by its
reason; the 3xTF32 arithmetic, emulated in plain PyTorch, holds float32's
accuracy where one TF32 pass does not; the planner and the operand
layouts.  Card cases (``cuda``, skipped without a card): the kernel
against float64 at the main path's shapes and layouts, its gradients,
repeatability, a CUDA-graph replay, and a training step that routes every
weight product.  The file imports neither JAX nor the JAX package, so the
card cases run on a machine with only PyTorch:

    python -m pytest --noconftest -p no:cacheprovider \
        tests/test_torch_port_f32_gemm.py
"""
import pytest
import torch

from bigdl_tpu_torch import resolve_device
from bigdl_tpu_torch.models.transformer import TransformerLM
from bigdl_tpu_torch.ops import f32_gemm
from bigdl_tpu_torch.quant.kernels import qmatmul
from bigdl_tpu_torch.quant.qtensor import quantize_array
from bigdl_tpu_torch.utils import keychain
from bigdl_tpu_torch.utils.params import params_from_numpy

# the largest error of a product against float64, over the sum of |a||b|
# that bounds it (elementwise): 3xTF32 stays within a few float32
# roundings of it (the kernel read 1.5e-8 to 1.2e-7 on an H100 at the
# main-path shapes); one TF32 pass is off by up to 2^-11 a term
BOUND = 1e-5
# 3xTF32 against float32's own error on the same operands, on the CPU
# (measured 0.9-1.3; one TF32 pass 400-800)
EMULATION_MULTIPLE = 4.0


def _err(c, a, b):
    ref = a.double() @ b.double()
    scale = (a.double().abs() @ b.double().abs()).clamp_min(1e-30)
    return ((c.double() - ref).abs() / scale).max().item()


class DTensor(torch.Tensor):
    """A stand-in, named as ``torch.distributed.tensor.DTensor`` is."""


@pytest.fixture
def fresh_stats():
    f32_gemm.reset_stats()
    yield
    f32_gemm.reset_stats()


def _declined_case(reason):
    g = torch.Generator().manual_seed(7)
    x = torch.randn(5, 3, 48, generator=g)
    w = torch.randn(48, 40, generator=g)
    if reason == "cpu":
        return x, w, torch.matmul(x, w)
    if reason == "dtype":
        x, w = x.bfloat16(), w.bfloat16()
        return x, w, torch.matmul(x, w)
    if reason == "dtensor":
        wd = w.as_subclass(DTensor)
        return x, wd, torch.matmul(x, w)
    q = quantize_array(w, (-2,))
    return x, q, torch.matmul(x, q.dequantize())


@pytest.mark.parametrize("reason", ["cpu", "dtype", "dtensor", "qtensor"])
def test_declined_products_take_torch_matmul(fresh_stats, reason):
    x, w, want = _declined_case(reason)
    got = qmatmul(x, w)
    assert torch.equal(got.as_subclass(torch.Tensor),
                       want.as_subclass(torch.Tensor))
    st = f32_gemm.stats()
    assert st["routed"] == 0
    assert st["declined"] == {r: int(r == reason)
                              for r in f32_gemm.DECLINE_REASONS}


def test_decline_reason_order():
    x = torch.randn(2, 8)
    w = torch.randn(8, 4)
    assert f32_gemm.decline_reason(x, w) == "cpu"
    assert f32_gemm.decline_reason(x.bfloat16(), w.bfloat16()) == "dtype"
    assert f32_gemm.decline_reason(x.bfloat16(), w.as_subclass(DTensor)) \
        == "dtensor"
    meta = torch.empty(8, 4, device="meta")
    assert f32_gemm.decline_reason(x.to("meta"), meta) == "cpu"


@pytest.mark.parametrize("tied", [True, False])
def test_cpu_lm_forward_is_unchanged_and_counted(fresh_stats, tied):
    """A CPU TransformerLM runs every weight product through the seam as
    ``torch.matmul``: each is declined as ``cpu``, none routed, and the
    head's logits are ``torch.matmul``'s bits."""
    model = TransformerLM(97, hidden_size=64, n_head=2, n_layers=2,
                          max_len=32, tie_embeddings=tied, device="cpu")
    params = params_from_numpy(model.init(keychain.prng_key(3)), "cpu")
    ids = torch.randint(1, 98, (2, 16), generator=torch.Generator()
                        .manual_seed(1))
    model.f(params, ids)
    st = f32_gemm.stats()
    assert st["routed"] == 0
    assert st["declined"]["cpu"] == 2 * 6 + 1
    h = torch.randn(3, 64)
    head = params["embed"].T if tied else params["head"]
    assert torch.equal(model.head_logits(params, h), torch.matmul(h, head))


def test_matmul_f32_on_cpu_is_torch_matmul():
    g = torch.Generator().manual_seed(2)
    a = torch.randn(4, 7, 33, generator=g, requires_grad=True)
    b = torch.randn(33, 19, generator=g, requires_grad=True)
    assert torch.equal(f32_gemm.matmul_f32(a, b), torch.matmul(a, b))
    with pytest.raises(ValueError):
        f32_gemm.matmul_f32(a.detach().to("meta"), b.detach().to("meta"))


def _tf32_one_pass(a, b):
    return torch.matmul(f32_gemm._rna_tf32(a), f32_gemm._rna_tf32(b))


@pytest.mark.parametrize("m,n,k", [(16, 50257, 96), (16, 96, 50257),
                                   (33, 257, 1001)])
def test_3xtf32_emulation_holds_float32_accuracy(m, n, k):
    """Split, then three float32 products: within a small multiple of
    plain float32's error against float64 (odd N and K, the vocabulary's
    50,257 among them); one TF32 pass is not, so the check tells the two
    apart."""
    g = torch.Generator().manual_seed(m + n + k)
    a = torch.randn(m, k, generator=g)
    b = torch.randn(k, n, generator=g)
    e_f32 = _err(torch.matmul(a, b), a, b)
    e_3x = _err(f32_gemm.matmul_3xtf32_reference(a, b), a, b)
    e_1 = _err(_tf32_one_pass(a, b), a, b)
    assert e_3x <= EMULATION_MULTIPLE * e_f32
    assert e_3x <= BOUND
    assert e_1 > 25 * EMULATION_MULTIPLE * e_f32


def test_split_tf32_parts():
    g = torch.Generator().manual_seed(4)
    x = torch.randn(10_000, generator=g) * 1e3
    hi, lo = f32_gemm.split_tf32(x)
    for part in (hi, lo):   # 10 stored mantissa bits: the low 13 are 0
        assert not (part.view(torch.int32) & 0x1FFF).any()
    rest = (x.double() - hi.double() - lo.double()).abs()
    assert (rest <= x.double().abs() * 2.0 ** -21).all()


@pytest.mark.parametrize("m,n,k", [
    (32768, 768, 768), (32768, 3072, 768), (32768, 50257, 768),
    (32768, 768, 50257), (768, 768, 32768), (768, 3072, 32768),
    (50257, 768, 32768), (64, 1600, 1600), (64, 6400, 1600),
    (64, 1600, 6400), (64, 50257, 1600), (512, 6400, 1600), (1, 1600, 1600),
    (16, 50257, 1600)])
def test_plan_covers_k_in_whole_stages(m, n, k):
    tile, split, kps = f32_gemm.plan(m, n, k)
    assert tile in f32_gemm.TILES
    assert tile == 1 or m > 64
    assert kps % f32_gemm.BK == 0 and 1 <= split <= f32_gemm.MAX_SPLIT
    assert (split - 1) * kps < k <= split * kps   # no split is empty
    assert f32_gemm.plan(m, n, k) == (tile, split, kps)


def test_operand_layouts_read_in_place():
    t = torch.randn(6, 10)
    assert f32_gemm._operand(t)[1:] == (True, 10)
    assert f32_gemm._operand(t.T)[1:] == (False, 10)
    view = torch.randn(6, 12)[:, :10]      # rows 12 floats apart
    got, kc, ld = f32_gemm._operand(view)
    assert got.data_ptr() == view.data_ptr() and (kc, ld) == (True, 12)
    strided = torch.randn(6, 20)[:, ::2]   # neither layout: copied
    got, kc, ld = f32_gemm._operand(strided)
    assert got.is_contiguous() and (kc, ld) == (True, 10)
    assert torch.equal(got, strided)


# --------------------------------------------------------------------- #
# on the card                                                           #
# --------------------------------------------------------------------- #
@pytest.fixture
def card():
    """The card, decided when the test runs (never at import time)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and the CUDA toolkit")
    return resolve_device("cuda")


def _operand(shape, layout, g, dev):
    """A float32 matrix of ``shape``, row-major ("r") or the transpose of
    a row-major one ("c")."""
    r, c = shape
    if layout == "r":
        return torch.randn(r, c, generator=g, device=dev)
    return torch.randn(c, r, generator=g, device=dev).T


def _launches():
    return f32_gemm.F32_GEMM.launches, f32_gemm.F32_GEMM_REDUCE.launches


# (m, n, k, A layout, B layout): decode, prefill and the training step's
# forward, dX (B transposed) and dW (A transposed) products, the head's
# vocabulary-wide rows (50,257 floats, not 16-byte aligned) among them
MAIN_PATH = [
    (1, 1600, 1600, "r", "r"), (64, 1600, 1600, "r", "r"),
    (64, 6400, 1600, "r", "r"), (64, 1600, 6400, "r", "r"),
    (64, 50257, 1600, "r", "c"), (16, 1600, 1600, "r", "r"),
    (300, 6400, 1600, "r", "r"), (512, 50257, 1600, "r", "c"),
    (1024, 768, 768, "r", "r"), (1024, 3072, 768, "r", "r"),
    (1024, 50257, 768, "r", "c"), (1024, 768, 3072, "r", "c"),
    (1024, 768, 50257, "r", "r"), (768, 768, 4096, "c", "r"),
    (768, 3072, 4096, "c", "r"), (50257, 768, 1024, "c", "r"),
    (777, 333, 555, "c", "c"), (100, 200, 300, "r", "r")]


@pytest.mark.cuda
@pytest.mark.parametrize("m,n,k,la,lb", MAIN_PATH)
def test_kernel_matches_float64(card, m, n, k, la, lb):
    g = torch.Generator(device=card).manual_seed(m + n + k)
    a = _operand((m, k), la, g, card)
    b = _operand((k, n), lb, g, card)
    before = _launches()
    c = f32_gemm.gemm(a, b)
    torch.cuda.synchronize()
    _, split, _ = f32_gemm.plan(m, n, k)
    assert _launches() == (before[0] + 1, before[1] + int(split > 1))
    assert c.shape == (m, n) and c.is_contiguous()
    assert _err(c, a, b) <= BOUND


@pytest.mark.cuda
def test_kernel_gradients_match_float64(card):
    """An (in, out) weight and a tied head's transposed embedding, both
    differentiated through the kernel, against float64 autograd."""
    g = torch.Generator(device=card).manual_seed(11)
    x = torch.randn(3, 100, 768, generator=g, device=card)
    w = torch.randn(768, 1000, generator=g, device=card) * 0.03
    emb = torch.randn(5003, 768, generator=g, device=card) * 0.03
    gy = torch.randn(3, 100, 1000, generator=g, device=card)
    gz = torch.randn(3, 100, 5003, generator=g, device=card)
    grads = {}
    for dt in (torch.float32, torch.float64):
        xs, ws, es = (t.detach().to(dt).requires_grad_()
                      for t in (x, w, emb))
        mm = f32_gemm.matmul_f32 if dt == torch.float32 else torch.matmul
        loss = ((mm(xs, ws) * gy.to(dt)).sum()
                + (mm(xs, es.T) * gz.to(dt)).sum())
        loss.backward()
        grads[dt] = (xs.grad, ws.grad, es.grad)
    for got, want in zip(grads[torch.float32], grads[torch.float64]):
        assert got.dtype == torch.float32 and got.shape == want.shape
        rel = ((got.double() - want).abs().max() / want.abs().max()).item()
        assert rel <= BOUND


@pytest.mark.cuda
@pytest.mark.parametrize("m,n,k", [(64, 1600, 6400), (1024, 3072, 768)])
def test_kernel_is_bitwise_repeatable(card, m, n, k):
    g = torch.Generator(device=card).manual_seed(5)
    a = torch.randn(m, k, generator=g, device=card)
    b = torch.randn(k, n, generator=g, device=card)
    assert torch.equal(f32_gemm.gemm(a, b), f32_gemm.gemm(a, b))


@pytest.mark.cuda
@pytest.mark.parametrize("m,n,k", [(64, 1600, 6400), (256, 768, 768)])
def test_graph_replay_matches_eager(card, m, n, k):
    g = torch.Generator(device=card).manual_seed(6)
    a = torch.randn(m, k, generator=g, device=card)
    b = torch.randn(k, n, generator=g, device=card)
    eager = f32_gemm.gemm(a, b)         # loads the library outside capture
    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.stream(stream), torch.cuda.graph(graph, stream=stream):
        out = f32_gemm.gemm(a, b)
    torch.cuda.current_stream().wait_stream(stream)
    out.zero_()
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(out, eager)


def _random_params(shapes, dev, g):
    if isinstance(shapes, dict):
        return {k: _random_params(v, dev, g) for k, v in shapes.items()}
    return (torch.randn(shapes, generator=g, device=dev) * 0.02
            ).requires_grad_()


@pytest.mark.cuda
def test_training_step_routes_every_weight_product(card, fresh_stats):
    """A GPT-2-small-width step (12 layers, tied head): each layer's six
    products and the head go through the kernel, forward and both
    gradients: 3 x (12 x 6 + 1) launches, none declined."""
    model = TransformerLM(50257, hidden_size=768, n_head=12, n_layers=12,
                          max_len=256, device=card)
    g = torch.Generator(device=card).manual_seed(0)
    params = _random_params(model.param_shapes(), card, g)
    ids = torch.randint(1, 50258, (2, 256), generator=g, device=card)
    before = f32_gemm.F32_GEMM.launches
    logp, _ = model.apply(params, ids, training=True)
    logp.mean().backward()
    torch.cuda.synchronize()
    products = 12 * 6 + 1
    st = f32_gemm.stats()
    assert st["routed"] == products
    assert sum(st["declined"].values()) == 0
    assert f32_gemm.F32_GEMM.launches - before == 3 * products
