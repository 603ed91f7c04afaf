"""bigdl_tpu_torch's host surface against the JAX package's, on the CPU:
the ``Tensor``/``Storage`` facade, the ``RandomGenerator`` draws and the
``RNG`` facade, the quantized convolution (``qconv``/``qconv_i8`` and
``Module.quantize`` on the image classifiers) and per-layer profiling.

The Tensor classes mirror the reference's ``tests/test_tensor.py`` case
for case (``to_jax``/``from_jax`` are ``to_torch``/``from_torch`` here);
the parity tests below run the same seeded inputs through both
packages.  RNG streams, random fills and the int8 convolution are held
bitwise; the rest with the tolerance each test states.
"""
import threading

import numpy as np
import pytest
import torch

from bigdl_tpu_torch.tensor import Storage, Tensor

# --------------------------------------------------------------------- #
# the reference's Tensor cases, on the port                             #
# --------------------------------------------------------------------- #
class TestShape:
    def test_construct_sizes(self):
        t = Tensor(3, 4)
        assert t.dim() == 2 and t.size() == (3, 4) and t.n_element() == 12
        assert t.size(1) == 3 and t.size(2) == 4
        assert t.stride() == (4, 1)

    def test_construct_from_array(self):
        t = Tensor(np.arange(6, dtype=np.float32).reshape(2, 3))
        assert t.size() == (2, 3)
        assert t.value_at(2, 3) == 5.0

    def test_one_based_get_set(self):
        t = Tensor(2, 2)
        t.set_value(1, 1, 7).set_value(2, 2, 9)
        assert t[1, 1] == 7.0 and t[2, 2] == 9.0
        assert t.storage()[1] == 7.0  # storage is 1-based too

    def test_narrow_aliases(self):
        t = Tensor(np.zeros((4, 3), np.float32))
        n = t.narrow(1, 2, 2)  # rows 2..3
        n.fill(5)
        assert t.value_at(1, 1) == 0 and t.value_at(2, 1) == 5 and t.value_at(3, 3) == 5
        assert t.value_at(4, 1) == 0

    def test_select(self):
        t = Tensor(np.arange(12, dtype=np.float32).reshape(3, 4))
        row2 = t.select(1, 2)
        assert row2.size() == (4,)
        assert row2.value_at(1) == 4.0
        row2.fill(-1)  # aliases
        assert t.value_at(2, 3) == -1

    def test_view_and_reshape(self):
        t = Tensor(np.arange(6, dtype=np.float32))
        v = t.view(2, 3)
        assert v.size() == (2, 3) and v.value_at(2, 1) == 3.0
        v2 = t.view(3, -1)
        assert v2.size() == (3, 2)

    def test_transpose_t(self):
        t = Tensor(np.arange(6, dtype=np.float32).reshape(2, 3))
        tt = t.t()
        assert tt.size() == (3, 2) and tt.value_at(3, 1) == 2.0
        assert not tt.is_contiguous() and tt.contiguous().is_contiguous()

    def test_unfold(self):
        t = Tensor(np.arange(7, dtype=np.float32))
        u = t.unfold(1, 3, 2)  # windows [0,1,2],[2,3,4],[4,5,6]
        assert u.size() == (3, 3)
        assert u.value_at(2, 1) == 2.0 and u.value_at(3, 3) == 6.0

    def test_expand(self):
        t = Tensor(np.array([[1.0], [2.0]], np.float32))
        e = t.expand(2, 3)
        assert e.size() == (2, 3) and e.value_at(2, 3) == 2.0

    def test_squeeze_unsqueeze(self):
        t = Tensor(1, 3, 1)
        assert t.squeeze().size() == (3,)
        assert t.squeeze(3).size() == (1, 3)
        assert Tensor(3).unsqueeze(1).size() == (1, 3)

    def test_split(self):
        t = Tensor(np.arange(10, dtype=np.float32))
        parts = t.split(4)
        assert [p.size(1) for p in parts] == [4, 4, 2]
        assert parts[2].value_at(1) == 8.0

    def test_set_shares_storage(self):
        a = Tensor(np.arange(4, dtype=np.float32))
        b = Tensor()
        b.set(a)
        b.fill(9)
        assert a.value_at(1) == 9.0

    def test_resize(self):
        t = Tensor(2, 2)
        t.resize(3, 3)
        assert t.size() == (3, 3)


class TestMath:
    def test_add_scalar_tensor_alpha(self):
        t = Tensor(np.ones((2, 2), np.float32))
        t.add(1.0)
        assert t.value_at(1, 1) == 2.0
        t.add(2.0, Tensor(np.ones((2, 2), np.float32)))
        assert t.value_at(2, 2) == 4.0

    def test_operators(self):
        a = Tensor(np.full((2,), 3.0, np.float32))
        b = Tensor(np.full((2,), 2.0, np.float32))
        assert (a + b).value_at(1) == 5.0
        assert (a - b).value_at(1) == 1.0
        assert (a * b).value_at(1) == 6.0
        assert (a / b).value_at(1) == 1.5
        assert (2.0 * a).value_at(1) == 6.0
        assert (-a).value_at(1) == -3.0

    def test_cmul_cdiv_addcmul(self):
        a = Tensor(np.full((3,), 6.0, np.float32))
        a.cmul(Tensor(np.full((3,), 2.0, np.float32)))
        assert a.value_at(1) == 12.0
        a.cdiv(Tensor(np.full((3,), 3.0, np.float32)))
        assert a.value_at(1) == 4.0
        a.addcmul(0.5, Tensor(np.full((3,), 2.0, np.float32)),
                  Tensor(np.full((3,), 2.0, np.float32)))
        assert a.value_at(1) == 6.0

    def test_addmm_mm(self):
        m1 = Tensor(np.arange(6, dtype=np.float32).reshape(2, 3))
        m2 = Tensor(np.arange(6, dtype=np.float32).reshape(3, 2))
        out = Tensor(2, 2).zero().addmm(m1, m2)
        expect = m1.numpy() @ m2.numpy()
        np.testing.assert_allclose(out.numpy(), expect)
        out2 = Tensor().mm(m1, m2)
        np.testing.assert_allclose(out2.numpy(), expect)

    def test_addmm_beta_alpha(self):
        c = Tensor(np.ones((2, 2), np.float32))
        m = Tensor(np.eye(2, dtype=np.float32))
        c.addmm(2.0, 3.0, m, m)  # 2*1 + 3*I
        np.testing.assert_allclose(c.numpy(), 2 * np.ones((2, 2)) + 3 * np.eye(2))

    def test_mv_dot_addr_bmm(self):
        m = Tensor(np.arange(6, dtype=np.float32).reshape(2, 3))
        v = Tensor(np.ones(3, np.float32))
        assert Tensor().mv(m, v).numpy().tolist() == [3.0, 12.0]
        assert Tensor(np.array([1.0, 2.0], np.float32)).dot(
            Tensor(np.array([3.0, 4.0], np.float32))) == 11.0
        r = Tensor(2, 2).zero().addr(Tensor(np.array([1.0, 2.0], np.float32)),
                                     Tensor(np.array([3.0, 4.0], np.float32)))
        np.testing.assert_allclose(r.numpy(), [[3, 4], [6, 8]])
        b = Tensor(np.ones((2, 2, 2), np.float32))
        np.testing.assert_allclose(Tensor().bmm(b, b).numpy(), 2 * np.ones((2, 2, 2)))

    def test_transcendental(self):
        t = Tensor(np.array([1.0, 4.0], np.float32))
        assert t.clone().sqrt().numpy().tolist() == [1.0, 2.0]
        np.testing.assert_allclose(t.clone().log().numpy(), np.log([1.0, 4.0]), rtol=1e-6)
        np.testing.assert_allclose(t.clone().exp().numpy(), np.exp([1.0, 4.0]), rtol=1e-6)
        assert t.clone().pow(2).numpy().tolist() == [1.0, 16.0]
        assert Tensor(np.array([-2.0], np.float32)).abs().value_at(1) == 2.0

    def test_reductions(self):
        t = Tensor(np.arange(6, dtype=np.float32).reshape(2, 3))
        assert t.sum() == 15.0 and t.mean() == 2.5
        assert t.sum(1).numpy().tolist() == [[3.0, 5.0, 7.0]]
        assert t.max() == 5.0 and t.min() == 0.0
        vals, idx = t.max(2)
        assert vals.numpy().reshape(-1).tolist() == [2.0, 5.0]
        assert idx.numpy().reshape(-1).tolist() == [3.0, 3.0]  # 1-based

    def test_topk(self):
        t = Tensor(np.array([[3.0, 1.0, 2.0]], np.float32))
        vals, idx = t.topk(2)  # 2 smallest, increasing
        assert vals.numpy().tolist() == [[1.0, 2.0]]
        assert idx.numpy().tolist() == [[2.0, 3.0]]
        vals, idx = t.topk(1, increase=False)
        assert vals.numpy().tolist() == [[3.0]] and idx.numpy().tolist() == [[1.0]]

    def test_norm_dist(self):
        t = Tensor(np.array([3.0, 4.0], np.float32))
        assert t.norm(2) == pytest.approx(5.0)
        assert t.norm(1) == pytest.approx(7.0)
        assert t.dist(Tensor(np.zeros(2, np.float32))) == pytest.approx(5.0)

    def test_masks(self):
        t = Tensor(np.array([1.0, 5.0, 3.0], np.float32))
        assert t.gt(2.0).numpy().tolist() == [0.0, 1.0, 1.0]
        assert t.le(3.0).numpy().tolist() == [1.0, 0.0, 1.0]
        assert t.eq(5.0).numpy().tolist() == [0.0, 1.0, 0.0]
        m = t.gt(2.0)
        sel = t.masked_select(m)
        assert sel.numpy().tolist() == [5.0, 3.0]
        t.masked_fill(m, 0.0)
        assert t.numpy().tolist() == [1.0, 0.0, 0.0]

    def test_gather_scatter(self):
        t = Tensor(np.arange(1, 7, dtype=np.float32).reshape(2, 3))
        idx = Tensor(np.array([[1.0], [3.0]], np.float32))
        g = t.gather(2, idx)
        assert g.numpy().reshape(-1).tolist() == [1.0, 6.0]
        t.scatter(2, idx, Tensor(np.array([[9.0], [9.0]], np.float32)))
        assert t.value_at(1, 1) == 9.0 and t.value_at(2, 3) == 9.0

    def test_index_select(self):
        t = Tensor(np.arange(6, dtype=np.float32).reshape(3, 2))
        s = t.index_select(1, Tensor(np.array([3.0, 1.0], np.float32)))
        assert s.numpy().tolist() == [[4.0, 5.0], [0.0, 1.0]]

    def test_conv2_xcorr2(self):
        a = Tensor(np.arange(9, dtype=np.float32).reshape(3, 3))
        k = Tensor(np.array([[0.0, 1.0], [2.0, 3.0]], np.float32))
        x = a.xcorr2(k)
        expect = np.array([[1 * 1 + 3 * 2 + 4 * 3, 2 + 4 * 2 + 5 * 3],
                           [4 + 6 * 2 + 7 * 3, 5 + 7 * 2 + 8 * 3]], np.float32)
        np.testing.assert_allclose(x.numpy(), expect)
        # conv2 == xcorr2 with flipped kernel
        np.testing.assert_allclose(
            a.conv2(k).numpy(),
            a.xcorr2(Tensor(np.flip(k.numpy()).copy())).numpy())


class TestFactoriesAndRandom:
    def test_ones_zeros_range(self):
        assert Tensor.ones(2, 2).numpy().tolist() == [[1.0, 1.0], [1.0, 1.0]]
        assert Tensor.zeros(3).numpy().tolist() == [0.0, 0.0, 0.0]
        assert Tensor.arange(1, 5).numpy().tolist() == [1.0, 2.0, 3.0, 4.0, 5.0]
        assert Tensor.arange(0, 10, 5).numpy().tolist() == [0.0, 5.0, 10.0]

    def test_randperm(self):
        p = Tensor.randperm(10).numpy()
        assert sorted(p.tolist()) == list(range(1, 11))

    def test_gaussian1D(self):
        g = Tensor.gaussian1D(5, normalize=True)
        assert g.size() == (5,)
        assert g.numpy().sum() == pytest.approx(1.0, abs=1e-6)
        assert g.numpy().argmax() == 2  # centered

    def test_rand_deterministic(self):
        from bigdl_tpu_torch.utils.rng import RNG
        RNG.set_seed(42)
        a = Tensor(4).rand().numpy()
        RNG.set_seed(42)
        b = Tensor(4).rand().numpy()
        np.testing.assert_array_equal(a, b)
        assert ((0 <= a) & (a < 1)).all()

    def test_bernoulli(self):
        from bigdl_tpu_torch.utils.rng import RNG
        RNG.set_seed(1)
        t = Tensor(1000).bernoulli(0.3)
        assert 0.2 < t.numpy().mean() < 0.4

    def test_storage(self):
        s = Storage([1.0, 2.0, 3.0])
        assert len(s) == 3 and s[2] == 2.0
        s[1] = 9.0
        assert s[1] == 9.0
        s.fill(0.0, 2, 2)
        assert s.array().tolist() == [9.0, 0.0, 0.0]


class TestInterop:
    def test_torch_roundtrip(self):
        t = Tensor(np.arange(4, dtype=np.float32).reshape(2, 2))
        j = t.to_torch("cpu")
        assert j.shape == (2, 2)
        t2 = Tensor.from_torch(j)
        assert t2.almost_equal(t)

    def test_clone_independent(self):
        a = Tensor(np.ones(3, np.float32))
        b = a.clone()
        b.fill(2)
        assert a.value_at(1) == 1.0

    def test_apply1(self):
        t = Tensor(np.array([1.0, 2.0], np.float32)).apply1(lambda x: x * 10)
        assert t.numpy().tolist() == [10.0, 20.0]


# --------------------------------------------------------------------- #
# Tensor against the reference                                          #
# --------------------------------------------------------------------- #
def _pair(seed=0, shape=(3, 4)):
    from bigdl_tpu.tensor import Tensor as J
    a = np.random.RandomState(seed).randn(*shape).astype(np.float32)
    return Tensor(a.copy()), J(a.copy())


_OPS = {
    # name: fn(t, Tensor class) -> Tensor or float; both packages
    "narrow_fill": lambda t, T: (t.narrow(2, 2, 2).fill(7.0), t)[1],
    "select_add": lambda t, T: (t.select(1, 2).add(3.0), t)[1],
    "transpose_contig": lambda t, T: t.transpose(1, 2).contiguous(),
    "unfold": lambda t, T: t.view(12).unfold(1, 3, 2).contiguous(),
    "expand_copy": lambda t, T: T(1, 4).copy(t.narrow(1, 1, 1))
    .expand(3, 4).contiguous(),
    "addmm": lambda t, T: T(np.ones((3, 3), np.float32)).addmm(
        0.5, 2.0, t, t.t()),
    "addmv": lambda t, T: T(3).fill(1.0).addmv(2.0, t, t.select(1, 1)),
    "addr": lambda t, T: T(3, 3).zero().addr(t.select(2, 1),
                                             t.select(2, 2)),
    "cmul_cdiv": lambda t, T: t.clone().cmul(t).cdiv(t.clone().abs()
                                                    .add(1.0)),
    "addcmul_addcdiv": lambda t, T: t.clone().addcmul(0.5, t, t)
    .addcdiv(2.0, t, t.clone().abs().add(1.0)),
    "transcendental": lambda t, T: t.clone().abs().add(0.5).log().exp()
    .sqrt().pow(3).log1p(),
    "sum_mean_dim": lambda t, T: t.sum(2) + t.mean(1).expand(1, 4)
    .contiguous().sum(1),
    "max_dim": lambda t, T: t.max(2)[1] + t.max(2)[0],
    "min_dim": lambda t, T: t.min(1)[1] + t.min(1)[0],
    "topk": lambda t, T: t.topk(2, 2, increase=False)[1] + t.topk(2)[0],
    "norm_dist": lambda t, T: T(np.array([t.norm(3), t.norm(1),
                                          t.dist(t.clone().mul(2.0))],
                                         np.float32)),
    "masks": lambda t, T: t.gt(0.0) + t.le(0.1) + t.clone().masked_fill(
        t.lt(0.0), 9.0),
    "masked_select": lambda t, T: t.masked_select(t.ge(0.0)),
    "gather_scatter": lambda t, T: t.clone().scatter(
        2, T(np.array([[1.0], [4.0], [2.0]], np.float32)),
        T(np.full((3, 1), 5.0, np.float32))).gather(
        2, T(np.array([[4.0, 1.0], [2.0, 2.0], [3.0, 1.0]], np.float32))),
    "index_select": lambda t, T: t.index_select(
        2, T(np.array([4.0, 1.0], np.float32))),
    "conv2_xcorr2": lambda t, T: t.conv2(t.narrow(1, 1, 2).narrow(2, 1, 2))
    + t.xcorr2(t.narrow(1, 2, 2).narrow(2, 2, 2)),
    "operators": lambda t, T: (t + 1.0) * t - t / 2.0 - (-t) + 3.0 * t,
    "gaussian1D": lambda t, T: T.gaussian1D(7, 0.3, 2.0, True, 0.4),
    "arange": lambda t, T: T.arange(0.1, 0.9, 0.1),
}


@pytest.mark.parametrize("op", sorted(_OPS))
def test_tensor_op_matches_the_reference(op):
    """Each Torch verb on the same seeded (3, 4) tensor: the same shape,
    values within 1e-6 relative / 1e-6 absolute (float32 reductions sum
    in another order), and the receiver's storage aliased alike."""
    from bigdl_tpu.tensor import Tensor as J
    t, j = _pair()
    got, want = _OPS[op](t, Tensor), _OPS[op](j, J)
    if isinstance(got, Tensor):
        assert got.size() == want.size()
        got, want = got.numpy(), want.numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(t.numpy(), j.numpy(), rtol=0, atol=0)


def test_views_share_the_references_offsets_and_strides():
    from bigdl_tpu.tensor import Tensor as J
    for T in (Tensor, J):
        t = T(np.arange(24, dtype=np.float32).reshape(2, 3, 4))
        views = [t.narrow(3, 2, 2), t.select(2, 3), t.transpose(1, 3),
                 t.unfold(3, 2, 2), t.unsqueeze(2), t.view(6, 4)]
        meta = [(v.storage_offset(), v.size(), v.stride(),
                 v.is_contiguous()) for v in views]
        if T is Tensor:
            port = meta
    assert port == meta


# --------------------------------------------------------------------- #
# the RNG draws, bitwise                                                #
# --------------------------------------------------------------------- #
def _draws(gen):
    """Every draw kind interleaved, in an order that leaves a cached
    normal pending across kinds."""
    out = [gen.normal(), gen.uniform(2.0, 3.0), gen.normal(1.0, 2.0),
           gen.normal(), gen.exponential(1.5), gen.cauchy(0.5, 2.0),
           gen.log_normal(1.0, 0.5), gen.geometric(0.3),
           float(gen.bernoulli(0.4)), gen.normal()]
    out += gen.uniform_array(5, -1.0, 1.0).tolist()
    out += gen.normal_array(7, 0.5, 3.0).tolist()
    out += gen.bernoulli_array(9, 0.5).tolist()
    out += [gen.normal(), float(gen.random_int())]
    return out


@pytest.mark.parametrize("seed", [1, 42, 5489])
def test_rng_draws_are_the_references_bitwise(seed):
    """The reference's generator (its native library) and the port's
    host library give the same stream, the cached second polar value
    included."""
    from bigdl_tpu.utils.rng import RandomGenerator as J
    from bigdl_tpu_torch.utils.rng import RandomGenerator
    assert _draws(RandomGenerator(seed)) == _draws(J(seed))


def test_rng_python_path_is_the_native_stream(monkeypatch):
    """With BIGDL_TPU_NO_NATIVE=1 the port's draws run in Python, bit
    for bit the native stream: past the 455th word too, where the
    reference's own Python fallback leaves the standard sequence (its
    fallback is therefore compared only over its first 400 words)."""
    from bigdl_tpu.utils.rng import RandomGenerator as J
    from bigdl_tpu_torch.utils.rng import RandomGenerator
    native = RandomGenerator(7)
    want = _draws(native) + native.normal_array(20_000).tolist()
    monkeypatch.setenv("BIGDL_TPU_NO_NATIVE", "1")
    py = RandomGenerator(7)
    assert py._native is None
    assert _draws(py) + py.normal_array(20_000).tolist() == want
    a, b = RandomGenerator(3), J(3)
    b._native = None                # the reference's Python fallback
    b.set_seed(3)
    assert [a.normal() for _ in range(100)] == [b.normal()
                                                for _ in range(100)]


@pytest.mark.parametrize("native", [True, False])
def test_rng_copy_carries_the_cached_normal(monkeypatch, native):
    import copy
    import pickle

    from bigdl_tpu_torch.utils.rng import RandomGenerator
    if not native:
        monkeypatch.setenv("BIGDL_TPU_NO_NATIVE", "1")
    g = RandomGenerator(11)
    g.normal()                      # the second polar value is cached
    for twin in (copy.deepcopy(g), pickle.loads(pickle.dumps(g))):
        assert twin.normal() == copy.deepcopy(g).normal()
    want = g.normal()
    g.set_seed(11)
    g.normal()
    assert g.normal() == want       # set_seed clears the cache


def test_rng_facade_is_thread_local_and_the_references():
    from bigdl_tpu.utils.rng import RNG as J
    from bigdl_tpu_torch.utils.rng import RNG
    RNG.set_seed(42)
    J.set_seed(42)
    assert [RNG.uniform(), RNG.normal(), RNG.normal(0.5, 2.0),
            float(RNG.bernoulli(0.5))] == [J.uniform(), J.normal(),
                                           J.normal(0.5, 2.0),
                                           float(J.bernoulli(0.5))]
    seen = {}

    def other():
        seen["draw"] = RNG.uniform()   # a fresh generator, seed 5489
    th = threading.Thread(target=other)
    th.start()
    th.join()
    from bigdl_tpu_torch.utils.rng import RandomGenerator
    assert seen["draw"] == RandomGenerator(5489).uniform()


@pytest.mark.parametrize("fill", ["rand", "randn", "bernoulli", "randperm"])
def test_tensor_random_fills_are_the_references_bitwise(fill):
    """The fills draw from RNG in the reference's order, into a
    non-contiguous view too."""
    from bigdl_tpu.tensor import Tensor as J
    from bigdl_tpu.utils.rng import RNG as JR
    from bigdl_tpu_torch.utils.rng import RNG
    out = []
    for T, R in ((Tensor, RNG), (J, JR)):
        R.set_seed(123)
        if fill == "randperm":
            out.append(T.randperm(50).numpy())
            continue
        t = T(5, 6)
        view = t.t().narrow(1, 2, 3)
        args = (0.3,) if fill == "bernoulli" else ()
        getattr(view, fill)(*args)
        getattr(T(4, 4), fill)(*args)
        out.append(t.numpy())
    np.testing.assert_array_equal(out[0], out[1])


def test_to_torch_and_from_torch_lose_nothing():
    t = Tensor(np.random.RandomState(2).randn(3, 5).astype(np.float32)).t()
    d = t.to_torch("cpu")
    assert d.is_contiguous() and d.shape == (5, 3)
    back = Tensor.from_torch(d)
    assert back == t.contiguous() and back.storage() is not t.storage()


# --------------------------------------------------------------------- #
# the quantized convolution                                             #
# --------------------------------------------------------------------- #
_CONVS = [  # n, c, h, w, o, k, stride, pad, groups, dilation
    (2, 3, 8, 8, 4, 3, 1, 1, 1, 1),
    (3, 6, 11, 9, 8, 3, 2, 0, 2, 1),
    (2, 4, 9, 9, 4, 3, 1, 2, 1, 2),
    (1, 2, 7, 7, 5, 5, 2, 2, 1, 1),
]


def _qconv_case(case, compute, act_scale=None, seed=0):
    from bigdl_tpu.quant.qtensor import quantize_array as jq
    from bigdl_tpu_torch.utils.params import params_from_numpy
    n, c, h, w, o, k, s, p, g, d = case
    rs = np.random.RandomState(seed)
    x = rs.randn(n, c, h, w).astype(np.float32)
    wt = rs.randn(o, c // g, k, k).astype(np.float32)
    jqt = jq(wt, (1, 2, 3), native=True, compute=compute)
    if act_scale is not None:
        jqt = jqt.replace(act_scale=act_scale) if hasattr(jqt, "replace") \
            else type(jqt)(jqt.q, jqt.scale, jqt.orig_dtype, jqt.native,
                           jqt.compute, act_scale)
    jkw = dict(window_strides=(s, s), padding=((p, p), (p, p)),
               dimension_numbers=("NCHW", "OIHW", "NCHW"),
               feature_group_count=g, rhs_dilation=(d, d))
    tkw = dict(stride=(s, s), padding=(p, p), dilation=(d, d), groups=g)
    return x, jqt, params_from_numpy({"w": jqt}, "cpu")["w"], jkw, tkw


@pytest.mark.parametrize("case", _CONVS)
@pytest.mark.parametrize("act_scale", [None, 0.02])
def test_qconv_i8_is_the_references_bitwise(case, act_scale):
    """The int8 convolution on the same QTensor: per-sample (or the
    calibrated static) activation scale, exact int32 products through
    F.unfold and int_mm, one float32 rescale: bitwise equal."""
    import jax.numpy as jnp
    from bigdl_tpu.quant.kernels import qconv_i8 as jconv
    from bigdl_tpu_torch.quant import qconv, qconv_i8
    x, jqt, qt, jkw, tkw = _qconv_case(case, "int8", act_scale)
    want = np.asarray(jconv(jnp.asarray(x), jqt, **jkw))
    got = qconv_i8(torch.from_numpy(x), qt, **tkw).numpy()
    np.testing.assert_array_equal(got, want)
    # qconv dispatches the int8 weight to it
    np.testing.assert_array_equal(qconv(torch.from_numpy(x), qt,
                                        **tkw).numpy(), want)


@pytest.mark.parametrize("case", _CONVS)
def test_qconv_dequant_matches_the_reference(case):
    """dequant: bf16 operands, float32 accumulation; within 1e-5 of the
    output's largest magnitude (the summation order only)."""
    import jax.numpy as jnp
    from bigdl_tpu.quant.kernels import qconv as jconv
    from bigdl_tpu_torch.quant import qconv
    x, jqt, qt, jkw, tkw = _qconv_case(case, "dequant")
    want = np.asarray(jconv(jnp.asarray(x), jqt, **jkw))
    got = qconv(torch.from_numpy(x), qt, **tkw).numpy()
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=1e-5 * np.abs(want).max())


def test_qconv_i8_matches_dequant_regime_to_tolerance():
    """The reference's regime check on the port: int8 within 8% of the
    dequant output's scale."""
    from bigdl_tpu_torch.quant import qconv, qconv_i8
    x, _, qd, _, tkw = _qconv_case(_CONVS[0], "dequant", seed=3)
    _, _, qi, _, _ = _qconv_case(_CONVS[0], "int8", seed=3)
    ref = qconv(torch.from_numpy(x), qd, **tkw).numpy()
    got = qconv_i8(torch.from_numpy(x), qi, **tkw).numpy()
    assert np.max(np.abs(got - ref)) < 0.08 * max(np.max(np.abs(ref)), 1.0)


def _port_and_ref(name):
    """The port's model built from seed 2 and the reference's holding the
    same tree (the port's ``build`` is the reference's bit for bit, and
    skips the reference's per-layer compiles on the CPU)."""
    import jax.numpy as jnp
    from bigdl_tpu import models as jm
    from bigdl_tpu_torch import models as tm
    from bigdl_tpu_torch.utils.params import params_to_numpy
    from bigdl_tpu_torch.utils.pytree import tree_map
    make = {"lenet": lambda m: m.LeNet5(10),
            "resnet": lambda m: m.ResNet(10, depth=8, dataset="cifar10"),
            "vgg": lambda m: m.VggForCifar10(10)}[name]
    port = make(tm).build(seed=2, device="cpu").evaluate()
    ref = make(jm).evaluate()
    ref.params = tree_map(jnp.asarray, params_to_numpy(port.params))
    ref.buffers = tree_map(jnp.asarray, params_to_numpy(port.buffers))
    return port, ref


def test_quantized_lenet_conv_parity_and_payload():
    """The reference's case on the port: native per-output-plane conv
    scales, logits within 5e-2 of float32 with the same top-1, payload
    at most 30%; and the quantized forward within 1e-5 of the
    reference's quantized forward (bf16 products, float32 sums)."""
    from bigdl_tpu_torch.quant import is_qtensor, params_nbytes
    port, ref = _port_and_ref("lenet")
    q, jq = port.quantize("int8"), ref.quantize("int8")
    conv_w = q.params["1"]["weight"]
    assert is_qtensor(conv_w) and conv_w.native
    assert tuple(conv_w.scale.shape) == (conv_w.shape[0], 1, 1, 1)
    np.testing.assert_array_equal(conv_w.q.numpy(),
                                  np.asarray(jq.params["1"]["weight"].q))
    x = np.random.RandomState(5).randn(4, 28, 28, 1).astype(np.float32)
    with torch.no_grad():
        y_f32 = port.forward(torch.from_numpy(x)).numpy()
        y_q = q.forward(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(y_q, y_f32, atol=5e-2)
    assert (y_q.argmax(-1) == y_f32.argmax(-1)).all()
    np.testing.assert_allclose(y_q, np.asarray(jq.forward(x)), rtol=0,
                               atol=1e-5)
    assert q.quant_report["payload_ratio"] <= 0.30
    assert q.quant_report["payload_ratio"] == \
        jq.quant_report["payload_ratio"]
    assert params_nbytes(q.params) < params_nbytes(port.params)
    assert q.quant_report["max_abs_dequant_error"] < 0.05


@pytest.mark.parametrize("name", ["resnet", "vgg"])
def test_quantized_classifier_int8_is_the_references(name):
    """ResNet-8 and VGG (CIFAR) quantized with int8 compute: the
    reference's top-1 on 4 seeded images, and logits within 1e-4 of the
    largest: each layer's products are exact, but a batch norm's float32
    output one ulp off an int8 rounding boundary of the next layer's
    activation quantization rounds to the neighbouring step."""
    port, ref = _port_and_ref(name)
    q, jq = port.quantize("int8", compute="int8"), ref.quantize(
        "int8", compute="int8")
    x = np.random.RandomState(6).randn(4, 3, 32, 32).astype(np.float32)
    with torch.no_grad():
        y_q = q.forward(torch.from_numpy(x)).numpy()
        y_f = port.forward(torch.from_numpy(x)).numpy()
    want = np.asarray(jq.forward(x))
    np.testing.assert_allclose(y_q, want, rtol=0,
                               atol=1e-4 * max(np.abs(want).max(), 1.0))
    assert (y_q.argmax(-1) == want.argmax(-1)).all()
    assert (y_q.argmax(-1) == y_f.argmax(-1)).all()


# --------------------------------------------------------------------- #
# per-layer profiling                                                   #
# --------------------------------------------------------------------- #
def _small(nn, device=None):
    m = nn.Sequential(
        nn.SpatialConvolution(3, 8, 3, 3, 1, 1, 1, 1), nn.ReLU(True),
        nn.SpatialMaxPooling(2, 2, 2, 2), nn.Reshape((8 * 8 * 8,)),
        nn.Linear(8 * 8 * 8, 10), nn.LogSoftMax())
    return m.build(seed=0) if device is None else m.build(seed=0,
                                                          device=device)


def test_profile_layers_reports_flops(nprng):
    from bigdl_tpu_torch import nn
    from bigdl_tpu_torch.utils import profiling
    m = _small(nn, "cpu")
    x = nprng.randn(4, 3, 16, 16).astype(np.float32)
    rows = profiling.profile_layers(m, x, training=True)
    by_name = {r["name"]: r for r in rows}
    assert by_name["SpatialConvolution"]["flops_fwd"] > 0
    assert by_name["Linear"]["flops_fwd"] > 0
    assert (by_name["SpatialConvolution"]["flops_train"]
            >= by_name["SpatialConvolution"]["flops_fwd"])
    assert [r["name"] for r in rows][0] == "SpatialConvolution"
    assert all(r["name"] != "Sequential" for r in rows)


def test_profile_flops_match_xlas_count(nprng):
    """Linear and SpatialConvolution forward and training FLOPs against
    XLA's cost analysis in the reference: the Linear within 1% (XLA also
    counts the bias add); the padded 3x3 convolution within 7% (XLA
    leaves out the taps over the zero padding, 6.3% at this shape, and
    counts the bias add)."""
    from bigdl_tpu import nn as jnn
    from bigdl_tpu.utils import profiling as jp
    from bigdl_tpu_torch import nn
    from bigdl_tpu_torch.utils import profiling
    x = nprng.randn(4, 3, 16, 16).astype(np.float32)
    want = {r["name"]: r for r in jp.profile_layers(_small(jnn), x)}
    got = {r["name"]: r for r in profiling.profile_layers(_small(nn, "cpu"),
                                                           x)}
    for name, tol in (("Linear", 0.01), ("SpatialConvolution", 0.07)):
        for key in ("flops_fwd", "flops_train"):
            assert abs(got[name][key] - want[name][key]) <= \
                tol * want[name][key], (name, key, got[name][key],
                                        want[name][key])


def test_attribute_step_time_fills_get_times(nprng):
    from bigdl_tpu_torch import nn
    from bigdl_tpu_torch.utils import profiling
    m = _small(nn, "cpu")
    x = nprng.randn(4, 3, 16, 16).astype(np.float32)
    m.reset_times()
    rows = profiling.attribute_step_time(m, x, 0.02, training=True)
    assert abs(sum(r["time_s"] for r in rows) - 0.02) < 1e-9
    per_layer = {mod.get_name(): f + b for mod, f, b in m.get_times()
                 if not getattr(mod, "modules", None)}
    assert per_layer["SpatialConvolution"] > 0
    assert per_layer["Linear"] > 0
    assert per_layer["SpatialConvolution"] > per_layer["LogSoftMax"]


def test_attribution_walks_nested_containers(nprng):
    from bigdl_tpu_torch.models import ResNet
    from bigdl_tpu_torch.utils import profiling
    m = ResNet(class_num=10, depth=8, dataset="cifar10").build(
        seed=1, device="cpu")
    x = nprng.randn(2, 3, 32, 32).astype(np.float32)
    rows = profiling.profile_layers(m, x, training=False)
    names = [r["name"] for r in rows]
    assert names.count("SpatialConvolution") >= 7
    assert "SpatialBatchNormalization" in names
    convs = [r for r in rows if r["name"] == "SpatialConvolution"]
    assert all(r["flops_fwd"] > 0 for r in convs)
    linears = [r for r in rows if r["name"] == "Linear"]
    assert linears and all(r["flops_fwd"] > 0 for r in linears)


def test_roofline_attribution_bills_memory_bound_layers(nprng):
    from bigdl_tpu_torch import nn
    from bigdl_tpu_torch.utils.profiling import attribute_step_time

    def model():
        return nn.Sequential(nn.SpatialConvolution(3, 8, 3, 3, 1, 1, 1, 1),
                             nn.SpatialBatchNormalization(8),
                             nn.ReLU()).build(seed=1, device="cpu")
    x = nprng.randn(4, 3, 16, 16).astype(np.float32)
    rows_fl = attribute_step_time(model(), x, 1.0, mode="flops")
    rows_rf = attribute_step_time(model(), x, 1.0, mode="roofline")

    def share(rows, frag):
        return sum(r["time_s"] for r in rows
                   if frag in type(r["module"]).__name__)
    assert share(rows_rf, "BatchNorm") > share(rows_fl, "BatchNorm")
    for rows in (rows_fl, rows_rf):
        assert abs(sum(r["time_s"] for r in rows) - 1.0) < 1e-6
    bn_rows = [r for r in rows_rf if "BatchNorm" in type(r["module"]).__name__]
    assert all(r["bound"] == "memory" for r in bn_rows)
    with pytest.raises(ValueError):
        attribute_step_time(model(), x, 1.0, mode="nope")


def test_measure_layer_times_actual_wall_clock(nprng):
    from bigdl_tpu_torch import nn
    from bigdl_tpu_torch.utils.profiling import measure_layer_times
    model = nn.Sequential(nn.Linear(16, 32), nn.Tanh(),
                          nn.Linear(32, 8)).build(seed=1, device="cpu")
    x = nprng.randn(4, 16).astype(np.float32)
    rows = measure_layer_times(model, x, iters=3, warmup=1)
    assert len(rows) == 3
    for r in rows:
        assert r["measured_fwd_s"] is not None and r["measured_fwd_s"] > 0
        assert r["measured_train_s"] is not None and r["measured_train_s"] > 0
        assert r["granularity"] == "standalone"
    assert any(t[1] > 0 for t in model.get_times())


def test_wire_bytes_and_prediction_are_the_references():
    from bigdl_tpu.utils import profiling as jp
    from bigdl_tpu_torch.utils import profiling
    fp = {"all-gather": 4096, "reduce-scatter": 1024, "all-reduce": 8,
          "collective-permute": 64, "all-to-all": 32}
    for n in (1, 2, 4, 8):
        assert profiling.wire_bytes(fp, n) == jp.wire_bytes(fp, n)
    for args in ((0.1, 1e9, 450.0), (0.0, 0.0, 90.0), (0.2, 5e8, 90.0)):
        assert profiling.predict_ici_efficiency(*args) == \
            jp.predict_ici_efficiency(*args)


def test_planning_constants_are_the_h100s(monkeypatch):
    """The defaults are an H100 SXM5's (not the reference's TPU
    numbers), each named by its env override and read at import."""
    import importlib

    from bigdl_tpu_torch.utils import profiling
    assert profiling.PEAK_FLOPS == 67e12
    assert profiling.PEAK_HBM_BYTES_S == 3350e9
    assert profiling.LINK_GBPS_DEFAULT == 450.0
    assert profiling.env_source("BIGDL_TPU_TORCH_LINK_GBPS") == "default"
    monkeypatch.setenv("BIGDL_TPU_TORCH_LINK_GBPS", "900")
    monkeypatch.setenv("BIGDL_TPU_TORCH_HBM_GBPS", "fast")
    try:
        with pytest.warns(UserWarning, match="not a number"):
            importlib.reload(profiling)
        assert profiling.LINK_GBPS_DEFAULT == 900.0
        assert profiling.env_source("BIGDL_TPU_TORCH_LINK_GBPS") == "env"
        assert profiling.env_source("BIGDL_TPU_TORCH_HBM_GBPS") == \
            "env-malformed-default"
        assert profiling.PEAK_HBM_BYTES_S == 3350e9
    finally:
        monkeypatch.undo()
        importlib.reload(profiling)


def test_collective_footprint_sums_bytes_per_family():
    from bigdl_tpu_torch.utils import profiling
    rows = [("all-gather", torch.bfloat16, 512),
            ("reduce-scatter", torch.bfloat16, 256),
            ("all-reduce", torch.float32, 1), ("all-reduce", torch.float32,
                                               64)]
    assert profiling.collective_footprint(rows) == {
        "all-gather": 1024, "reduce-scatter": 512, "all-reduce": 260}
    assert profiling.collective_footprint([]) == {}
