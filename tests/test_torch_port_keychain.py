"""bigdl_tpu_torch.utils.keychain against jax.random (threefry2x32,
partitionable, 64-bit ints off): keys, splits, fold-ins and uniforms
bitwise; Gumbel noise within 2 ulp at unit scale; categorical draws
exactly equal, where a mismatch is a tie only when the top two of
``logits / T + gumbel`` lie within TIE_GAP."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from bigdl_tpu_torch.utils import keychain

TIE_GAP = 1e-4


def _jkey(seed):
    return np.asarray(jax.random.PRNGKey(seed))


def test_jax_prng_is_partitionable_threefry():
    """The key chain copies this configuration of jax.random."""
    assert jax.config.jax_threefry_partitionable
    assert str(jax.config.jax_default_prng_impl) == "threefry2x32"


@pytest.mark.parametrize("seed", [0, 1, 7, 2 ** 31 + 5, 2 ** 32 + 3, -1])
def test_prng_key_bitwise(seed):
    got = keychain.prng_key(seed)
    assert got.dtype == np.uint32 and got.shape == (2,)
    np.testing.assert_array_equal(got, _jkey(seed))
    np.testing.assert_array_equal(keychain.as_key(seed), _jkey(seed))


@pytest.mark.parametrize("num", [1, 2, 7, 31])
def test_split_bitwise(num):
    for seed in (0, 7, 2 ** 31 + 5):
        key = _jkey(seed)
        got = keychain.split(key, num)
        assert got.dtype == np.uint32 and got.shape == (num, 2)
        np.testing.assert_array_equal(
            got, np.asarray(jax.random.split(jnp.asarray(key), num)))


@pytest.mark.parametrize("data", [0, 101, 103, 107, 2 ** 31])
def test_fold_in_bitwise(data):
    for seed in (0, 7, 12345):
        key = _jkey(seed)
        np.testing.assert_array_equal(
            keychain.fold_in(key, data),
            np.asarray(jax.random.fold_in(jnp.asarray(key), data)))


@pytest.mark.parametrize("shape", [(), (1, 50257)])
def test_uniform_bitwise(shape):
    for seed in (0, 3, 99):
        key = keychain.split(_jkey(seed), 3)[2]   # a chain key, not a seed
        got = keychain.uniform(key, shape)
        want = np.asarray(jax.random.uniform(jnp.asarray(key), shape))
        assert got.shape == want.shape and got.dtype == np.float32
        np.testing.assert_array_equal(got.view(np.uint32),
                                      want.view(np.uint32))
    tiny = np.finfo(np.float32).tiny
    got = keychain.uniform(key, (97,), tiny, 1.0)
    want = np.asarray(jax.random.uniform(jnp.asarray(key), (97,),
                                         minval=tiny, maxval=1.0))
    np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))


@pytest.mark.parametrize("bounds", [(1e-30, 3.0), (-1e-10, 3.0),
                                    (0.001, 1000.001), (1000.0, 1000.001)])
def test_uniform_bitwise_with_far_bounds(bounds):
    """Bounds whose scale-and-shift the float64 sum cannot hold exactly:
    a double rounding would miss the fused multiply-add's ties."""
    lo, hi = bounds
    for seed in (0, 5):
        key = keychain.split(_jkey(seed), 3)[2]
        got = keychain.uniform(key, (4099,), lo, hi)
        want = np.asarray(jax.random.uniform(jnp.asarray(key), (4099,),
                                             minval=lo, maxval=hi))
        np.testing.assert_array_equal(got.view(np.uint32),
                                      want.view(np.uint32))


@pytest.mark.parametrize("shape", [(97,), (1, 50257), (3, 1000)])
def test_gumbel_within_2_ulp(shape):
    """Two float32 logs each land within an ulp of XLA's; measured at
    unit scale (an ulp of max(|g|, 1)), since g near 0 is a difference
    of nearly equal logs."""
    for seed in range(5):
        key = _jkey(seed)
        got = keychain.gumbel(key, shape)
        want = np.asarray(jax.random.gumbel(jnp.asarray(key), shape))
        assert got.dtype == np.float32 and got.shape == want.shape
        unit = np.spacing(np.maximum(np.abs(want), np.float32(1.0)))
        assert np.all(np.abs(got - want) <= 2 * unit)


@pytest.mark.parametrize("temperature", [0.7, 1.0, 1e-7])
@pytest.mark.parametrize("vocab", [97, 50257])
def test_categorical_draws_equal_jax(vocab, temperature):
    """200 rows, each with its own chain key; the logits divided by the
    clamped temperature in float32, as the serving draw divides them."""
    rng = np.random.RandomState(vocab)
    keys = keychain.split(_jkey(vocab), 200)
    logits = (rng.randn(200, vocab) * 3).astype(np.float32)
    scaled = logits / np.float32(max(temperature, 1e-6))
    want = np.asarray(jax.vmap(
        lambda k, row: jax.random.categorical(k, row[None, :])[0])(
        jnp.asarray(keys), jnp.asarray(scaled)))
    ties = 0
    for i in range(200):
        got = int(keychain.categorical(keys[i], scaled[i][None, :])[0])
        if got == int(want[i]):
            continue
        z = np.sort(keychain.gumbel(keys[i], (1, vocab))[0] + scaled[i])
        assert z[-1] - z[-2] < TIE_GAP, (i, got, int(want[i]))
        ties += 1
    assert ties <= 2


@pytest.mark.parametrize("stdv", [1 / 8 ** 0.5, 1 / 768 ** 0.5, 1.0])
def test_uniform_bitwise_with_symmetric_bounds(stdv):
    """A layer init's draw, ``uniform(-stdv, stdv)``: XLA fuses the scale
    and shift into one multiply-add, and so does the key chain."""
    for seed in range(4):
        key = keychain.split(_jkey(seed), 2)[0]
        got = keychain.uniform(key, (64, 96), -stdv, stdv)
        want = np.asarray(jax.random.uniform(
            jnp.asarray(key), (64, 96), minval=-stdv, maxval=stdv))
        np.testing.assert_array_equal(got.view(np.uint32),
                                      want.view(np.uint32))


@pytest.mark.parametrize("shape", [(97,), (300, 24), (1000, 33)])
def test_normal_within_4_ulp(shape):
    """``normal`` runs XLA's float32 inverse-error-function polynomial
    over the bitwise uniform; numpy's log1p and XLA's differ in the last
    bit, which the polynomial carries to at most 4 ulp."""
    worst = 0
    for seed in range(6):
        key = _jkey(seed)
        got = keychain.normal(key, shape)
        want = np.asarray(jax.random.normal(jnp.asarray(key), shape))
        assert got.dtype == np.float32 and got.shape == want.shape
        ulp = np.abs(got.view(np.int32).astype(np.int64)
                     - want.view(np.int32).astype(np.int64))
        worst = max(worst, int(ulp.max()))
    assert worst <= 4
