"""PyTorch port: repro_torch.prng, the threefry2x32 stream of jax.random.

The port's seeded sampler must give the reference's tokens, so its key
data, fold_in, random bits and uniforms are held BITWISE against
jax.random (JAX's default threefry2x32, partitionable); the Gumbel noise
goes through `log`, whose f32 result may differ from XLA's by an ulp, so
it is held within 2e-6 absolute; categorical ids are identical."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import _torch_threads  # noqa: F401  (torch threads: a share of the cores)

from repro_torch import prng

TINY = float(np.finfo(np.float32).tiny)
V = 151936                          # Qwen3's vocabulary: a served row
GUMBEL_ATOL = 2e-6


@pytest.fixture(scope="module", autouse=True)
def _first_parallel_log():
    """torch's CPU build (MKL) computes the first multi-threaded `log` of a
    process now and then with one thread's share at ~1e-4 relative error
    (seen on torch 2.13.0+cpu: one contiguous chunk of n / threads
    elements, first call only). The Gumbel comparison needs the log's
    usual accuracy, so that first call is made here."""
    torch.log(torch.rand(1 << 20) + 0.5)


def _jkeys(seeds):
    return jax.vmap(jax.random.key)(jnp.asarray(seeds, jnp.uint32))


def _words(jkeys) -> torch.Tensor:
    """JAX keys -> the port's (..., 2) int64 key words."""
    return prng.as_key_data(np.asarray(jax.random.key_data(jkeys)))


def _u32(x) -> np.ndarray:
    return np.asarray(x).astype(np.int64)


@pytest.mark.parametrize("seed", [0, 1, 2**31 - 1, -1, 2**32 + 5])
def test_key_data_matches_jax(seed):
    want = _u32(jax.random.key_data(jax.random.key(seed)))
    np.testing.assert_array_equal(prng.key_data(seed).numpy(), want)


def test_fold_in_chain_matches_jax():
    """A 3-deep chain of fold_ins over 16 keys with per-key data (the
    speculative stream's shape: tag, sample index, extra), and an int
    folded into every key, bitwise."""
    rng = np.random.default_rng(0)
    seeds = rng.integers(0, 2**32, 16, dtype=np.uint64).astype(np.uint32)
    data = [rng.integers(0, 2**32, 16, dtype=np.uint64).astype(np.uint32)
            for _ in range(3)]
    jk, tk = _jkeys(seeds), _words(_jkeys(seeds))
    for d in data:
        jk = jax.vmap(jax.random.fold_in)(jk, jnp.asarray(d))
        tk = prng.fold_in(tk, torch.from_numpy(d.astype(np.int64)))
        np.testing.assert_array_equal(tk.numpy(),
                                      _u32(jax.random.key_data(jk)))
    jk = jax.vmap(lambda k: jax.random.fold_in(k, 0x5BEC))(jk)
    np.testing.assert_array_equal(prng.fold_in(tk, 0x5BEC).numpy(),
                                  _u32(jax.random.key_data(jk)))


@pytest.mark.parametrize("shape", [(V,), (2, 500), (8, V)])
def test_random_bits_match_jax(shape):
    """(V,) and (8, V): one draw of V per key (vmap over keys); (2, 500):
    one key's 2-D draw, whose flat counters make it the (1000,) draw."""
    if len(shape) == 2 and shape[0] == 2:
        jk = jax.random.key(11)
        want = _u32(jax.random.bits(jk, shape)).reshape(1, -1)
        got = prng.random_bits(_words(jk)[None], shape[0] * shape[1])
    else:
        B = 1 if len(shape) == 1 else shape[0]
        jk = _jkeys(np.arange(B) * 7 + 3)
        want = _u32(jax.vmap(lambda k: jax.random.bits(k, (shape[-1],)))(jk))
        got = prng.random_bits(_words(jk), shape[-1])
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("minval", [0.0, TINY])
@pytest.mark.parametrize("shape", [(V,), (2, 500), (8, V)])
def test_uniform_bitwise(shape, minval):
    if shape == (2, 500):
        jk = jax.random.key(12)
        want = np.asarray(jax.random.uniform(jk, shape, minval=minval,
                                             maxval=1.0)).reshape(1, -1)
        got = prng.uniform(_words(jk)[None], 1000, minval, 1.0)
    else:
        B = 1 if len(shape) == 1 else shape[0]
        jk = _jkeys(np.arange(B) * 5 + 1)
        want = np.asarray(jax.vmap(lambda k: jax.random.uniform(
            k, (shape[-1],), minval=minval, maxval=1.0))(jk))
        got = prng.uniform(_words(jk), shape[-1], minval, 1.0)
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy().view(np.int32),
                                  want.view(np.int32))


def test_gumbel_within_tolerance():
    jk = _jkeys(np.arange(8) + 40)
    want = np.asarray(jax.vmap(lambda k: jax.random.gumbel(k, (V,)))(jk))
    got = prng.gumbel(_words(jk), V).numpy()
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=0, atol=GUMBEL_ATOL)


def test_categorical_ids_match_jax():
    """64 keys over rows of 1000 logits, some masked to -inf (a filtered
    row), and 8 keys over full-width rows: ids identical."""
    rng = np.random.default_rng(5)
    z = (2.0 * rng.standard_normal((64, 1000))).astype(np.float32)
    z[rng.random(z.shape) < 0.3] = -np.inf
    z[:, 0] = 1.0                             # no row fully masked
    jk = _jkeys(rng.integers(0, 2**31, 64))
    want = np.asarray(jax.vmap(jax.random.categorical)(jk, jnp.asarray(z)))
    got = prng.categorical(_words(jk), torch.from_numpy(z)).numpy()
    np.testing.assert_array_equal(got, want)
    zw = rng.standard_normal((8, V)).astype(np.float32)
    jk = _jkeys(np.arange(8) + 90)
    want = np.asarray(jax.vmap(jax.random.categorical)(jk, jnp.asarray(zw)))
    np.testing.assert_array_equal(
        prng.categorical(_words(jk), torch.from_numpy(zw)).numpy(), want)


def test_key_words_from_every_form():
    """as_key_data takes uint32 numpy, uint32 torch and int64 words alike,
    and refuses a key that is not 2 words wide."""
    kd = np.asarray(jax.random.key_data(jax.random.key(-7)))
    want = _u32(kd)
    for form in (kd, torch.from_numpy(kd.astype(np.int64)),
                 torch.from_numpy(kd.view(np.int32).astype(np.int64))):
        np.testing.assert_array_equal(prng.as_key_data(form).numpy(), want)
    with pytest.raises(ValueError, match="2 words"):
        prng.as_key_data(np.zeros(4, np.uint32))
