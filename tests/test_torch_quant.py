"""PyTorch port: `repro_torch.kernels.quant` against `repro.kernels.quant`
on the CPU. Scales and codes must agree bit for bit (int8 and fp8),
including subnormal fp8 codes, ties, ±448 and all-zero rows."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import _torch_threads  # noqa: F401  (torch threads: a share of the cores)

from repro.kernels import quant as jq
from repro_torch.kernels import quant as tq

_TORCH = {"float32": torch.float32, "bfloat16": torch.bfloat16}
_JAX = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}


def _pair(arr, dtype):
    """The same numpy values as a JAX array and a torch tensor."""
    a = np.asarray(arr, np.float32)
    return (jnp.asarray(a, _JAX[dtype]),
            torch.from_numpy(a).to(_TORCH[dtype]))


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy() if x.dtype != torch.int8 else x.numpy()
    return np.asarray(x.astype(jnp.float32)) if x.dtype != jnp.int8 \
        else np.asarray(x)


def _e4m3_grid():
    """Every finite non-negative float8_e4m3fn value, 0 to 448."""
    return torch.arange(0, 127, dtype=torch.uint8).view(
        torch.float8_e4m3fn).float().numpy()


def _hard_values(rng):
    """Values that stress the rounding: the e4m3 grid, its midpoints (ties)
    and one f32 ulp either side, subnormals, ±448 and int8 half steps."""
    g = _e4m3_grid()
    mid = ((g[1:] + g[:-1]) / 2).astype(np.float32)
    up = np.nextafter(mid, np.float32(np.inf))
    down = np.nextafter(mid, np.float32(0))
    halves = np.arange(-127, 128, dtype=np.float32) + 0.5
    v = np.concatenate([g, mid, up, down, halves, [448.0, 2.0 ** -9,
                                                   2.0 ** -10, 1e-30]])
    v = np.concatenate([v, -v, rng.standard_normal(512) * 100]).astype(
        np.float32)
    return v


def _rows(rng, shape):
    """Rows whose amax spans 1e-6 .. 1e4, two of them all zero."""
    x = rng.standard_normal(shape) * np.exp(
        rng.uniform(-14, 9, shape[:-1] + (1,)))
    x[0] = 0.0
    x[(1,) * (len(shape) - 1)] = 0.0
    return x.astype(np.float32)


@pytest.mark.parametrize("name", ["auto", "float32", "bf16", "int8", "fp8"])
@pytest.mark.parametrize("auto", ["float32", "bfloat16"])
def test_resolve_kv_spec_matches_reference(name, auto):
    want = jq.resolve_kv_spec(name, _JAX[auto])
    got = tq.resolve_kv_spec(name, _TORCH[auto])
    assert (got.kind, got.qmax, got.quantized) == \
        (want.kind, want.qmax, want.quantized)
    assert str(got.store_dtype).removeprefix("torch.") == \
        jnp.dtype(want.store_dtype).name
    if name == "fp8":           # 1-byte codes on every device
        assert got.store_dtype == torch.float8_e4m3fn


def test_resolve_kv_spec_rejects_unknown_name():
    assert tq.KV_CACHE_DTYPES == jq.KV_CACHE_DTYPES
    assert (tq.INT8_QMAX, tq.FP8_QMAX, tq.SCALE_EPS) == \
        (jq.INT8_QMAX, jq.FP8_QMAX, jq.SCALE_EPS)
    with pytest.raises(ValueError, match="kv_cache_dtype"):
        tq.resolve_kv_spec("int4", torch.float32)


@pytest.mark.parametrize("axis", [-1, 0, None])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("qmax", [tq.INT8_QMAX, tq.FP8_QMAX])
def test_amax_scale_matches_reference_bitwise(axis, dtype, qmax):
    x_j, x_t = _pair(_rows(np.random.default_rng(1), (6, 5, 24)), dtype)
    got = tq.amax_scale(x_t, qmax, axis=axis)
    want = jq.amax_scale(x_j, qmax, axis=axis)
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_int8_round_matches_reference_bitwise():
    v = _hard_values(np.random.default_rng(2))
    y = np.clip(v, -200, 200).astype(np.float32)   # past ±127: clipped
    got = tq.int8_round(torch.from_numpy(y))
    want = jq.int8_round(jnp.asarray(y))
    assert got.dtype == torch.int8
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_round_e4m3_matches_reference_and_the_cast():
    y = np.clip(_hard_values(np.random.default_rng(3)), -448, 448).astype(
        np.float32)
    got = tq.round_e4m3(torch.from_numpy(y))
    np.testing.assert_array_equal(got.numpy(),
                                  np.asarray(jq.round_e4m3(jnp.asarray(y))))
    cast = torch.from_numpy(y).to(torch.float8_e4m3fn).float()
    np.testing.assert_array_equal(got.numpy(), cast.numpy())


@pytest.mark.parametrize("kind", ["int8", "fp8"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("axis", [-1, 1])
def test_quantize_matches_reference_bitwise(kind, dtype, axis):
    rng = np.random.default_rng(4)
    x = _rows(rng, (12, 9, 32))
    hard = _hard_values(rng)
    tail = x[2:].reshape(-1)                       # rows 0 and 1, 1 stay 0
    tail[:hard.size] = hard                        # ties, subnormals, ±448
    x[2:] = tail.reshape(x[2:].shape)
    x_j, x_t = _pair(x, dtype)
    spec_j = jq.resolve_kv_spec(kind, x_j.dtype)
    spec_t = tq.resolve_kv_spec(kind, x_t.dtype)
    codes_j, scale_j = jq.quantize(x_j, spec_j, axis=axis)
    codes_t, scale_t = tq.quantize(x_t, spec_t, axis=axis)
    assert codes_t.dtype == spec_t.store_dtype
    assert scale_t.dtype == torch.float32
    np.testing.assert_array_equal(scale_t.numpy(), np.asarray(scale_j))
    np.testing.assert_array_equal(_np(codes_t), _np(codes_j))
    if axis == -1:              # the all-zero rows dequantize to exact 0
        back = tq.dequantize(codes_t, scale_t, torch.float32, axis=axis)
        assert torch.all(back[0] == 0) and torch.all(back[1, 1] == 0)


@pytest.mark.parametrize("kind", ["int8", "fp8"])
@pytest.mark.parametrize("out", ["float32", "bfloat16"])
def test_dequantize_matches_reference(kind, out):
    x = _rows(np.random.default_rng(5), (4, 16, 3, 24))
    codes_j, scale_j = jq.quantize(jnp.asarray(x),
                                   jq.resolve_kv_spec(kind, jnp.float32))
    codes_t, scale_t = tq.quantize(torch.from_numpy(x),
                                   tq.resolve_kv_spec(kind, torch.float32))
    got = tq.dequantize(codes_t, scale_t, _TORCH[out])
    want = jq.dequantize(codes_j, scale_j, _JAX[out])
    assert got.dtype == _TORCH[out] and got.shape == x.shape
    np.testing.assert_allclose(_np(got), _np(want), rtol=1e-6, atol=0)


@pytest.mark.parametrize("name", ["auto", "float32", "bf16"])
def test_float_kinds_are_plain_casts(name):
    x = torch.from_numpy(_rows(np.random.default_rng(6), (3, 8)))
    codes, scale = tq.quantize(x, tq.resolve_kv_spec(name, torch.float32))
    assert scale is None
    assert codes.dtype == (torch.bfloat16 if name == "bf16"
                           else torch.float32)
    assert torch.equal(codes, x.to(codes.dtype))


def test_stochastic_rounding_raises_until_ported():
    """Stochastic rounding (key=), once refused, draws JAX's uniforms
    (prng.uniform): int8_round's and quantize's codes are the
    reference's for the same key, bit for bit, and differ from
    round-to-nearest."""
    x = np.random.default_rng(4).uniform(-3, 3, (4, 8, 16)).astype(
        np.float32)
    spec_t = tq.resolve_kv_spec("int8", torch.float32)
    spec_j = jq.resolve_kv_spec("int8", jnp.float32)
    for seed in (0, 7):
        key = jax.random.PRNGKey(seed)
        kd = np.asarray(key)
        got = tq.int8_round(torch.from_numpy(x * 40), key=kd).numpy()
        want = np.asarray(jq.int8_round(jnp.asarray(x * 40), key=key))
        np.testing.assert_array_equal(got, want)
        assert (got != tq.int8_round(torch.from_numpy(x * 40)).numpy()
                ).any()
        codes, scale = tq.quantize(torch.from_numpy(x), spec_t, key=kd)
        jcodes, jscale = jq.quantize(jnp.asarray(x), spec_j, key=key)
        np.testing.assert_array_equal(codes.numpy(), np.asarray(jcodes))
        np.testing.assert_array_equal(scale.numpy(), np.asarray(jscale))
