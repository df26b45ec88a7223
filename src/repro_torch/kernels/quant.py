"""Low-bit quantization of KV rows: scales, rounding, codes.

The port's copy of `repro/kernels/quant.py`, with the same names and the
same arithmetic, bit for bit on the CPU:

  float : no quantization; codes are the values, no scale tensor.
  int8  : symmetric int8, scale = amax / 127, codes = round(x / scale).
  fp8   : e4m3 with amax scaling to the e4m3 max normal (448): codes are
          x / scale cast to torch.float8_e4m3fn (round to nearest even).
          PyTorch holds that dtype on the CPU and on CUDA, so the port
          always stores 1-byte codes; `round_e4m3` is the same grid in
          f32 arithmetic, kept to check the cast against.

Scales are always float32, one per row of the reduced axis (per position
and head for cache rows). The flash-attention kernel consumes these
codes and scales and fuses `code * scale` into its kv-tile load, as the
decode kernels do over the quantized caches of models/decode.py.

The stochastic rounding of the reference (`key=`, the gradient
compression path of optim/compression.py) draws its uniforms through
`prng.uniform`, JAX's threefry bits: the same key gives the reference's
codes, bit for bit.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch

from repro_torch import prng

INT8_QMAX = 127.0
FP8_QMAX = 448.0          # float8_e4m3fn max normal
# floor keeps all-zero rows (empty cache slots) dequantizing to exact 0
# and the division NaN-free
SCALE_EPS = 1e-12

KV_CACHE_DTYPES = ("auto", "float32", "bf16", "int8", "fp8")


@dataclasses.dataclass(frozen=True)
class KVQuantSpec:
    """Resolved cache storage: what the codes are and how to scale them."""
    kind: str                     # float | int8 | fp8
    store_dtype: torch.dtype      # dtype of the cache code tensor
    qmax: float = 0.0             # scale target (unused for float)

    @property
    def quantized(self) -> bool:
        return self.kind != "float"


def resolve_kv_spec(name: str, auto_dtype: torch.dtype) -> KVQuantSpec:
    """cfg.kv_cache_dtype -> KVQuantSpec. `auto_dtype` is the activation
    dtype the cache would use unquantized (the `auto` behavior)."""
    if name == "auto":
        return KVQuantSpec("float", auto_dtype)
    if name == "float32":
        return KVQuantSpec("float", torch.float32)
    if name == "bf16":
        return KVQuantSpec("float", torch.bfloat16)
    if name == "int8":
        return KVQuantSpec("int8", torch.int8, INT8_QMAX)
    if name == "fp8":
        return KVQuantSpec("fp8", torch.float8_e4m3fn, FP8_QMAX)
    raise ValueError(
        f"kv_cache_dtype must be one of {KV_CACHE_DTYPES}, got {name!r}")


def amax_scale(x: torch.Tensor, qmax: float, axis=-1) -> torch.Tensor:
    """Symmetric f32 scale: max|x| over `axis` / qmax + SCALE_EPS
    (axis=None: one global scalar)."""
    a = x.to(torch.float32).abs()
    m = a.amax() if axis is None else a.amax(dim=axis)
    return m / qmax + SCALE_EPS


def _expand(scale, axis):
    return scale if axis is None else scale.unsqueeze(axis)


def int8_round(y: torch.Tensor, *, key=None) -> torch.Tensor:
    """Pre-scaled y in [-127, 127] -> int8 codes. key=None: round to
    nearest even (the cache path). key (a JAX key's data,
    prng.as_key_data): stochastic rounding, floor(y) + (u < y - floor(y))
    with u the draws of jax.random.uniform(key, y.shape) (the gradient
    path, unbiased in expectation)."""
    if key is None:
        q = torch.round(y)
    else:
        k = prng.as_key_data(key).to(y.device)
        u = prng.uniform(k[None], y.numel())[0].view(y.shape)
        lo = torch.floor(y)
        q = lo + (u < (y - lo)).to(y.dtype)
    return q.clamp(-INT8_QMAX, INT8_QMAX).to(torch.int8)


def round_e4m3(y: torch.Tensor) -> torch.Tensor:
    """Round f32 to the float8_e4m3fn grid in f32 arithmetic: 3 mantissa
    bits, normals down to 2^-6 (subnormal step 2^-9), saturating at
    ±448, ties to even. Equal to y.to(float8_e4m3fn).float() on |y| <=
    448."""
    _, e = torch.frexp(y.abs())              # |y| = m * 2^e, m in [0.5, 1)
    exp = (e - 1).clamp(-6, 8)               # normals >= 2^-6; top 2^8
    step = torch.exp2((exp - 3).to(torch.float32))     # 3 mantissa bits
    return (torch.round(y / step) * step).clamp(-FP8_QMAX, FP8_QMAX)


def quantize(x: torch.Tensor, spec: KVQuantSpec, *, axis=-1,
             key=None) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """x -> (codes in spec.store_dtype, f32 scale without `axis`).

    float kind: plain dtype cast, scale is None. int8/fp8: symmetric amax
    scaling over `axis` (the head dim for cache rows: one scale per
    position and head)."""
    if not spec.quantized:
        return x.to(spec.store_dtype), None
    xf = x.to(torch.float32)
    scale = amax_scale(xf, spec.qmax, axis=axis)
    y = xf / _expand(scale, axis)
    if spec.kind == "int8":
        return int8_round(y, key=key), scale
    return y.to(torch.float8_e4m3fn), scale


def dequantize(codes: torch.Tensor, scale: torch.Tensor, dtype,
               *, axis=-1) -> torch.Tensor:
    """codes * scale (f32 multiply) -> dtype. The plain path; the CUDA
    flash-attention kernel fuses this multiply into its kv-tile load."""
    return (codes.to(torch.float32) * _expand(scale, axis)).to(dtype)
