"""PyTorch port: the kernels' plain versions and model-facing wrappers,
held against the JAX oracles and the Pallas kernels in interpret mode on
the CPU. The CUDA kernels themselves run only on the card
(chip_smoke.py); on CPU tensors the wrappers take the plain versions and
their launch counters stay 0."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import _torch_threads  # noqa: F401  (torch threads: a share of the cores)

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.kernels.altup_fused import altup_predict_correct as jaltup_raw
from repro.kernels.ragged_decode_attention import (
    paged_ragged_decode_attention as jpaged_raw)
from repro.kernels.ragged_decode_attention import (
    ragged_decode_attention as jragged_raw)
from repro_torch.kernels import altup_fused, ops, ref
from repro_torch.kernels import ragged_decode_attention as ragged_mod

F32_TOL = dict(rtol=1e-5, atol=1e-5)
BF16_TOL = dict(rtol=2e-2, atol=2e-2)


def _pair(arr, dtype):
    """The same numpy values as a JAX array and a torch CPU tensor."""
    if dtype == "float32":
        return jnp.asarray(arr, jnp.float32), torch.from_numpy(
            np.asarray(arr, np.float32))
    j = jnp.asarray(arr, jnp.bfloat16)
    t = torch.from_numpy(np.asarray(arr, np.float32)).to(torch.bfloat16)
    return j, t


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


@pytest.fixture(autouse=True)
def _counts_stay_zero():
    ops.reset_launch_counts()
    yield
    assert ops.launch_counts() == {"altup_predict_correct": 0,
                                   "ragged_decode_attention": 0,
                                   "paged_ragged_decode_attention": 0,
                                   "ragged_decode_split": 0,
                                   "ragged_decode_merge": 0,
                                   "rwkv6_wkv": 0,
                                   "flash_attention": 0,
                                   "flash_attention_paged": 0}


@pytest.mark.parametrize("T,K,d", [(8, 2, 128), (5, 2, 64), (64, 4, 256),
                                   (3, 4, 40)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_altup_ref_sweep_matches_jax(T, K, d, dtype):
    rng = np.random.default_rng(T * 100 + K * 10 + d)
    xw_j, xw_t = _pair(rng.standard_normal((T, K, d)), dtype)
    xt_j, xt_t = _pair(rng.standard_normal((T, d)), dtype)
    p = rng.standard_normal((K, K)).astype(np.float32)
    g = rng.standard_normal((K,)).astype(np.float32)
    sel = (np.arange(K) == (T % K)).astype(np.float32)
    args_j = [jnp.asarray(a) for a in (sel, p, g)]
    args_t = [torch.from_numpy(a) for a in (sel, p, g)]
    got = ref.altup_predict_correct_ref(xw_t, xt_t, *args_t)
    assert got.dtype == xw_t.dtype and got.shape == (T, K, d)
    tol = F32_TOL if dtype == "float32" else BF16_TOL
    want = jref.altup_predict_correct_ref(xw_j, xt_j, *args_j)
    np.testing.assert_allclose(_np(got), _np(want), **tol)
    # the Pallas kernel in interpret mode (blocks dividing T and d)
    bt = next(b for b in (8, 4, 2, 1) if T % b == 0)
    bd = next(b for b in (64, 32, 8, 1) if d % b == 0)
    pallas = jaltup_raw(xw_j, xt_j, *args_j, block_t=bt, block_d=bd,
                        interpret=True)
    np.testing.assert_allclose(_np(got), _np(pallas), **tol)
    # the model-facing wrapper on a CPU tensor runs the plain version
    wrapped = ops.decode_altup_predict_correct(
        xw_t.reshape(1, T, K, d), xt_t.reshape(1, T, d), *args_t)
    np.testing.assert_array_equal(_np(wrapped).reshape(T, K, d), _np(got))


def _lengths(B, T, seed):
    """Per-slot fill depths including an EMPTY and a FULL slot."""
    lens = np.random.default_rng(seed).integers(1, T + 1, B)
    lens[0] = 0
    lens[-1] = T
    return lens.astype(np.int32)


@pytest.mark.parametrize("B,T,Hk,rep,dh", [
    (4, 37, 2, 1, 32),      # no grouping (H == Hk), odd T
    (3, 64, 2, 2, 16),      # GQA 2:1
    (2, 33, 1, 4, 64),      # GQA 4:1, single kv head, odd T
    (5, 17, 3, 2, 8),       # odd T, three kv heads
])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ragged_ref_sweep_matches_jax(B, T, Hk, rep, dh, dtype):
    rng = np.random.default_rng(B * 1000 + T)
    q_j, q_t = _pair(rng.standard_normal((B, Hk, rep, dh)), dtype)
    k_j, k_t = _pair(rng.standard_normal((B, T, Hk, dh)), dtype)
    v_j, v_t = _pair(rng.standard_normal((B, T, Hk, dh)), dtype)
    lens = _lengths(B, T, seed=B)
    got = ref.ragged_decode_ref(q_t, k_t, v_t, torch.from_numpy(lens))
    assert got.dtype == q_t.dtype
    assert torch.all(got[0] == 0)             # empty slot: exact zeros
    tol = F32_TOL if dtype == "float32" else BF16_TOL
    want = jref.ragged_decode_ref(q_j, k_j, v_j, jnp.asarray(lens))
    np.testing.assert_allclose(_np(got), _np(want), **tol)
    pallas = jragged_raw(q_j, k_j, v_j, jnp.asarray(lens), block_k=16,
                         interpret=True)
    np.testing.assert_allclose(_np(got), _np(pallas), **tol)


@pytest.mark.parametrize("H,Hk", [(4, 4), (4, 2), (8, 2)])
def test_ragged_wrapper_matches_jax_wrapper(H, Hk):
    """ops.ragged_decode_attn groups (B, 1, H, dh) queries as the
    reference does (query head h reads kv head h // rep) and reads a
    strided (B, Tb) slice of a larger cache in place."""
    B, T, Tb, dh = 4, 48, 40, 16
    rng = np.random.default_rng(H * 10 + Hk)
    q = rng.standard_normal((B, 1, H, dh)).astype(np.float32)
    k = rng.standard_normal((B, T, Hk, dh)).astype(np.float32)
    v = rng.standard_normal((B, T, Hk, dh)).astype(np.float32)
    lens = np.asarray([0, 17, 40, 1], np.int32)
    kt, vt = torch.from_numpy(k), torch.from_numpy(v)
    got = ops.ragged_decode_attn(torch.from_numpy(q), kt[:, :Tb], vt[:, :Tb],
                                 torch.from_numpy(lens))
    want = jops.ragged_decode_attn(jnp.asarray(q), jnp.asarray(k[:, :Tb]),
                                   jnp.asarray(v[:, :Tb]), jnp.asarray(lens),
                                   block_k=8)
    np.testing.assert_allclose(_np(got), _np(want), **F32_TOL)


def _paged_pool_of(k, page, perm):
    """Scatter contiguous (B, T, Hk, dh) rows into a (R, Hk, dh) page pool
    under a permuted page assignment; returns (pool, block_table)."""
    B, T = k.shape[0], k.shape[1]
    npp = T // page
    pool = np.zeros((len(perm) * page,) + k.shape[2:], k.dtype)
    bt = np.asarray(perm[: B * npp], np.int32).reshape(B, npp)
    for b in range(B):
        for j in range(npp):
            pool[bt[b, j] * page:(bt[b, j] + 1) * page] = \
                k[b, j * page:(j + 1) * page]
    return pool, bt


@pytest.mark.parametrize("B,T,Hk,rep,dh,page,t_max", [
    (3, 16, 2, 2, 8, 4, 16),     # GQA 2:1, the whole table read
    (4, 32, 2, 1, 16, 8, 24),    # t_max inside the table, not page-aligned
    (2, 24, 1, 4, 32, 8, 16),    # GQA 4:1, a full slot clamped to t_max
])
def test_paged_ragged_ref_matches_jax(B, T, Hk, rep, dh, page, t_max):
    """The paged plain version against the reference's paged Pallas
    kernel in interpret mode, through a permuted block table with an
    empty and a full slot; and against the contiguous plain version on
    the same rows, bitwise."""
    rng = np.random.default_rng(B * 100 + T)
    q = rng.standard_normal((B, Hk, rep, dh)).astype(np.float32)
    k = rng.standard_normal((B, T, Hk, dh)).astype(np.float32)
    v = rng.standard_normal((B, T, Hk, dh)).astype(np.float32)
    lens = _lengths(B, T, seed=B + 1)
    perm = rng.permutation(B * (T // page) + 3).tolist()
    kp, bt = _paged_pool_of(k, page, perm)
    vp, _ = _paged_pool_of(v, page, perm)
    got = ref.paged_ragged_decode_ref(
        torch.from_numpy(q), torch.from_numpy(kp), torch.from_numpy(vp),
        torch.from_numpy(lens), torch.from_numpy(bt), page=page,
        t_max=t_max)
    assert torch.all(got[0] == 0)             # empty slot: exact zeros
    want = jpaged_raw(jnp.asarray(q), jnp.asarray(kp), jnp.asarray(vp),
                      jnp.asarray(lens), jnp.asarray(bt), page=page,
                      t_max=t_max, interpret=True)
    np.testing.assert_allclose(_np(got), _np(want), **F32_TOL)
    contiguous = ref.ragged_decode_ref(
        torch.from_numpy(q), torch.from_numpy(k[:, :t_max]),
        torch.from_numpy(v[:, :t_max]), torch.from_numpy(lens))
    assert torch.equal(got, contiguous)


def test_paged_ragged_wrapper_matches_jax_wrapper():
    """ops.paged_ragged_decode_attn groups (B, 1, H, dh) queries as the
    reference's wrapper does; on CPU tensors it runs the plain version."""
    B, T, H, Hk, dh, page = 3, 16, 4, 2, 8, 4
    rng = np.random.default_rng(23)
    q = rng.standard_normal((B, 1, H, dh)).astype(np.float32)
    k = rng.standard_normal((B, T, Hk, dh)).astype(np.float32)
    v = rng.standard_normal((B, T, Hk, dh)).astype(np.float32)
    lens = np.asarray([5, 16, 0], np.int32)
    perm = rng.permutation(B * (T // page) + 2).tolist()
    kp, bt = _paged_pool_of(k, page, perm)
    vp, _ = _paged_pool_of(v, page, perm)
    got = ops.paged_ragged_decode_attn(
        torch.from_numpy(q), torch.from_numpy(kp), torch.from_numpy(vp),
        torch.from_numpy(lens), torch.from_numpy(bt), page=page, t_max=T)
    want = jops.paged_ragged_decode_attn(
        jnp.asarray(q), jnp.asarray(kp), jnp.asarray(vp), jnp.asarray(lens),
        jnp.asarray(bt), page=page, t_max=T)
    assert got.shape == (B, 1, H, dh)
    np.testing.assert_allclose(_np(got), _np(want), **F32_TOL)
    assert np.all(_np(got)[2] == 0.0)


def test_kernel_launchers_refuse_cpu_tensors():
    """The CUDA launchers take CUDA tensors only: a CPU tensor is an
    error, never a silent plain-version run."""
    x = torch.zeros(4, 2, 8)
    with pytest.raises(ValueError, match="CUDA"):
        altup_fused.altup_predict_correct(x, torch.zeros(4, 8),
                                          torch.tensor([1., 0.]),
                                          torch.eye(2), torch.ones(2))
    with pytest.raises(ValueError, match="CUDA"):
        ragged_mod.ragged_decode_attention(
            torch.zeros(2, 1, 1, 8), torch.zeros(2, 4, 1, 8),
            torch.zeros(2, 4, 1, 8), torch.zeros(2, dtype=torch.int32))
    with pytest.raises(ValueError, match="CUDA"):
        ragged_mod.paged_ragged_decode_attention(
            torch.zeros(2, 1, 1, 8), torch.zeros(8, 1, 8),
            torch.zeros(8, 1, 8), torch.zeros(2, dtype=torch.int32),
            torch.zeros(2, 2, dtype=torch.int32), page=4, t_max=8)


def test_kernel_build_raises_without_nvcc(monkeypatch, tmp_path):
    """No toolchain means an error, not a fallback."""
    from repro_torch.kernels import build
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.delenv("CUDA_HOME", raising=False)
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path / "b")
    if build.Path("/usr/local/cuda/bin/nvcc").is_file():
        pytest.skip("a CUDA toolkit is installed")
    with pytest.raises(RuntimeError, match="nvcc not found"):
        build.build(["altup_fused"])
    assert set(build.sources()) == {"altup_fused", "flash_attention",
                                    "ragged_decode_attention", "rwkv6_wkv"}


def test_kernel_library_is_keyed_on_its_sources(monkeypatch, tmp_path):
    """An edit of a kernel source or of a shared header names a new
    library, so the next call rebuilds instead of loading a stale one."""
    from repro_torch.kernels import build
    monkeypatch.setattr(build, "CSRC", tmp_path)
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path / "b")
    (tmp_path / "k.cu").write_text("// v1\n")
    (tmp_path / "common.cuh").write_text("// h1\n")
    first = build.target("k")
    assert first == build.target("k")
    assert first.parent == tmp_path / "b" and first.name.startswith("k-")
    (tmp_path / "k.cu").write_text("// v2\n")
    second = build.target("k")
    (tmp_path / "common.cuh").write_text("// h2\n")
    assert len({first, second, build.target("k")}) == 3
