"""PyTorch port: gradient compression (optim/compression.py) against the
reference's repro/optim/compression.py.

* topk_compress / topk_decompress on values of distinct magnitude (so
  the order of ties cannot differ), several fractions;
* int8_quantize with stochastic rounding: codes bitwise the reference's
  for the same key (kernels/quant.int8_round draws JAX's uniforms),
  scales and dequantized values equal;
* compressed_psum over 2 gloo ranks on the CPU (one spawn,
  tests/_torch_tp_train_worker.py) in the modes topk, int8 (with a key)
  and none, against the reference's run through shard_map over 2 host
  devices as tests/test_distributed.py::test_compressed_dp_allreduce
  calls it (a subprocess: this process keeps one device): the synced
  gradient and the new error residual;
* error feedback: repeated top-k syncs of the same gradients from zero
  error average to the true mean within 0.08, the reference test's
  bound. Their mean misses it by the ranks' mean residual over the
  number of syncs; the reference averages 8 devices' residuals over 25
  syncs, here 2 ranks' over 100."""
import os
import pickle
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import _torch_threads  # noqa: F401  (torch threads: a share of the cores)
from test_torch_tp_train import ok, spawn

from repro.optim import compression as jc
from repro_torch.optim import compression as tc

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORLD, N = 2, 64
STEPS, STEPS_FRAC, EF_BOUND = 100, 0.25, 0.08
KEY_SEED = 3
MODES = (("topk", 0.25), ("int8", 0.05), ("none", 0.05))

_REFERENCE = r"""
import pickle, sys
from functools import partial
import jax, jax.numpy as jnp, numpy as np
from jax.experimental.shard_map import shard_map
from jax.sharding import Mesh, PartitionSpec as P
from repro.optim.compression import compressed_psum
with open(sys.argv[1], "rb") as f:
    job = pickle.load(f)
mesh = Mesh(np.array(jax.devices()[:2]), ("data",))
key = jax.random.PRNGKey(job["key_seed"])
out = {}
for mode, frac in job["modes"]:
    def sync(g, e):
        s, ne = compressed_psum(g[0], e[0], "data", mode=mode, frac=frac,
                                key=key)
        return s, ne[None]
    f = jax.jit(shard_map(sync, mesh=mesh, in_specs=(P("data"), P("data")),
                          out_specs=(P(), P("data")), check_rep=False))
    s, ne = f(jnp.asarray(job["g"]), jnp.asarray(job["err"]))
    out[mode] = (np.asarray(s), np.asarray(ne))
with open(sys.argv[2], "wb") as f:
    pickle.dump(out, f)
"""


def distinct(shape, seed):
    """Values whose magnitudes are all distinct: a permutation of
    0.01 .. with random signs."""
    rng = np.random.default_rng(seed)
    n = int(np.prod(shape))
    mags = (rng.permutation(n) + 1) * 0.01
    return (mags * rng.choice([-1.0, 1.0], n)).reshape(shape).astype(
        np.float32)


def inputs():
    rng = np.random.default_rng(0)
    return (rng.standard_normal((WORLD, N)).astype(np.float32),
            0.1 * rng.standard_normal((WORLD, N)).astype(np.float32))


def run_reference(d):
    g, err = inputs()
    with open(d / "ref_job.pkl", "wb") as f:
        pickle.dump({"g": g, "err": err, "modes": MODES,
                     "key_seed": KEY_SEED}, f)
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=2",
               PYTHONPATH=os.path.join(ROOT, "src"))
    r = subprocess.run([sys.executable, "-c", _REFERENCE,
                        str(d / "ref_job.pkl"), str(d / "ref_out.pkl")],
                       capture_output=True, text=True, env=env, timeout=600)
    assert r.returncode == 0, r.stdout + r.stderr
    with open(d / "ref_out.pkl", "rb") as f:
        return pickle.load(f)


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    d = tmp_path_factory.mktemp("compress")
    g, err = inputs()
    key = np.asarray(jax.random.PRNGKey(KEY_SEED))
    case = {"kind": "compress", "g": g, "err": err,
            "modes": [(m, f, key) for m, f in MODES], "steps": STEPS,
            "steps_frac": STEPS_FRAC}
    ref = {}
    runs = spawn({"mesh": ((WORLD,), ("data",)), "cases": {"c": case}}, d,
                 WORLD, wait=lambda: ref.update(run_reference(d)))
    return {"runs": runs, "ref": ref}


@pytest.mark.parametrize("frac", [0.01, 0.05, 0.3, 1.0])
@pytest.mark.parametrize("shape", [(64,), (8, 33)])
def test_topk_compress_matches_reference(shape, frac):
    g = distinct(shape, 1)
    vals, idx = tc.topk_compress(torch.from_numpy(g), frac)
    jvals, jidx = jc.topk_compress(jnp.asarray(g), frac)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
    np.testing.assert_array_equal(vals.numpy(), np.asarray(jvals))
    got = tc.topk_decompress(vals, idx, shape, torch.float32)
    want = jc.topk_decompress(jvals, jidx, shape, jnp.float32)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("seed", [0, 1, 12345])
@pytest.mark.parametrize("shape", [(64,), (4, 8, 16)])
def test_int8_quantize_codes_bitwise(shape, seed):
    g = np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)
    key = jax.random.PRNGKey(seed)
    q, scale = tc.int8_quantize(torch.from_numpy(g), np.asarray(key))
    jq, jscale = jc.int8_quantize(jnp.asarray(g), key)
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(scale.numpy(), np.asarray(jscale))
    np.testing.assert_array_equal(
        tc.int8_dequantize(q, scale, torch.float32).numpy(),
        np.asarray(jc.int8_dequantize(jq, jscale, jnp.float32)))
    # stochastic: not all codes are round-to-nearest's
    nearest = torch.round(torch.from_numpy(g) / scale)
    assert (q.float() != nearest).any()


def test_init_error_state_is_f32_zeros():
    params = {"a": torch.ones(3, 4, dtype=torch.bfloat16),
              "b": {"c": torch.ones(5)}}
    err = tc.init_error_state(params)
    assert err["a"].dtype == torch.float32 and err["a"].shape == (3, 4)
    assert not err["a"].any() and not err["b"]["c"].any()


@pytest.mark.parametrize("mode", [m for m, _ in MODES])
def test_compressed_psum_matches_reference(ranks, mode):
    """Each rank's synced gradient (replicated) and new error residual
    (its own) against the reference's shard_map run."""
    want_s, want_e = ranks["ref"][mode]
    for r, run in enumerate(ranks["runs"]):
        s, e = ok(run["cases"]["c"])[mode]
        np.testing.assert_allclose(s, want_s, rtol=0, atol=1e-6)
        np.testing.assert_allclose(e, want_e[r], rtol=0, atol=1e-6)


def test_error_feedback_converges_to_the_true_mean(ranks):
    g, _ = inputs()
    for run in ranks["runs"]:
        got = ok(run["cases"]["c"])["mean_of_syncs"]
        assert np.abs(got - g.mean(0)).max() < EF_BOUND
