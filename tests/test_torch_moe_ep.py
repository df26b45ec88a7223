"""PyTorch port: expert parallelism with capacity drops (moe.moe_block
over a mesh) on 4 gloo ranks on the CPU, held against the reference's
own moe_ffn_ep run through shard_map.

Over data 2 x model 2 each rank routes its quarter of the batch's flat
tokens (the reference's token axis over ("data", "model")) at that
shard's capacity, exchanges the (E, C, d) buffers with the other model
rank (all-to-all), runs its 4 of the 8 experts and sends the outputs
back. The reference runs in one subprocess with 4 host devices (its
device count is fixed when JAX starts; this process keeps one), once per
module: the forward, the aux loss and jax.grad of sum(y * cot) + 0.7 aux
with respect to x, the router, w1, w2 and w3, and each shard's dropped
(token, choice) assignments. Cases: capacity_factor 1.0 (capacity 2 for
8 tokens a shard, so drops) and 8.0 (none), and a "model" axis of 4
alone (2 experts a rank). One more case runs the
data-only path over data 4 x model 1, where the whole batch routes as
one at capacity_for of all its tokens (an assignment's slot counts the
same expert's assignments on earlier batch ranks), against the
reference's moe_ffn_local on the whole batch in this process.

Gates: the f32 output within Y_TOL, the aux loss within AUX_TOL, each
gradient within GRAD_TOL of its leaf's largest entry, the same
assignments dropped; the output under no_grad (the forward without
autograd, which routes the same way: the reference's forward over a mesh
takes moe_ffn_ep train or not) equal to it; two all-to-alls forward and
two backward, each of M x (E / M) x C x d f32 bytes."""
import functools
import json
import os
import pickle
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import _torch_threads  # noqa: F401  (torch threads: a share of the cores)
from test_torch_tp_train import ok, spawn

import repro.config as jcfg
from repro.models import moe as jmoe
from repro_torch import config as tcfg

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
Y_TOL, AUX_TOL, GRAD_TOL = 1e-5, 1e-6, 1e-5
AUX_W = 0.7
B, S, D_MODEL = 4, 8, 16
MESH_EP = ((2, 2), ("data", "model"))
MESH_MODEL = ((4,), ("model",))
MESH_DATA = ((4, 1), ("data", "model"))
# name -> (capacity factor, mesh) of the expert-parallel cases
EP_CASES = {"drops": (1.0, MESH_EP), "no-drops": (8.0, MESH_EP),
            "model-4": (1.0, MESH_MODEL)}
LEAVES = ("router", "w1", "w3", "w2")

# the reference's moe_ffn_ep through shard_map over 4 host devices; reads
# and writes pickles named on the command line
_REFERENCE = r"""
import pickle, sys
from functools import partial
import jax, jax.numpy as jnp, numpy as np
from jax.experimental.shard_map import shard_map
from jax.sharding import Mesh, PartitionSpec as P
from repro.config import MoEConfig
from repro.models import moe as MOE
with open(sys.argv[1], "rb") as f:
    job = pickle.load(f)
out = {}
for name, c in job.items():
    shape, axes = c["mesh"]
    mesh = Mesh(np.array(jax.devices()[:4]).reshape(shape), axes)
    M = dict(zip(axes, shape))["model"]
    moe = MoEConfig(**c["moe"])
    p = {k: jnp.asarray(v) for k, v in c["params"].items()}
    x = jnp.asarray(c["x"]).reshape(-1, c["x"].shape[-1])
    cot = jnp.asarray(c["cot"]).reshape(x.shape)
    n = x.shape[0] // 4
    cap = MOE.capacity_for(n, moe)
    tok = P(tuple(axes))
    ps = {"router": P(None, None), "w1": P("model", None, None),
          "w3": P("model", None, None), "w2": P("model", None, None)}
    fn = shard_map(partial(MOE.moe_ffn_ep, moe=moe, capacity=cap,
                           axis="model", axis_size=M, all_axes=tuple(axes)),
                   mesh=mesh, in_specs=(ps, tok), out_specs=(tok, P()),
                   check_rep=False)

    def loss(p, x):
        y, aux = fn(p, x)
        return jnp.sum(y * cot) + c["aux_w"] * aux, (y, aux)
    (_, (y, aux)), (gp, gx) = jax.jit(jax.value_and_grad(
        loss, argnums=(0, 1), has_aux=True))(p, x)
    dropped = []
    for s in range(4):
        _, top_i, _ = MOE.router_probs(p, moe, x[s * n:(s + 1) * n])
        order, slot, _ = MOE._dispatch_indices(top_i, moe.padded_experts,
                                               cap)
        d = np.zeros(order.shape, bool)
        d[np.asarray(order)] = np.asarray(slot) >= cap
        dropped.append(d.reshape(-1, moe.top_k))
    out[name] = {"y": np.asarray(y), "aux": float(aux), "capacity": cap,
                 "grad_x": np.asarray(gx), "dropped": np.concatenate(dropped),
                 **{f"grad_{k}": np.asarray(v) for k, v in gp.items()}}
with open(sys.argv[2], "wb") as f:
    pickle.dump(out, f)
"""


def moe_cfg(cf):
    return dict(num_experts=8, top_k=2, d_expert=32, capacity_factor=cf)


@functools.lru_cache(maxsize=None)
def inputs(cf):
    """The reference's init_moe parameters (numpy), x and the output's
    cotangent, seeded."""
    p = jmoe.init_moe(jax.random.PRNGKey(0), D_MODEL,
                      jcfg.MoEConfig(**moe_cfg(cf)), jnp.float32)
    rng = np.random.default_rng(1)
    return ({k: np.asarray(p[k]) for k in LEAVES},
            rng.standard_normal((B, S, D_MODEL)).astype(np.float32),
            rng.standard_normal((B, S, D_MODEL)).astype(np.float32))


def case(cf, mesh=MESH_EP):
    params, x, cot = inputs(cf)
    return {"moe": moe_cfg(cf), "params": params, "x": x, "cot": cot,
            "aux_w": AUX_W, "mesh": mesh}


def run_reference(d):
    """Runs _REFERENCE on every EP case in a subprocess with 4 host
    devices; returns {case: results}."""
    with open(d / "ref_job.pkl", "wb") as f:
        pickle.dump({name: case(*c) for name, c in EP_CASES.items()}, f)
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=4",
               PYTHONPATH=os.path.join(ROOT, "src"))
    r = subprocess.run([sys.executable, "-c", _REFERENCE,
                        str(d / "ref_job.pkl"), str(d / "ref_out.pkl")],
                       capture_output=True, text=True, env=env, timeout=600)
    assert r.returncode == 0, r.stdout + r.stderr
    with open(d / "ref_out.pkl", "rb") as f:
        return pickle.load(f)


def data_only_reference(cf):
    """The reference's moe_block without a mesh over data axes alone:
    moe_ffn_local on the whole batch at capacity_for(B * S)."""
    params, x, cot = inputs(cf)
    moe = jcfg.MoEConfig(**moe_cfg(cf))
    flat = jnp.asarray(x).reshape(-1, D_MODEL)
    cap = jmoe.capacity_for(flat.shape[0], moe)

    def loss(p, xx):
        y, aux = jmoe.moe_ffn_local(p, moe, xx, cap)
        return jnp.sum(y * jnp.asarray(cot).reshape(flat.shape)) + \
            AUX_W * aux, (y, aux)
    p = {k: jnp.asarray(v) for k, v in params.items()}
    (_, (y, aux)), (gp, gx) = jax.jit(jax.value_and_grad(
        loss, argnums=(0, 1), has_aux=True))(p, flat)
    _, top_i, _ = jmoe.router_probs(p, moe, flat)
    order, slot, _ = jmoe._dispatch_indices(top_i, moe.padded_experts, cap)
    dropped = np.zeros(order.shape, bool)
    dropped[np.asarray(order)] = np.asarray(slot) >= cap
    return {"y": np.asarray(y), "aux": float(aux), "capacity": cap,
            "grad_x": np.asarray(gx),
            "dropped": dropped.reshape(-1, moe.top_k),
            **{f"grad_{k}": np.asarray(v) for k, v in gp.items()}}


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    d = tmp_path_factory.mktemp("moe_ep")
    cases = {}
    for name, (cf, mesh) in EP_CASES.items():
        cases[name] = dict(case(cf, mesh), kind="moe",
                           moe=tcfg.MoEConfig(**moe_cfg(cf)))
    cases["data-only"] = dict(case(1.0, MESH_DATA), kind="moe",
                              moe=tcfg.MoEConfig(**moe_cfg(1.0)))
    ref = {}
    runs = spawn({"cases": cases}, d, 4,
                 wait=lambda: ref.update(run_reference(d)))
    ref["data-only"] = data_only_reference(1.0)
    return {"runs": runs, "ref": ref}


def check(got, want):
    y = want["y"].reshape(got["y"].shape)
    np.testing.assert_allclose(got["y"], y, rtol=0, atol=Y_TOL)
    assert got["aux"] == pytest.approx(want["aux"], abs=AUX_TOL)
    gx = want["grad_x"].reshape(got["grad_x"].shape)
    for k, g, w in [("x", got["grad_x"], gx)] + [
            (k, got[f"grad_{k}"], want[f"grad_{k}"]) for k in LEAVES]:
        np.testing.assert_allclose(
            g, w, rtol=0, atol=GRAD_TOL * float(np.abs(w).max()),
            err_msg=f"grad {k}")


@pytest.mark.parametrize("name", sorted(EP_CASES) + ["data-only"])
def test_moe_matches_reference(ranks, name):
    """Output, aux loss and every gradient against the reference (rank
    0's results: the gathered ones are the same on every rank)."""
    got = ok(ranks["runs"][0]["cases"][name])
    want = ranks["ref"][name]
    assert got["capacity"] == want["capacity"]
    check(got, want)
    for r in ranks["runs"][1:]:
        other = ok(r["cases"][name])
        np.testing.assert_array_equal(other["y"], got["y"])
        assert other["aux"] == got["aux"]


@pytest.mark.parametrize("name", sorted(EP_CASES) + ["data-only"])
def test_moe_drops_the_reference_assignments(ranks, name):
    """Each source shard drops exactly the (token, choice) assignments the
    reference drops; capacity_factor 1.0 drops some, 8.0 none."""
    got = np.concatenate([ok(r["cases"][name])["dropped"]
                          for r in ranks["runs"]])
    want = ranks["ref"][name]["dropped"]
    np.testing.assert_array_equal(got, want)
    assert got.any() == (name != "no-drops")


@pytest.mark.parametrize("name", sorted(EP_CASES) + ["data-only"])
def test_moe_without_autograd_routes_the_same(ranks, name):
    """The forward without autograd (forward(train=False, mesh=), the
    collectives in place) gives the autograd run's output and aux loss,
    bit for bit."""
    for r in ranks["runs"]:
        got = ok(r["cases"][name])
        np.testing.assert_array_equal(got["y_no_grad"], got["y"])
        assert got["aux_no_grad"] == got["aux"]


@pytest.mark.parametrize("name", sorted(EP_CASES))
def test_moe_ep_all_to_all_calls_and_bytes(ranks, name):
    """Two all-to-alls forward and two backward over "model", each of M x
    (E / M) x C x d f32 bytes; no all-to-all on the data-only path."""
    got = ok(ranks["runs"][0]["cases"][name])
    nbytes = 8 * got["capacity"] * D_MODEL * 4      # M x E / M = E = 8
    for tag in ("fwd", "bwd"):
        assert got["collectives"][f"all_to_all/{tag}"] == (2, 2 * nbytes)
    data = ok(ranks["runs"][0]["cases"]["data-only"])["collectives"]
    assert not any(k.startswith("all_to_all") for k in data)
    print(json.dumps({name: got["collectives"]}))
