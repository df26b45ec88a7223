"""Shared pieces of the port's training tests (tests/test_torch_loss.py,
test_torch_optim.py, test_torch_train.py): the same configs in both
packages, the reference's parameters (perturbed) as JAX and port trees,
and per-leaf comparisons."""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import torch

import repro.configs as jconfigs
from repro.models.transformer import init_params as jax_init_params
from repro_torch import bridge
from repro_torch import configs as tconfigs
from repro_torch import tree as tree_lib

jinit = jax.jit(jax_init_params, static_argnums=1)
# config fields the reference's init_params never reads: configs that
# differ only in them get the same parameters, drawn once (jax_init)
_NOT_READ_BY_INIT = dict(remat="full", kv_cache_dtype="auto",
                         fused_xent=False, banded_local_attn=False)


@functools.lru_cache(maxsize=None)
def _jax_init(jc, seed):
    return jinit(jax.random.PRNGKey(seed), jc)


def jax_init(jc, seed=0):
    """init_params(PRNGKey(seed), jc) of the reference (JAX arrays), once
    per worker process for all configs that differ from jc only in fields
    the init does not read; a compile of the jitted init costs seconds."""
    return _jax_init(jc.replace(**_NOT_READ_BY_INIT), seed)

# per-leaf gradient tolerance: rtol, and atol as a share of the leaf's max
GRAD_RTOL, GRAD_ATOL_REL = 1e-4, 1e-6


def cfg_pair(arch, altup_k=0, recycled=None, **kw):
    """The registry's SMOKE config of `arch` in both packages, with `kw`
    replaced."""
    jc = jconfigs.get_config(arch, smoke=True, altup_k=altup_k,
                             recycled=recycled).replace(**kw)
    tc = tconfigs.get_config(arch, smoke=True, altup_k=altup_k,
                             recycled=recycled).replace(**kw)
    return jc, tc


def perturb(tree, seed):
    """AltUp p/g away from I and 1 (else predict/correct is trivial) and,
    for RWKV-6, seeded values for the leaves the reference starts at zero
    (ts_b, w_b, u) and a spread of decay bases (w_base + lora stays below
    ~1.5, where the chunked form keeps 1/A inside f32); for Mamba-2,
    seeded dt_bias, D, conv_b and norm (zeros and ones at init). The
    hybrid's shared block (unstacked: p (K, K), g (K,)) is perturbed as
    one layer."""
    rng = np.random.default_rng(seed)
    for name, seg in tree.items():
        if name == "shared_blk":
            K = seg["altup_g"].shape[0]
            seg["altup_p"] = (np.eye(K) + 0.25 * rng.standard_normal(
                (K, K))).astype(np.float32)
            seg["altup_g"] = (1 + 0.25 * rng.standard_normal(K)
                              ).astype(np.float32)
            continue
        if not name.startswith("seg"):
            continue
        if "mamba" in seg:
            mb = seg["mamba"]
            for leaf, base, scale in (("dt_bias", 0.0, 0.5),
                                      ("D", 1.0, 0.3),
                                      ("conv_b", 0.0, 0.1),
                                      ("norm", 0.0, 0.1)):
                mb[leaf] = (base + scale * rng.standard_normal(
                    mb[leaf].shape)).astype(mb[leaf].dtype)
        if "rwkv" in seg:
            rw = seg["rwkv"]
            for leaf, scale in (("ts_b", 0.3), ("w_b", 0.3), ("u", 0.5)):
                rw[leaf] = (scale * rng.standard_normal(rw[leaf].shape)
                            ).astype(rw[leaf].dtype)
            rw["w_base"] = rng.uniform(-4.0, -0.5, rw["w_base"].shape
                                       ).astype(rw["w_base"].dtype)
        if "altup_p" in seg:
            n, K = seg["altup_g"].shape
            seg["altup_p"] = (np.eye(K)[None] + 0.25 * rng.standard_normal(
                (n, K, K))).astype(np.float32)
            seg["altup_g"] = (1 + 0.25 * rng.standard_normal((n, K))
                              ).astype(np.float32)
    return tree


def numpy_params(jc, seed=0):
    """The reference's parameters of `jc`, perturbed, as numpy."""
    tree = jax.tree_util.tree_map(np.asarray, jax_init(jc, seed))
    return perturb(tree, seed + 100)


def both_params(tree):
    """numpy tree -> (JAX tree, port ParamTree on the CPU), sharing no
    memory: on the CPU jnp.asarray may alias an aligned numpy buffer, and
    a port optimizer updates its tensors in place while the JAX step
    dispatched before it may still be reading."""
    return (jax.tree_util.tree_map(jnp.asarray, tree),
            bridge.params_from_numpy(jax.tree_util.tree_map(np.array, tree),
                                     device="cpu"))


def jax_leaves(tree):
    """{path tuple: numpy} of a JAX pytree of dicts."""
    return {tuple(p.key for p in path): np.asarray(leaf)
            for path, leaf in jax.tree_util.tree_leaves_with_path(tree)}


def port_leaves(tree):
    return {path: leaf.detach().float().numpy()
            for path, leaf in tree_lib.leaves(tree)}


def f32(a):
    return np.asarray(a, np.float32)


def assert_leaves_close(got, want, *, rtol=GRAD_RTOL,
                        atol_rel=GRAD_ATOL_REL, what="grad"):
    """Leaf by leaf: |got - want| <= atol_rel * max|want| + rtol * |want|;
    the key sets must match."""
    got, want = port_leaves(got), jax_leaves(want)
    assert sorted(got) == sorted(want)
    for path in want:
        w = f32(want[path])
        scale = float(np.abs(w).max())
        np.testing.assert_allclose(
            got[path], w, rtol=rtol, atol=atol_rel * scale,
            err_msg=f"{what} {'/'.join(path)} (max {scale:.3e})")


def torch_batch(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def jax_batch(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


@functools.lru_cache(maxsize=None)
def jit_value_and_grad():
    from repro.models.model import loss_fn
    return jax.jit(jax.value_and_grad(loss_fn, has_aux=True),
                   static_argnums=1)
