"""PyTorch port: configs, dispatch rule, device rule and the weight bridge,
held against the JAX reference on the CPU."""
import dataclasses

import jax
import numpy as np
import pytest
import torch

import repro.config as jcfg
import repro.configs as jconfigs
import repro_torch.config as tcfg
import repro_torch.configs as tconfigs
from repro.models.transformer import init_params as jax_init_params
from repro.train import checkpoint as jckpt
from repro_torch import bridge
from repro_torch.kernels import resolve_kernel_flag
from repro_torch.serve.engine import Engine, kv_bucket


def _fields(cls):
    out = {}
    for f in dataclasses.fields(cls):
        if f.default is not dataclasses.MISSING:
            out[f.name] = f.default
        elif f.default_factory is not dataclasses.MISSING:
            out[f.name] = dataclasses.asdict(f.default_factory())
        else:
            out[f.name] = dataclasses.MISSING
    return out


@pytest.mark.parametrize("name", ["AltUpConfig", "SeqAltUpConfig",
                                  "MoEConfig", "MLAConfig", "SSMConfig",
                                  "RWKVConfig", "ModelConfig"])
def test_config_fields_and_defaults_match_reference(name):
    assert _fields(getattr(tcfg, name)) == _fields(getattr(jcfg, name))


@pytest.mark.parametrize("kw", [dict(), dict(smoke=True),
                                dict(altup_k=2), dict(altup_k=4),
                                dict(altup_k=2, recycled=False),
                                dict(smoke=True, altup_k=2)])
def test_get_config_matches_reference(kw):
    got = dataclasses.asdict(tconfigs.get_config("qwen3-0.6b", **kw))
    want = dataclasses.asdict(jconfigs.get_config("qwen3-0.6b", **kw))
    assert got == want
    if kw == dict(altup_k=2):
        assert got["altup"]["recycled"]       # vocab > 100k


def test_get_config_unported_arch_raises():
    with pytest.raises(KeyError, match="not ported"):
        tconfigs.get_config("gemma3-4b")


@pytest.mark.parametrize("flag,device,want", [
    (None, "cpu", False), (None, "cuda", True),
    (True, "cpu", True), (True, "cuda", True),
    (False, "cpu", False), (False, "cuda", False)])
def test_resolve_kernel_flag(flag, device, want):
    assert resolve_kernel_flag(flag, torch.device(device)) is want


def test_kv_bucket_matches_reference():
    from repro.serve.engine import kv_bucket as jax_kv_bucket
    for needed in (1, 5, 32, 33, 100, 256):
        assert kv_bucket(needed, 32, 256) == jax_kv_bucket(needed, 32, 256)
    with pytest.raises(ValueError):
        kv_bucket(300, 32, 256)
    with pytest.raises(ValueError):
        kv_bucket(4, 0, 256)


def test_cuda_default_raises_without_card():
    """Entry points default to device='cuda' and raise when there is no
    card instead of drifting to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    from repro_torch.models.decode import init_cache
    from repro_torch.models.transformer import init_params
    cfg = tcfg.ModelConfig(n_layers=1, d_model=16, n_heads=2, n_kv_heads=2,
                           d_ff=32, vocab_size=64)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        init_params(cfg)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        init_cache(cfg, 1, 8)
    params = init_params(cfg, device="cpu")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Engine(cfg, params, max_len=16)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        bridge.params_from_numpy({"embed": np.zeros((4, 4), np.float32)})


@pytest.mark.parametrize("param_dtype", ["float32", "bfloat16"])
def test_bridge_npz_matches_jax_tree(tmp_path, param_dtype):
    """load_npz reads the reference checkpoint's p//... leaves into the
    same names, shapes and bits as params_from_numpy of the live tree."""
    cfg = jcfg.ModelConfig(n_layers=2, d_model=16, n_heads=2, n_kv_heads=1,
                           d_ff=32, vocab_size=100, qk_norm=True,
                           param_dtype=param_dtype,
                           altup=jcfg.AltUpConfig(K=2))
    params = jax_init_params(jax.random.PRNGKey(3), cfg)
    tree = jax.tree_util.tree_map(np.asarray, params)
    live = bridge.params_from_numpy(tree, device="cpu")
    final = jckpt.save(str(tmp_path), 1, params, {}, keep=1)
    loaded = bridge.load_npz(f"{final}/arrays.npz", device="cpu")
    a, b = live.state_dict(), loaded.state_dict()
    assert a.keys() == b.keys()
    assert "seg0.attn.wq" in a and a["seg0.attn.wq"].shape == (2, 16, 2, 8)
    want_dtype = torch.float32 if param_dtype == "float32" \
        else torch.bfloat16
    assert a["seg0.attn.wq"].dtype == want_dtype
    for k in a:
        assert torch.equal(a[k], b[k]), k
    flat = jax.tree_util.tree_leaves_with_path(params)
    for path, leaf in flat:
        key = ".".join(p.key for p in path)
        np.testing.assert_array_equal(a[key].float().numpy(),
                                      np.asarray(leaf, np.float32))
