"""PyTorch port: configs, dispatch rule, device rule and the weight bridge,
held against the JAX reference on the CPU."""
import dataclasses

import jax
import numpy as np
import pytest
import torch
import _torch_threads  # noqa: F401  (torch threads: a share of the cores)

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
                                  "RWKVConfig", "ModelConfig",
                                  "OptimizerConfig", "TrainConfig",
                                  "ShapeConfig", "MeshConfig"])
def test_config_fields_and_defaults_match_reference(name):
    assert _fields(getattr(tcfg, name)) == _fields(getattr(jcfg, name))


def test_mesh_config_counts_devices_as_reference():
    for kw in ({}, dict(model=4), dict(data=2, model=8, pod=2)):
        assert tcfg.MeshConfig(**kw).n_devices == \
            jcfg.MeshConfig(**kw).n_devices


def test_shapes_match_reference():
    assert tcfg.ALL_SHAPES == tuple(
        tcfg.ShapeConfig(**dataclasses.asdict(s)) for s in jcfg.ALL_SHAPES)
    assert list(tcfg.SHAPES_BY_NAME) == list(jcfg.SHAPES_BY_NAME)
    assert tcfg.DECODE_32K == tcfg.SHAPES_BY_NAME["decode_32k"]
    with pytest.raises(AssertionError):
        tcfg.ShapeConfig("x", 8, 1, "serve")


def test_hardware_config_names_match_reference_numbers_are_h100():
    """The reference's field names (roofline_terms reads them by name);
    the defaults are an H100 SXM's data-sheet numbers, not the
    reference's: a deviation by design."""
    assert list(_fields(tcfg.HardwareConfig)) == \
        list(_fields(jcfg.HardwareConfig))
    assert _fields(tcfg.HardwareConfig) == dict(
        peak_flops=989e12, hbm_bw=3.35e12, ici_bw=450e9, hbm_bytes=80e9)
    assert tcfg.H100_SXM == tcfg.HardwareConfig()
    assert tcfg.H100_SXM_F32 == tcfg.HardwareConfig(peak_flops=67e12)


@pytest.mark.parametrize("kw", [dict(), dict(smoke=True),
                                dict(altup_k=2), dict(altup_k=4),
                                dict(altup_k=2, recycled=False),
                                dict(smoke=True, altup_k=2)])
@pytest.mark.parametrize("arch", ["qwen3-0.6b", "rwkv6-1.6b", "gemma3-4b",
                                  "gemma3-12b", "qwen2-moe-a2.7b",
                                  "whisper-tiny", "deepseek-v3-671b",
                                  "granite-3-2b", "zamba2-1.2b",
                                  "llava-next-mistral-7b"])
def test_get_config_matches_reference(arch, kw):
    got = dataclasses.asdict(tconfigs.get_config(arch, **kw))
    want = dataclasses.asdict(jconfigs.get_config(arch, **kw))
    assert got == want
    if kw == dict(altup_k=2):
        # recycled by default only above 100k tokens of vocabulary
        assert got["altup"]["recycled"] == (
            arch not in ("rwkv6-1.6b", "whisper-tiny", "granite-3-2b",
                         "zamba2-1.2b", "llava-next-mistral-7b"))


@pytest.mark.parametrize("name", ["T5_SMALL", "T5_BASE", "T5_LARGE", "T5_XL",
                                  "T5_TINY", "T5_MINI"])
def test_t5_configs_match_reference(name):
    """The port's copy of repro/configs/t5.py, field for field, and its
    altup() / seq_altup() variants (the module is outside both
    registries)."""
    from repro.configs import t5 as jt5
    from repro_torch.configs import t5 as tt5
    j, t = getattr(jt5, name), getattr(tt5, name)
    assert dataclasses.asdict(t) == dataclasses.asdict(j)
    for args in ((2,), (4, True), (2, False, "same")):
        assert dataclasses.asdict(tt5.altup(t, *args)) == \
            dataclasses.asdict(jt5.altup(j, *args))
    for mode in ("altup", "stride_skip", "avgpool"):
        assert dataclasses.asdict(tt5.seq_altup(t, 4, mode)) == \
            dataclasses.asdict(jt5.seq_altup(j, 4, mode))
    assert "t5-large" not in tconfigs.ARCH_IDS


def test_whisper_config_matches_reference():
    from repro.configs import whisper_tiny as jw
    from repro_torch.configs import whisper_tiny as tw
    for name in ("CONFIG", "SMOKE"):
        assert dataclasses.asdict(getattr(tw, name)) == \
            dataclasses.asdict(getattr(jw, name))
    assert set(tconfigs.ARCH_IDS) <= set(jconfigs.ARCH_IDS)


def test_get_config_unported_arch_raises():
    """Every architecture of the reference's registry is ported (the same
    ids in the same order); an id outside it raises."""
    assert tconfigs.ARCH_IDS == jconfigs.ARCH_IDS
    with pytest.raises(KeyError, match="unknown architecture"):
        tconfigs.get_config("granite-3-8b")


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


def test_bridge_carries_rwkv_tree():
    """params_from_numpy carries the reference's rwkv6 pytree (SMOKE,
    AltUp K=2) across leaf for leaf: names, shapes and values."""
    cfg = jconfigs.get_config("rwkv6-1.6b", smoke=True, altup_k=2)
    params = jax_init_params(jax.random.PRNGKey(5), cfg)
    tree = jax.tree_util.tree_map(np.asarray, params)
    got = bridge.params_from_numpy(tree, device="cpu").state_dict()
    flat = jax.tree_util.tree_leaves_with_path(params)
    assert sorted(got) == sorted(".".join(p.key for p in path)
                                 for path, _ in flat)
    for path, leaf in flat:
        key = ".".join(p.key for p in path)
        assert tuple(got[key].shape) == leaf.shape, key
        np.testing.assert_array_equal(got[key].numpy(), np.asarray(leaf))
    assert "seg0.rwkv.twk" in got and "seg0.ln_tm" in got
    assert got["seg0.rwkv.u"].shape == (3, 4, 16)
