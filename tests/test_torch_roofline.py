"""PyTorch port: the bytes and roofline models (`roofline/analysis.py`) and
the cells' input specs (`configs.shape_applicable` / `input_specs`), held
against the JAX package's on every architecture of the registry at full
size, plain and with AltUp K=2. Pure arithmetic and shapes: nothing is
allocated (the port's specs live on the meta device)."""
import dataclasses

import numpy as np
import pytest
import torch
import _torch_threads  # noqa: F401  (torch threads: a share of the cores)

import repro.config as jcfg
import repro.configs as jconfigs
from repro.roofline import analysis as jra
import repro_torch.config as tcfg
import repro_torch.configs as tconfigs
from repro_torch.models.decode import shared_segments
from repro_torch.roofline import analysis as tra

KV_DTYPES = (None, "auto", "float32", "bf16", "bfloat16", "float16", "int8",
             "fp8")
CONFIGS = [(a, k) for a in jconfigs.ARCH_IDS for k in (0, 2)]


def _cfgs(arch, k):
    return (jconfigs.get_config(arch, altup_k=k),
            tconfigs.get_config(arch, altup_k=k))


def _lengths(seed, T):
    """Seeded fill depths of 1 to 17 slots, up to T (0, 1 and T among
    them for the larger batches)."""
    rng = np.random.default_rng(seed)
    ln = rng.integers(0, T + 1, size=int(rng.integers(1, 18))).tolist()
    return ln + [0, 1, T] if len(ln) > 8 else ln


@pytest.mark.parametrize("arch,k", CONFIGS)
def test_kv_bytes_models_match_reference(arch, k):
    """decode_kv_bytes (ragged and dense, every kv dtype) and
    paged_gather_bytes (pages 1 and 16) equal the reference's exactly:
    rings capped at the window, one shared_attn invocation a layer, MLA
    latents with one scale a position, recurrent segments nothing."""
    jc, tc = _cfgs(arch, k)
    for seed, T in enumerate((17, 4096, 32768)):
        lengths = _lengths(seed * 100 + k, T)
        for kd in KV_DTYPES:
            for ragged in (True, False):
                kw = dict(T=T, ragged=ragged, kv_dtype=kd)
                assert tra.decode_kv_bytes(tc, lengths, **kw) == \
                    jra.decode_kv_bytes(jc, lengths, **kw), (kd, ragged)
            for page in (1, 16):
                kw = dict(page=page, T=T, kv_dtype=kd)
                assert tra.paged_gather_bytes(tc, lengths, **kw) == \
                    jra.paged_gather_bytes(jc, lengths, **kw), (kd, page)
        assert tra.decode_kv_bytes(tc, lengths, T=T, dtype_bytes=4) == \
            jra.decode_kv_bytes(jc, lengths, T=T, dtype_bytes=4)
    kv = tra.decode_kv_bytes(tc, [T], T=T, kv_dtype="auto")
    assert (kv == 0) == (arch == "rwkv6-1.6b")


def _outcome(fn, *a, **kw):
    """fn's result, or the type of what it raised."""
    try:
        return fn(*a, **kw)
    except ZeroDivisionError as e:
        return type(e)


@pytest.mark.parametrize("arch,k", CONFIGS)
def test_speculative_bytes_match_reference(arch, k):
    """The same dicts; KV-only (no param_bytes) on rwkv6, which reads no
    KV rows, both divide by zero."""
    jc, tc = _cfgs(arch, k)
    lengths = _lengths(7 + k, 8192)
    for draft, kk, acc, kd, pb in ((1, 1, 0.0, None, None),
                                   (jc.n_layers // 2 or 1, 4, 0.6, "auto",
                                    1.2e9),
                                   (jc.n_layers, 8, 1.0, "int8", 3e8)):
        kw = dict(T=8192, draft_layers=draft, k=kk, accept_rate=acc,
                  kv_dtype=kd, param_bytes=pb)
        got = _outcome(tra.speculative_bytes, tc, lengths, **kw)
        assert got == _outcome(jra.speculative_bytes, jc, lengths, **kw)
        assert (got is ZeroDivisionError) == (
            arch == "rwkv6-1.6b" and pb is None)


@pytest.mark.parametrize("chips", [1, 4])
def test_roofline_terms_match_reference_on_the_same_hardware(chips):
    """Given the same numbers, the same dicts; the port's default is the
    H100 SXM."""
    for hw in (tcfg.H100_SXM, tcfg.H100_SXM_F32,
               tcfg.HardwareConfig(197e12, 819e9, 50e9, 16e9)):
        jhw = jcfg.HardwareConfig(**dataclasses.asdict(hw))
        for fl, by, co, mf in ((1e12, 1e9, 0.0, None), (3e9, 4e10, 1e8, 2e12),
                               (5e14, 2e9, 7e9, 1e15), (0.0, 0.0, 0.0, 1.0)):
            kw = dict(n_chips=chips, model_flops_total=mf)
            assert tra.roofline_terms(fl, by, co, hw=hw, **kw) == \
                jra.roofline_terms(fl, by, co, hw=jhw, **kw)
    got = tra.roofline_terms(989e12, 3.35e12, 0.0, n_chips=1)
    assert got["compute_s"] == got["memory_s"] == 1.0


def _leaves(tree, prefix=()):
    for name, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, prefix + (name,))
        else:
            yield prefix + (name,), v


@pytest.mark.parametrize("shape", [s.name for s in jcfg.ALL_SHAPES])
@pytest.mark.parametrize("arch", list(jconfigs.ARCH_IDS))
def test_shape_applicable_and_input_specs_match_reference(arch, shape):
    """The reference's skip reason, and its specs' leaf names, shapes and
    dtypes, up to the port caches' sink row: one more row on the sequence
    axis of each attention and latent leaf, and no other difference."""
    jc, tc = _cfgs(arch, 0)
    js, ts = jcfg.SHAPES_BY_NAME[shape], tcfg.SHAPES_BY_NAME[shape]
    assert tconfigs.shape_applicable(tc, ts) == \
        jconfigs.shape_applicable(jc, js)
    want = dict(_leaves(jconfigs.input_specs(jc, js)))
    got = dict(_leaves(tconfigs.input_specs(tc, ts)))
    assert sorted(got) == sorted(want)
    shared = shared_segments(tc)
    for path, w in want.items():
        g = got[path]
        assert g.device.type == "meta", path
        assert str(g.dtype).removeprefix("torch.") == w.dtype.name, path
        gs = list(g.shape)
        if path[0] == "caches" and path[1] != "cross" and path[-1] in (
                "k", "v", "k_scale", "v_scale", "latent", "latent_scale"):
            ax = 1 if path[1] in shared else 2
            gs[ax] -= 1
        assert tuple(gs) == w.shape, path
    if js.kind != "decode":
        assert "caches" not in got


def test_input_specs_allocate_nothing():
    """deepseek-v3-671b's decode_32k caches (hundreds of GB) on the meta
    device; resolve_device takes "meta" and still refuses other kinds."""
    from repro_torch import resolve_device
    spec = tconfigs.input_specs(tconfigs.get_config("deepseek-v3-671b"),
                                tcfg.DECODE_32K)
    total = sum(t.numel() * t.element_size()
                for _, t in _leaves(spec["caches"]))
    assert total > 1e11
    assert resolve_device("meta").type == "meta"
    with pytest.raises(ValueError, match="'meta'"):
        resolve_device("xpu")
