"""PyTorch port: the "model" axis's placement tables held against the
reference's PartitionSpecs, the two deviations by design (the kv-head
rule of the caches, the component-wise Mamba-2 layout of w_in / conv_w /
conv), the recurrent and encoder-decoder caches on a rank's heads, paged
caches over the batch axes (their pool rows whole on every rank) and
the long-context layout's row split.

The reference's param_pspecs / cache_pspecs / paged_cache_pspecs read
only `mesh.shape` (and `axis_names`), so a stand-in mesh of {"data": 1,
"model": N} serves them with no devices; shapes come from jax.eval_shape
on the reference's side and meta tensors on the port's. Multi-rank
serving is tests/test_torch_tp_serve.py and
tests/test_torch_tp_families.py."""
import dataclasses
import functools

import jax
import numpy as np
import pytest
import torch
import _torch_threads  # noqa: F401  (torch threads: a share of the cores)

import repro.configs as jconfigs
from repro.models import decode as jdec
from repro.models.transformer import init_params as jax_init_params
from repro.sharding import param_pspecs
from repro_torch import config as tcfg
from repro_torch import configs as tconfigs
from repro_torch import sharding as sh
from repro_torch.models import decode as tdec
from repro_torch.models import moe as tmoe
from repro_torch.models.transformer import forward, init_tree
from repro_torch.serve.engine import Engine

SIZES = (2, 4, 8, 16)
B, T = 4, 64


@dataclasses.dataclass
class StandIn:
    """What the reference's spec functions read of a mesh, and what the
    port's refusals and select_kv read of a DeviceMesh: no devices."""
    dims: dict
    rank: int = 0
    device_type: str = "cpu"

    @property
    def shape(self):                       # the reference's Mesh.shape
        return self.dims

    @property
    def axis_names(self):
        return tuple(self.dims)

    @property
    def mesh_dim_names(self):              # DeviceMesh's
        return tuple(self.dims)

    def size(self, i):
        return list(self.dims.values())[i]

    def get_local_rank(self, name):
        return self.rank


def _mesh(n, **dims):
    return StandIn({"data": 1, "model": n, **dims})


def _model_dim(spec):
    """The dim a PartitionSpec shards over "model" (alone or in a tuple of
    axes), or None."""
    for i, ax in enumerate(spec):
        if ax == "model" or (isinstance(ax, tuple) and "model" in ax):
            return i
    return None


def _jax_leaves(tree):
    return {tuple(p.key for p in path): leaf for path, leaf in
            jax.tree_util.tree_leaves_with_path(
                tree, is_leaf=lambda x: isinstance(x, jax.sharding.
                                                   PartitionSpec))}


@functools.lru_cache(maxsize=None)
def _cfgs(arch):
    return (jconfigs.get_config(arch, altup_k=2),
            tconfigs.get_config(arch, altup_k=2))


@functools.lru_cache(maxsize=None)
def _param_shapes(arch):
    jc, tc = _cfgs(arch)
    jshapes = jax.eval_shape(lambda: jax_init_params(jax.random.PRNGKey(0),
                                                     jc))
    return jshapes, init_tree(tc, None, torch.device("meta"))


@pytest.mark.parametrize("n", SIZES)
@pytest.mark.parametrize("arch", tconfigs.ARCH_IDS)
def test_param_placements_equal_reference_pspecs(arch, n):
    jc, tc = _cfgs(arch)
    jshapes, tshapes = _param_shapes(arch)
    want = {path: _model_dim(spec) for path, spec in
            _jax_leaves(param_pspecs(jshapes, jc, _mesh(n))).items()}
    got = sh.param_placements(tshapes, tc, n)
    assert got == want
    # the table shards something at every size (the vocabulary at least)
    assert any(d is not None for d in got.values())


def _cache_shapes(cfg, paged, module):
    kw = dict(n_pages=8, page=8) if paged else {}
    fn = module.init_paged_cache if paged else module.init_cache
    if module is jdec:
        return jax.eval_shape(lambda: fn(cfg, B, T, **kw))
    return fn(cfg, B, T, device="meta", **kw)


ATTN_LEAVES = ("k", "v", "k_scale", "v_scale", "latent", "latent_scale")
RECURRENT_LEAVES = ("wkv", "ssm", "shift_tm", "shift_cm", "conv")


# paged caches serve decoder-only models
CACHE_CASES = [(arch, paged) for arch in tconfigs.ARCH_IDS
               for paged in (False, True)
               if not (paged and tconfigs.get_config(arch).family == "encdec")]


@pytest.mark.parametrize("arch,paged", CACHE_CASES)
def test_cache_placements_differ_from_reference_only_by_kv_head_rule(
        arch, paged):
    """Attention and MLA leaves, float and int8, N in SIZES: where the
    reference shards the kv heads, so does the port; where it shards the
    sequence axis (kv heads N does not divide, the contiguous latent) or
    nothing, the port holds the heads its local queries read (N divides
    n_heads) or everything. Recurrent leaves: wkv, ssm and the
    token-shift tails exactly as the reference's; the conv tail, the
    other deviation, split (its x columns) exactly when the Mamba-2
    heads are."""
    jc, tc = _cfgs(arch)
    seen = 0
    for kv in ("auto", "int8"):
        jcq, tcq = jc.replace(kv_cache_dtype=kv), tc.replace(kv_cache_dtype=kv)
        jshapes = _cache_shapes(jcq, paged, jdec)
        tshapes = _cache_shapes(tcq, paged, tdec)
        for n in SIZES:
            fn = jdec.paged_cache_pspecs if paged else jdec.cache_pspecs
            want = _jax_leaves(fn(jcq, jshapes, _mesh(n)))
            place = (sh.paged_cache_placements if paged
                     else sh.cache_placements)
            got = place(tcq, tshapes, StandIn({"model": n}))
            for path, spec in want.items():
                name = path[-1]
                ref, port = _model_dim(spec), _model_dim(got[path])
                if name == "conv":
                    seen += 1
                    assert port == (3 if sh.mamba_heads(tc) % n == 0
                                    else None), path
                    continue
                if name in RECURRENT_LEAVES:
                    seen += 1
                    assert port == ref, path
                    continue
                if name not in ATTN_LEAVES:
                    continue
                seen += 1
                ndim = len(spec)
                head = ndim - (2 if name in ("k", "v") else 1)
                if name.startswith("latent"):
                    assert port is None, path
                elif ref == head:
                    assert port == head, path
                else:
                    # the deviation: only where N does not divide the kv
                    # heads
                    assert tc.n_kv_heads % n != 0, path
                    assert port == (head if tc.n_heads % n == 0 else None)
    assert seen > 0


@pytest.mark.parametrize("h,hk,n", [(4, 2, 2), (4, 2, 4), (16, 8, 16),
                                    (8, 4, 8), (12, 3, 4), (12, 3, 2),
                                    (6, 6, 3), (8, 1, 4), (6, 2, 2),
                                    (32, 8, 16)])
def test_kv_head_rule_keeps_the_heads_local_queries_read(h, hk, n):
    """The deviation by design: each rank's cache holds local_kv_heads kv
    heads, and its local query head j, reading local kv head j // (its
    local GQA ratio), reads the global kv head that query head reads in
    the unsharded model (h_global // (h / hk)), for every rank."""
    cfg = tcfg.ModelConfig(n_layers=1, d_model=h * 4, n_heads=h,
                           n_kv_heads=hk, d_ff=8, vocab_size=64)
    rep = h // hk
    heads = torch.arange(hk).view(1, 1, hk, 1)       # kv head ids
    for r in range(n):
        mesh = StandIn({"model": n}, rank=r)
        hkl = sh.local_kv_heads(cfg, mesh)
        if not sh.heads_sharded(cfg, mesh):
            assert hkl == hk
            continue
        hl = h // n
        kept = (sh.select_kv(heads, cfg, mesh) if hk % n else
                heads.narrow(2, r * hkl, hkl)).view(-1)
        assert kept.numel() == hkl and hl % hkl == 0
        for j in range(hl):
            assert int(kept[j // (hl // hkl)]) == (r * hl + j) // rep
        # what is cached is a subset only when N does not divide hk
        assert (hkl * n == hk) == (hk % n == 0)


def _tiny(family="dense", **kw):
    base = dict(name="t", family=family, n_layers=2, d_model=32, n_heads=4,
                n_kv_heads=2, d_ff=64, vocab_size=128,
                altup=tcfg.AltUpConfig(K=2))
    base.update(kw)
    return tcfg.ModelConfig(**base)


FAMILIES = {
    "rwkv6": _tiny("rwkv6", rwkv=tcfg.RWKVConfig(head_dim=16, decay_lora=8,
                                                  token_shift_lora=8)),
    "hybrid": _tiny("hybrid", n_layers=3, ssm=tcfg.SSMConfig(
        d_state=8, d_conv=4, expand=2, head_dim=16, shared_every=2)),
    "encdec": tconfigs.get_config("whisper-tiny", smoke=True, altup_k=2),
}


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_recurrent_and_encdec_caches_over_model_axis_hold_local_heads(
        family):
    """A model axis of 2 serves the recurrent, hybrid and encoder-decoder
    plans: init_cache holds the rank's heads of the wkv / ssm states, its
    x columns of the conv tail beside the whole B and C, the rank's kv
    heads of the self and cross caches, and whole token-shift tails;
    init_paged_cache the same recurrent leaves beside the pools."""
    cfg = FAMILIES[family]
    mesh = StandIn({"model": 2})
    local = tdec.init_cache(cfg, 2, 16, device="meta", mesh=mesh)
    whole = tdec.init_cache(cfg, 2, 16, device="meta")
    ssm = cfg.ssm
    for si, seg in whole.items():
        for name, leaf in seg.items():
            got, want = tuple(local[si][name].shape), list(leaf.shape)
            if name in ("wkv", "ssm"):
                want[2] //= 2
            elif name == "conv":
                want[3] = ssm.expand * cfg.d_model // 2 + 2 * ssm.d_state
            elif name in ("k", "v"):
                want[-2] //= 2
            assert got == tuple(want), (si, name)
    if family != "encdec":
        paged = tdec.init_paged_cache(cfg, 2, 16, n_pages=4, page=4,
                                      device="meta", mesh=mesh)
        for si, seg in paged.items():
            for name, leaf in seg.items():
                if name in RECURRENT_LEAVES:
                    assert leaf.shape == local[si][name].shape


def test_mamba_w_in_columns_per_rank_at_full_shape():
    """The component-wise Mamba-2 layout at zamba2-1.2b's full shape, N =
    4, on meta tensors: the placement reports dim 1 of w_in and conv_w
    (as param_pspecs does), but a rank holds 2192 of w_in's 8384 columns,
    not a contiguous 2096: its 1024 of z and of x, the whole B and C (64
    each) and its 16 of dt; conv_w's 1024 of x and the whole B and C.
    Rank r's w_in columns, by index, are exactly those."""
    cfg = tconfigs.get_config("zamba2-1.2b", altup_k=2)
    meta = init_tree(cfg, None, torch.device("meta"))
    place = sh.param_placements(meta, cfg, 4)
    mamba = [p for p in place if p[-1] in ("w_in", "conv_w")]
    assert mamba and all(place[p] == 2 for p in mamba)   # stacked: dim 1+1
    d_in, N, H = 4096, 64, 64
    W = 2 * d_in + 2 * N + H
    assert meta["seg0"]["mamba"]["w_in"].shape[-1] == W == 8384
    cols = torch.arange(W)
    for r in range(4):
        shard = sh.shard_params(meta, cfg, StandIn({"model": 4}, rank=r))
        assert shard["seg0"]["mamba"]["w_in"].shape[-1] == 2192
        assert shard["seg0"]["mamba"]["conv_w"].shape[-1] == 1024 + 2 * N
        got = sh.local_columns(cols, sh.mamba_columns(cfg, "w_in"), r, 4)
        want = torch.cat([
            torch.arange(r * 1024, (r + 1) * 1024),               # z
            d_in + torch.arange(r * 1024, (r + 1) * 1024),        # x
            2 * d_in + torch.arange(2 * N),                       # B, C
            2 * d_in + 2 * N + torch.arange(r * 16, (r + 1) * 16)])  # dt
        assert torch.equal(got, want)
        parts = [sh.local_columns(cols, sh.mamba_columns(cfg, "w_in"), q, 4)
                 for q in range(4)]
        assert torch.equal(sh.merge_columns(
            parts, sh.mamba_columns(cfg, "w_in"), 4), cols)


@pytest.mark.parametrize("dims", [{"data": 2, "model": 2},
                                  {"pod": 2, "data": 1, "model": 1}])
def test_data_and_pod_axes_raise_a11(dims, mesh1):
    """Paged caches over a batch axis of more than one rank build (the
    refusal that stood here until the rest of A11 is gone): the engine
    holds the slots of its batch coordinate, its pool holds every row
    (n_pages + the sink page) on every rank, and the placements keep the
    pool rows whole, with the kv heads under the kv-head rule (over
    "model" where its size divides n_heads) and no dim over the batch
    dims. Served over 2 and 4 ranks: tests/test_torch_tp_families.py."""
    from repro_torch.models.transformer import init_params
    import torch.distributed as dist

    class Grouped(StandIn):
        def get_group(self, name):        # the world-1 group, for its backend
            return dist.group.WORLD
    cfg = _tiny()
    mesh = Grouped(dims)
    eng = Engine(cfg, init_params(cfg, seed=0, device="cpu"), 16,
                 n_slots=4, mesh=mesh, paged=True, page_size=4, device="cpu")
    eng._ensure_slots()
    D = sh.batch_size(mesh)
    assert (eng._lo, eng._hi) == (0, 4 // D)
    n = dims["model"]
    for path, spec in sh.paged_cache_placements(cfg, eng._caches,
                                                mesh).items():
        leaf = eng._caches[path[0]][path[1]]
        assert leaf.shape[1] == (4 * 4 + 1) * 4, path   # every pool row
        assert spec[1] is None and sh.BATCH[0] not in spec and \
            ("data",) not in spec, (path, spec)
        head = leaf.dim() - (2 if path[-1] in ("k", "v") else 1)
        assert spec[head] == ("model" if n > 1 else None), (path, spec)
        assert leaf.shape[head] == sh.local_kv_heads(cfg, mesh)


LONG_CASES = {
    # name: (config, mesh dims, the rows' mesh dims of k / v, of a latent)
    "dense-data2": (_tiny(), {"data": 2, "model": 1}, ("data",), None),
    "dense-data2-model2": (_tiny(), {"data": 2, "model": 2}, ("data",),
                           None),
    "h3-data2-model2": (_tiny(d_model=48, n_heads=3, n_kv_heads=1),
                        {"data": 2, "model": 2}, ("data", "model"), None),
    "pod2-data2": (_tiny(), {"pod": 2, "data": 2, "model": 1},
                   ("pod", "data"), None),
    "mla-data2-model2": (tconfigs.get_config("deepseek-v3-671b", smoke=True,
                                             altup_k=2),
                         {"data": 2, "model": 2}, None, ("data",)),
    "hybrid-data2": (FAMILIES["hybrid"], {"data": 2, "model": 1}, ("data",),
                     None),
}


@pytest.mark.parametrize("case", sorted(LONG_CASES))
def test_long_context_layout_splits_rows_over_the_head_group(case):
    """Slots the batch dims do not divide (one slot of 1000 rows over D =
    2 or 4): cache_placements puts each attention leaf's sequence dim
    over the ranks that compute the same heads (the batch dims with heads
    on local heads; the batch dims and "model" when the attention runs
    whole; an MLA latent over the batch dims only) and nothing on the
    slot axis; recurrent leaves stay whole per slot. init_cache(seq=)
    gives every rank shard_rows(T, R) rows (whole spans, about T / R)
    and its sink, and the ranks' row ranges tile [0, T)."""
    cfg, dims, kv_rows, lat_rows = LONG_CASES[case]
    T = 1000
    mesh = StandIn(dims)
    whole = tdec.init_cache(cfg, 1, T, device="meta")
    place = sh.cache_placements(cfg, whole, mesh)
    local = tdec.init_cache(cfg, 1, T, device="meta", mesh=mesh,
                            seq=sh.SeqSplit(T))
    seen = 0
    for (si, name), spec in place.items():
        leaf = local[si][name]
        if name in RECURRENT_LEAVES:
            assert spec[1] is None and leaf.shape[1] == 1, (si, name)
            continue
        latent = name.startswith("latent")
        want = lat_rows if latent else kv_rows
        row = 1 if leaf.dim() == whole[si][name].dim() and (
            latent or leaf.dim() == (5 if name in ("k", "v") else 4)) else 0
        row += 1
        assert spec[row] == want and spec[row - 1] is None, (si, name, spec)
        R = sh.row_ranks(cfg, mesh, latent)
        Tc = whole[si][name].shape[row] - 1
        Tr = sh.shard_rows(Tc, R)
        assert leaf.shape[row] == Tr + 1 and Tr % 128 == 0
        assert (R - 1) * Tr < Tc <= R * Tr          # every rank holds rows
        assert Tr < Tc
        seen += 1
    assert seen > 0


def test_moe_with_capacity_drops_over_mesh_raises_a11():
    """The expert-parallel routing with capacity drops over a model axis
    refuses what the reference's shard_map specs cannot split: 4 experts
    over 3 model ranks, 6 tokens over 2 x 2 ranks."""
    moe = tcfg.MoEConfig(num_experts=4, top_k=2, d_expert=8)
    p = tmoe.init_moe(16, moe, torch.float32, torch.Generator(), "cpu")
    x = torch.zeros(2, 3, 16)
    with pytest.raises(ValueError, match="4 experts over 3 model ranks"):
        tmoe.moe_block(p, moe, x, mesh=StandIn({"model": 3}))
    with pytest.raises(ValueError, match="12 tokens over 2 x 4 ranks"):
        tmoe.moe_block(p, moe, x, mesh=StandIn({"data": 2, "model": 4}))


def test_moe_local_experts_sum_to_the_whole():
    """moe_ffn_local over a slice of the experts (first=...) gives a
    partial sum: the slices' outputs add up to the whole layer's, and
    the router's aux is the same on every slice."""
    moe = tcfg.MoEConfig(num_experts=8, top_k=2, d_expert=8)
    g = torch.Generator().manual_seed(0)
    p = tmoe.init_moe(16, moe, torch.float32, g, "cpu")
    x = torch.randn(10, 16, generator=g)
    whole, aux = tmoe.moe_ffn_local(p, moe, x, 10)
    parts = []
    for first in range(0, 8, 2):
        pl = {k: (v[first:first + 2] if k != "router" else v)
              for k, v in p.items()}
        y, a = tmoe.moe_ffn_local(pl, moe, x, 10, first)
        assert torch.equal(a, aux)
        parts.append(y)
    np.testing.assert_allclose(sum(parts).numpy(), whole.numpy(), atol=1e-6,
                               rtol=1e-6)


@pytest.fixture(scope="module")
def mesh1(tmp_path_factory):
    """A "model" axis of one rank: a world-1 gloo group in this process,
    destroyed after the module."""
    import torch.distributed as dist
    from repro_torch.launch.mesh import make_mesh
    store = dist.FileStore(str(tmp_path_factory.mktemp("mesh1") / "store"),
                           1)
    dist.init_process_group("gloo", store=store, rank=0, world_size=1)
    try:
        yield make_mesh((1,), ("model",), device="cpu")
    finally:
        dist.destroy_process_group()


@pytest.mark.parametrize("arch", tconfigs.ARCH_IDS)
def test_mesh_of_one_rank_is_exactly_unmeshed(arch, mesh1):
    """Every family, SMOKE + AltUp K=2: a model axis of one rank gives the
    unmeshed port's forward logits and generate() tokens bit for bit
    (the collectives of one rank change nothing)."""
    from repro_torch.models.transformer import init_params
    cfg = tconfigs.get_config(arch, smoke=True, altup_k=2)
    params = init_params(cfg, seed=3, device="cpu")
    g = torch.Generator().manual_seed(4)
    tok = torch.randint(0, cfg.vocab_size, (2, 5), generator=g)
    kw = {}
    if cfg.family == "encdec":
        kw["encoder_frames"] = torch.randn(2, cfg.encoder_seq, cfg.d_model,
                                           generator=g)
    shard = sh.shard_params(params, cfg, mesh1)
    assert torch.equal(forward(shard, cfg, tok, mesh=mesh1, **kw),
                       forward(params, cfg, tok, **kw))
    outs = [Engine(cfg, params, 16, n_slots=2, mesh=m, device="cpu")
            .generate(tok, 4, **kw) for m in (None, mesh1)]
    assert torch.equal(outs[0], outs[1])


def test_make_mesh_checks_world_and_device(mesh1):
    """make_mesh over the world-1 group: names its dims; a shape of more
    ranks than the world raises with both counts; CUDA without a card
    raises, never a move to the CPU."""
    from repro_torch.launch.mesh import make_mesh
    assert mesh1.mesh_dim_names == ("model",)
    assert sh.model_size(mesh1) == 1 and sh.model_rank(mesh1) == 0
    with pytest.raises(RuntimeError, match="needs 2 ranks.*has 1"):
        make_mesh((1, 2), ("data", "model"), device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            make_mesh((1,), ("model",), device="cuda")
