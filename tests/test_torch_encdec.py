"""PyTorch port: the encoder-decoder family (A9) — T5 with its relative
position bias and whisper over float frames — held against the JAX
package on the CPU, from the reference's own parameters (AltUp p/g
perturbed) on the same numpy inputs, in f32.

* `t5_rel_bucket` bitwise and `t5_rel_bias` exactly;
* `encode`, `forward` and `loss_fn` for T5_TINY + AltUp K=2 (full and
  recycled), T5_TINY without AltUp and whisper-tiny SMOKE (± K=2);
* `prefill` + `decode_step`: logits and cross caches, float self caches
  and int8 / fp8 ones (within one code step), with the kernel flags on
  (their plain versions on the CPU);
* `Engine.generate(encoder_frames=)` tokens identical to the JAX Engine's,
  greedy and seeded sampled;
* gradients against `jax.value_and_grad(loss_fn)` on a span_corruption
  batch and on lm_batch's float frames, and Trainer losses against the
  JAX Trainer's, with a checkpoint of the `enc` subtree read back;
* the refusals (submit, paged, speculative, draft_step);
* the paper's AltUp parameter count on T5;
* the reference's T5 decode, which passes no relative bias (ROADMAP C6).

Sequence-AltUp: tests/test_torch_seq_altup.py."""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import _torch_threads  # noqa: F401  (torch threads: a share of the cores)

import repro.config as jcfg
from repro.configs import t5 as jt5
from repro.configs import whisper_tiny as jwhisper
from repro.data.pipeline import lm_batch as jlm_batch
from repro.data.pipeline import span_corruption_batch as jspan_batch
from repro.models import decode as jdec
from repro.models import layers as jlayers
from repro.models import transformer as jtr
from repro.serve.engine import Engine as JEngine
from repro.serve.sampling import SamplingParams as JSamplingParams
from repro.train import checkpoint as jckpt
from repro.train import train_step as jts
from repro.train.trainer import Trainer as JTrainer
from repro_torch import bridge
from repro_torch import config as tcfg
from repro_torch import tree as tree_lib
from repro_torch.configs import t5 as tt5
from repro_torch.configs import whisper_tiny as twhisper
from repro_torch.data.pipeline import lm_batch as tlm_batch
from repro_torch.data.pipeline import span_corruption_batch as tspan_batch
from repro_torch.models import decode as tdec
from repro_torch.models import layers as tlayers
from repro_torch.models import model as tmodel
from repro_torch.models import transformer as ttr
from repro_torch.serve.engine import Engine
from repro_torch.serve.sampling import SamplingParams

from _torch_train_util import (assert_leaves_close, jax_batch, jax_init,
                               jit_value_and_grad, jax_leaves, port_leaves,
                               torch_batch)

ENC_SEQ = 32                 # T5_TINY's encoder length here (96 upstream)
B = 2
TOL_REL = 1e-4               # f32 outputs: atol 1e-4 of the reference's max
# quantized self caches: within one code step of the reference
QUANT_TOL = {"int8": 1e-2, "fp8": 5e-2}


def _t5(m, K=0, recycled=False):
    cfg = m.T5_TINY.replace(encoder_seq=ENC_SEQ)
    return m.altup(cfg, K, recycled=recycled) if K > 1 else cfg


def _whisper(m, K=0):
    cfg = m.SMOKE
    if K > 1:
        alt = (jcfg if m is jwhisper else tcfg).AltUpConfig(K=K)
        cfg = cfg.replace(altup=alt)
    return cfg


CASES = {
    "t5-altup2": lambda m: _t5(m, 2),
    "t5-altup2-recycled": lambda m: _t5(m, 2, recycled=True),
    "t5": lambda m: _t5(m),
    "whisper": lambda m: _whisper(m),
    "whisper-altup2": lambda m: _whisper(m, 2),
    # Sequence-AltUp encoders, stride 4 (tests/test_torch_seq_altup.py)
    "t5-seq-altup": lambda m: m.seq_altup(_t5(m), 4, "altup"),
    "t5-seq-stride_skip": lambda m: m.seq_altup(_t5(m), 4, "stride_skip"),
    "t5-seq-avgpool": lambda m: m.seq_altup(_t5(m), 4, "avgpool"),
}


def cfg_pair(case, **kw):
    mods = (jwhisper, twhisper) if case.startswith("whisper") else (jt5, tt5)
    return (CASES[case](mods[0]).replace(**kw),
            CASES[case](mods[1]).replace(**kw))


def perturb(tree, seed):
    """AltUp p/g of the decoder and the encoder away from I and 1 (else
    predict/correct is trivial), and seeded norm scales."""
    rng = np.random.default_rng(seed)
    segs = [v for k, v in tree.items() if k.startswith("seg")]
    if "enc" in tree:
        segs.append(tree["enc"]["seg"])
        tree["enc"]["final_norm"] = (0.1 * rng.standard_normal(
            tree["enc"]["final_norm"].shape)).astype(np.float32)
    for seg in segs:
        if "altup_p" in seg:
            n, K = seg["altup_g"].shape
            seg["altup_p"] = (np.eye(K)[None] + 0.25 * rng.standard_normal(
                (n, K, K))).astype(np.float32)
            seg["altup_g"] = (1 + 0.25 * rng.standard_normal((n, K))
                              ).astype(np.float32)
    if "seq_altup" in tree:
        sa = tree["seq_altup"]
        for name, base in (("a1", 1.0), ("a2", 0.0), ("b", 1.0)):
            sa[name] = (base + 0.3 * rng.standard_normal(sa[name].shape)
                        ).astype(np.float32)
    return tree


def params(jc, seed=0):
    """(JAX tree, port ParamTree on the CPU) of the reference's
    parameters of `jc`, perturbed."""
    tree = perturb(jax.tree_util.tree_map(np.asarray, jax_init(jc)),
                   seed + 1)
    return (jax.tree_util.tree_map(jnp.asarray, tree),
            bridge.params_from_numpy(tree, device="cpu"))


def enc_input(jc, seed=0, batch=B):
    """T5: token ids (B, ENC_SEQ); whisper: float frames (B, S_enc, d)."""
    rng = np.random.default_rng(seed)
    if jc.use_rel_pos_bias:
        return rng.integers(0, jc.vocab_size, (batch, jc.encoder_seq)
                            ).astype(np.int32)
    return rng.standard_normal((batch, jc.encoder_seq, jc.d_model)
                               ).astype(np.float32)


def close(got, want, rel=TOL_REL, rtol=1e-4):
    want = np.asarray(want, np.float32)
    got = got.detach().float().numpy() if isinstance(got, torch.Tensor) \
        else np.asarray(got, np.float32)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=rtol,
                               atol=rel * float(np.abs(want).max()))


jdecode_step = jax.jit(jdec.decode_step, static_argnames=("cfg", "kv_len"))
PROMPT = 6                   # decoder tokens of the forward and the prefill
T_CACHE = 16
N_STEPS = 4                  # greedy S=1 steps after the prefill


@functools.partial(jax.jit, static_argnums=1)
def _jax_forward_all(p, cfg, batch):
    from repro.models.model import loss_fn
    enc = jtr.encode(p, cfg, batch["encoder_frames"])
    logits, _ = jtr.forward(p, cfg, batch["tokens"],
                            encoder_frames=batch["encoder_frames"])
    total, m = loss_fn(p, cfg, batch)
    return enc, logits, total, m["accuracy"]


def batch_of(jc, seed=5):
    """A (B, PROMPT) token batch with next-token labels and its encoder
    input."""
    tok = np.random.default_rng(seed).integers(
        0, jc.vocab_size, (B, PROMPT + 1)).astype(np.int32)
    return {"tokens": tok[:, :-1], "labels": tok[:, 1:],
            "mask": np.ones((B, PROMPT), np.float32),
            "encoder_frames": enc_input(jc, seed)}


@functools.lru_cache(maxsize=None)
def jax_run(case, kind="auto"):
    """The reference's numbers for `case` (kv_cache_dtype `kind`), computed
    once per file: encode / forward / loss on batch_of, then prefill of the
    same tokens and N_STEPS greedy steps (its tokens, logits and cross
    caches)."""
    jc, _ = cfg_pair(case, kv_cache_dtype=kind)
    jp, _ = params(jc)
    nb = batch_of(jc)
    out = {}
    if kind == "auto":
        enc, logits, total, acc = _jax_forward_all(jp, jc, jax_batch(nb))
        out.update(enc=np.asarray(enc), logits=np.asarray(logits),
                   loss=float(total), accuracy=float(acc))

    def jstep(p, c, tk, t):
        return jdecode_step(p, cfg=jc, caches=c, tokens=tk,
                            pos=jnp.asarray(t), kv_len=T_CACHE)
    jl, cache = jdec.prefill(jp, jc, jnp.asarray(nb["tokens"]), T_CACHE,
                             encoder_frames=jnp.asarray(nb["encoder_frames"]),
                             step_fn=jstep)
    out["cross"] = (np.asarray(cache["cross"]["k"]),
                    np.asarray(cache["cross"]["v"]))
    steps, toks = [np.asarray(jl)], []
    for t in range(PROMPT, PROMPT + N_STEPS):
        tok = np.asarray(jnp.argmax(jl[:, -1, :jc.vocab_size], -1))[:, None]
        jl, cache = jstep(jp, cache, jnp.asarray(tok), t)
        steps.append(np.asarray(jl))
        toks.append(tok)
    out["steps"], out["tokens"] = steps, toks
    return out


# --------------------------------------------------------------------------
# the relative position bias
# --------------------------------------------------------------------------

@pytest.mark.parametrize("n_buckets", [32, 8])
@pytest.mark.parametrize("bidirectional", [False, True])
def test_t5_rel_bucket_bitwise(bidirectional, n_buckets):
    rel = np.arange(-300, 301)
    want = np.asarray(jlayers.t5_rel_bucket(
        jnp.asarray(rel, jnp.int32), n_buckets, bidirectional=bidirectional))
    got = tlayers.t5_rel_bucket(torch.from_numpy(rel), n_buckets,
                                bidirectional=bidirectional).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("bidirectional", [False, True])
def test_t5_rel_bias_exact(bidirectional):
    table = np.random.default_rng(3).standard_normal((32, 4)).astype(
        np.float32)
    q, k = np.arange(40), np.arange(57)
    want = jlayers.t5_rel_bias(jnp.asarray(table), jnp.asarray(q),
                               jnp.asarray(k), 32, bidirectional)
    got = tlayers.t5_rel_bias(torch.from_numpy(table), torch.from_numpy(q),
                              torch.from_numpy(k), 32, bidirectional)
    assert got.shape == (1, 4, 40, 57)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


# --------------------------------------------------------------------------
# encode, forward, loss_fn
# --------------------------------------------------------------------------

@pytest.mark.parametrize("case", list(CASES))
def test_init_tree_matches_reference_shapes(case):
    """Leaf paths, shapes and dtypes of init_params, `enc`, `rel_bias_dec`
    and the cross stack included."""
    jc, tc = cfg_pair(case)
    shapes = jax.eval_shape(lambda: jtr.init_params(
        jax.random.PRNGKey(0), jc))
    want = {tuple(k.key for k in p): (tuple(a.shape), str(a.dtype))
            for p, a in jax.tree_util.tree_leaves_with_path(shapes)}
    tree = ttr.init_tree(tc, None, torch.device("meta"))
    got = {p: (tuple(a.shape), str(a.dtype).replace("torch.", ""))
           for p, a in tree_lib.leaves(tree)}
    assert got == want


@pytest.mark.parametrize("case", ["t5-altup2", "t5-altup2-recycled", "t5",
                                  "whisper-altup2"])
def test_encode_forward_loss_match_jax(case):
    jc, tc = cfg_pair(case)
    _, tp = params(jc)
    want = jax_run(case)
    nb = batch_of(jc)
    close(ttr.encode(tp, tc, torch.from_numpy(nb["encoder_frames"])),
          want["enc"])
    close(ttr.forward(tp, tc, torch.from_numpy(nb["tokens"]),
                      encoder_frames=torch.from_numpy(nb["encoder_frames"])),
          want["logits"])
    total, m = tmodel.loss_fn(tp, tc, torch_batch(nb))
    np.testing.assert_allclose(float(total), want["loss"], rtol=1e-5)
    np.testing.assert_allclose(float(m["accuracy"]), want["accuracy"])


def test_forward_needs_encoder_frames():
    _, tc = cfg_pair("t5")
    tp = ttr.init_params(tc, seed=0, device="cpu")
    with pytest.raises(ValueError, match="encoder_frames"):
        ttr.forward(tp, tc, torch.zeros(1, 3, dtype=torch.long))


# --------------------------------------------------------------------------
# prefill + decode_step
# --------------------------------------------------------------------------

def _decode_pairs(case, kind, flags):
    """The port's prefill and greedy steps (fed the reference's tokens)
    beside jax_run's. Yields (what, port, JAX)."""
    jc, tc = cfg_pair(case, kv_cache_dtype=kind)
    tc = tc.replace(ragged_decode_attn=flags, fused_decode_altup=flags)
    _, tp = params(jc)
    want = jax_run(case, kind)
    nb = batch_of(jc)
    tl, cache = tdec.prefill(tp, tc, torch.from_numpy(nb["tokens"]),
                             T_CACHE, encoder_frames=torch.from_numpy(
                                 nb["encoder_frames"]))
    yield "cross_k", cache["cross"]["k"], want["cross"][0]
    yield "cross_v", cache["cross"]["v"], want["cross"][1]
    yield "prefill", tl, want["steps"][0]
    for i, tok in enumerate(want["tokens"]):
        tl, cache = tdec.decode_step(tp, tc, cache,
                                     torch.from_numpy(tok).long(),
                                     PROMPT + i, kv_len=T_CACHE)
        yield f"step{i}", tl, want["steps"][i + 1]


@pytest.mark.parametrize("flags", [None, True])
@pytest.mark.parametrize("case", ["t5-altup2", "whisper-altup2", "t5"])
def test_prefill_and_decode_match_jax(case, flags):
    """Float self caches: logits and the cross caches within 1e-4 of the
    reference's max, the kernels' plain versions (flags True) as the dense
    path; the cross entry holds the encoder output's length."""
    for what, got, want in _decode_pairs(case, "auto", flags):
        if what == "cross_k":
            assert got.shape[2] == (ENC_SEQ if case.startswith("t5")
                                    else 16)
        close(got, want)


@pytest.mark.parametrize("kind", ["int8", "fp8"])
def test_quantized_self_caches_match_jax(kind):
    """int8 / fp8 self caches with float cross caches (T5_TINY + AltUp
    K=2, the kernels' plain versions): logits within one code step of the
    reference's."""
    for what, got, want in _decode_pairs("t5-altup2", kind, True):
        if what.startswith("cross"):
            assert got.dtype == torch.float32
            close(got, want)
        else:
            close(got, want, rel=QUANT_TOL[kind], rtol=QUANT_TOL[kind])


def test_cache_layout():
    """init_cache's cross entry: (n_layers, B, encoder_seq, Hk, Dh) in the
    activation dtype whatever kv_cache_dtype says."""
    _, tc = cfg_pair("whisper", kv_cache_dtype="int8", dtype="bfloat16")
    c = tdec.init_cache(tc, 3, 24, device="cpu")
    assert c["cross"]["k"].shape == (2, 3, 16, 4, 16)
    assert c["cross"]["k"].dtype == torch.bfloat16
    assert c["seg0"]["k"].dtype == torch.int8


# --------------------------------------------------------------------------
# the Engine
# --------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def engines(case):
    jc, tc = cfg_pair(case)
    jp, tp = params(jc, seed=2)
    return (JEngine(jc, jp, max_len=24, n_slots=2),
            Engine(tc, tp, max_len=24, n_slots=2, device="cpu"), jc)


@pytest.mark.parametrize("mode", ["greedy", "sampled"])
@pytest.mark.parametrize("case", ["t5-altup2", "whisper-altup2"])
def test_engine_generate_matches_jax_engine(case, mode):
    jeng, teng, jc = engines(case)
    frames = enc_input(jc, seed=11)
    prompts = np.random.default_rng(12).integers(0, jc.vocab_size, (B, 4))
    if mode == "greedy":
        want = jeng.generate(jnp.asarray(prompts), 8,
                             encoder_frames=jnp.asarray(frames))
        got = teng.generate(prompts, 8, encoder_frames=frames)
    else:
        kw = dict(max_new=8, temperature=0.9, top_k=40, seed=17)
        want = jeng.generate(jnp.asarray(prompts),
                             sampling=JSamplingParams(**kw),
                             encoder_frames=jnp.asarray(frames))
        got = teng.generate(prompts, sampling=SamplingParams(**kw),
                            encoder_frames=frames)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_engine_refuses_continuous_paged_and_speculative():
    _, teng, jc = engines("t5-altup2")
    with pytest.raises(NotImplementedError, match="generate"):
        teng.submit([1, 2], sampling=SamplingParams(max_new=2))
    with pytest.raises(NotImplementedError, match="generate"):
        teng.run()
    tc = teng.cfg
    for kw in (dict(paged=True), dict(speculative=True)):
        with pytest.raises(NotImplementedError, match="decoder-only"):
            Engine(tc, teng.params, max_len=24, device="cpu", **kw)
    with pytest.raises(NotImplementedError, match="decoder-only"):
        tdec.init_paged_cache(tc, 2, 16, n_pages=4, page=4, device="cpu")
    with pytest.raises(NotImplementedError, match="decoder-only"):
        tdec.draft_step(teng.params, tc, {}, torch.zeros(1, 1).long(), 0,
                        draft_layers=1)


# --------------------------------------------------------------------------
# training
# --------------------------------------------------------------------------

@pytest.mark.parametrize("case,task", [("t5-altup2", "span"),
                                       ("whisper-altup2", "lm")])
def test_grads_match_jax(case, task):
    """loss_fn's value and every leaf's gradient (rel_bias_dec,
    enc/rel_bias_enc and the cross stack included) against
    jax.value_and_grad, on a span_corruption batch (int encoder ids) or
    lm_batch's float frames."""
    jc, tc = cfg_pair(case, remat="none")
    jp, tp = params(jc, seed=3)
    if task == "span":
        nb = jspan_batch(jc, 4, ENC_SEQ, 12, seed=1, step=0)
        np.testing.assert_array_equal(
            tspan_batch(tc, 4, ENC_SEQ, 12, seed=1, step=0)
            ["encoder_frames"], nb["encoder_frames"])
    else:
        nb = jlm_batch(jc, 4, 10, seed=1, step=0)
        np.testing.assert_array_equal(
            tlm_batch(tc, 4, 10, seed=1, step=0)["encoder_frames"],
            nb["encoder_frames"])
    (jtot, _), jg = jit_value_and_grad()(jp, jc, jax_batch(nb))
    tp.requires_grad_(True)
    paths, leaves = zip(*tree_lib.leaves(tp))
    ttot, _ = tmodel.loss_fn(tp, tc.replace(remat="full"), torch_batch(nb))
    grads = torch.autograd.grad(ttot, leaves)
    np.testing.assert_allclose(float(ttot.detach()), float(jtot), rtol=1e-5)
    got = tree_lib.from_paths(zip(paths, grads))
    assert_leaves_close(got, jg, atol_rel=TOL_REL)
    names = {"/".join(p) for p in paths}
    if jc.use_rel_pos_bias:
        assert {"rel_bias_dec", "enc/rel_bias_enc"} <= names


def test_trainer_matches_jax_trainer_and_checkpoints_enc(tmp_path):
    """Three span-corruption steps of the port's Trainer (Adafactor, 2
    microbatches) from the JAX Trainer's initial parameters: the same
    losses and accuracies; the checkpoint, `enc` subtree included,
    restores in the reference bit for bit and reads back through
    bridge.load_npz."""
    jc, tc = cfg_pair("t5-altup2")
    base = dict(steps=3, seq_len=12, global_batch=4, microbatches=2,
                log_every=1000, checkpoint_every=0, task="span_corruption",
                checkpoint_dir=str(tmp_path))
    opt = dict(learning_rate=0.3, warmup_steps=2)
    jt = jcfg.TrainConfig(**base, optimizer=jcfg.OptimizerConfig(**opt))
    tt = tcfg.TrainConfig(**base, optimizer=tcfg.OptimizerConfig(**opt))
    from repro_torch.train.trainer import Trainer
    jtrn = JTrainer(jc, jt)
    tree = jax.tree_util.tree_map(np.asarray, jtrn.params)
    ttrn = Trainer(tc, tt, device="cpu",
                   params=bridge.params_from_numpy(tree, device="cpu"))
    jres = jtrn.run(log=lambda s: None)
    tres = ttrn.run(log=lambda s: None)
    for k in ("loss", "accuracy"):
        np.testing.assert_allclose([h[k] for h in tres["history"]],
                                   [h[k] for h in jres["history"]],
                                   rtol=1e-4, err_msg=k)
    ttrn.checkpoint()
    jp = jax.tree_util.tree_map(jnp.asarray, tree)
    p, _, step = jckpt.restore(str(tmp_path), jp,
                               jts.init_opt_state(jp, jt.optimizer))
    got = jax_leaves(p)
    assert step == 3 and ("enc", "cross", "cross", "wq") in got
    for path, want in port_leaves(ttrn.params).items():
        np.testing.assert_array_equal(np.asarray(got[path], np.float32),
                                      want, err_msg=str(path))
    back = bridge.load_npz(str(tmp_path / f"step-{3:09d}" / "arrays.npz"),
                           device="cpu")
    for path, want in port_leaves(ttrn.params).items():
        np.testing.assert_array_equal(port_leaves(back)[path], want)


# --------------------------------------------------------------------------
# accounting and the reference's T5 decode
# --------------------------------------------------------------------------

def test_altup_param_count_matches_paper():
    """K^2 + K extra scalars per layer, encoder layers included (paper
    Sec. 3.2), and the (K d - d) widening of the decoder's final norm;
    the embedding doubles at K = 2. param_counts and active_param_count
    of the port equal the reference's, at T5_TINY and t5-large."""
    from repro.models.model import active_param_count as jactive
    from repro.models.model import param_counts as jcounts
    base, plus = tt5.T5_TINY, tt5.altup(tt5.T5_TINY, K=2)
    c0 = tmodel.param_counts(ttr.init_params(base, seed=0, device="cpu"))
    c1 = tmodel.param_counts(ttr.init_params(plus, seed=0, device="cpu"))
    assert c1["embedding"] == 2 * c0["embedding"]
    K = 2
    n_altup_layers = base.n_layers + base.n_encoder_layers
    extra = c1["non_embedding"] - c0["non_embedding"]
    assert extra == (K * K + K) * n_altup_layers + base.d_model * (K - 1)
    assert c1 == jcounts(jax.eval_shape(lambda: jtr.init_params(
        jax.random.PRNGKey(0), jt5.altup(jt5.T5_TINY, K=2))))
    for jc, tc in ((jt5.altup(jt5.T5_LARGE, 2), tt5.altup(tt5.T5_LARGE, 2)),
                   (jwhisper.CONFIG, twhisper.CONFIG)):
        assert tmodel.active_param_count(tc) == jactive(jc)


def test_t5_decode_mirrors_reference_without_bias():
    """ROADMAP C6: the reference's decode passes no relative bias (and T5
    has no RoPE), so its decode differs from its forward; the port's
    decode equals the JAX decode, and both differ from their forwards by
    the same amount. whisper (RoPE, no bias): decode == forward."""
    for case in ("t5-altup2", "whisper-altup2"):
        jc, tc = cfg_pair(case)
        _, tp = params(jc)
        want = jax_run(case)
        nb = batch_of(jc)
        frames = torch.from_numpy(nb["encoder_frames"])
        tok = torch.from_numpy(nb["tokens"])
        tf = ttr.forward(tp, tc, tok, encoder_frames=frames)
        td, _ = tdec.prefill(tp, tc, tok, T_CACHE, encoder_frames=frames)
        close(td, want["steps"][0])
        gap_j = float(np.abs(want["steps"][0][:, 0]
                             - want["logits"][:, -1]).max())
        gap_t = float((td[:, 0] - tf[:, -1]).abs().max())
        if case.startswith("t5"):
            assert gap_j > 1e-2                   # the bias is missing
            np.testing.assert_allclose(gap_t, gap_j, rtol=1e-3)
        else:
            assert gap_j < 1e-4 and gap_t < 1e-4
