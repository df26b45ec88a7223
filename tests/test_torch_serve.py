"""PyTorch port: the serving engine, held against the JAX Engine on the CPU.

Greedy continuous batching through the port's Engine is token-identical
to the reference Engine(prefix_cache=False) on staggered requests through
two slots, with EOS, stop tokens, stop sequences, repetition penalty and
logprobs (within 1e-4); the port's generate() matches the reference's
generate(); and the port's continuous output equals its own generate()
(the tests/test_serve.py oracle)."""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.config as jcfg
from repro.models.transformer import init_params as jax_init_params
from repro.serve.engine import Engine as JEngine
from repro.serve.sampling import SamplingParams as JSP
from repro_torch import bridge
from repro_torch import config as tcfg
from repro_torch.kernels import ops
from repro_torch.serve import sampling as tsamp
from repro_torch.serve.engine import Engine as TEngine
from repro_torch.serve.sampling import SamplingParams as TSP

KW = dict(name="srv", family="dense", n_layers=2, d_model=32, n_heads=4,
          n_kv_heads=2, d_ff=64, vocab_size=128, qk_norm=True)
MAX_LEN = 32
N_REQ = 6


def _cfgs(**flags):
    jc = jcfg.ModelConfig(**KW, altup=jcfg.AltUpConfig(K=2, recycled=True),
                          **flags)
    tc = tcfg.ModelConfig(**KW, altup=tcfg.AltUpConfig(K=2, recycled=True),
                          **flags)
    return jc, tc


@functools.lru_cache(maxsize=None)
def _setup():
    """Reference parameters (AltUp p/g perturbed), prompts, and the
    reference's greedy streams of the prompts, which pick the EOS and
    stop ids so that each stop rule really fires."""
    jc, _ = _cfgs()
    params = jax_init_params(jax.random.PRNGKey(0), jc)
    tree = jax.tree_util.tree_map(np.asarray, params)
    rng = np.random.default_rng(7)
    n, K = tree["seg0"]["altup_g"].shape
    tree["seg0"]["altup_p"] = (np.eye(K)[None] + 0.3 * rng.standard_normal(
        (n, K, K))).astype(np.float32)
    tree["seg0"]["altup_g"] = (1 + 0.3 * rng.standard_normal((n, K))
                               ).astype(np.float32)
    prompts = [rng.integers(0, jc.vocab_size, 3 + 2 * i).tolist()
               for i in range(N_REQ)]
    jp = jax.tree_util.tree_map(jnp.asarray, tree)
    eng = JEngine(jc, jp, max_len=MAX_LEN)
    greedy = [np.asarray(eng.generate(jnp.asarray(p)[None], 6)).ravel()
              .tolist() for p in prompts]
    return tree, jp, prompts, greedy


def _requests(greedy):
    """(SamplingParams kwargs) per request: plain, penalty + logprobs,
    EOS, stop token, stop sequence, logprobs."""
    g2, g3, g4 = greedy[2], greedy[3], greedy[4]
    return [dict(max_new=5),
            dict(max_new=6, repetition_penalty=1.3, logprobs=True),
            dict(max_new=8, eos_id=g2[1]),
            dict(max_new=8, stop_token_ids=(g3[2],)),
            dict(max_new=8, stop_sequences=((g4[1], g4[2]),)),
            dict(max_new=4, logprobs=True)]


def _run_staggered(eng, prompts, sps):
    rids = [eng.submit(prompts[0], sampling=sps[0]),
            eng.submit(prompts[1], sampling=sps[1])]
    eng.step()
    eng.step()
    rids += [eng.submit(prompts[2], sampling=sps[2]),
             eng.submit(prompts[3], sampling=sps[3])]
    eng.step()
    rids += [eng.submit(prompts[i], sampling=sps[i]) for i in (4, 5)]
    out = eng.run()
    return [out[r] for r in rids]


@pytest.mark.parametrize("flags", [None, True])
def test_continuous_matches_jax_engine(flags):
    tree, jp, prompts, greedy = _setup()
    reqs = _requests(greedy)
    jc, _ = _cfgs()
    _, tc = _cfgs(ragged_decode_attn=flags, fused_decode_altup=flags)
    jeng = JEngine(jc, jp, max_len=MAX_LEN, n_slots=2, prefill_chunk=4,
                   prefix_cache=False)
    want = _run_staggered(jeng, prompts, [JSP(**r) for r in reqs])
    tp = bridge.params_from_numpy(tree, device="cpu")
    teng = TEngine(tc, tp, max_len=MAX_LEN, n_slots=2, prefill_chunk=4,
                   device="cpu")
    ops.reset_launch_counts()
    got = _run_staggered(teng, prompts, [TSP(**r) for r in reqs])
    assert [c.tokens for c in got] == [c.tokens for c in want]
    assert [c.finish_reason for c in got] == [c.finish_reason
                                              for c in want]
    # each stop rule fired
    assert [c.finish_reason for c in got][2:5] == ["eos", "stop", "stop"]
    for g, w in zip(got, want):
        assert (g.logprobs is None) == (w.logprobs is None)
        if w.logprobs is not None:
            np.testing.assert_allclose(g.logprobs, w.logprobs, atol=1e-4,
                                       rtol=1e-4)
        assert g.prompt_len == w.prompt_len
        assert g.submitted_at <= g.first_token_at <= g.finished_at
    assert ops.launch_counts() == {"altup_predict_correct": 0,
                                   "ragged_decode_attention": 0}


def test_generate_matches_jax_and_continuous():
    tree, jp, prompts, greedy = _setup()
    jc, tc = _cfgs()
    tp = bridge.params_from_numpy(tree, device="cpu")
    teng = TEngine(tc, tp, max_len=MAX_LEN, device="cpu")
    jeng = JEngine(jc, jp, max_len=MAX_LEN)
    # batched static generate == the reference's
    batch = np.asarray([prompts[1][:5], prompts[2][:5]])
    got = teng.generate(batch, 6).numpy()
    want = np.asarray(jeng.generate(jnp.asarray(batch), 6))
    np.testing.assert_array_equal(got, want)
    assert teng.generate(np.asarray(prompts[0])[None], 6).numpy().ravel() \
        .tolist() == greedy[0]
    # with repetition penalty and logprobs
    sp = dict(max_new=6, repetition_penalty=1.3, logprobs=True)
    got = teng.generate(np.asarray(prompts[1])[None], sampling=TSP(**sp))
    want = jeng.generate(jnp.asarray(prompts[1])[None], sampling=JSP(**sp))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_allclose(teng.last_logprobs.numpy(),
                               np.asarray(jeng.last_logprobs), atol=1e-4,
                               rtol=1e-4)
    # the port's own oracle: continuous == static, request by request
    cont = TEngine(tc, tp, max_len=MAX_LEN, n_slots=2, prefill_chunk=3,
                   device="cpu")
    rids = [cont.submit(p, sampling=TSP(max_new=5)) for p in prompts[:4]]
    out = cont.run()
    for rid, p in zip(rids, prompts[:4]):
        static = teng.generate(np.asarray(p)[None], 5).numpy().ravel()
        assert list(out[rid].tokens) == static.tolist()


def test_sampler_pieces_match_jax():
    """update_seen drops padded tokens; greedy sample_rows with penalty
    and logprobs matches the reference's sampler."""
    from repro.serve import sampling as jsamp
    rng = np.random.default_rng(11)
    B, V, C = 3, 40, 4
    toks = rng.integers(0, V, (B, C)).astype(np.int32)
    toks[1, 3] = toks[1, 0]                   # a padded duplicate of a real id
    nval = np.asarray([4, 2, 0], np.int32)
    seen_t = tsamp.update_seen(torch.zeros(B, V, dtype=torch.bool),
                               torch.from_numpy(toks),
                               torch.from_numpy(nval))
    seen_j = jsamp.update_seen(jnp.zeros((B, V), bool), jnp.asarray(toks),
                               jnp.asarray(nval))
    np.testing.assert_array_equal(seen_t.numpy(), np.asarray(seen_j))
    rows = rng.standard_normal((B, V)).astype(np.float32) * 3
    sp_t = {"rep_pen": torch.tensor([1.0, 1.5, 0.8])}
    sp_j = {k: jnp.asarray(v) for k, v in jsamp.blank_slot_params(B).items()}
    sp_j["rep_pen"] = jnp.asarray([1.0, 1.5, 0.8], jnp.float32)
    ids_t, lp_t = tsamp.sample_rows(torch.from_numpy(rows), sp_t, seen_t,
                                    want_logprobs=True)
    ids_j, lp_j = jsamp.sample_rows(jnp.asarray(rows), sp_j, seen_j,
                                    want_logprobs=True, any_sampled=False)
    np.testing.assert_array_equal(ids_t.numpy(), np.asarray(ids_j))
    np.testing.assert_allclose(lp_t.numpy(), np.asarray(lp_j), atol=1e-5)


def test_sampled_requests_raise_until_ported():
    _, tc = _cfgs()
    tree, _, prompts, _ = _setup()
    tp = bridge.params_from_numpy(tree, device="cpu")
    eng = TEngine(tc, tp, max_len=MAX_LEN, device="cpu")
    with pytest.raises(NotImplementedError, match="temperature"):
        eng.submit(prompts[0], sampling=TSP(max_new=2, temperature=0.7))
    with pytest.raises(NotImplementedError, match="temperature"):
        eng.generate(np.asarray(prompts[0])[None],
                     sampling=TSP(max_new=2, temperature=0.7, seed=1))
    with pytest.raises(ValueError, match="max_len"):
        eng.submit(prompts[0], sampling=TSP(max_new=MAX_LEN))
