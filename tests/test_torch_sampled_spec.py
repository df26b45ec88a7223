"""PyTorch port: the sampled half of self-speculative decoding, held
against the JAX package on the CPU.

The rejection rule equals the reference's and its numpy mirror
(tests/test_speculative.py); processed_dist (penalty -> temperature ->
filters -> softmax) is within 1e-6 of the reference's. Through the
Engine, seeded sampled requests decode speculatively to the JAX
speculative Engine's tokens, stats and logprobs, contiguous, paged, on a
ring and from int8 caches: the draft draws categorical(log q) under
fold_in(fold_in(fold_in(base, 0x5BEC), t), i), the verify its uniforms
and correction tokens under the 0x5FEC stream, all through the port's
threefry2x32. Every round phase's first call runs as a capture does on
the card (warm-up, undo, replay: RoundCheckedEngine), so a sampled
verify's warm-up must leave the replay the tables it found. A greedy slot
in a round with a sampled one keeps the non-speculative engine's
tokens."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import _torch_threads  # noqa: F401  (torch threads: a share of the cores)

from repro.serve import speculative as jspec
from repro.serve.engine import Engine as JEngine
from repro.serve.sampling import SamplingParams as JSP
from repro_torch.kernels import ops
from repro_torch.serve import speculative as tspec
from repro_torch.serve.engine import Engine as TEngine
from repro_torch.serve.sampling import SamplingParams as TSP
from test_speculative import _np_rejection_reference
from test_torch_speculative import (MAX_LEN, PAGE, RoundCheckedEngine, _cfgs,
                                    _params, _prompts, _stats)

PROB_ATOL = 1e-6
LP_ATOL = 2e-5


@pytest.fixture(autouse=True)
def _counts_stay_zero():
    """CPU tensors never launch a kernel: every count stays 0."""
    ops.reset_launch_counts()
    yield
    assert set(ops.launch_counts().values()) == {0}


def test_rejection_rule_matches_jax_and_numpy():
    """The reference test's draws (16 slots, S = 4, V = 12, q zeroed past
    each slot's drafted count), plus identical p and q (every draft
    accepted, the bonus row's residual is p): accepted counts identical,
    residuals within 1e-6 of both."""
    rng = np.random.default_rng(7)
    B, S, V = 16, 4, 12
    p = rng.dirichlet(np.ones(V), (B, S)).astype(np.float32)
    q = rng.dirichlet(np.ones(V), (B, S - 1)).astype(np.float32)
    d = rng.integers(0, S, B)
    q = q * (np.arange(S - 1)[None, :, None] < d[:, None, None])
    drafts = rng.integers(0, V, (B, S - 1))
    u = rng.uniform(size=(B, S - 1)).astype(np.float32)
    for pp, qq, dd in ((p, q, d), (np.full((B, S, V), 1 / V, np.float32),
                                   np.full((B, S - 1, V), 1 / V, np.float32),
                                   np.full(B, S - 1))):
        a, resid = tspec.rejection_rule(*map(torch.from_numpy,
                                             (pp, qq, drafts, dd, u)))
        a_j, resid_j = jspec.rejection_rule(*map(jnp.asarray,
                                                 (pp, qq, drafts, dd, u)))
        a_n, resid_n = _np_rejection_reference(pp, qq, drafts, dd, u)
        np.testing.assert_array_equal(a.numpy(), np.asarray(a_j))
        np.testing.assert_array_equal(a.numpy(), a_n)
        np.testing.assert_allclose(resid.numpy(), np.asarray(resid_j),
                                   rtol=0, atol=PROB_ATOL)
        np.testing.assert_allclose(resid.numpy(), resid_n, rtol=0,
                                   atol=PROB_ATOL)
    assert (a.numpy() == S - 1).all()


def test_processed_dist_matches_jax():
    """(B, S, V) rows with per-row temperature (greedy rows divided by 1),
    top-k, top-p, min-p and repetition penalty over a per-row seen table:
    distributions within 1e-6, zero exactly where the reference's are."""
    rng = np.random.default_rng(3)
    B, S, V = 4, 3, 128
    rows = (3 * rng.standard_normal((B, S, V))).astype(np.float32)
    temp = rng.choice([0.0, 0.7, 1.0, 1.3], (B, S)).astype(np.float32)
    top_k = rng.choice([0, 1, 20, 200], (B, S)).astype(np.int32)
    top_p = rng.choice([0.5, 0.9, 1.0], (B, S)).astype(np.float32)
    min_p = rng.choice([0.0, 0.05], (B, S)).astype(np.float32)
    rep = rng.choice([1.0, 1.3, 0.8], (B, S)).astype(np.float32)
    seen = rng.random((B, S, V)) < 0.2
    args = (rows, temp, top_k, top_p, min_p, rep, seen)
    got = tspec.processed_dist(*map(torch.from_numpy, args)).numpy()
    want = np.asarray(jspec.processed_dist(*map(jnp.asarray, args)))
    np.testing.assert_array_equal(got == 0, want == 0)
    np.testing.assert_allclose(got, want, rtol=0, atol=PROB_ATOL)


def _spec_run(E, cfg, params, spec, prompts, sps, **kw):
    """Requests through E(max_len=MAX_LEN, n_slots=2); returns (completions
    in submission order, engine)."""
    SP, extra = (JSP, {}) if E is JEngine else (TSP, {"device": "cpu"})
    eng = E(cfg, params, speculative=spec,
            **{"max_len": MAX_LEN, "n_slots": 2, **kw}, **extra)
    rids = [eng.submit(p, sampling=SP(**sp)) for p, sp in zip(prompts, sps)]
    out = eng.run()
    return [out[r] for r in rids], eng


SAMPLED = [dict(max_new=9, temperature=0.9, top_k=40, seed=11),
           dict(max_new=7, temperature=1.2, top_p=0.9, min_p=0.02, seed=12),
           dict(max_new=8, temperature=0.7, repetition_penalty=1.3,
                logprobs=True)]


@pytest.mark.parametrize("name,paged", [("dense", False), ("dense", True),
                                        ("ring", False), ("int8", True)])
def test_sampled_spec_engine_matches_jax(name, paged):
    """Three seeded sampled requests (the last seeded by its request id,
    with a repetition penalty and logprobs) through 2 slots, the third
    admitted when a slot frees: tokens, finish reasons, stats (spec_*
    included), pool counters and logprobs (2e-5) equal to the JAX
    speculative Engine's, run to run."""
    jc, tc = _cfgs(name)
    jp, tp = _params(name)
    prompts = _prompts(3, seed=21)
    kw = {"paged": True, "page_size": PAGE} if paged else {}
    want, jeng = _spec_run(JEngine, jc, jp, True, prompts, SAMPLED, **kw)
    got, eng = _spec_run(RoundCheckedEngine, tc, tp, True, prompts, SAMPLED,
                         **kw)
    assert [list(c.tokens) for c in got] == [list(c.tokens) for c in want]
    assert [c.finish_reason for c in got] == [c.finish_reason for c in want]
    assert _stats(eng) == _stats(jeng)
    assert eng.stats["spec_rounds"] > 0 and eng.stats["spec_accepted"] > 0
    assert eng.paged_stats == jeng.paged_stats
    np.testing.assert_allclose(got[2].logprobs, want[2].logprobs, rtol=0,
                               atol=LP_ATOL)
    again, _ = _spec_run(TEngine, tc, tp, True, prompts, SAMPLED, **kw)
    assert [list(c.tokens) for c in again] == [list(c.tokens) for c in got]
    # every sampled round ran its own graphs' keys
    assert any(key[0] == "draft" and key[-1] for key in eng.keys)
    assert any(key[0] == "verify" and key[-1] for key in eng.keys)


def test_mixed_round_greedy_slot_matches_non_spec():
    """A greedy and a sampled request share every round: the greedy one
    keeps the non-speculative engine's tokens, and both equal the JAX
    speculative Engine's."""
    jc, tc = _cfgs("gqa")
    jp, tp = _params("gqa")
    prompts = _prompts(2, seed=5)
    sps = [dict(max_new=8), dict(max_new=8, temperature=0.8, seed=5)]
    ref, _ = _spec_run(TEngine, tc, tp, False, prompts, sps)
    got, eng = _spec_run(RoundCheckedEngine, tc, tp, True, prompts, sps)
    want, _ = _spec_run(JEngine, jc, jp, True, prompts, sps)
    assert list(got[0].tokens) == list(ref[0].tokens)
    assert [list(c.tokens) for c in got] == [list(c.tokens) for c in want]
    assert eng.stats["spec_rounds"] > 0
    assert len(got[1].tokens) == 8
