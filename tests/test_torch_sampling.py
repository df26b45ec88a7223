"""PyTorch port: the seeded sampler (serve/sampling.py) against the JAX
package's on the same numpy inputs.

The filters' keep masks are identical to the reference's over a grid of
top-k / top-p / min-p with ties at each threshold, a saturated cumsum
under top_p = 1.0, and min_p 0 and 1; sample_rows gives identical ids
(greedy and sampled slots mixed, repetition penalty on) and logprobs
within 1e-5; the slot-parameter arrays and key data equal the
reference's. Then the reference's own sampler cases (tests/
test_sampling.py), ported."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import _torch_threads  # noqa: F401  (torch threads: a share of the cores)

from repro.serve import sampling as jsamp
from repro_torch.serve import sampling as tsamp

LP_ATOL = 1e-5


def _pair(arrs):
    """Numpy slot parameters -> (port tensors, JAX arrays)."""
    return ({k: torch.from_numpy(np.asarray(v)) for k, v in arrs.items()},
            {k: jnp.asarray(v) for k, v in arrs.items()})


def _sp_arrays(B, **over):
    """The reference test's helper: blank slot params, overrides, slot b
    keyed by base_key_data(b)."""
    arrs = tsamp.blank_slot_params(B)
    for k, v in over.items():
        arrs[k][:] = v
    for b in range(B):
        arrs["key"][b] = tsamp.base_key_data(b)
    return arrs


def test_slot_params_and_keys_match_jax():
    """blank/fill_slot_params, base_key_data, key_data_of and key_width
    give the reference's arrays (dtypes included)."""
    sp = tsamp.SamplingParams(max_new=3, temperature=0.7, top_k=5,
                              top_p=0.8, min_p=0.1, repetition_penalty=1.2)
    jsp = jsamp.SamplingParams(max_new=3, temperature=0.7, top_k=5,
                               top_p=0.8, min_p=0.1, repetition_penalty=1.2)
    a, b = tsamp.blank_slot_params(3), jsamp.blank_slot_params(3)
    assert tsamp.key_width() == jsamp.key_width() == 2
    for seed in (0, 9, -1, 2**31 - 1):
        np.testing.assert_array_equal(tsamp.base_key_data(seed),
                                      jsamp.base_key_data(seed))
        assert tsamp.base_key_data(seed).dtype == np.uint32
    tsamp.fill_slot_params(a, 1, sp, tsamp.base_key_data(42), 7)
    jsamp.fill_slot_params(b, 1, jsp, jsamp.base_key_data(42), 7)
    assert a.keys() == b.keys()
    for k in a:
        assert a[k].dtype == b[k].dtype, k
        np.testing.assert_array_equal(a[k], b[k])
    jkey = jax.random.key(5)
    for form in (jax.random.key_data(jkey), jax.random.PRNGKey(5)):
        kd = np.asarray(form)
        np.testing.assert_array_equal(tsamp.key_data_of(kd),
                                      jsamp.key_data_of(jkey))
        np.testing.assert_array_equal(
            tsamp.key_data_of(torch.from_numpy(kd.astype(np.int64))),
            jsamp.key_data_of(form))
    with pytest.raises(ValueError, match="words"):
        tsamp.key_data_of(np.zeros(4, np.uint32))


def _filter_grid():
    """Rows of 64 logits in steps of 0.25 (ties everywhere, at every
    threshold), one row per (top_k, top_p, min_p) of the grid, and a
    saturating row: one logit of 40 over a tail of -40, whose f32 cumsum
    reaches 1.0 long before the tail, under top_p 1.0 and 0.999."""
    rng = np.random.default_rng(0)
    grid = [(k, p, m) for k in (0, 1, 5, 64, 100)
            for p in (0.05, 0.5, 0.9, 1.0) for m in (0.0, 0.05, 1.0)]
    B, V = len(grid) + 2, 64
    z = np.round(rng.standard_normal((B, V)) * 8) / 4
    z[-2:] = -40.0
    z[-2:, 3] = 40.0
    z = z.astype(np.float32)
    top_k = np.asarray([g[0] for g in grid] + [0, 0], np.int32)
    top_p = np.asarray([g[1] for g in grid] + [1.0, 0.999], np.float32)
    min_p = np.asarray([g[2] for g in grid] + [0.0, 0.0], np.float32)
    return z, top_k, top_p, min_p


def test_filter_masks_match_jax():
    z, top_k, top_p, min_p = _filter_grid()
    got = tsamp._filter_logits(*map(torch.from_numpy,
                                    (z, top_k, top_p, min_p))).numpy()
    want = np.asarray(jsamp._filter_logits(*map(jnp.asarray,
                                                (z, top_k, top_p, min_p))))
    np.testing.assert_array_equal(np.isfinite(got), np.isfinite(want))
    np.testing.assert_array_equal(got[np.isfinite(got)],
                                  want[np.isfinite(want)])
    # ties at the thresholds are kept: top-k keeps at least k and every
    # value equal to the k-th largest; min_p = 1 keeps exactly the max's
    # ties; top_p = 1.0 keeps the saturated row whole, and every row
    # keeps its max
    keep = np.isfinite(got)
    for b, (k, p, m) in enumerate(zip(top_k, top_p, min_p)):
        assert keep[b, np.argmax(z[b])]
        if 0 < k <= 64 and p >= 1.0 and m == 0.0:
            kth = np.sort(z[b])[::-1][k - 1]
            np.testing.assert_array_equal(keep[b], z[b] >= kth)
        if m == 1.0:
            np.testing.assert_array_equal(keep[b], z[b] == z[b].max())
    assert keep[-2].all() and keep[-1].sum() == 1


@pytest.mark.parametrize("V", [128, 1000])
def test_sample_rows_match_jax(V):
    """8 slots, greedy and sampled mixed (temperatures 0.7-1.3, top-k,
    top-p, min-p), repetition penalty on, each slot at its own sample
    index, over 6 draws: ids identical, chosen-token logprobs within
    1e-5; any_sampled=False gives the greedy ids of the same rows."""
    rng = np.random.default_rng(V)
    B = 8
    arrs = tsamp.blank_slot_params(B)
    arrs["temperature"][:] = [0.0, 0.7, 1.0, 1.3, 0.0, 0.9, 1.1, 0.8]
    arrs["top_k"][:] = [0, 0, 50, 5, 0, 0, 20, 0]
    arrs["top_p"][:] = [1.0, 0.9, 1.0, 0.95, 1.0, 1.0, 0.9, 1.0]
    arrs["min_p"][:] = [0.0, 0.0, 0.05, 0.0, 0.0, 0.1, 0.0, 0.0]
    arrs["rep_pen"][:] = [1.0, 1.3, 1.0, 1.2, 1.5, 1.0, 1.3, 0.9]
    for b in range(B):
        arrs["key"][b] = tsamp.base_key_data(100 * b + 3)
    seen = rng.random((B, V)) < 0.2
    for t in range(6):
        arrs["sample_idx"][:] = t + np.arange(B)
        rows = (rng.standard_normal((B, V)) * 3).astype(np.float32)
        sp_t, sp_j = _pair(arrs)
        ids_t, lp_t = tsamp.sample_rows(torch.from_numpy(rows), sp_t,
                                        torch.from_numpy(seen),
                                        want_logprobs=True, any_sampled=True)
        ids_j, lp_j = jsamp.sample_rows(jnp.asarray(rows), sp_j,
                                        jnp.asarray(seen), want_logprobs=True,
                                        any_sampled=True)
        np.testing.assert_array_equal(ids_t.numpy(), np.asarray(ids_j))
        np.testing.assert_allclose(lp_t.numpy(), np.asarray(lp_j),
                                   rtol=0, atol=LP_ATOL)
        g_t, _ = tsamp.sample_rows(torch.from_numpy(rows), sp_t,
                                   torch.from_numpy(seen))
        greedy = arrs["temperature"] <= 0
        np.testing.assert_array_equal(g_t.numpy()[greedy],
                                      ids_t.numpy()[greedy])


# ---------------------------------------------------------------------------
# the reference's sampler cases (tests/test_sampling.py), ported
# ---------------------------------------------------------------------------

def _ids(rows, arrs, seen):
    sp, _ = _pair(arrs)
    return tsamp.sample_rows(torch.from_numpy(rows), sp,
                             torch.from_numpy(seen), any_sampled=True)[0]


def test_top_k_one_is_argmax():
    rows = np.random.default_rng(0).normal(size=(3, 32)).astype(np.float32)
    ids = _ids(rows, _sp_arrays(3, temperature=1.0, top_k=1),
               np.zeros((3, 32), bool))
    np.testing.assert_array_equal(ids.numpy(), rows.argmax(-1))


def test_tiny_top_p_and_full_min_p_are_argmax():
    rows = np.random.default_rng(1).normal(size=(2, 64)).astype(np.float32)
    for over in (dict(top_p=1e-6), dict(min_p=1.0)):
        ids = _ids(rows, _sp_arrays(2, temperature=1.0, **over),
                   np.zeros((2, 64), bool))
        np.testing.assert_array_equal(ids.numpy(), rows.argmax(-1))


def test_top_k_never_samples_outside_the_k_largest():
    rows = np.random.default_rng(2).normal(size=(4, 64)).astype(np.float32)
    topk_ids = np.argsort(rows, axis=-1)[:, -8:]
    for t in range(20):
        ids = _ids(rows, _sp_arrays(4, temperature=1.3, top_k=8,
                                    sample_idx=t), np.zeros((4, 64), bool))
        for b in range(4):
            assert ids[b] in topk_ids[b]


def test_seeded_sampling_is_deterministic_per_index():
    rows = np.random.default_rng(3).normal(size=(2, 64)).astype(np.float32)
    seen = np.zeros((2, 64), bool)
    a = _ids(rows, _sp_arrays(2, temperature=1.0, sample_idx=4), seen)
    b = _ids(rows, _sp_arrays(2, temperature=1.0, sample_idx=4), seen)
    np.testing.assert_array_equal(a.numpy(), b.numpy())
    draws = {tuple(_ids(rows, _sp_arrays(2, temperature=1.0, sample_idx=t),
                        seen).tolist()) for t in range(10)}
    assert len(draws) > 1
