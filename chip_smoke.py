#!/usr/bin/env python3
"""Smoke run of the PyTorch port (`src/repro_torch`) on one CUDA card.

    python3 chip_smoke.py            # from the root of a checkout
    python3 chip_smoke.py --profile  # adds a torch.profiler phase (f)

Written for the NVIDIA H100: it builds the port's CUDA kernels from
`src/repro_torch/csrc/` with nvcc (sm_90a), holds each kernel against its
plain PyTorch version on the card, checks full-width f32 logits and greedy
tokens between the kernel path, the paged kernel path and the dense path,
then serves greedy requests through `Engine` in bf16 on the served model,
Qwen3-0.6B wrapped with AltUp K=2 (recycled), at its full width and depth,
with seeded random weights: once over contiguous slot caches and once
over a paged KV pool with prefix reuse. It then does the same for the
second served family, RWKV-6 "Finch" 1.6B wrapped with AltUp K=2, whose
recurrence runs through the WKV kernel. Phases:

  (a) device   card name and power limit, as nvidia-smi gives them
  (b) build    nvcc build of every kernel, seconds and ptxas report
  (c) kernels  each kernel vs its plain version at the shapes the serve
               phases give it (and at a spread of depths from 0 to
               2048): max error; device ms per call (torch.profiler) of
               the kernel (for the ragged decode attention, the split
               and the merge kernel together), its plain version and the
               library yardstick;
               the wrapper's ms per call (CUDA events); the bytes bound.
               c-paged also holds the paged kernel bitwise against the
               contiguous one on the same rows, through a permuted table;
               c-wkv holds the WKV kernel at (i)'s decode step, (h)'s
               forward, an odd length and a zero state (bitwise equal to
               no state)
      c-flash  the flash-attention kernel through ops.mha_flash, which no
               served path calls (as in the reference): Qwen3-0.6B's
               attention at full width as a causal prefill (B=4,
               S=T=2048), non-causal, with T > S, with int8 and fp8
               codes from quant.quantize; gemma3-4b's local layer (dh
               320, window 1024); untimed edge shapes; the causal over
               non-causal time (fully masked tiles are skipped)
      c-flash-paged  ops.mha_flash_paged over a 512-page pool of 16 rows
               with garbage in the free and tail pages: causal, window
               256 and int8, bitwise equal to the contiguous kernel on
               the same rows. The checked call of case 1 (bf16) and of
               the paged causal case runs with the launch counts set to
               0 just before and read just after: the slice's path
      c-ragged-quant, c-paged-quant  the fused dequant of both
               entry points (int8 and fp8 codes, f32 scales, bf16 and f32
               queries) at c-ragged's and c-paged's shapes against
               ref.ragged_decode_quant_ref / paged_ragged_decode_ref, the
               paged one bitwise equal to the contiguous one; bytes bound
               with 1-byte codes and two 4-byte scales per row-head; no
               library call dequantizes and attends (SDPA on dequantized
               k/v is printed beside, labelled as such); then bf16 k/v
               under f32 queries, untimed; then every int8 and e4m3 code
               through the kernel, exactly
      c-ragged-shapes, c-paged-shapes  both entry points at Dh 320 (rep
               2, Hk 4: gemma3-4b), Dh 240 (gemma3-12b), Dh 85 (rep 1:
               rows that take the scalar tail) and rep 8 (Dh 128), with
               lengths at the span edges, four k/v storages (f32, bf16,
               int8, fp8), bf16 and f32 queries, paged bitwise equal to
               contiguous; Dh 320 timed in bf16 with its bound
      c-paged-long  one paged slot of 40960 rows (2560 table pages) and
               seven short ones, four storages, both query types,
               bitwise equal to contiguous; timed in bf16 with its bound
  (d) parity   full-width f32 decode_step logits over a chunked prefill
               and 16 greedy steps for 4 slots: the kernel path and the
               paged kernel path (permuted block table) vs the dense path
      d-quant  the same with int8 and with fp8 caches: the fused dequant
               vs the dense dequant path (1e-3, tokens identical), and,
               not gated, the quantized logits' distance from the
               unquantized f32 path's
  (e) serve    8 greedy bf16 requests (prompts of 32-512 tokens, 64 new
               tokens each) through Engine(n_slots=8, max_len=2048,
               prefix_cache=False); the kernels' launch counts of that run
               show the path used them
      e-quant  the same traffic from int8 caches: the ragged kernel's
               launches (its fused dequant) == 28 x decode steps, and the
               cache bytes against (e)'s
  (g) paged    16 greedy bf16 requests sharing a 250-token system prompt
               through Engine(paged=True, n_slots=16, n_pages=512), the
               prefix cache on: hits, page aliasing, a boundary-page copy
               per hit, over-commit of the pool, and the paged kernel's
               launch counts of that run
      g-spill  the host spill tier: a prefix spilled to the host and
               restored serves the same tokens as the resident prefix;
               every copy, spill and restore held bitwise on the card
      g-quant  (g)'s traffic and gates from an fp8 pool
  (h) parity   rwkv6-1.6b + AltUp K=2 at full width, f32: forward logits
               on 2 prompts of 64 tokens, then a token-by-token prefill
               and 16 greedy decode_steps, the kernel path vs the dense
               path
  (i) rwkv     8 greedy bf16 requests (prompts of 32-256 tokens, 32 new
               tokens) through Engine(n_slots=8, max_len=512) with the
               prefix cache on: a max_new=1 donor over a prefix, then a
               request extending it hits and serves a cold engine's
               tokens; the WKV kernel launches 24 times per step
  (f) profile  (--profile only) device busy share of pure decode steps,
               of the (e) engine, (f-profile-quant) of the e-quant
               engine, (f-profile-paged) of the (g) engine and
               (f-profile-rwkv) of the (i) engine

Every phase prints one line; any failure raises and exits non-zero. The
second-to-last line is the per-kernel JSON record; the last line is
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
It exits 1 without printing a result when no CUDA device is present, and
fails when the repository's `src/repro_torch` is not beside it.
"""
from __future__ import annotations

import contextlib
import json
import math
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
PKG = ROOT / "src" / "repro_torch"
DEV = "cuda"


def served_config(**kw):
    """Qwen3-0.6B wrapped with AltUp K=2 (recycled: vocab > 100k)."""
    from repro_torch.configs import get_config
    return get_config("qwen3-0.6b", altup_k=2).replace(**kw)


def rwkv_config(**kw):
    """RWKV-6 1.6B wrapped with AltUp K=2 (not recycled: vocab 65536)."""
    from repro_torch.configs import get_config
    return get_config("rwkv6-1.6b", altup_k=2).replace(**kw)


# NVIDIA H100 SXM data sheet (dense rates, 700 W)
HBM_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = {"float32": 67e12, "bfloat16": 989e12}

F32_TOL = dict(atol=2e-5, rtol=2e-5)     # kernel vs plain, f32 in and out
# WKV kernel vs plain, f32: sums over Dh in another order, FMA-contracted,
# carried through up to 512 recurrent steps, on values of order 10
WKV_F32_TOL = dict(atol=1e-4, rtol=1e-4)
BF16_TOL = dict(atol=2e-2, rtol=2e-2)    # outputs rounded to bf16 (1 ulp)
PARITY_TOL = dict(atol=1e-3, rtol=1e-3)  # 28-layer f32 logits, two paths
# device_ms filter of the ragged decode attention: a call launches the
# split kernel (ragged_decode_split_kernel or
# paged_ragged_decode_split_kernel) and ragged_decode_merge_kernel, and
# this substring of the three names sums both kernels of the call (two
# matching launches per call, which device_ms checks)
RAGGED_KERNELS = "ragged_decode_"


T_START = time.perf_counter()


def line(tag, **vals):
    """One phase's JSON line, with the script's elapsed seconds."""
    vals["elapsed_s"] = time.perf_counter() - T_START
    print(f"[{tag}] " + json.dumps(vals), flush=True)


def time_ms(torch, fn, iters=100, warmup=10):
    """Mean device time of fn() in ms, by CUDA events over `iters` calls."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def bound_ms(nbytes, nops, dtype_name):
    """Least time for the work: max of bytes over HBM rate and operations
    over the peak rate of their type. Returns (ms, "bytes"|"operations")."""
    tb = nbytes / HBM_BYTES_PER_S
    to = nops / PEAK_OPS_PER_S[dtype_name]
    return (1e3 * max(tb, to), "bytes" if tb >= to else "operations")


def max_err(torch, a, b):
    return float((a.float() - b.float()).abs().max())


def perturb_rwkv(torch, params, cfg, seed):
    """Seeded values for the RWKV-6 leaves the reference starts at zero
    (ts_b, w_b, u) and a spread of decay bases, then AltUp p/g. Scales
    follow the fan-in so that w_base + lora(x) stays below ~1.5, where
    the reference's chunked form keeps 1/A inside f32 (16 steps)."""
    gen = torch.Generator(device=DEV).manual_seed(seed)
    rw = cfg.rwkv
    with torch.no_grad():
        p = params["seg0"]["rwkv"]
        for leaf, scale in (("ts_b", 1.0 / math.sqrt(rw.token_shift_lora)),
                            ("w_b", 0.4 / math.sqrt(rw.decay_lora)),
                            ("u", 0.5)):
            t = p[leaf]
            t.copy_(scale * torch.randn(t.shape, generator=gen, device=DEV))
        wb = p["w_base"]
        wb.copy_(-4.0 + 3.5 * torch.rand(wb.shape, generator=gen,
                                         device=DEV))
    perturb_altup(torch, params, seed + 1)


def perturb_altup(torch, params, seed):
    """p = I + 0.2·N(0,1), g = 1 + 0.2·N(0,1): at init (p = I, g = 1)
    predict and correct are trivial and would test nothing."""
    gen = torch.Generator(device=DEV).manual_seed(seed)
    with torch.no_grad():
        for name in params.keys():
            if not name.startswith("seg"):
                continue
            seg = params[name]
            p, g = seg["altup_p"], seg["altup_g"]
            eye = torch.eye(p.shape[-1], device=p.device)
            p.copy_(eye + 0.2 * torch.randn(p.shape, generator=gen,
                                            device=p.device))
            g.copy_(1 + 0.2 * torch.randn(g.shape, generator=gen,
                                          device=g.device))


# ---------------------------------------------------------------------------
# (c) kernels against their plain versions
# ---------------------------------------------------------------------------

def check_altup(torch, ops, ref, dtype, T, K=2, d=1024, seed=0):
    gen = torch.Generator(device=DEV).manual_seed(seed)
    xw = torch.randn(T, K, d, generator=gen, device=DEV).to(dtype)
    xt = torch.randn(T, d, generator=gen, device=DEV).to(dtype)
    p = torch.eye(K, device=DEV) + 0.3 * torch.randn(
        K, K, generator=gen, device=DEV)
    g = 1 + 0.3 * torch.randn(K, generator=gen, device=DEV)
    sel = (torch.arange(K, device=DEV) == 1).float()

    def launch():
        return ops.altup_predict_correct(xw, xt, sel, p, g)

    def plain():
        return ref.altup_predict_correct_ref(xw, xt, sel, p, g)
    got, want = launch(), plain()
    torch.cuda.synchronize()
    tol = F32_TOL if dtype == torch.float32 else BF16_TOL
    torch.testing.assert_close(got, want, **tol)
    name = "float32" if dtype == torch.float32 else "bfloat16"
    esz = xw.element_size()
    nbytes = (2 * K + 1) * T * d * esz + (K * K + 2 * K) * 4
    nops = T * d * (2 * K * K + 4 * K + 1)
    b_ms, b_by = bound_ms(nbytes, nops, "float32")   # computed in f32
    return {"dtype": name, "T": T, "K": K, "d": d,
            "max_abs_err": max_err(torch, got, want),
            "ms": device_ms(torch, launch, "altup_predict_correct_kernel"),
            "plain_ms": device_ms(torch, plain),
            "wrapper_ms": time_ms(torch, launch, iters=200),
            "bound_ms": b_ms, "bound_by": b_by, "library_ms": None,
            "bytes": nbytes, "tol": tol}


def stored_kv(torch, k, v, store, dtype):
    """k, v as the cache stores them: store None keeps q's dtype; "bf16"
    or "f32" stores float k/v in that type (a float storage mode other
    than the activations'); "int8" / "fp8" gives codes and f32 scales
    from the port's quant.quantize on the card. Returns (k, v, k_scale,
    v_scale)."""
    from repro_torch.kernels import quant as Q
    if store is None:
        return k, v, None, None
    if store in ("bf16", "f32"):
        t = torch.bfloat16 if store == "bf16" else torch.float32
        return k.to(t), v.to(t), None, None
    spec = Q.resolve_kv_spec(store, dtype)
    (kc, ks), (vc, vs) = Q.quantize(k, spec), Q.quantize(v, spec)
    return kc, vc, ks, vs


def kv_row_bytes(k, k_scale, Dh):
    """Bytes of one (row, kv head) of k and v, with their scales."""
    return 2 * Dh * k.element_size() + (0 if k_scale is None else 2 * 4)


def check_ragged(torch, ops, ref, dtype, lens_host, Hk=8, rep=2, Dh=128,
                 T=2048, store=None, timed=True, seed=1):
    """ops.ragged_decode_attn on CUDA tensors (the kernel) against its
    plain version; store as in stored_kv ("int8" / "fp8": the fused
    dequant, against ref.ragged_decode_quant_ref). Timed cases add device
    ms of the kernel, the plain version and the library call (SDPA on the
    masked GQA problem; for codes, which it cannot read, SDPA on the
    dequantized k/v, printed beside and no library call)."""
    import torch.nn.functional as F
    gen = torch.Generator(device=DEV).manual_seed(seed)
    B, H = len(lens_host), Hk * rep
    q = torch.randn(B, 1, H, Dh, generator=gen, device=DEV).to(dtype)
    k = torch.randn(B, T, Hk, Dh, generator=gen, device=DEV).to(dtype)
    v = torch.randn(B, T, Hk, Dh, generator=gen, device=DEV).to(dtype)
    k, v, ks, vs = stored_kv(torch, k, v, store, dtype)
    lens = torch.tensor(lens_host, dtype=torch.int32, device=DEV)
    qg = q[:, 0].reshape(B, Hk, rep, Dh)

    def launch():
        return ops.ragged_decode_attn(q, k, v, lens, ks, vs)

    def plain():
        if ks is None:
            return ref.ragged_decode_ref(qg, k, v, lens)
        return ref.ragged_decode_quant_ref(qg, k, v, ks, vs, lens)
    got, want = launch(), plain().reshape(B, 1, H, Dh)
    torch.cuda.synchronize()
    tol = F32_TOL if dtype == torch.float32 else BF16_TOL
    torch.testing.assert_close(got, want, **tol)
    for b in range(B):
        if lens_host[b] == 0 and not bool((got[b] == 0).all()):
            raise AssertionError(f"empty slot {b} is not exact zeros")
    name = "float32" if dtype == torch.float32 else "bfloat16"
    res = {"dtype": name, "store": store, "B": B, "Hk": Hk, "rep": rep,
           "Dh": Dh, "T": T, "lengths": lens_host,
           "max_abs_err": max_err(torch, got, want), "tol": tol}
    if not timed:
        return res
    esz = q.element_size()
    rows = sum(lens_host)
    nbytes = rows * Hk * kv_row_bytes(k, ks, Dh) + 2 * B * H * Dh * esz \
        + 4 * B
    nops = rows * Hk * rep * Dh * 4
    # the arithmetic of the codes' path (dequant, dots) is f32
    b_ms, b_by = bound_ms(nbytes, nops, name if ks is None else "float32")
    # library yardstick: one SDPA call on the same masked GQA problem,
    # timed here only (the port never calls it)
    kd = k if ks is None else ref.dequant_ref(k, ks, dtype)
    vd = v if vs is None else ref.dequant_ref(v, vs, dtype)
    qs = q.permute(0, 2, 1, 3)                        # (B, H, 1, Dh)
    kt, vt = (t.to(dtype).permute(0, 2, 1, 3) for t in (kd, vd))
    mask = (torch.arange(T, device=DEV)[None, :] < lens[:, None])
    mask = mask[:, None, None, :]

    def library():
        return F.scaled_dot_product_attention(qs, kt, vt, attn_mask=mask,
                                              enable_gqa=True)
    lib = library()
    live = lens > 0                  # SDPA gives NaN on an all-masked row
    lib_err = max_err(torch, lib[live].permute(0, 2, 1, 3), want[live])
    sdpa_ms = device_ms(torch, library)
    res.update({
        "ms": device_ms(torch, launch, RAGGED_KERNELS, per_call=2),
        "plain_ms": device_ms(torch, plain),
        "wrapper_ms": time_ms(torch, launch),
        "bound_ms": b_ms, "bound_by": b_by,
        # no single PyTorch call dequantizes and attends
        "library_ms": sdpa_ms if ks is None else None,
        "sdpa_on_dequantized_ms": None if ks is None else sdpa_ms,
        "library_max_abs_err_nonempty": lib_err, "bytes": nbytes})
    return res


def check_all_codes(torch, ops):
    """Every int8 code and every float8_e4m3fn code (NaN codes included)
    through the contiguous kernel's value path: one row of Dh = 256
    codes as v (k zero codes, scales 1), so that the output is that row
    as f32, held exactly (the kernel converts codes with integer
    arithmetic and paired e4m3 conversions, not one conversion per
    element; the score path shares the same conversion)."""
    res = {}
    for kind, dt in (("int8", torch.int8), ("fp8", torch.float8_e4m3fn)):
        row = torch.arange(256, dtype=torch.uint8, device=DEV).view(dt)
        v = row.reshape(1, 1, 1, 256)
        k = torch.zeros(1, 1, 1, 256, dtype=torch.uint8,
                        device=DEV).view(dt)
        ones = torch.ones(1, 1, 1, device=DEV)
        got = ops.ragged_decode_attn(
            torch.zeros(1, 1, 1, 256, device=DEV), k, v,
            torch.ones(1, dtype=torch.int32, device=DEV), ones, ones)
        torch.testing.assert_close(got.reshape(256), row.float(), atol=0,
                                   rtol=0, equal_nan=True)
        res[kind] = "exact"
    return res


def pages_for(rows, page):
    return -(-rows // page)


def paged_table(torch, gen, reserve, n_shared, n_pages, npg):
    """(B, npg) int32 block table over a seeded random permutation of the
    pool's pages, laid out as PagePool lays it out: slot b holds
    reserve[b] pages, the first n_shared of them the same pages for every
    slot (an aliased prompt prefix), the rest its own; an idle slot
    (reserve 0) and the entries past a slot's reservation are 0."""
    perm = torch.randperm(n_pages, generator=gen).tolist()
    if n_shared + sum(max(r - n_shared, 0) for r in reserve) > n_pages:
        raise ValueError("the pool cannot hold these reservations")
    bt = torch.zeros(len(reserve), npg, dtype=torch.int32)
    nxt = n_shared
    for b, r in enumerate(reserve):
        if r:
            own = perm[nxt:nxt + r - n_shared]
            nxt += r - n_shared
            bt[b, :r] = torch.tensor(perm[:n_shared] + own)
    return bt.to(DEV)


def check_paged(torch, ops, ref, dtype, lens_host, reserve, n_shared=0,
                n_pages=1024, Hk=8, rep=2, Dh=128, T=2048, t_max=2048,
                page=16, store=None, timed=True, seed=4):
    """The paged kernel over a random pool of n_pages pages plus the sink,
    through the block table of paged_table (T // page entries per slot)
    with the read bound t_max, against its plain version and, bitwise,
    against the contiguous kernel on the same rows gathered into
    contiguous caches; store as in stored_kv (codes with (R, Hk) pool
    scales)."""
    import torch.nn.functional as F
    gen = torch.Generator(device=DEV).manual_seed(seed)
    B, H, npg = len(lens_host), Hk * rep, T // page
    R = (n_pages + 1) * page
    q = torch.randn(B, 1, H, Dh, generator=gen, device=DEV).to(dtype)
    kp = torch.randn(R, Hk, Dh, generator=gen, device=DEV).to(dtype)
    vp = torch.randn(R, Hk, Dh, generator=gen, device=DEV).to(dtype)
    kp, vp, ksp, vsp = stored_kv(torch, kp, vp, store, dtype)
    lens = torch.tensor(lens_host, dtype=torch.int32, device=DEV)
    bt = paged_table(torch, torch.Generator().manual_seed(seed), reserve,
                     n_shared, n_pages, npg)
    grows = (bt.long()[:, :, None] * page
             + torch.arange(page, device=DEV)).reshape(B, T)

    def gathered(pool):
        """The contiguous read slice of the same rows, (B, t_max, ...),
        1-byte codes through their uint8 view."""
        if pool is None:
            return None
        raw = pool.view(torch.uint8) if pool.element_size() == 1 else pool
        return raw[grows[:, :t_max]].view(pool.dtype)
    k, v, ks, vs = (gathered(t) for t in (kp, vp, ksp, vsp))
    qg = q[:, 0].reshape(B, Hk, rep, Dh)

    def launch():
        return ops.paged_ragged_decode_attn(q, kp, vp, lens, bt, ksp, vsp,
                                            page=page, t_max=t_max)

    def plain():
        return ref.paged_ragged_decode_ref(qg, kp, vp, lens, bt, ksp, vsp,
                                           page=page, t_max=t_max)
    got, want = launch(), plain().reshape(B, 1, H, Dh)
    contiguous = ops.ragged_decode_attn(q, k, v, lens, ks, vs)
    torch.cuda.synchronize()
    tol = F32_TOL if dtype == torch.float32 else BF16_TOL
    torch.testing.assert_close(got, want, **tol)
    for b in range(B):
        if lens_host[b] == 0 and not bool((got[b] == 0).all()):
            raise AssertionError(f"empty slot {b} is not exact zeros")
    if not torch.equal(got, contiguous):
        raise AssertionError(
            f"paged kernel differs from the contiguous kernel on the same "
            f"rows: max abs {max_err(torch, got, contiguous)}")
    name = "float32" if dtype == torch.float32 else "bfloat16"
    res = {"dtype": name, "store": store, "B": B, "Hk": Hk, "rep": rep,
           "Dh": Dh, "page": page, "pool_pages": n_pages,
           "table_pages": npg, "t_max": t_max,
           "lengths": lens_host, "shared_pages": n_shared,
           "max_abs_err": max_err(torch, got, want),
           "bitwise_equal_contiguous": True, "tol": tol}
    if not timed:
        return res
    esz = q.element_size()
    # bytes: each pool row that some slot reads, once (an aliased page is
    # one input however many slots read it), q, out, lengths, table entries
    rows = torch.cat([grows[b, :n] for b, n in enumerate(lens_host)])
    distinct = int(rows.unique().numel())
    table = sum(pages_for(n, page) for n in lens_host)
    nbytes = (distinct * Hk * kv_row_bytes(kp, ksp, Dh)
              + 2 * B * H * Dh * esz + 4 * B + 4 * table)
    nops = sum(lens_host) * Hk * rep * Dh * 4
    b_ms, b_by = bound_ms(nbytes, nops, name if ksp is None else "float32")
    # no single PyTorch call reads through a block table; SDPA on rows
    # gathered (and dequantized) beforehand is printed beside it, labelled
    # as such
    kd = k if ks is None else ref.dequant_ref(k, ks, dtype)
    vd = v if vs is None else ref.dequant_ref(v, vs, dtype)
    qs = q.permute(0, 2, 1, 3)
    kt, vt = (t.to(dtype).permute(0, 2, 1, 3) for t in (kd, vd))
    mask = (torch.arange(t_max, device=DEV)[None, :] < lens[:, None])
    mask = mask[:, None, None, :]

    def sdpa_gathered():
        return F.scaled_dot_product_attention(qs, kt, vt, attn_mask=mask,
                                              enable_gqa=True)
    res.update({
        "distinct_rows_read": distinct,
        "ms": device_ms(torch, launch, RAGGED_KERNELS, per_call=2),
        "plain_ms": device_ms(torch, plain),
        "wrapper_ms": time_ms(torch, launch),
        "bound_ms": b_ms, "bound_by": b_by, "library_ms": None,
        "sdpa_on_pregathered_rows_ms": device_ms(torch, sdpa_gathered),
        "bytes": nbytes})
    return res


def ragged_stores(torch, dtype):
    """The four k/v storages under queries of `dtype`: q's own float type,
    the other float type, int8 and fp8 codes."""
    return (None, "f32" if dtype == torch.bfloat16 else "bf16", "int8",
            "fp8")


def check_shapes(torch, ops, ref):
    """Both entry points at the head shapes the split kernels were widened
    for: gemma3-4b's (Dh 320, rep 2, Hk 4) and gemma3-12b's (Dh 240, rep
    2, Hk 8) widths, an odd width whose rows take the scalar tail (Dh 85,
    rep 1), and the widest grouping (rep 8, Dh 128); 8 slots with lengths
    at the span edges, T = 1024, four storages, bf16 and f32 queries,
    paged bitwise equal to contiguous. The Dh 320 case is timed in bf16
    (bf16 k/v). Yields (tag, case, result)."""
    from repro_torch.kernels.ragged_decode_attention import SPAN
    lens = [0, 1, SPAN - 1, SPAN, SPAN + 1, 517, 1000, 1024]
    for case, kw in (("dh320", dict(Dh=320, rep=2, Hk=4)),
                     ("dh240", dict(Dh=240, rep=2, Hk=8)),
                     ("dh85", dict(Dh=85, rep=1, Hk=8)),
                     ("rep8", dict(Dh=128, rep=8, Hk=4))):
        for dtype in (torch.bfloat16, torch.float32):
            for store in ragged_stores(torch, dtype):
                timed = (case == "dh320" and dtype == torch.bfloat16
                         and store is None)
                yield "c-ragged-shapes", case, check_ragged(
                    torch, ops, ref, dtype, lens, T=1024, store=store,
                    timed=timed, **kw)
                yield "c-paged-shapes", case, check_paged(
                    torch, ops, ref, dtype, lens, reserve=[64] * 8,
                    n_pages=520, T=1024, t_max=1024, store=store,
                    timed=timed, **kw)


def check_long_slot(torch, ops, ref):
    """The paged entry point over one slot of 40960 rows and seven short
    ones, page 16: 2560 table pages, past the 2048 that the kernel before
    the split staged per slot. Four storages, bf16 and f32 queries,
    bitwise equal to the contiguous kernel on the same 40960-row caches;
    timed in bf16 (bf16 k/v). Yields results."""
    lens = [40960, 1, 100, 300, 17, 500, 129, 64]
    reserve = [pages_for(n, 16) for n in lens]
    for dtype in (torch.bfloat16, torch.float32):
        for store in ragged_stores(torch, dtype):
            yield check_paged(
                torch, ops, ref, dtype, lens, reserve=reserve,
                n_pages=sum(reserve) + 8, T=40960, t_max=40960, store=store,
                timed=dtype == torch.bfloat16 and store is None)
            torch.cuda.empty_cache()


def check_wkv(torch, ops, ref, dtype, B, H, Dh, S, state, seed=7):
    """The WKV kernel through ops.rwkv6_wkv on (B, S, H, Dh) inputs, u
    (H, Dh) and a random state updated in place (state="random") or none
    (state=None), against its plain version on the same rows. Inputs:
    r, k, v ~ N(0, 1), w = exp(-exp(N(0, 1) - 1)), state ~ N(0, 1)."""
    gen = torch.Generator(device=DEV).manual_seed(seed)

    def rnd(*shape):
        return torch.randn(*shape, generator=gen, device=DEV)
    r, k, v = (rnd(B, S, H, Dh).to(dtype) for _ in range(3))
    w = torch.exp(-torch.exp(rnd(B, S, H, Dh) - 1)).to(dtype)
    u = rnd(H, Dh).to(dtype)
    s0 = rnd(B, H, Dh, Dh) if state == "random" else None

    def fold(t):
        return t.transpose(1, 2).reshape(B * H, S, Dh)
    want_o, want_s = ref.rwkv6_wkv_ref(fold(r), fold(k), fold(v), fold(w),
                                       u, None if s0 is None
                                       else s0.reshape(B * H, Dh, Dh))
    want_o = want_o.reshape(B, H, S, Dh).transpose(1, 2)
    st = None if s0 is None else s0.clone()
    got_o, got_s = ops.rwkv6_wkv(r, k, v, w, u, st)
    torch.cuda.synchronize()
    if st is not None and got_s is not st:
        raise AssertionError("the WKV kernel did not update the state in "
                             "place")
    tol = WKV_F32_TOL if dtype == torch.float32 else BF16_TOL
    torch.testing.assert_close(got_o, want_o, **tol)
    torch.testing.assert_close(got_s, want_s.reshape(B, H, Dh, Dh),
                               **WKV_F32_TOL)
    name = "float32" if dtype == torch.float32 else "bfloat16"
    esz = r.element_size()
    BH = B * H
    # each input once (the state if given), out and the final state once
    nbytes = (5 * BH * S * Dh * esz + H * Dh * esz
              + (2 if s0 is not None else 1) * BH * Dh * Dh * 4)
    # per step and head: out (Σᵢ rᵢ Sᵢⱼ, 2 per element) and the state
    # update (wᵢ Sᵢⱼ + kᵢ vⱼ, 3 per element), all f32
    nops = 5 * BH * S * Dh * Dh
    b_ms, b_by = bound_ms(nbytes, nops, "float32")

    def launch():
        return ops.rwkv6_wkv(r, k, v, w, u, st)

    def plain():
        return ref.rwkv6_wkv_ref(fold(r), fold(k), fold(v), fold(w), u,
                                 None if s0 is None
                                 else s0.reshape(BH, Dh, Dh))
    return {"dtype": name, "B": B, "H": H, "Dh": Dh, "S": S,
            "state": state or "none", "in_place": st is not None,
            "max_abs_err": max_err(torch, got_o, want_o),
            "state_max_abs_err": max_err(torch, got_s,
                                         want_s.reshape(B, H, Dh, Dh)),
            "ms": device_ms(torch, launch, "rwkv6_wkv_kernel"),
            "plain_ms": device_ms(torch, plain, iters=5),
            "wrapper_ms": time_ms(torch, launch),
            "bound_ms": b_ms, "bound_by": b_by, "library": "none",
            "library_ms": None, "bytes": nbytes, "flop": nops, "tol": tol}


def check_wkv_zero_state(torch, ops, dtype, B=8, H=32, Dh=64, seed=8):
    """S = 1 from an all-zero state must equal the no-state case bitwise,
    output and final state."""
    gen = torch.Generator(device=DEV).manual_seed(seed)
    r, k, v, w = (torch.rand(B, 1, H, Dh, generator=gen, device=DEV)
                  .to(dtype) for _ in range(4))
    u = torch.randn(H, Dh, generator=gen, device=DEV).to(dtype)
    o_none, s_none = ops.rwkv6_wkv(r, k, v, w, u)
    zero = torch.zeros(B, H, Dh, Dh, device=DEV)
    o_zero, s_zero = ops.rwkv6_wkv(r, k, v, w, u, zero)
    torch.cuda.synchronize()
    if not (torch.equal(o_none, o_zero) and torch.equal(s_none, s_zero)):
        raise AssertionError(
            f"zero state differs from no state: out "
            f"{max_err(torch, o_none, o_zero)}, state "
            f"{max_err(torch, s_none, s_zero)}")
    return {"dtype": "float32" if dtype == torch.float32 else "bfloat16",
            "B": B, "H": H, "Dh": Dh, "S": 1, "bitwise_equal": True}


# ---------------------------------------------------------------------------
# (c-flash) the flash-attention kernel, reached through ops.mha_flash and
# ops.mha_flash_paged (no served path calls it, as in the reference)
# ---------------------------------------------------------------------------

def flash_pairs(S, T, causal, window):
    """Visible (query, key) pairs of one head: the work the kernel does
    once fully masked tiles are skipped (and the partly masked ones are
    not counted)."""
    total = 0
    for i in range(S):
        hi = min(T - 1, i) if causal else T - 1
        lo = max(0, i - window + 1) if window > 0 else 0
        total += max(0, hi - lo + 1)
    return total


def flash_bound(torch, q, k, k_scale, causal, window):
    """Bytes: q and out once, the kv rows some query sees once (rows past
    S are never visible under a causal mask), scales once. Operations:
    4·dh per visible pair, at the peak rate of the type the products
    run in (bf16 tensor cores for bf16 q, f32 for f32 q)."""
    B, S, H, dh = q.shape
    T, Hk = k.shape[1], k.shape[2]
    rows = min(T, S) if causal else T
    nbytes = (2 * q.numel() * q.element_size()
              + 2 * B * rows * Hk * dh * k.element_size()
              + (2 * B * rows * Hk * 4 if k_scale is not None else 0))
    nops = 4 * dh * B * H * flash_pairs(S, T, causal, window)
    name = "float32" if q.dtype == torch.float32 else "bfloat16"
    return nbytes, nops, bound_ms(nbytes, nops, name)


def flash_kernel_name(torch, dtype):
    return "flash_f32_kernel" if dtype == torch.float32 else \
        "flash_tc_kernel"


def flash_qkv(torch, B, S, T, H, Hk, dh, dtype, seed):
    gen = torch.Generator(device=DEV).manual_seed(seed)
    q = torch.randn(B, S, H, dh, generator=gen, device=DEV).to(dtype)
    k = torch.randn(B, T, Hk, dh, generator=gen, device=DEV).to(dtype)
    v = torch.randn(B, T, Hk, dh, generator=gen, device=DEV).to(dtype)
    return q, k, v


def window_mask(torch, S, T, causal, window):
    """(S, T) bool mask of visible keys, for SDPA's attn_mask."""
    i = torch.arange(S, device=DEV)[:, None]
    j = torch.arange(T, device=DEV)[None, :]
    m = torch.ones(S, T, dtype=torch.bool, device=DEV)
    if causal:
        m &= i >= j
    if window > 0:
        m &= i - j < window
    return m


def counted_call(torch, ops, launch, name, counted):
    """launch() once, synchronised. counted: every launch count is set to
    0 just before and read just after, and `name` must show exactly this
    one launch; returns (output, launches or None)."""
    if counted:
        ops.reset_launch_counts()
    out = launch()
    torch.cuda.synchronize()
    if not counted:
        return out, None
    counts = ops.launch_counts()
    if counts[name] != 1 or sum(counts.values()) != 1:
        raise AssertionError(f"launch counts {counts}: want one {name}")
    return out, counts[name]


def check_flash(torch, ops, ref, dtype, B, S, T, H, Hk, dh, causal=True,
                window=0, quant=None, timed=True, counted=False, seed=20):
    """ops.mha_flash on a CUDA tensor (the kernel) against ref.mha_ref on
    the same inputs; quant="int8"|"fp8" gives k/v as codes and scales from
    the port's quant.quantize on the card. Timed cases add device ms per
    call of the kernel, the plain version and SDPA (enable_gqa; an
    explicit mask for a window; on the dequantized k/v for codes, which
    SDPA cannot read), the wrapper's ms and the bound. counted: the
    checked call is the slice's path, run with every launch count set to
    0 just before and read just after."""
    import torch.nn.functional as F
    from repro_torch.kernels import quant as Q
    q, k, v = flash_qkv(torch, B, S, T, H, Hk, dh, dtype, seed)
    ks = vs = None
    if quant is not None:
        spec = Q.resolve_kv_spec(quant, dtype)
        k, ks = Q.quantize(k, spec)
        v, vs = Q.quantize(v, spec)
    kw = dict(causal=causal, window=window)
    # block_q / block_k only validate the call: S and T pass as one block
    blocks = dict(block_q=S, block_k=T)

    def launch():
        return ops.mha_flash(q, k, v, ks, vs, **blocks, **kw)

    def plain():
        return ref.mha_ref(q, k, v, ks, vs, **kw)
    got, launches = counted_call(torch, ops, launch, "flash_attention",
                                 counted)
    want = plain()
    tol = F32_TOL if dtype == torch.float32 else BF16_TOL
    torch.testing.assert_close(got, want, **tol)
    res = {"dtype": "float32" if dtype == torch.float32 else "bfloat16",
           "B": B, "S": S, "T": T, "H": H, "Hk": Hk, "dh": dh,
           "causal": causal, "window": window, "quant": quant,
           "max_abs_err": max_err(torch, got, want), "tol": tol,
           "launches": launches}
    if not timed:
        return res
    nbytes, nops, (b_ms, b_by) = flash_bound(torch, q, k, ks, causal,
                                             window)
    kd = k if ks is None else ref.dequant_ref(k, ks, dtype)
    vd = v if vs is None else ref.dequant_ref(v, vs, dtype)
    qs, kt, vt = (t.transpose(1, 2) for t in (q, kd, vd))
    mask = None
    if window > 0:
        mask = window_mask(torch, S, T, causal, window)

    def library():
        return F.scaled_dot_product_attention(
            qs, kt, vt, attn_mask=mask, is_causal=causal and mask is None,
            enable_gqa=True)
    lib = library().transpose(1, 2)
    sdpa_ms = device_ms(torch, library)
    res.update({
        "ms": device_ms(torch, launch, flash_kernel_name(torch, dtype)),
        "plain_ms": device_ms(torch, plain, iters=10),
        "wrapper_ms": time_ms(torch, launch, iters=20),
        "bound_ms": b_ms, "bound_by": b_by,
        # SDPA reads no codes: on codes it is timed on the dequantized k/v
        # and is no library call of the same function
        "library_ms": sdpa_ms if quant is None else None,
        "sdpa_on_dequantized_ms": sdpa_ms if quant is not None else None,
        "library_max_abs_err": max_err(torch, lib, want),
        "bytes": nbytes, "flop": nops})
    return res


# c-flash's timed cases: qwen3-0.6b's attention at full width (16 q / 8 kv
# heads of 128) as a causal prefill, non-causal, with T > S and with int8
# and fp8 codes; gemma3-4b's local layer at full width (8 q / 4 kv heads
# of 320, window 1024), bf16 only
FLASH_CASES = (
    ("prefill", dict(B=4, S=2048, T=2048, H=16, Hk=8, dh=128)),
    ("non-causal", dict(B=4, S=512, T=512, H=16, Hk=8, dh=128,
                        causal=False)),
    ("t-gt-s", dict(B=4, S=512, T=2048, H=16, Hk=8, dh=128)),
    ("prefill-int8", dict(B=4, S=2048, T=2048, H=16, Hk=8, dh=128,
                          quant="int8")),
    ("prefill-fp8", dict(B=4, S=2048, T=2048, H=16, Hk=8, dh=128,
                         quant="fp8")),
    ("gemma3-4b-local", dict(B=1, S=4096, T=4096, H=8, Hk=4, dh=320,
                             window=1024)),
)
# untimed shapes at the edges: every padded head width (64, 256, 320), rep
# 1, 3 (a block's 64 rows not filled) and 4, windows that cut tiles, T < S
# and T > S, a window without the causal mask (future keys visible)
FLASH_ODD = (
    ("dh8-rep1", dict(B=2, S=100, T=100, H=2, Hk=2, dh=8)),
    ("dh40-rep3-window-only", dict(B=2, S=96, T=160, H=6, Hk=2, dh=40,
                                   causal=False, window=40)),
    ("dh240-rep4-window", dict(B=1, S=192, T=256, H=8, Hk=2, dh=240,
                               window=48)),
    ("dh320-fp8-window", dict(B=1, S=256, T=256, H=8, Hk=4, dh=320,
                              window=64, quant="fp8")),
    ("dh64-int8-t-lt-s", dict(B=2, S=128, T=64, H=4, Hk=4, dh=64,
                              quant="int8")),
)


def flash_skip_ratio(torch, ops, dtype, B=4, S=2048, H=16, Hk=8, dh=128):
    """Causal over non-causal device ms at case 1's shape: the TPU
    design skips the tiles above the diagonal, about half of them."""
    q, k, v = flash_qkv(torch, B, S, S, H, Hk, dh, dtype, seed=21)
    name = flash_kernel_name(torch, dtype)
    ms = {c: device_ms(torch, lambda: ops.mha_flash(q, k, v, causal=c),
                       name, iters=20)
          for c in (True, False)}
    return {"dtype": "float32" if dtype == torch.float32 else "bfloat16",
            "causal_ms": ms[True], "non_causal_ms": ms[False],
            "causal_over_non_causal": ms[True] / ms[False],
            "visible_pair_ratio": flash_pairs(S, S, True, 0)
            / flash_pairs(S, S, False, 0)}


# (c-flash-paged): 4 sequences of 1024 rows in a pool of 512 pages of 16
# rows (phase g's page), through a permuted table with one more page per
# sequence, a tail page of garbage past the valid rows; the other pool
# pages hold garbage too
FP_B, FP_S, FP_PAGES, FP_PAGE = 4, 1024, 512, 16


def check_flash_paged(torch, ops, ref, dtype, causal=True, window=0,
                      quant=None, counted=False, H=16, Hk=8, dh=128,
                      seed=22):
    """ops.mha_flash_paged on a CUDA pool (the kernel) against
    ref.paged_attention_ref, and bitwise against the contiguous kernel
    (ops.mha_flash) on the same rows gathered through the table; counted
    as in check_flash."""
    import torch.nn.functional as F
    from repro_torch.kernels import quant as Q
    gen = torch.Generator(device=DEV).manual_seed(seed)
    B, S, page = FP_B, FP_S, FP_PAGE
    nk = S // page + 1                               # the tail page
    R = FP_PAGES * page
    q = torch.randn(B, S, H, dh, generator=gen, device=DEV).to(dtype)
    # garbage: 100x the scale of the valid rows, so a leak shows
    kp = 100 * torch.randn(R, Hk, dh, generator=gen, device=DEV)
    vp = 100 * torch.randn(R, Hk, dh, generator=gen, device=DEV)
    perm = torch.randperm(FP_PAGES, generator=torch.Generator()
                          .manual_seed(seed))[:B * nk]
    bt = perm.reshape(B, nk).to(torch.int32).to(DEV)
    rows = (bt.long()[:, :, None] * page
            + torch.arange(page, device=DEV)).reshape(B, nk * page)
    valid = rows[:, :S].reshape(-1)
    kp[valid] = torch.randn(valid.numel(), Hk, dh, generator=gen, device=DEV)
    vp[valid] = torch.randn(valid.numel(), Hk, dh, generator=gen, device=DEV)
    kp, vp = kp.to(dtype), vp.to(dtype)
    ks = vs = None
    if quant is not None:
        spec = Q.resolve_kv_spec(quant, dtype)
        kp, ks = Q.quantize(kp, spec)
        vp, vs = Q.quantize(vp, spec)
    kw = dict(causal=causal, window=window)

    def launch():
        return ops.mha_flash_paged(q, kp, vp, bt, ks, vs, page=page, **kw)

    def plain():
        return ref.paged_attention_ref(q, kp, vp, bt, ks, vs, page=page,
                                       **kw)
    got, launches = counted_call(torch, ops, launch, "flash_attention_paged",
                                 counted)
    want = plain()
    gk, gv = kp[rows], vp[rows]                      # (B, nk·page, Hk, dh)
    gks = None if ks is None else ks[rows]
    gvs = None if vs is None else vs[rows]
    contiguous = ops.mha_flash(q, gk, gv, gks, gvs, block_k=page, **kw)
    torch.cuda.synchronize()
    tol = F32_TOL if dtype == torch.float32 else BF16_TOL
    torch.testing.assert_close(got, want, **tol)
    if not torch.equal(got, contiguous):
        raise AssertionError(
            f"paged flash kernel differs from the contiguous kernel on the "
            f"same rows: max abs {max_err(torch, got, contiguous)}")
    nbytes, nops, (b_ms, b_by) = flash_bound(torch, q, gk, gks, causal,
                                             window)
    nbytes += 4 * bt.numel()
    qs, kt, vt = (t.transpose(1, 2) for t in (
        q, gk if ks is None else ref.dequant_ref(gk, gks, dtype),
        gv if vs is None else ref.dequant_ref(gv, gvs, dtype)))
    mask = window_mask(torch, S, nk * page, causal, window)

    def sdpa_gathered():
        return F.scaled_dot_product_attention(qs, kt, vt, attn_mask=mask,
                                              enable_gqa=True)
    res = {"dtype": "float32" if dtype == torch.float32 else "bfloat16",
           "B": B, "S": S, "H": H, "Hk": Hk, "dh": dh, "page": page,
           "pool_pages": FP_PAGES, "table_pages": nk, "causal": causal,
           "window": window, "quant": quant,
           "max_abs_err": max_err(torch, got, want),
           "bitwise_equal_contiguous": True, "launches": launches,
           "ms": device_ms(torch, launch, flash_kernel_name(torch, dtype)),
           "plain_ms": device_ms(torch, plain, iters=10),
           "wrapper_ms": time_ms(torch, launch, iters=20),
           "bound_ms": b_ms, "bound_by": b_by, "library_ms": None,
           "sdpa_on_pregathered_rows_ms": device_ms(torch, sdpa_gathered),
           "bytes": nbytes, "flop": nops, "tol": tol}
    return res


# ---------------------------------------------------------------------------
# (d) full-width f32 parity: kernel path and paged kernel path vs dense path
# ---------------------------------------------------------------------------

@contextlib.contextmanager
def no_cache_writes():
    """Contiguous decode steps inside the block write nothing to their
    caches (models.decode._update_at does nothing)."""
    import repro_torch.models.decode as D
    real = D._update_at
    D._update_at = lambda cache, new, idx: cache
    try:
        yield
    finally:
        D._update_at = real


def parity_f32(torch, kind=None):
    """Full-width f32 decode_step logits and greedy tokens of the kernel
    path ("k") and the paged kernel path ("p") against the dense path
    ("d"), over a chunked prefill and 16 decode steps.

    kind "int8" / "fp8" (d-quant): every side serves from quantized
    caches, and the dense side differs from the kernel side only in its
    S=1 attention (dense dequant, then sdpa, against the kernels' fused
    dequant) over the same codes: it runs the fused AltUp kernel too, so
    their prefills are one computation, and each decode step it reads a
    copy of the kernel side's caches taken after the kernel side's step
    (this step's rows included), with its own writes suppressed. Rounding
    to codes is discontinuous: the two attention paths' ~1e-7 differences
    would move a code it writes by a whole step now and then (seen: 2 of
    607744 logits 1.1e-3 apart after one such step), which is the
    rounding's doing, not the kernel's. An unquantized dense side ("f"),
    fed the kernel side's tokens, gives the quantized logits' distance
    from the unquantized ones, printed and not gated."""
    from repro_torch.models.decode import (decode_step, init_cache,
                                           init_paged_cache)
    from repro_torch.models.transformer import init_params
    from repro_torch.serve.engine import kv_bucket
    torch.backends.cuda.matmul.allow_tf32 = False   # full f32 products
    torch.backends.cudnn.allow_tf32 = False
    cfg = served_config(dtype="float32", param_dtype="float32")
    quant = kind is not None
    cfg_q = cfg.replace(kv_cache_dtype=kind) if quant else cfg
    cfgs = {"k": cfg_q.replace(ragged_decode_attn=None,
                               fused_decode_altup=None),
            "d": cfg_q.replace(ragged_decode_attn=False,
                               fused_decode_altup=None if quant else False)}
    cfgs["p"] = cfgs["k"]
    if quant:
        cfgs["f"] = cfgs["d"].replace(kv_cache_dtype="auto")
    params = init_params(cfg, seed=0, device=DEV)
    perturb_altup(torch, params, seed=10)
    B, T, C, n_dec, page = 4, 1024, 64, 16, 16
    gen = torch.Generator(device=DEV).manual_seed(2)
    plens = [37, 180, 5, 300]
    prompts = [torch.randint(0, cfg.vocab_size, (n,), generator=gen,
                             device=DEV) for n in plens]
    n_pages = B * T // page
    caches = {s: init_cache(c, B, T, device=DEV) for s, c in cfgs.items()
              if s != "p"}
    caches["p"] = init_paged_cache(cfgs["p"], B, T, n_pages=n_pages,
                                   page=page, device=DEV)
    # the paged side reads through a seeded permutation of the pool
    bt = torch.randperm(n_pages, generator=gen, device=DEV).reshape(
        B, T // page).to(torch.int32)
    pkw = {s: {} for s in cfgs}
    pkw["p"] = {"block_table": bt, "page_size": page}
    sides = tuple(cfgs)
    gated = ("k", "p")
    pos = [0] * B
    worst = {s: 0.0 for s in sides if s != "d"}
    last = {}
    # chunked prefill: every slot feeds up to C prompt tokens per step
    while any(pos[b] < plens[b] for b in range(B)):
        toks = torch.zeros(B, C, dtype=torch.long, device=DEV)
        nval = [min(C, plens[b] - pos[b]) for b in range(B)]
        for b in range(B):
            toks[b, :nval[b]] = prompts[b][pos[b]:pos[b] + nval[b]]
        kv_len = kv_bucket(max(p + n for p, n in zip(pos, nval)), 32, T)
        out = {}
        for side in sides:
            out[side], _ = decode_step(
                params, cfgs[side], caches[side], toks,
                torch.tensor(pos, device=DEV),
                n_valid=torch.tensor(nval, device=DEV), kv_len=kv_len,
                **pkw[side])
        for b in range(B):
            if nval[b]:
                rows = {s: out[s][b, :nval[b], :cfg.vocab_size]
                        for s in sides}
                for s in gated:
                    torch.testing.assert_close(rows[s], rows["d"],
                                               **PARITY_TOL)
                for s in worst:
                    worst[s] = max(worst[s],
                                   max_err(torch, rows[s], rows["d"]))
                if pos[b] + nval[b] == plens[b]:
                    last[b] = {s: rows[s][-1] for s in sides}
        pos = [p + n for p, n in zip(pos, nval)]
    tok = {s: torch.stack([last[b][s].argmax() for b in range(B)])
           for s in sides}
    streams = {s: [tok[s].tolist()] for s in sides}
    min_gap = math.inf
    for _ in range(n_dec):
        kv_len = kv_bucket(max(pos) + 1, 32, T)
        if quant:
            # the dense and unquantized sides take the kernel side's tokens
            tok["d"] = tok["f"] = tok["k"]
        lg = {}
        for side in sides:
            writes = contextlib.nullcontext()
            if quant and side == "d":
                # the kernel side's caches after its step; no writes
                caches["d"] = {si: {n: t.clone() for n, t in seg.items()}
                               for si, seg in caches["k"].items()}
                writes = no_cache_writes()
            with writes:
                logits, _ = decode_step(
                    params, cfgs[side], caches[side], tok[side][:, None],
                    torch.tensor(pos, device=DEV), kv_len=kv_len,
                    **pkw[side])
            lg[side] = logits[:, 0, :cfg.vocab_size]
        for s in gated:
            torch.testing.assert_close(lg[s], lg["d"], **PARITY_TOL)
        for s in worst:
            worst[s] = max(worst[s], max_err(torch, lg[s], lg["d"]))
        top2 = lg["d"].topk(2, dim=-1).values
        min_gap = min(min_gap, float((top2[:, 0] - top2[:, 1]).min()))
        for side in sides:
            tok[side] = lg[side].argmax(dim=-1)
            streams[side].append(tok[side].tolist())
        pos = [p + 1 for p in pos]
    if not streams["k"] == streams["p"] == streams["d"]:
        raise AssertionError(f"greedy tokens differ between the kernel, "
                             f"paged kernel and dense paths: {streams}")
    del params, caches
    torch.cuda.empty_cache()
    res = {"kv_cache_dtype": kind or "auto", "slots": B,
           "prompt_lens": plens, "decode_steps": n_dec,
           "max_abs_logit_err": worst["k"],
           "paged_max_abs_logit_err": worst["p"], "page": page,
           "tol": PARITY_TOL,
           "greedy_tokens_identical": True,
           "tokens_checked": B * (n_dec + 1),
           "min_top2_gap_dense": min_gap,
           "tf32": [torch.backends.cuda.matmul.allow_tf32,
                    torch.backends.cudnn.allow_tf32]}
    if quant:
        # not gated: the quantized dense path against the unquantized one
        res["max_abs_logit_diff_vs_unquantized"] = worst["f"]
        res["greedy_tokens_equal_unquantized"] = \
            streams["d"] == streams["f"]
    return res


# ---------------------------------------------------------------------------
# (e) serve: the main path, through the entry points a user calls
# ---------------------------------------------------------------------------

E_PROMPTS, E_NEW = (32, 96, 160, 224, 288, 352, 416, 512), 64

def cache_bytes(eng):
    """Device bytes of the engine's caches, every leaf."""
    return sum(t.numel() * t.element_size()
               for seg in eng._caches.values() for t in seg.values())


def serve_bf16(torch, ops, profile=False, kind=None):
    """Phase (e); kind "int8" / "fp8" serves the same traffic from
    quantized caches (e-quant)."""
    from repro_torch.models.transformer import init_params
    from repro_torch.serve.engine import Engine
    from repro_torch.serve.sampling import SamplingParams
    cfg = served_config()                              # bf16
    if kind is not None:
        cfg = cfg.replace(kv_cache_dtype=kind)
    params = init_params(cfg, seed=1, device=DEV)
    perturb_altup(torch, params, seed=11)
    eng = Engine(cfg, params, max_len=2048, n_slots=8, prefill_chunk=64,
                 prefix_cache=False, device=DEV)
    gen = torch.Generator().manual_seed(3)
    plens = list(E_PROMPTS)
    prompts = [torch.randint(0, cfg.vocab_size, (n,), generator=gen).tolist()
               for n in plens]
    n_new = E_NEW
    # warm-up request (cuBLAS handles, allocator) outside the counted run
    eng.submit(prompts[0][:16], sampling=SamplingParams(max_new=4))
    eng.run()
    eng.reset_stats()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()     # the peak of this run only
    ops.reset_launch_counts()                # counts start at 0 right here
    t_run = time.perf_counter()
    rids = [eng.submit(p, sampling=SamplingParams(max_new=n_new))
            for p in prompts]
    decode_ms, steps = [], 0
    while eng.has_work:
        pf0 = eng.stats["prefill_tokens"]
        t0 = time.perf_counter()
        eng.step()                           # ends in the ids' device->host
        dt = time.perf_counter() - t0
        steps += 1
        if eng.stats["prefill_tokens"] == pf0:
            decode_ms.append(1e3 * dt)
    wall = time.perf_counter() - t_run
    counts = ops.launch_counts()             # read right after the run
    out = eng.collect()
    if sorted(out) != sorted(rids):
        raise AssertionError(f"not every request completed: {sorted(out)}")
    for rid in rids:
        c = out[rid]
        if len(c.tokens) != n_new or c.finish_reason != "length" or \
                not all(0 <= t < cfg.vocab_size for t in c.tokens):
            raise AssertionError(f"request {rid}: {c.finish_reason}, "
                                 f"{len(c.tokens)} tokens")
    n_layers = cfg.n_layers
    if counts["altup_predict_correct"] <= 0 or \
            counts["ragged_decode_attention"] <= 0:
        raise AssertionError(f"a kernel of the path never launched: {counts}")
    # one launch per layer per step: fused AltUp on every step, ragged
    # attention on the pure-decode (S=1) steps
    if counts["altup_predict_correct"] != n_layers * steps or \
            counts["ragged_decode_attention"] != n_layers * len(decode_ms) \
            or counts["paged_ragged_decode_attention"] != 0:
        raise AssertionError(f"launch counts {counts} do not match {steps} "
                             f"steps, {len(decode_ms)} decode steps")
    st = eng.stats
    decode_ms.sort()
    res = {"requests": len(rids), "prompt_lens": plens, "new_tokens": n_new,
           "steps": steps, "decode_steps": len(decode_ms),
           "launches": counts,
           "kv_cache_dtype": kind or "auto", "cache_bytes": cache_bytes(eng),
           "ragged_launches_per_decode_step":
               counts["ragged_decode_attention"] / len(decode_ms),
           "prefill_tok_s": st["prefill_tokens"] / st["prefill_s"],
           "decode_tok_s": st["decode_tokens"] / st["decode_s"],
           "decode_step_ms_median": decode_ms[len(decode_ms) // 2],
           "decode_step_ms_p80": decode_ms[int(0.8 * len(decode_ms))],
           "decode_step_ms_min": decode_ms[0],
           "wall_s": wall,
           "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9}
    prof = profile_decode(torch, eng, prompts) if profile else None
    del eng, params
    torch.cuda.empty_cache()
    return res, counts, prof


# ---------------------------------------------------------------------------
# (g) paged serve with prefix reuse: the paged path, through Engine
# ---------------------------------------------------------------------------

# phase (g)'s traffic: a system prompt that is not a whole number of pages
# (so every hit aliases its full pages and copies its boundary page), then
# requests of that prompt plus a tail, on 16 slots over a pool of 4
# full-length requests' worth of pages
G_SYSTEM, G_REQUESTS, G_NEW = 250, 15, 64
G_SLOTS, G_PAGES, G_PAGE = 16, 512, 16


def paged_traffic(torch, vocab):
    """Phase (g)'s system prompt, tail lengths and prompts, from seed 5."""
    gen = torch.Generator().manual_seed(5)
    system = torch.randint(0, vocab, (G_SYSTEM,), generator=gen).tolist()
    tails = torch.randint(32, 257, (G_REQUESTS,), generator=gen).tolist()
    prompts = [system + torch.randint(0, vocab, (n,), generator=gen).tolist()
               for n in tails]
    return system, tails, prompts


@contextlib.contextmanager
def page_ops(torch, check):
    """Count the engine's boundary-page copies, spills and restores made
    inside the block; with `check`, hold each one bitwise against the
    pool rows it read or wrote (one host sync each)."""
    import repro_torch.serve.engine as E
    real = {n: getattr(E, n)
            for n in ("copy_pages", "scatter_pages", "_spill_entry")}
    n = {"copies": 0, "copied_pages": 0, "spills": 0, "restores": 0}

    def same(a, b):                          # two gather_pages blobs
        return all(torch.equal(a[s][k], b[s][k].to(a[s][k].device))
                   for s in a for k in a[s])

    def copy_pages(caches, dst, src, *, page):
        out = real["copy_pages"](caches, dst, src, page=page)
        n["copies"] += 1
        n["copied_pages"] += len(dst)
        if check and not same(E.gather_pages(caches, dst, page=page),
                              E.gather_pages(caches, src, page=page)):
            raise AssertionError("a copied page differs from its source")
        return out

    def scatter_pages(caches, blob, pages, *, page):
        out = real["scatter_pages"](caches, blob, pages, page=page)
        n["restores"] += 1
        if check:
            rows = len(pages) * page     # pooled k/v: (n, rows, Hk, Dh)
            want = {s: {k: t[:, :rows] for k, t in leaves.items()}
                    for s, leaves in blob.items()}
            if not same(E.gather_pages(caches, pages, page=page), want):
                raise AssertionError("restored pages differ from the blob")
        return out

    def spill_entry(caches, page, entry):
        blob = real["_spill_entry"](caches, page, entry)
        n["spills"] += 1
        if check and not same(E.gather_pages(caches, entry.pages, page=page),
                              blob):
            raise AssertionError("a spilled blob differs from its pages")
        return blob
    E.copy_pages, E.scatter_pages, E._spill_entry = (copy_pages,
                                                     scatter_pages,
                                                     spill_entry)
    try:
        yield n
    finally:
        for name, fn in real.items():
            setattr(E, name, fn)


def serve_paged_bf16(torch, ops, profile=False, kind=None):
    """Phase (g); kind "int8" / "fp8" serves the same traffic from a
    quantized pool (g-quant)."""
    from repro_torch.models.transformer import init_params
    from repro_torch.serve.engine import Engine
    from repro_torch.serve.sampling import SamplingParams
    cfg = served_config()                              # bf16
    if kind is not None:
        cfg = cfg.replace(kv_cache_dtype=kind)
    params = init_params(cfg, seed=1, device=DEV)
    perturb_altup(torch, params, seed=11)
    eng = Engine(cfg, params, max_len=2048, n_slots=G_SLOTS, prefill_chunk=64,
                 paged=True, page_size=G_PAGE, n_pages=G_PAGES, device=DEV)
    system, tails, prompts = paged_traffic(torch, cfg.vocab_size)
    n_new = G_NEW
    # the warm request puts the system prompt in the prefix cache (and
    # warms cuBLAS and the allocator) outside the counted run
    eng.submit(system, sampling=SamplingParams(max_new=n_new))
    eng.run()
    eng.reset_stats()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    with page_ops(torch, check=False) as pops:
        ops.reset_launch_counts()            # counts start at 0 right here
        t_run = time.perf_counter()
        rids = [eng.submit(p, sampling=SamplingParams(max_new=n_new))
                for p in prompts]
        decode_ms, steps = [], 0
        while eng.has_work:
            pf0 = eng.stats["prefill_tokens"]
            t0 = time.perf_counter()
            eng.step()                       # ends in the ids' device->host
            dt = time.perf_counter() - t0
            steps += 1
            if eng.stats["prefill_tokens"] == pf0:
                decode_ms.append(1e3 * dt)
        wall = time.perf_counter() - t_run
        counts = ops.launch_counts()         # read right after the run
    out = eng.collect()
    if sorted(out) != sorted(rids):
        raise AssertionError(f"not every request completed: {sorted(out)}")
    for rid in rids:
        c = out[rid]
        if len(c.tokens) != n_new or c.finish_reason != "length" or \
                not all(0 <= t < cfg.vocab_size for t in c.tokens):
            raise AssertionError(f"request {rid}: {c.finish_reason}, "
                                 f"{len(c.tokens)} tokens")
    st, ps = eng.stats, eng.paged_stats
    hits = st["prefix_hits"]
    if hits < 1 or ps["alias_acquisitions"] <= 0:
        raise AssertionError(f"no prefix reuse: {st}, {ps}")
    # every hit aliases the system prompt's full pages and copies its
    # boundary page (the warm request aliased nothing)
    if ps["alias_acquisitions"] != hits * (G_SYSTEM // G_PAGE) or \
            pops["copies"] != hits or pops["copied_pages"] != hits:
        raise AssertionError(f"{hits} hits, {pops}, {ps}: not one boundary "
                             f"copy and {G_SYSTEM // G_PAGE} aliased pages "
                             f"each")
    if st["concurrency_peak"] <= 4 or ps["pages_in_use_peak"] > G_PAGES:
        raise AssertionError(f"pool not over-committed as expected: {st}, "
                             f"{ps}")
    n_layers = cfg.n_layers
    if counts["paged_ragged_decode_attention"] != n_layers * len(decode_ms) \
            or counts["ragged_decode_attention"] != 0 \
            or counts["altup_predict_correct"] != n_layers * steps:
        raise AssertionError(f"launch counts {counts} do not match {steps} "
                             f"steps, {len(decode_ms)} decode steps")
    decode_ms.sort()
    res = {"requests": len(rids), "system_prompt": len(system),
           "kv_cache_dtype": kind or "auto", "cache_bytes": cache_bytes(eng),
           "tails": tails, "new_tokens": n_new, "steps": steps,
           "decode_steps": len(decode_ms), "launches": counts,
           "paged_launches_per_decode_step":
               counts["paged_ragged_decode_attention"] / len(decode_ms),
           "prefix_hits": hits, "boundary_copies": pops["copies"],
           "prefill_tokens_saved": st["prefill_tokens_saved"],
           "concurrency_peak": st["concurrency_peak"],
           "prefill_tok_s": st["prefill_tokens"] / st["prefill_s"],
           "decode_tok_s": st["decode_tokens"] / st["decode_s"],
           "decode_step_ms_median": decode_ms[len(decode_ms) // 2],
           "decode_step_ms_p80": decode_ms[int(0.8 * len(decode_ms))],
           "decode_step_ms_min": decode_ms[0],
           "wall_s": wall, "paged_stats": ps,
           "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9}
    prof = profile_decode(torch, eng, prompts) if profile else None
    del eng, params
    torch.cuda.empty_cache()
    return res, counts, prof


def serve_spill_bf16(torch):
    """The host spill tier on the card. One slot over a 64-page pool (one
    max_len=1024 request's worth) serves requests of 508 tokens (a 500-
    token prefix, not a whole number of pages) and 16 new tokens, in
    order. Request x shares a's prefix. Served after a alone, x hits a's
    retained pages (alias + boundary copy); served after a and b, it hits
    a's blob, which b's admission spilled to the host, and restores it
    into fresh pages. The two x must give the same tokens, and every
    copy, spill and restore is held bitwise against the pool."""
    from repro_torch.models.transformer import init_params
    from repro_torch.serve.engine import Engine
    from repro_torch.serve.sampling import SamplingParams
    cfg = served_config()                              # bf16
    params = init_params(cfg, seed=1, device=DEV)
    perturb_altup(torch, params, seed=11)
    page, n_pages, n_new = 16, 64, 16
    gen = torch.Generator().manual_seed(6)

    def ids(n):
        return torch.randint(0, cfg.vocab_size, (n,), generator=gen).tolist()
    pre_a, pre_b = ids(500), ids(500)
    a, b, x = pre_a + ids(8), pre_b + ids(8), pre_a + ids(8)

    def serve(prompts):
        eng = Engine(cfg, params, max_len=1024, n_slots=1, prefill_chunk=64,
                     paged=True, page_size=page, n_pages=n_pages,
                     host_spill_pages=2 * n_pages, device=DEV)
        t0 = time.perf_counter()
        with page_ops(torch, check=True) as pops:
            rids = [eng.submit(p, sampling=SamplingParams(max_new=n_new))
                    for p in prompts]
            out = eng.run()
        wall = time.perf_counter() - t0
        toks = [out[r].tokens for r in rids]
        if any(len(t) != n_new for t in toks):
            raise AssertionError(f"a request fell short: {toks}")
        return {"tokens": toks, "stats": dict(eng.stats),
                "paged_stats": eng.paged_stats, "page_ops": pops,
                "wall_s": wall}
    resident = serve([a, x])
    spilled = serve([a, b, x])
    r, s = resident, spilled
    if r["stats"]["prefix_hits"] != 1 or r["page_ops"]["copies"] != 1 or \
            r["page_ops"]["spills"] or r["page_ops"]["restores"]:
        raise AssertionError(f"x did not hit a's resident pages: {r}")
    if s["stats"]["prefix_hits"] != 1 or s["page_ops"]["restores"] != 1 or \
            s["page_ops"]["spills"] < 1 or s["page_ops"]["copies"] or \
            s["paged_stats"]["spills"] < 1 or \
            s["paged_stats"]["restores"] != 1:
        raise AssertionError(f"x did not hit a's spilled blob: {s}")
    if r["tokens"][0] != s["tokens"][0] or r["tokens"][-1] != s["tokens"][-1]:
        raise AssertionError(f"restored prefix serves other tokens than the "
                             f"resident one: {r['tokens']} vs {s['tokens']}")
    del params
    torch.cuda.empty_cache()
    return {"prompt_lens": [len(a), len(b), len(x)], "prefix": len(pre_a),
            "page": page, "n_pages": n_pages, "new_tokens": n_new,
            "x_tokens_identical": True,
            "resident": {k: r[k] for k in ("page_ops", "paged_stats",
                                           "wall_s")},
            "spilled": {k: s[k] for k in ("page_ops", "paged_stats",
                                          "wall_s")}}


# ---------------------------------------------------------------------------
# (h) rwkv6-1.6b full-width f32 parity: WKV kernel path vs dense path
# ---------------------------------------------------------------------------

def rwkv_parity_f32(torch):
    from repro_torch.models.decode import decode_step, init_cache
    from repro_torch.models.transformer import forward, init_params
    torch.backends.cuda.matmul.allow_tf32 = False   # full f32 products
    torch.backends.cudnn.allow_tf32 = False
    cfg = rwkv_config(dtype="float32", param_dtype="float32")
    cfgs = {"k": cfg.replace(fused_decode_altup=None),
            "d": cfg.replace(fused_decode_altup=False)}
    wkv = {"k": None, "d": False}               # None: the kernel on CUDA
    params = init_params(cfg, seed=0, device=DEV)
    perturb_rwkv(torch, params, cfg, seed=20)
    B, S, n_dec = 2, 64, 16
    gen = torch.Generator(device=DEV).manual_seed(21)
    prompts = torch.randint(0, cfg.vocab_size, (B, S), generator=gen,
                            device=DEV)
    fwd = {s: forward(params, cfgs[s], prompts, wkv_kernel=wkv[s])
           [..., :cfg.vocab_size] for s in "kd"}
    torch.testing.assert_close(fwd["k"], fwd["d"], **PARITY_TOL)
    worst_fwd = max_err(torch, fwd["k"], fwd["d"])
    caches = {s: init_cache(cfgs[s], B, S + n_dec, device=DEV) for s in "kd"}
    worst = 0.0
    for t in range(S):                   # token-by-token prefill
        lg = {}
        for s in "kd":
            out, _ = decode_step(params, cfgs[s], caches[s],
                                 prompts[:, t:t + 1], t, wkv_kernel=wkv[s])
            lg[s] = out[:, 0, :cfg.vocab_size]
        torch.testing.assert_close(lg["k"], lg["d"], **PARITY_TOL)
        worst = max(worst, max_err(torch, lg["k"], lg["d"]))
    # the prefill's last logits are the forward's
    torch.testing.assert_close(lg["d"], fwd["d"][:, -1], **PARITY_TOL)
    tok = {s: lg[s].argmax(-1) for s in "kd"}
    streams = {s: [tok[s].tolist()] for s in "kd"}
    min_gap = math.inf
    for t in range(S, S + n_dec):
        for s in "kd":
            out, _ = decode_step(params, cfgs[s], caches[s], tok[s][:, None],
                                 t, wkv_kernel=wkv[s])
            lg[s] = out[:, 0, :cfg.vocab_size]
        torch.testing.assert_close(lg["k"], lg["d"], **PARITY_TOL)
        worst = max(worst, max_err(torch, lg["k"], lg["d"]))
        top2 = lg["d"].topk(2, dim=-1).values
        min_gap = min(min_gap, float((top2[:, 0] - top2[:, 1]).min()))
        for s in "kd":
            tok[s] = lg[s].argmax(-1)
            streams[s].append(tok[s].tolist())
    if streams["k"] != streams["d"]:
        raise AssertionError(f"greedy tokens differ between the WKV kernel "
                             f"path and the dense path: {streams}")
    state_err = max_err(torch, caches["k"]["seg0"]["wkv"],
                        caches["d"]["seg0"]["wkv"])
    del params, caches
    torch.cuda.empty_cache()
    return {"prompts": B, "prompt_len": S, "decode_steps": n_dec,
            "forward_max_abs_logit_err": worst_fwd,
            "decode_max_abs_logit_err": worst,
            "final_wkv_state_max_abs_err": state_err, "tol": PARITY_TOL,
            "greedy_tokens_identical": True,
            "tokens_checked": B * (n_dec + 1),
            "min_top2_gap_dense": min_gap,
            "tf32": [torch.backends.cuda.matmul.allow_tf32,
                     torch.backends.cudnn.allow_tf32]}


# ---------------------------------------------------------------------------
# (i) rwkv6-1.6b bf16 serve with prefix reuse, through Engine
# ---------------------------------------------------------------------------

# phase (i)'s traffic: a donor of a 64-token prefix (max_new=1, so it stops
# at the prefix boundary, the recurrent validity rule), then 7 requests in
# one batch: the prefix plus 32 tokens, and 6 prompts of their own
I_PREFIX, I_EXTEND, I_NEW = 64, 32, 32
I_PROMPTS = (32, 128, 160, 192, 224, 256)
I_SLOTS, I_MAX_LEN = 8, 512


def rwkv_traffic(torch, vocab):
    """Phase (i)'s donor prompt and its batch (the extender first), from
    seed 9."""
    gen = torch.Generator().manual_seed(9)

    def ids(n):
        return torch.randint(0, vocab, (n,), generator=gen).tolist()
    donor = ids(I_PREFIX)
    batch = [donor + ids(I_EXTEND)] + [ids(n) for n in I_PROMPTS]
    return donor, batch


def serve_rwkv_bf16(torch, ops, profile=False):
    from repro_torch.models.transformer import init_params
    from repro_torch.serve.engine import Engine
    from repro_torch.serve.sampling import SamplingParams
    cfg = rwkv_config()                                # bf16
    params = init_params(cfg, seed=1, device=DEV)
    perturb_rwkv(torch, params, cfg, seed=22)
    donor, batch = rwkv_traffic(torch, cfg.vocab_size)

    def engine(**kw):
        return Engine(cfg, params, max_len=I_MAX_LEN, n_slots=I_SLOTS,
                      device=DEV, **kw)
    eng = engine()
    # warm-up request (cuBLAS handles, allocator) outside the counted run
    eng.submit(batch[1][:8], sampling=SamplingParams(max_new=4))
    eng.run()
    eng.reset_stats()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()     # the peak of this run only
    ops.reset_launch_counts()                # counts start at 0 right here
    t_run = time.perf_counter()
    decode_ms, steps = [], 0

    def drive():
        nonlocal steps
        while eng.has_work:
            pf0 = eng.stats["prefill_tokens"]
            t0 = time.perf_counter()
            eng.step()                       # ends in the ids' device->host
            dt = time.perf_counter() - t0
            steps += 1
            if eng.stats["prefill_tokens"] == pf0:
                decode_ms.append(1e3 * dt)
    r_donor = eng.submit(donor, sampling=SamplingParams(max_new=1))
    drive()                                  # the donor retires at depth 64
    rids = [eng.submit(p, sampling=SamplingParams(max_new=I_NEW))
            for p in batch]
    drive()
    wall = time.perf_counter() - t_run
    counts = ops.launch_counts()             # read right after the run
    out = eng.collect()
    if sorted(out) != sorted([r_donor] + rids):
        raise AssertionError(f"not every request completed: {sorted(out)}")
    for rid in rids:
        c = out[rid]
        if len(c.tokens) != I_NEW or c.finish_reason != "length" or \
                not all(0 <= t < cfg.vocab_size for t in c.tokens):
            raise AssertionError(f"request {rid}: {c.finish_reason}, "
                                 f"{len(c.tokens)} tokens")
    st = dict(eng.stats)
    if st["prefix_hits"] != 1 or st["prefill_tokens_saved"] != I_PREFIX:
        raise AssertionError(f"not one prefix hit at the donor's depth: "
                             f"{st}")
    n_layers = cfg.n_layers
    if counts["rwkv6_wkv"] != n_layers * steps or \
            counts["altup_predict_correct"] <= 0 or \
            counts["ragged_decode_attention"] != 0 or \
            counts["paged_ragged_decode_attention"] != 0:
        raise AssertionError(f"launch counts {counts} do not match "
                             f"{steps} steps of {n_layers} layers")
    hit_tokens = list(out[rids[0]].tokens)
    decode_ms.sort()
    res = {"requests": 1 + len(rids), "donor_prompt": len(donor),
           "prompt_lens": [len(p) for p in batch], "new_tokens": I_NEW,
           "steps": steps, "decode_steps": len(decode_ms),
           "launches": counts,
           "wkv_launches_per_step": counts["rwkv6_wkv"] / steps,
           "prefix_hits": st["prefix_hits"],
           "prefill_tokens_saved": st["prefill_tokens_saved"],
           "prefill_tok_s": st["prefill_tokens"] / st["prefill_s"],
           "decode_tok_s": st["decode_tokens"] / st["decode_s"],
           "decode_step_ms_median": decode_ms[len(decode_ms) // 2],
           "decode_step_ms_p80": decode_ms[int(0.8 * len(decode_ms))],
           "decode_step_ms_min": decode_ms[0],
           "wall_s": wall,
           "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9}
    prof = profile_decode(torch, eng, batch[1:]) if profile else None
    del eng
    # the extender served cold, alone, on an engine of the same shape
    cold = engine(prefix_cache=False)
    rid = cold.submit(batch[0], sampling=SamplingParams(max_new=I_NEW))
    cold_tokens = list(cold.run()[rid].tokens)
    if cold_tokens != hit_tokens:
        raise AssertionError(f"the prefix hit serves other tokens than a "
                             f"cold engine: {hit_tokens} vs {cold_tokens}")
    res["hit_tokens_equal_cold"] = True
    del cold, params
    torch.cuda.empty_cache()
    return res, counts, prof


def _device_kernels(prof):
    """key_averages() entries of the kernels run on the card (the CPU-side
    ops that launched them carry the same time again, so only these are
    summed)."""
    from torch.autograd import DeviceType
    return [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]


def device_ms(torch, fn, name_part=None, iters=50, per_call=None):
    """Device time per call of fn(): the summed time of the kernels it ran
    (only those whose name holds `name_part`, if given), from
    torch.profiler over `iters` calls. Free of the host time between
    launches, which CUDA events around a loop of calls would include.
    Now and then a profiler session on the card records no device
    activity at all (once in the ~110 sessions of one run), or only part
    of it; such a session is run again, three sessions at most. per_call:
    how many kernels matching name_part one call launches, so that a
    partial session can be told (None: any number)."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        hits = [e for e in _device_kernels(prof)
                if name_part is None or name_part in e.key]
        n = sum(e.count for e in hits)
        if n and (per_call is None or n == per_call * iters):
            break
    else:
        raise AssertionError(f"kernels {name_part!r}: {n} in the profile, "
                             f"want {per_call} x {iters}")
    return sum(e.self_device_time_total for e in hits) / 1e3 / iters


def profile_decode(torch, eng, prompts, n_steps=8):
    """Device busy share of pure decode steps at the served shapes: the
    phase's own prompts, prefilled, then `n_steps` decode steps under
    torch.profiler."""
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.serve.sampling import SamplingParams
    for p in prompts:
        eng.submit(p, sampling=SamplingParams(max_new=n_steps + 4))
    while True:                              # through the prefill steps
        pf0 = eng.stats["prefill_tokens"]
        eng.step()
        if eng.stats["prefill_tokens"] == pf0:
            break
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(n_steps):
            eng.step()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    eng.run()
    kern = sorted(_device_kernels(prof),
                  key=lambda e: -e.self_device_time_total)
    dev_us = sum(e.self_device_time_total for e in kern)
    return {"steps": n_steps, "wall_ms_per_step": 1e3 * wall / n_steps,
            "device_ms_per_step": dev_us / 1e3 / n_steps,
            "device_busy_share": (dev_us / 1e6) / wall,
            "kernels_per_step": sum(e.count for e in kern) / n_steps,
            "top_kernels": [[e.key[:70], e.count / n_steps,
                             e.self_device_time_total / 1e3 / n_steps]
                            for e in kern[:10]],
            # the port's own kernels, each with its launches and device ms
            # per step and its share of the step's device time
            "port_kernels": [[e.key[:70], e.count / n_steps,
                              e.self_device_time_total / 1e3 / n_steps,
                              e.self_device_time_total / dev_us]
                             for e in kern if "repro_torch::" in e.key]}


def main(argv) -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1
    if not PKG.is_dir():
        print(f"chip_smoke: {PKG} not found; run from a checkout of the "
              f"repository", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    profile = "--profile" in argv

    # (a) device
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60).stdout
    print(smi.strip().splitlines()[0], flush=True)
    kind = torch.cuda.get_device_name(0)
    line("a-device", kind=kind, count=torch.cuda.device_count(),
         torch=torch.__version__, cuda=torch.version.cuda,
         capability=list(torch.cuda.get_device_capability(0)))

    # (b) build, one nvcc per source, all started together
    from repro_torch.kernels import build, ops, ref
    t0 = time.perf_counter()
    info = build.build()
    ptxas = {n: [ln.split("ptxas info    : ")[-1] for ln in i["log"].splitlines()
                 if "registers" in ln or "spill" in ln]
             for n, i in info.items()}
    line("b-build", seconds=time.perf_counter() - t0,
         per_source={n: i["seconds"] for n, i in info.items()}, ptxas=ptxas)

    # (c) kernels vs their plain versions, f32 products in full precision
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    altup = {}
    for dtype in (torch.bfloat16, torch.float32):
        # tokens per step: decode and prefill steps of (e) (8 slots, chunk
        # 64) and of (g) (16 slots), and a chunk of 8
        for T in (8, 16, 64, 512, 1024):
            r = check_altup(torch, ops, ref, dtype, T)
            altup[(r["dtype"], T)] = r
            line("c-altup", **r)
    # attention: the depths of a decode step halfway through (e), read
    # through the engine's kv-len bucket, then a spread of depths from
    # empty to full
    from repro_torch.serve.engine import kv_bucket
    e_lens = [n + E_NEW // 2 for n in E_PROMPTS]
    spread = [0, 2048, 1, 517, 1024, 77, 1999, 300]
    ragged = {}
    for dtype in (torch.bfloat16, torch.float32):
        for case, lens_host in (("e", e_lens), ("spread", spread)):
            r = check_ragged(torch, ops, ref, dtype, lens_host,
                             T=kv_bucket(max(lens_host), 32, 2048))
            ragged[(r["dtype"], case)] = r
            line("c-ragged", case=case, **r)
    # paged: the spread through a full pool of 1024 pages, then a step of
    # (g) halfway through: slot 0 idle (a zero table row), 15 slots that
    # share the system prompt's full pages, each its own after them
    _, tails, _ = paged_traffic(torch, served_config().vocab_size)
    g_lens = [0] + [G_SYSTEM + t + G_NEW // 2 for t in tails]
    g_reserve = [0] + [pages_for(G_SYSTEM + t + G_NEW, G_PAGE)
                       for t in tails]
    paged = {}
    for dtype in (torch.bfloat16, torch.float32):
        for case, kw in (
                ("g", dict(lens_host=g_lens, reserve=g_reserve,
                           n_shared=G_SYSTEM // G_PAGE, n_pages=G_PAGES,
                           t_max=kv_bucket(max(g_lens), 32, 2048))),
                ("spread", dict(lens_host=spread, reserve=[2048 // 16] * 8,
                                n_pages=1024))):
            r = check_paged(torch, ops, ref, dtype, **kw)
            paged[(r["dtype"], case)] = r
            line("c-paged", case=case, **r)
    # the fused dequant, both entry points, at the same shapes: (e)'s
    # halfway depths and the spread for the contiguous kernel, (g)'s
    # halfway step and the spread for the paged one, int8 and fp8 codes
    # with bf16 and f32 queries; then float k/v stored in bf16 under f32
    # queries (a float storage mode other than the activations'), untimed
    ragged_q, paged_q = {}, {}
    for dtype in (torch.bfloat16, torch.float32):
        for store in ("int8", "fp8"):
            for case, lens_host in (("e", e_lens), ("spread", spread)):
                r = check_ragged(torch, ops, ref, dtype, lens_host,
                                 T=kv_bucket(max(lens_host), 32, 2048),
                                 store=store)
                ragged_q[(r["dtype"], case, store)] = r
                line("c-ragged-quant", case=case, **r)
    line("c-ragged-quant", case="spread-bf16-kv",
         **check_ragged(torch, ops, ref, torch.float32, spread,
                        store="bf16", timed=False))
    line("c-ragged-quant", case="all-codes", **check_all_codes(torch, ops))
    for dtype in (torch.bfloat16, torch.float32):
        for store in ("int8", "fp8"):
            for case, kw in (
                    ("g", dict(lens_host=g_lens, reserve=g_reserve,
                               n_shared=G_SYSTEM // G_PAGE, n_pages=G_PAGES,
                               t_max=kv_bucket(max(g_lens), 32, 2048))),
                    ("spread", dict(lens_host=spread,
                                    reserve=[2048 // 16] * 8,
                                    n_pages=1024))):
                r = check_paged(torch, ops, ref, dtype, store=store, **kw)
                paged_q[(r["dtype"], case, store)] = r
                line("c-paged-quant", case=case, **r)
    # split-K: the head shapes the split kernels were widened for; one
    # paged slot of 40960 rows
    for tag, case, r in check_shapes(torch, ops, ref):
        line(tag, case=case, **r)
    for r in check_long_slot(torch, ops, ref):
        line("c-paged-long", **r)

    # WKV: (i)'s decode step (8 slots, 32 heads of 64, the state in
    # place), (h)'s forward (no state, 512 steps), an odd length with a
    # state, and the zero state against none
    wkv = {}
    for dtype in (torch.bfloat16, torch.float32):
        for case, kw in (("i-decode", dict(B=8, H=32, Dh=64, S=1,
                                           state="random")),
                         ("h-forward", dict(B=4, H=32, Dh=64, S=512,
                                            state=None)),
                         ("odd", dict(B=3, H=5, Dh=16, S=77,
                                      state="random"))):
            r = check_wkv(torch, ops, ref, dtype, **kw)
            wkv[(r["dtype"], case)] = r
            line("c-wkv", case=case, **r)
        line("c-wkv", case="zero-state",
             **check_wkv_zero_state(torch, ops, dtype))

    # flash attention through ops.mha_flash / mha_flash_paged: the timed
    # full-width cases, the edge shapes, the skip ratio, then the paged
    # entry point over a permuted pool with garbage, bitwise vs contiguous
    flash = {}
    for dtype in (torch.bfloat16, torch.float32):
        for case, kw in FLASH_CASES:
            if kw["dh"] > 128 and dtype == torch.float32:
                continue
            # case 1 in bf16 is the slice's path, counted from 0
            main = case == "prefill" and dtype == torch.bfloat16
            r = check_flash(torch, ops, ref, dtype, counted=main, **kw)
            flash[(r["dtype"], case)] = r
            line("c-flash", case=case, **r)
        for case, kw in FLASH_ODD:
            line("c-flash", case=case,
                 **check_flash(torch, ops, ref, dtype, timed=False, **kw))
        line("c-flash", case="skip-ratio",
             **flash_skip_ratio(torch, ops, dtype))
    flash_paged = {}
    for dtype in (torch.bfloat16, torch.float32):
        for case, kw in (("causal", {}), ("window-256", dict(window=256)),
                         ("int8", dict(quant="int8"))):
            if kw.get("quant") and dtype == torch.float32:
                continue
            main = case == "causal" and dtype == torch.bfloat16
            r = check_flash_paged(torch, ops, ref, dtype, counted=main, **kw)
            flash_paged[(r["dtype"], case)] = r
            line("c-flash-paged", case=case, **r)
    main_flash = flash[("bfloat16", "prefill")]
    main_flash_paged = flash_paged[("bfloat16", "causal")]
    torch.cuda.empty_cache()

    # (d) full-width f32 parity of the two paths, then of the fused
    # dequant against the dense dequant path, int8 and fp8
    line("d-parity", **parity_f32(torch))
    for store in ("int8", "fp8"):
        line("d-quant", **parity_f32(torch, store))

    # (e) the main path: bf16 serving through Engine, then from int8
    # caches (e-quant)
    res, counts, prof = serve_bf16(torch, ops, profile=profile)
    line("e-serve", **res)
    if prof is not None:
        line("f-profile", **prof)
    res_eq, counts_eq, prof_eq = serve_bf16(torch, ops, profile=profile,
                                            kind="int8")
    res_eq["cache_bytes_over_e"] = res_eq["cache_bytes"] / res["cache_bytes"]
    line("e-quant", **res_eq)
    if prof_eq is not None:
        line("f-profile-quant", **prof_eq)

    # (g) the paged path: bf16 serving from a page pool with prefix reuse
    res_g, counts_g, prof_g = serve_paged_bf16(torch, ops, profile=profile)
    line("g-paged-serve", **res_g)
    if prof_g is not None:
        line("f-profile-paged", **prof_g)
    line("g-spill", **serve_spill_bf16(torch))
    # (g-quant) the paged path from an fp8 pool
    res_gq, counts_gq, _ = serve_paged_bf16(torch, ops, kind="fp8")
    res_gq["cache_bytes_over_g"] = res_gq["cache_bytes"] / res_g["cache_bytes"]
    line("g-quant", **res_gq)

    # (h) rwkv6-1.6b: full-width f32 parity of the WKV kernel path
    line("h-parity", **rwkv_parity_f32(torch))

    # (i) rwkv6-1.6b: bf16 serving through Engine with prefix reuse
    res_i, counts_i, prof_i = serve_rwkv_bf16(torch, ops, profile=profile)
    line("i-rwkv-serve", **res_i)
    if prof_i is not None:
        line("f-profile-rwkv", **prof_i)

    # each kernel at the shape of the run its launches are counted in
    main_altup = altup[("bfloat16", 8)]      # (e)'s decode step
    main_ragged = ragged[("bfloat16", "e")]
    main_paged = paged[("bfloat16", "g")]
    main_wkv = wkv[("bfloat16", "i-decode")]
    main_ragged_q = ragged_q[("bfloat16", "e", "int8")]    # e-quant's
    main_paged_q = paged_q[("bfloat16", "g", "fp8")]       # g-quant's
    keys = ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
            "library_ms")
    kernels = [
        {"name": "altup_predict_correct", "route": "cuda",
         "source": "src/repro_torch/csrc/altup_fused.cu",
         "replaces": "src/repro/kernels/altup_fused.py:39",
         "launches": counts["altup_predict_correct"],
         **{k: main_altup[k] for k in keys}},
        {"name": "ragged_decode_attention", "route": "cuda",
         "source": "src/repro_torch/csrc/ragged_decode_attention.cu",
         "replaces": "src/repro/kernels/ragged_decode_attention.py:210",
         "launches": counts["ragged_decode_attention"],
         **{k: main_ragged[k] for k in keys}},
        {"name": "paged_ragged_decode_attention", "route": "cuda",
         "source": "src/repro_torch/csrc/ragged_decode_attention.cu",
         "replaces": "src/repro/kernels/ragged_decode_attention.py:122",
         "launches": counts_g["paged_ragged_decode_attention"],
         **{k: main_paged[k] for k in keys}},
        {"name": "ragged_decode_attention_quant", "route": "cuda",
         "source": "src/repro_torch/csrc/ragged_decode_attention.cu",
         "replaces": "src/repro/kernels/ragged_decode_attention.py:210",
         "launches": counts_eq["ragged_decode_attention"],
         **{k: main_ragged_q[k] for k in keys}},
        {"name": "paged_ragged_decode_attention_quant", "route": "cuda",
         "source": "src/repro_torch/csrc/ragged_decode_attention.cu",
         "replaces": "src/repro/kernels/ragged_decode_attention.py:122",
         "launches": counts_gq["paged_ragged_decode_attention"],
         **{k: main_paged_q[k] for k in keys}},
        {"name": "rwkv6_wkv", "route": "cuda",
         "source": "src/repro_torch/csrc/rwkv6_wkv.cu",
         "replaces": "src/repro/kernels/rwkv6_scan.py:53",
         "launches": counts_i["rwkv6_wkv"],
         **{k: main_wkv[k] for k in keys}},
        {"name": "flash_attention", "route": "cuda",
         "source": "src/repro_torch/csrc/flash_attention.cu",
         "replaces": "src/repro/kernels/flash_attention.py:120",
         "launches": main_flash["launches"],
         **{k: main_flash[k] for k in keys}},
        {"name": "flash_attention_paged", "route": "cuda",
         "source": "src/repro_torch/csrc/flash_attention.cu",
         "replaces": "src/repro/kernels/flash_attention.py:120",
         "launches": main_flash_paged["launches"],
         **{k: main_flash_paged[k] for k in keys}},
    ]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
