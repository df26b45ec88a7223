#!/usr/bin/env python3
"""Smoke run of the PyTorch port (`src/repro_torch`) on one CUDA card.

    python3 chip_smoke.py            # from the root of a checkout
    python3 chip_smoke.py --profile  # adds a torch.profiler phase (f)

Written for the NVIDIA H100: it builds the port's CUDA kernels from
`src/repro_torch/csrc/` with nvcc (sm_90a), holds each kernel against its
plain PyTorch version on the card, checks full-width f32 logits and greedy
tokens between the kernel path and the dense path, then serves greedy
requests through `Engine` in bf16 on the served model, Qwen3-0.6B wrapped
with AltUp K=2 (recycled), at its full width and depth, with seeded random
weights. Phases:

  (a) device   card name and power limit, as nvidia-smi gives them
  (b) build    nvcc build of every kernel, seconds and ptxas report
  (c) kernels  each kernel vs its plain version at the served shapes:
               max error; device ms per call (torch.profiler) of the
               kernel, its plain version and the library yardstick; the
               wrapper's ms per call (CUDA events); the bytes bound
  (d) parity   full-width f32 decode_step logits, kernels vs dense path,
               over a chunked prefill and 16 greedy steps for 4 slots
  (e) serve    8 greedy bf16 requests (prompts of 32-512 tokens, 64 new
               tokens each) through Engine(n_slots=8, max_len=2048); the
               kernels' launch counts of that run show the path used them
  (f) profile  (--profile only) device busy share of pure decode steps

Every phase prints one line; any failure raises and exits non-zero. The
second-to-last line is the per-kernel JSON record; the last line is
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
It exits 1 without printing a result when no CUDA device is present, and
fails when the repository's `src/repro_torch` is not beside it.
"""
from __future__ import annotations

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


# NVIDIA H100 SXM data sheet (dense rates, 700 W)
HBM_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = {"float32": 67e12, "bfloat16": 989e12}

F32_TOL = dict(atol=2e-5, rtol=2e-5)     # kernel vs plain, f32 in and out
BF16_TOL = dict(atol=2e-2, rtol=2e-2)    # outputs rounded to bf16 (1 ulp)
PARITY_TOL = dict(atol=1e-3, rtol=1e-3)  # 28-layer f32 logits, two paths


def line(tag, **vals):
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


def check_ragged(torch, ops, ref, dtype, B=8, Hk=8, rep=2, Dh=128, T=2048,
                 seed=1):
    import torch.nn.functional as F
    gen = torch.Generator(device=DEV).manual_seed(seed)
    H = Hk * rep
    q = torch.randn(B, 1, H, Dh, generator=gen, device=DEV).to(dtype)
    k = torch.randn(B, T, Hk, Dh, generator=gen, device=DEV).to(dtype)
    v = torch.randn(B, T, Hk, Dh, generator=gen, device=DEV).to(dtype)
    lens_host = [0, T, 1, 517, 1024, 77, T - 49, 300][:B]
    lens = torch.tensor(lens_host, dtype=torch.int32, device=DEV)
    qg = q[:, 0].reshape(B, Hk, rep, Dh)

    def launch():
        return ops.ragged_decode_attn(q, k, v, lens)

    def plain():
        return ref.ragged_decode_ref(qg, k, v, lens)
    got, want = launch(), plain().reshape(B, 1, H, Dh)
    torch.cuda.synchronize()
    tol = F32_TOL if dtype == torch.float32 else BF16_TOL
    torch.testing.assert_close(got, want, **tol)
    if not bool((got[0] == 0).all()):
        raise AssertionError("empty slot (length 0) is not exact zeros")
    name = "float32" if dtype == torch.float32 else "bfloat16"
    esz = q.element_size()
    rows = sum(lens_host)
    nbytes = rows * Hk * Dh * 2 * esz + 2 * B * H * Dh * esz + 4 * B
    nops = rows * Hk * rep * Dh * 4
    b_ms, b_by = bound_ms(nbytes, nops, name)
    # library yardstick: one SDPA call on the same masked GQA problem,
    # timed here only (the port never calls it)
    qs = q.permute(0, 2, 1, 3)                        # (B, H, 1, Dh)
    ks, vs = k.permute(0, 2, 1, 3), v.permute(0, 2, 1, 3)
    mask = (torch.arange(T, device=DEV)[None, :] < lens[:, None])
    mask = mask[:, None, None, :]

    def library():
        return F.scaled_dot_product_attention(qs, ks, vs, attn_mask=mask,
                                              enable_gqa=True)
    lib = library()
    lib_err = max_err(torch, lib[1:].permute(0, 2, 1, 3), want[1:])
    return {"dtype": name, "B": B, "Hk": Hk, "rep": rep, "Dh": Dh, "T": T,
            "lengths": lens_host,
            "max_abs_err": max_err(torch, got, want),
            "ms": device_ms(torch, launch, "ragged_decode_kernel"),
            "plain_ms": device_ms(torch, plain),
            "wrapper_ms": time_ms(torch, launch),
            "bound_ms": b_ms, "bound_by": b_by,
            "library_ms": device_ms(torch, library),
            "library_max_abs_err_nonempty": lib_err,
            "bytes": nbytes, "tol": tol}


# ---------------------------------------------------------------------------
# (d) full-width f32 parity, kernel path vs dense path
# ---------------------------------------------------------------------------

def parity_f32(torch):
    from repro_torch.models.decode import decode_step, init_cache
    from repro_torch.models.transformer import init_params
    from repro_torch.serve.engine import kv_bucket
    torch.backends.cuda.matmul.allow_tf32 = False   # full f32 products
    torch.backends.cudnn.allow_tf32 = False
    cfg = served_config(dtype="float32", param_dtype="float32")
    cfg_k = cfg.replace(ragged_decode_attn=None, fused_decode_altup=None)
    cfg_d = cfg.replace(ragged_decode_attn=False, fused_decode_altup=False)
    params = init_params(cfg, seed=0, device=DEV)
    perturb_altup(torch, params, seed=10)
    B, T, C, n_dec = 4, 1024, 64, 16
    gen = torch.Generator(device=DEV).manual_seed(2)
    plens = [37, 180, 5, 300]
    prompts = [torch.randint(0, cfg.vocab_size, (n,), generator=gen,
                             device=DEV) for n in plens]
    caches = {"k": init_cache(cfg_k, B, T, device=DEV),
              "d": init_cache(cfg_d, B, T, device=DEV)}
    cfgs = {"k": cfg_k, "d": cfg_d}
    pos = [0] * B
    worst = 0.0
    last = {}
    # chunked prefill: every slot feeds up to C prompt tokens per step
    while any(pos[b] < plens[b] for b in range(B)):
        toks = torch.zeros(B, C, dtype=torch.long, device=DEV)
        nval = [min(C, plens[b] - pos[b]) for b in range(B)]
        for b in range(B):
            toks[b, :nval[b]] = prompts[b][pos[b]:pos[b] + nval[b]]
        kv_len = kv_bucket(max(p + n for p, n in zip(pos, nval)), 32, T)
        out = {}
        for side in ("k", "d"):
            out[side], _ = decode_step(
                params, cfgs[side], caches[side], toks,
                torch.tensor(pos, device=DEV),
                n_valid=torch.tensor(nval, device=DEV), kv_len=kv_len)
        for b in range(B):
            if nval[b]:
                rows_k = out["k"][b, :nval[b], :cfg.vocab_size]
                rows_d = out["d"][b, :nval[b], :cfg.vocab_size]
                torch.testing.assert_close(rows_k, rows_d, **PARITY_TOL)
                worst = max(worst, max_err(torch, rows_k, rows_d))
                if pos[b] + nval[b] == plens[b]:
                    last[b] = (rows_k[-1], rows_d[-1])
        pos = [p + n for p, n in zip(pos, nval)]
    tok = {s: torch.stack([last[b][i].argmax() for b in range(B)])
           for i, s in enumerate(("k", "d"))}
    streams = {"k": [tok["k"].tolist()], "d": [tok["d"].tolist()]}
    min_gap = math.inf
    for _ in range(n_dec):
        kv_len = kv_bucket(max(pos) + 1, 32, T)
        logits = {}
        for side in ("k", "d"):
            logits[side], _ = decode_step(
                params, cfgs[side], caches[side], tok[side][:, None],
                torch.tensor(pos, device=DEV), kv_len=kv_len)
        lk = logits["k"][:, 0, :cfg.vocab_size]
        ld = logits["d"][:, 0, :cfg.vocab_size]
        torch.testing.assert_close(lk, ld, **PARITY_TOL)
        worst = max(worst, max_err(torch, lk, ld))
        top2 = ld.topk(2, dim=-1).values
        min_gap = min(min_gap, float((top2[:, 0] - top2[:, 1]).min()))
        for side, lg in (("k", lk), ("d", ld)):
            tok[side] = lg.argmax(dim=-1)
            streams[side].append(tok[side].tolist())
        pos = [p + 1 for p in pos]
    if streams["k"] != streams["d"]:
        raise AssertionError(f"greedy tokens differ between the kernel and "
                             f"dense paths: {streams}")
    del params, caches
    torch.cuda.empty_cache()
    return {"slots": B, "prompt_lens": plens, "decode_steps": n_dec,
            "max_abs_logit_err": worst, "tol": PARITY_TOL,
            "greedy_tokens_identical": True,
            "tokens_checked": B * (n_dec + 1),
            "min_top2_gap_dense": min_gap,
            "tf32": [torch.backends.cuda.matmul.allow_tf32,
                     torch.backends.cudnn.allow_tf32]}


# ---------------------------------------------------------------------------
# (e) serve: the main path, through the entry points a user calls
# ---------------------------------------------------------------------------

def serve_bf16(torch, ops, profile=False):
    from repro_torch.models.transformer import init_params
    from repro_torch.serve.engine import Engine
    from repro_torch.serve.sampling import SamplingParams
    cfg = served_config()                              # bf16
    params = init_params(cfg, seed=1, device=DEV)
    perturb_altup(torch, params, seed=11)
    eng = Engine(cfg, params, max_len=2048, n_slots=8, prefill_chunk=64,
                 device=DEV)
    gen = torch.Generator().manual_seed(3)
    plens = [32, 96, 160, 224, 288, 352, 416, 512]
    prompts = [torch.randint(0, cfg.vocab_size, (n,), generator=gen).tolist()
               for n in plens]
    n_new = 64
    # warm-up request (cuBLAS handles, allocator) outside the counted run
    eng.submit(prompts[0][:16], sampling=SamplingParams(max_new=4))
    eng.run()
    eng.reset_stats()
    torch.cuda.synchronize()
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
            counts["ragged_decode_attention"] != n_layers * len(decode_ms):
        raise AssertionError(f"launch counts {counts} do not match {steps} "
                             f"steps, {len(decode_ms)} decode steps")
    st = eng.stats
    decode_ms.sort()
    res = {"requests": len(rids), "prompt_lens": plens, "new_tokens": n_new,
           "steps": steps, "decode_steps": len(decode_ms),
           "launches": counts,
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


def _device_kernels(prof):
    """key_averages() entries of the kernels run on the card (the CPU-side
    ops that launched them carry the same time again, so only these are
    summed)."""
    from torch.autograd import DeviceType
    return [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]


def device_ms(torch, fn, name_part=None, iters=50):
    """Device time per call of fn(): the summed time of the kernels it ran
    (only those whose name holds `name_part`, if given), from
    torch.profiler over `iters` calls. Free of the host time between
    launches, which CUDA events around a loop of calls would include."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    hits = [e for e in _device_kernels(prof)
            if name_part is None or name_part in e.key]
    if not hits:
        raise AssertionError(f"no kernel {name_part!r} in the profile")
    return sum(e.self_device_time_total for e in hits) / 1e3 / iters


def profile_decode(torch, eng, prompts, n_steps=8):
    """Device busy share of pure decode steps at the served shapes: the
    same 8 prompts, prefilled, then `n_steps` decode steps under
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
                            for e in kern[:10]]}


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
        for T in (8, 64, 512):   # decode; chunk 8 and 64 x 8 slots
            r = check_altup(torch, ops, ref, dtype, T)
            altup[(r["dtype"], T)] = r
            line("c-altup", **r)
    ragged = {}
    for dtype in (torch.bfloat16, torch.float32):
        r = check_ragged(torch, ops, ref, dtype)
        ragged[r["dtype"]] = r
        line("c-ragged", **r)

    # (d) full-width f32 parity of the two paths
    line("d-parity", **parity_f32(torch))

    # (e) the main path: bf16 serving through Engine
    res, counts, prof = serve_bf16(torch, ops, profile=profile)
    line("e-serve", **res)
    if prof is not None:
        line("f-profile", **prof)

    main_altup = altup[("bfloat16", 8)]      # the decode-step shape
    main_ragged = ragged["bfloat16"]
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
    ]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
