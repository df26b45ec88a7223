"""Serving example of the PyTorch port: continuous batching of an AltUp
model with slot-based KV caches — SamplingParams per request, typed
Completion results (finish_reason / logprobs / timing), token-level
streaming — through contiguous slot caches and a paged pool, plus the
paper's serving story: the widened stream adds ZERO KV-cache bytes because
caches are built from the active d-wide block only (examples/serve_altup.py
on the JAX package).

  PYTHONPATH=src python examples/serve_altup_torch.py            # the card
  PYTHONPATH=src python examples/serve_altup_torch.py --device cpu
"""
import argparse
import time

import numpy as np
import torch

from repro_torch.config import AltUpConfig, ModelConfig
from repro_torch.models.decode import init_cache
from repro_torch.models.transformer import init_params
from repro_torch.roofline.analysis import decode_kv_bytes
from repro_torch.serve.engine import Engine
from repro_torch.serve.sampling import SamplingParams

MAX_LEN = 64


def _continuous(cfg, params, device, **kw):
    """6 staggered requests through 2 slots: mixed greedy / sampled,
    budgets, seeds and one logprobs request, sampled on the device in the
    fused step. Returns ({rid: Completion}, {rid: prompt_len}, seconds)."""
    eng = Engine(cfg, params, max_len=MAX_LEN, n_slots=2, device=device,
                 **kw)
    rids = {}
    for i in range(6):
        plen = 4 + 3 * i
        prompt = np.random.default_rng(i).integers(0, cfg.vocab_size, plen)
        sp = SamplingParams(max_new=4 + 2 * i,
                            temperature=0.0 if i % 2 == 0 else 0.8,
                            top_k=64, seed=i, logprobs=(i == 0))
        rids[eng.submit(prompt.tolist(), sampling=sp)] = plen
        eng.step()                       # requests arrive mid-flight
    t0 = time.perf_counter()
    out = eng.run()
    return out, rids, time.perf_counter() - t0


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda",
                    help="cuda (raises without a card) or cpu")
    args = ap.parse_args(argv)
    dev = args.device
    base = ModelConfig(name="serve-base", family="dense", n_layers=4,
                       d_model=128, n_heads=4, n_kv_heads=2, d_ff=256,
                       vocab_size=512)
    wide = base.replace(name="serve-altup", altup=AltUpConfig(K=4))

    res = {"cache_bytes": {}, "kv_read_bytes": {}}
    prompts = np.random.default_rng(0).integers(0, base.vocab_size, (4, 8))
    for cfg in (base, wide):
        params = init_params(cfg, seed=0, device=dev)
        cache = init_cache(cfg, B=4, T=MAX_LEN, device=dev)
        cache_bytes = sum(t.numel() * t.element_size()
                          for seg in cache.values() for t in seg.values())
        # the bytes a decode step reads from full slots, by the roofline
        kv_read = decode_kv_bytes(cfg, [MAX_LEN] * 4, T=MAX_LEN,
                                  kv_dtype="auto")
        eng = Engine(cfg, params, max_len=MAX_LEN, device=dev)
        t0 = time.perf_counter()
        out = eng.generate(prompts, sampling=SamplingParams(
            max_new=16, temperature=0.8, top_k=64, seed=0))
        dt = (time.perf_counter() - t0) / 16 * 1e3
        res["cache_bytes"][cfg.altup.K] = cache_bytes
        res["kv_read_bytes"][cfg.altup.K] = kv_read
        print(f"{cfg.name:12s} K={cfg.altup.K} cache={cache_bytes/1e6:.2f}MB "
              f"kv_read={kv_read/1e6:.3f}MB/step decode={dt:.1f}ms/tok "
              f"out[0]={out[0, :8].tolist()}")
    added = res["cache_bytes"][4] - res["cache_bytes"][1]
    res["added_cache_bytes"] = added
    print(f"note: 4x wider residual stream, {added} added KV-cache bytes "
          f"({res['kv_read_bytes'][4] - res['kv_read_bytes'][1]:.0f} "
          f"added bytes read a step).\n")

    # -- continuous batching, contiguous slot caches and a paged pool ----
    params = init_params(wide, seed=0, device=dev)
    tokens = {}
    for mode, kw in (("contiguous", {}),
                     ("paged", dict(paged=True, page_size=8))):
        out, plens, dt = _continuous(wide, params, dev, **kw)
        tokens[mode] = {rid: list(c.tokens) for rid, c in out.items()}
        total = sum(len(c.tokens) for c in out.values())
        print(f"continuous ({mode}): 6 requests / 2 slots, {total} tokens "
              f"in {dt*1e3:.0f}ms")
        for rid in sorted(out):
            c = out[rid]
            lp = (f" lp[0]={c.logprobs[0]:.2f}" if c.logprobs else "")
            print(f"  rid={rid} prompt_len={plens[rid]:2d} "
                  f"finish={c.finish_reason:6s} ttft={c.ttft_s*1e3:5.1f}ms"
                  f"{lp} -> {list(c.tokens)}")
    res["tokens"] = tokens
    res["paged_equals_contiguous"] = tokens["paged"] == tokens["contiguous"]
    print("paged tokens == contiguous tokens:",
          res["paged_equals_contiguous"])

    # -- streaming: deltas arrive per fused step, interleaved -------------
    eng = Engine(wide, params, max_len=MAX_LEN, n_slots=2, device=dev)
    for i in range(3):
        prompt = np.random.default_rng(10 + i).integers(0, wide.vocab_size, 5)
        eng.submit(prompt.tolist(), sampling=SamplingParams(
            max_new=4, temperature=0.9, seed=100 + i))
    print("\nstream deltas (rid, token):")
    res["stream"] = list(eng.stream())
    print("  " + " ".join(f"({rid},{tok})" for rid, tok in res["stream"]))
    return res


if __name__ == "__main__":
    main()
