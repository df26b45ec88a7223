"""Time the ragged decode kernels at each candidate span on the card.

SPAN, the rows one split block attends, is one compile-time constant of
`csrc/ragged_decode_attention.cu` (`kSpan`), mirrored by
`ragged_decode_attention.SPAN`. This script builds one copy of that
source for each span of {64, 128, 256}, the constant rewritten, into
`build/repro_torch_kernels/span_sweep/` (one nvcc each, all started
together), binds each copy in turn to the launchers and prints, for each
span and decode shape, the device ms of one bf16 call (split and merge
kernels summed, from torch.profiler) and its largest distance from the
plain version. The shapes are those of the served Qwen3-0.6B decode (Hk
8, rep 2, Dh 128) that chip_smoke.py times: (e)'s halfway step and the
spread through the contiguous launcher, (g)'s halfway step through the
paged one. Needs a CUDA card; run from the root of the checkout:

    PYTHONPATH=src python -m repro_torch.kernels.span_sweep

It prints one JSON object per line; the served kernel is untouched.
"""
from __future__ import annotations

import ctypes
import json
import subprocess
import sys
from unittest import mock

import torch

from repro_torch.kernels import build, ref
from repro_torch.kernels import ragged_decode_attention as R
from repro_torch.serve.engine import kv_bucket

SPANS = (64, 128, 256)
NAME = "ragged_decode_attention"
CONSTANT = f"constexpr int kSpan = {R.SPAN};"
HK, REP, DH, PAGE = 8, 2, 128, 16
E_LENS = [64, 128, 192, 256, 320, 384, 448, 544]       # prompts + 32 new
SPREAD = [0, 2048, 1, 517, 1024, 77, 1999, 300]
# slot 0 idle; 15 requests of a 250-token system prompt, its tail and 32
# new tokens (chip_smoke.py's paged_traffic, seed 5)
G_LENS = [0, 523, 410, 522, 333, 452, 504, 373, 341, 443, 420, 403, 393,
          409, 455, 469]
G_SHARED = 250 // PAGE


def build_variants() -> dict:
    """{span: ctypes library} of the source with kSpan set to each span."""
    src = build.sources()[NAME].read_text()
    if src.count(CONSTANT) != 1:
        raise RuntimeError(f"{NAME}.cu does not define {CONSTANT!r} once")
    out_dir = build.BUILD_DIR / "span_sweep"
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = {}
    for span in SPANS:
        cu = out_dir / f"{NAME}_span{span}.cu"
        cu.write_text(src.replace(CONSTANT,
                                  f"constexpr int kSpan = {span};"))
        so = cu.with_suffix(".so")
        cmd = [build.nvcc(), *build.NVCC_FLAGS, "-I", str(build.CSRC),
               "-o", str(so), str(cu)]
        procs[span] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       so)
    libs = {}
    for span, (proc, so) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for span {span}:\n{log}")
        libs[span] = R.bind(ctypes.CDLL(str(so)))
    return libs


def device_ms(fn, iters=50) -> float:
    """Summed device time per call of the ragged decode kernels fn()
    launches (split and merge), over `iters` calls under torch.profiler.
    A session that recorded only part of the calls is run again, three
    sessions at most."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        hits = [e for e in prof.key_averages()
                if e.device_type == torch.autograd.DeviceType.CUDA
                and "ragged_decode_" in e.key]
        if sum(e.count for e in hits) == 2 * iters:
            return sum(e.self_device_time_total for e in hits) / 1e3 / iters
    raise RuntimeError(f"want {2 * iters} kernels in the profile, got "
                       f"{[(e.key, e.count) for e in hits]}")


def cases(gen):
    """(name, call, plain) of each timed shape, random bf16 inputs."""
    dev, bf16 = "cuda", torch.bfloat16

    def rand(*shape):
        return torch.randn(*shape, generator=gen, device=dev).to(bf16)
    for name, lens_host in (("e", E_LENS), ("spread", SPREAD)):
        B, T = len(lens_host), kv_bucket(max(lens_host), 32, 2048)
        q = rand(B, HK, REP, DH)
        k, v = rand(B, T, HK, DH), rand(B, T, HK, DH)
        lens = torch.tensor(lens_host, dtype=torch.int32, device=dev)
        yield (name, lambda q=q, k=k, v=v, lens=lens:
               R.ragged_decode_attention(q, k, v, lens),
               ref.ragged_decode_ref(q, k, v, lens))
    B, t_max = len(G_LENS), kv_bucket(max(G_LENS), 32, 2048)
    npg = t_max // PAGE
    own = [max(-(-n // PAGE) - G_SHARED, 0) if n else 0 for n in G_LENS]
    n_pages = G_SHARED + sum(own)
    perm = torch.randperm(n_pages,
                          generator=torch.Generator().manual_seed(4))
    bt = torch.zeros(B, npg, dtype=torch.int32)
    nxt = G_SHARED
    for b, n in enumerate(own):
        if G_LENS[b]:
            bt[b, :G_SHARED + n] = torch.cat([perm[:G_SHARED],
                                              perm[nxt:nxt + n]])
            nxt += n
    bt = bt.to(dev)
    q = rand(B, HK, REP, DH)
    kp, vp = rand(n_pages * PAGE, HK, DH), rand(n_pages * PAGE, HK, DH)
    lens = torch.tensor(G_LENS, dtype=torch.int32, device=dev)
    yield ("g", lambda: R.paged_ragged_decode_attention(
        q, kp, vp, lens, bt, page=PAGE, t_max=t_max),
        ref.paged_ragged_decode_ref(q, kp, vp, lens, bt, page=PAGE,
                                    t_max=t_max))


def main() -> int:
    if not torch.cuda.is_available():
        print("span_sweep needs a CUDA card", file=sys.stderr)
        return 1
    libs = build_variants()
    todo = list(cases(torch.Generator(device="cuda").manual_seed(9)))
    for span, lib in libs.items():
        with mock.patch.object(R, "SPAN", span), \
                mock.patch.object(R, "_library", lambda lib=lib: lib):
            for name, call, plain in todo:
                got = call()
                err = (got.float() - plain.float()).abs().max().item()
                torch.testing.assert_close(got, plain, atol=2e-2, rtol=2e-2)
                print(json.dumps({"span": span, "case": name,
                                  "ms": device_ms(call),
                                  "max_abs_err": err}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
