"""Build the CUDA kernels under `repro_torch/csrc/` at first use.

Each `csrc/<name>.cu` compiles on its own with nvcc into a shared library
with a plain C interface, which `load(name)` opens with ctypes:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \
         -Xcompiler -fPIC -o build/repro_torch_kernels/<name>-<hash>.so \
         csrc/<name>.cu

The library name carries a hash of the source, the shared headers and
the flags, so an edit rebuilds it and an unchanged tree reuses it. The
build directory `build/repro_torch_kernels/` sits at the root of the
checkout and is git-ignored. `build()` starts one nvcc per source, all
at once, and waits for them together. Nothing here runs at import time:
the CPU tests import every module on machines that have no nvcc.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict, Iterable, Optional

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch_kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v")

_LIBS: Dict[str, ctypes.CDLL] = {}


def sources() -> Dict[str, Path]:
    """{name: path} of every kernel source under csrc/."""
    return {p.stem: p for p in sorted(CSRC.glob("*.cu"))}


def nvcc() -> str:
    """Path of nvcc: $CUDA_HOME/bin, then PATH, then /usr/local/cuda."""
    cands = []
    if os.environ.get("CUDA_HOME"):
        cands.append(Path(os.environ["CUDA_HOME"]) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found:
        cands.append(Path(found))
    cands.append(Path("/usr/local/cuda/bin/nvcc"))
    for c in cands:
        if c.is_file():
            return str(c)
    raise RuntimeError("repro_torch kernels: nvcc not found (set CUDA_HOME "
                       "or put nvcc on PATH); CUDA kernels cannot be built")


def target(name: str) -> Path:
    """Library path of `name`, keyed on its source, headers and flags."""
    h = hashlib.sha256()
    h.update(sources()[name].read_bytes())
    for hdr in sorted(CSRC.glob("*.cuh")):
        h.update(hdr.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{name}-{h.hexdigest()[:16]}.so"


def build(names: Optional[Iterable[str]] = None) -> Dict[str, dict]:
    """Compile the named kernels (default: all) that are not built yet.

    One nvcc process per source, started together. Returns {name:
    {"path", "seconds", "log"}} with nvcc's -Xptxas=-v report (registers,
    shared memory, spills) in "log"; an already-built library reports 0
    seconds and its stored log. Raises RuntimeError naming the failed
    source and nvcc's output if any compile fails."""
    srcs = sources()
    names = list(srcs) if names is None else list(names)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    out: Dict[str, dict] = {}
    t0 = time.perf_counter()
    for name in names:
        so = target(name)
        if so.exists():
            log = so.with_suffix(".log")
            out[name] = {"path": so, "seconds": 0.0,
                         "log": log.read_text() if log.exists() else ""}
            continue
        tmp = so.with_name(f"{so.stem}.{os.getpid()}.tmp.so")
        cmd = [nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(srcs[name])]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, so)
    failed = []
    for name, (proc, tmp, so) in procs.items():
        log, _ = proc.communicate()
        secs = time.perf_counter() - t0
        if proc.returncode != 0:
            failed.append(f"{name}.cu (nvcc exit {proc.returncode}):\n{log}")
            tmp.unlink(missing_ok=True)
            continue
        so.with_suffix(".log").write_text(log)
        os.replace(tmp, so)
        out[name] = {"path": so, "seconds": secs, "log": log}
    if failed:
        raise RuntimeError("repro_torch kernel build failed:\n"
                           + "\n".join(failed))
    return out


def load(name: str) -> ctypes.CDLL:
    """The ctypes handle of kernel library `name`, built if needed."""
    lib = _LIBS.get(name)
    if lib is None:
        info = build([name])[name]
        lib = ctypes.CDLL(str(info["path"]))
        _LIBS[name] = lib
    return lib
