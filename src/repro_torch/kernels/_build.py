"""Builds the port's CUDA sources (`csrc/*.cu`) at first use (counterpart:
none; Pallas kernels compile inside `jax.jit`).

Route: `nvcc` compiles each source into a shared library with a plain C
interface for `sm_90a`, loaded with `ctypes` (no PyTorch headers, so a build
takes seconds).  Libraries go to `build/repro_torch_kernels/` at the root of
the checkout, named by a hash of the sources and flags, so an edited source
is rebuilt and an unchanged one is loaded as it is.  Nothing is built at
import: the first call that hands a CUDA tensor to a kernel builds it, and
`build()` builds every source at once, one `nvcc` process per source, all
started together.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict, Iterable, Optional

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch_kernels"
SOURCES = {
    "pairwise_reduce": "pairwise_reduce.cu",
    "aqp_batch": "aqp_batch.cu",
    "aqp_boxes": "aqp_boxes.cu",
    "sv_precompute": "sv_precompute.cu",
    "lscv_grid": "lscv_grid.cu",
    "gh_fused": "gh_fused.cu",
    "aqp_grouped": "aqp_grouped.cu",
    "qmc_reduce": "qmc_reduce.cu",
    "rff_eval": "rff_eval.cu",
    "kde_eval": "kde_eval.cu",
    "draw_box": "draw_box.cu",
}
HEADERS = ("common.cuh",)
NVCC_FLAGS = ("-gencode=arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v")

_libs: Dict[str, ctypes.CDLL] = {}
_lock = threading.Lock()


def nvcc() -> str:
    """Path of the CUDA compiler; RuntimeError when the toolkit is absent."""
    found = shutil.which("nvcc")
    if found:
        return found
    cuda_home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    cand = Path(cuda_home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found (PATH, CUDA_HOME, /usr/local/cuda): "
                       "the CUDA kernels cannot be built here")


def target(name: str) -> Path:
    """The library a source builds into, keyed by sources and flags."""
    digest = hashlib.sha256()
    for fname in (SOURCES[name],) + HEADERS:
        digest.update((CSRC / fname).read_bytes())
    digest.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{name}-{digest.hexdigest()[:16]}.so"


def build(names: Optional[Iterable[str]] = None) -> None:
    """Compile the named sources (default: all) that are not built yet, in
    parallel, keeping each compiler log (ptxas register and spill counts)
    beside its library; raises RuntimeError naming every source that
    failed, with the compiler's output."""
    names = list(SOURCES if names is None else names)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    compiler = nvcc()
    procs = {}
    for name in names:
        out = target(name)
        if out.exists():
            continue
        log = out.with_suffix(".log")
        tmp = out.with_name(f"{out.stem}.{os.getpid()}.tmp.so")
        cmd = [compiler, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / SOURCES[name])]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, out, log)
    failed = []
    for name, (proc, tmp, out, log) in procs.items():
        text, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"{name} (nvcc exit {proc.returncode}):\n{text}")
            tmp.unlink(missing_ok=True)
            continue
        log.write_text(text)
        os.replace(tmp, out)
    if failed:
        raise RuntimeError("CUDA kernel build failed:\n" + "\n".join(failed))


def load(name: str) -> ctypes.CDLL:
    """The loaded library for one source, built first if needed."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            path = target(name)
            if not path.exists():
                build([name])
            lib = _libs[name] = ctypes.CDLL(str(path))
        return lib


def build_all() -> float:
    """Build every source in parallel and load each; returns seconds."""
    t0 = time.perf_counter()
    build()
    for name in SOURCES:
        load(name)
    return time.perf_counter() - t0
