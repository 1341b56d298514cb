"""Build the port's CUDA kernels from the repository's sources.

Each kernel is one ``.cu`` file under ``tdfo_tpu_torch/ops/csrc/`` with a
plain ``extern "C"`` launcher, compiled by ``nvcc`` into its own shared
library and loaded with ``ctypes``.  The library lands in
``tdfo_tpu_torch/build/<name>-<hash>/`` where the hash covers the source, the
shared ``*.cuh`` headers and the compiler flags, so an edited source
rebuilds and an unchanged one is reused.  Nothing here runs at import
time: the first call that needs a kernel builds it.  :func:`build_all`
starts one ``nvcc`` per source, all at once, so a run that needs several
kernels pays for the slowest build only.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from dataclasses import dataclass
from pathlib import Path

__all__ = ["KERNEL_SOURCES", "NVCC_FLAGS", "BuildResult", "build_all", "load"]

_PKG = Path(__file__).resolve().parents[2]
CSRC = _PKG / "ops" / "csrc"
BUILD_DIR = _PKG / "build"

# kernel name -> source file under ops/csrc
KERNEL_SOURCES = {
    "fat_line_update": "fat_line_update.cu",
    "fat_line_update_routed": "fat_line_update_routed.cu",
    "flash_attn_fwd": "flash_attn_fwd.cu",
    "flash_attn_bwd": "flash_attn_bwd.cu",
    "segment_sum": "segment_sum.cu",
}

# -fmad=false: no contracted multiply-adds, so each kernel rounds exactly
# where its plain PyTorch version does; --use_fast_math stays off for the
# same reason (IEEE sqrt and division).
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-fmad=false", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


@dataclass(frozen=True)
class BuildResult:
    name: str
    path: Path
    seconds: float   # 0.0 when an earlier build was reused
    log: str         # nvcc's output (-Xptxas -v: registers, spills)


_LOADED: dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    cand = [Path(CUDA_HOME) / "bin" / "nvcc"] if CUDA_HOME else []
    which = shutil.which("nvcc")
    if which:
        cand.append(Path(which))
    for c in cand:
        if c.exists():
            return str(c)
    raise RuntimeError(
        "nvcc not found (neither CUDA_HOME/bin/nvcc nor on PATH): the port's "
        "CUDA kernels are built from source at first use")


def _target(name: str) -> Path:
    src = CSRC / KERNEL_SOURCES[name]
    h = hashlib.sha256(src.read_bytes())
    for hdr in sorted(CSRC.glob("*.cuh")):  # shared headers rebuild every user
        h.update(hdr.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{name}-{h.hexdigest()[:16]}" / f"lib{name}.so"


def build_all(names=None) -> dict[str, BuildResult]:
    """Build (or reuse) every named kernel library; one ``nvcc`` process
    per source, started together.  Raises with the compiler's output when
    a build fails.  Each library compiled (not reused) is an
    ``obs/events.py`` build event."""
    from tdfo_tpu_torch.obs import events as _events

    names = list(KERNEL_SOURCES if names is None else names)
    jobs = {}
    results: dict[str, BuildResult] = {}
    for name in names:
        out = _target(name)
        if out.exists():
            results[name] = BuildResult(name, out, 0.0, "")
            continue
        out.parent.mkdir(parents=True, exist_ok=True)
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=out.parent)
        os.close(fd)
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, str(CSRC / KERNEL_SOURCES[name])]
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT, text=True)
        jobs[name] = (proc, tmp, out, time.perf_counter())
    failed = []
    for name, (proc, tmp, out, t0) in jobs.items():
        log, _ = proc.communicate()
        secs = time.perf_counter() - t0
        if proc.returncode != 0:
            Path(tmp).unlink(missing_ok=True)
            failed.append(f"{name}:\n{log}")
            continue
        os.replace(tmp, out)  # atomic: a half-written library never loads
        results[name] = BuildResult(name, out, secs, log)
        _events.compiled(f"kernel_build:{name}", secs)
    if failed:
        raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
    return results


def load(name: str) -> ctypes.CDLL:
    """The loaded library of kernel ``name``, built on first use."""
    lib = _LOADED.get(name)
    if lib is None:
        lib = ctypes.CDLL(str(build_all([name])[name].path))
        _LOADED[name] = lib
    return lib
