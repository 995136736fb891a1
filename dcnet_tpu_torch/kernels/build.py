"""Builds the hand-written CUDA kernels in `dcnet_tpu_torch/csrc/` at first use.

Each `csrc/<name>.cu` exposes a plain C interface and is compiled by `nvcc`
for Hopper (`sm_90a`) into its own shared library, loaded with `ctypes`;
device code shared between sources lives in `csrc/*.cuh` headers.
Libraries land in `dcnet_tpu_torch/_build/` (listed in `.gitignore`) under a
name that carries a hash of the source and the headers, so an edited source
or header rebuilds. One
`nvcc` process runs per source, all started together. A failed build raises
with the compiler's output; nothing falls back.

No library is linked beyond the CUDA runtime: the TMA tensor maps of
`csrc/attend_wgmma.cuh` are encoded with the driver's
`cuTensorMapEncodeTiled`, reached at run time through the runtime's
`cudaGetDriverEntryPoint(ByVersion)`, not by linking `-lcuda`. The kernels
use raw PTX, no CUTLASS headers.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from typing import Dict, Sequence

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SRC_DIR = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "_build")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v", "-lineinfo")

_LIBS: Dict[str, ctypes.CDLL] = {}
BUILD_LOG: Dict[str, str] = {}       # name -> nvcc output (ptxas register use)
BUILD_SECONDS: Dict[str, float] = {}  # name -> wall seconds of its nvcc


def nvcc() -> str:
    """Path of nvcc: $CUDA_HOME/bin, then PATH, then /usr/local/cuda/bin."""
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    for cand in ([os.path.join(home, "bin", "nvcc")] if home else []) + [
            shutil.which("nvcc") or "", "/usr/local/cuda/bin/nvcc"]:
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels of dcnet_tpu_torch "
                       "are built from source at first use and need the CUDA "
                       "toolkit (set CUDA_HOME)")


def _target(name: str) -> str:
    """The library path of `csrc/<name>.cu`, named by a hash of the source,
    the headers of `csrc/` it may include, and the flags."""
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    headers = sorted(n for n in os.listdir(SRC_DIR) if n.endswith(".cuh"))
    for src in [f"{name}.cu", *headers]:
        with open(os.path.join(SRC_DIR, src), "rb") as f:
            digest.update(f.read())
    return os.path.join(BUILD_DIR, f"lib{name}-{digest.hexdigest()[:12]}.so")


def build(names: Sequence[str]) -> Dict[str, str]:
    """Compile the named sources that are not built yet, in parallel.
    Returns name -> library path."""
    os.makedirs(BUILD_DIR, exist_ok=True)
    paths = {n: _target(n) for n in names}
    procs = {}
    for n, path in paths.items():
        if os.path.exists(path):
            continue
        tmp = f"{path}.{os.getpid()}.tmp"
        cmd = [nvcc(), *NVCC_FLAGS, "-o", tmp, os.path.join(SRC_DIR, f"{n}.cu")]
        procs[n] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                     stderr=subprocess.STDOUT, text=True),
                    tmp, time.perf_counter())
    failed = []
    for n, (proc, tmp, t0) in procs.items():
        out, _ = proc.communicate()
        BUILD_SECONDS[n] = time.perf_counter() - t0
        BUILD_LOG[n] = out
        if proc.returncode != 0:
            failed.append(f"{n}.cu (nvcc exit {proc.returncode}):\n{out}")
            continue
        os.replace(tmp, paths[n])
    if failed:
        raise RuntimeError("kernel build failed: " + "\n".join(failed))
    return paths


def load(name: str) -> ctypes.CDLL:
    """The loaded library of `csrc/<name>.cu`, built first if needed."""
    lib = _LIBS.get(name)
    if lib is None:
        lib = ctypes.CDLL(build([name])[name])
        _LIBS[name] = lib
    return lib
