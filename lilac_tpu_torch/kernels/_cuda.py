"""Builds and loads the hand-written CUDA kernels of csrc/.

Each source file becomes its own shared library with a plain C interface,
compiled by nvcc for sm_90a and loaded with ctypes (no PyTorch headers,
so a build takes seconds). All sources are compiled in parallel, one nvcc
process each, at the first call of ``load``; nothing is built when a
module is imported. Libraries go to <repo>/build/lilac_tpu_torch/
(git-ignored) under a name that carries a hash of the source, the headers
of csrc/ and the flags, so a stale library is never picked up.

A failed build or a missing nvcc raises: no caller catches it to fall
back to a plain version.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from typing import Dict

from lilac_tpu_torch.utils.profiling import BUILD, span

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_CSRC = os.path.join(_PKG, "csrc")
_BUILD = os.path.join(os.path.dirname(_PKG), "build", "lilac_tpu_torch")

SOURCES = ("routed", "dfmulred", "hier", "adjoint", "gemm", "dfdot", "dfops", "dfadj")

# --fmad=false holds for EVERY source: no contraction of a*b+c into FMA
# anywhere (the error-free transformations of the df64 kernel and of the
# adjoint merges need every step rounded on its own; the sources also use
# the _rn intrinsics). A kernel that wants a fused multiply-add spells it
# out (__fmaf_rn), since under this flag a written a*b+c is an FMUL and an
# FADD; gemm.cu (K12) multiplies on the tensor cores and rounds its split
# and epilogue with _rn intrinsics. No -use_fast_math.
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "--fmad=false", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_libs: Dict[str, ctypes.CDLL] = {}
# a library's first load in the process: dlopen, and nvcc where it is missing
_KERNELS = span("lilac.build.kernels", BUILD)


def source_path(name: str) -> str:
    return os.path.join(_CSRC, f"{name}.cu")


def _nvcc() -> str:
    for home in (os.environ.get("CUDA_HOME"), os.environ.get("CUDA_PATH")):
        if home and os.path.exists(os.path.join(home, "bin", "nvcc")):
            return os.path.join(home, "bin", "nvcc")
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError(
        "nvcc not found (set CUDA_HOME): the CUDA kernels of lilac_tpu_torch "
        "are compiled from csrc/ at first use"
    )


def _target(name: str) -> str:
    h = hashlib.sha256()
    # the source and every header of csrc/ it may include
    headers = sorted(f for f in os.listdir(_CSRC) if f.endswith(".cuh"))
    for path in [source_path(name)] + [os.path.join(_CSRC, f) for f in headers]:
        with open(path, "rb") as f:
            h.update(f.read())
    h.update(" ".join(NVCC_FLAGS).encode())
    return os.path.join(_BUILD, f"lib{name}_{h.hexdigest()[:12]}.so")


def build_all() -> Dict[str, object]:
    """Compile every missing library, all nvcc processes started together.
    Returns {"seconds", "built": [names], "ptxas": {name: text}}."""
    t0 = time.perf_counter()
    os.makedirs(_BUILD, exist_ok=True)
    procs = []
    for name in SOURCES:
        so = _target(name)
        if os.path.exists(so):
            continue
        # per-process temp name, published atomically when nvcc is done
        tmp = f"{so}.{os.getpid()}.tmp"
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, source_path(name)]
        procs.append((name, so, tmp, cmd, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    ptxas = {}
    errors = []
    for name, so, tmp, cmd, p in procs:
        out, _ = p.communicate()
        if p.returncode != 0:
            errors.append(f"{' '.join(cmd)}\n{out}")
            continue
        os.replace(tmp, so)
        ptxas[name] = out
    if errors:
        raise RuntimeError("nvcc failed:\n" + "\n".join(errors))
    return {
        "seconds": time.perf_counter() - t0,
        "built": [name for name, *_ in procs],
        "ptxas": ptxas,
    }


def load(name: str) -> ctypes.CDLL:
    """The ctypes library of one source file, built on first use."""
    lib = _libs.get(name)
    if lib is None:
        with _KERNELS:
            so = _target(name)
            if not os.path.exists(so):
                build_all()
            lib = ctypes.CDLL(so)
        _libs[name] = lib
    return lib


def launch_on(index: int, launch):
    """launch(stream) with card `index` the current device (a kernel goes
    to the current device's context) and `stream` the raw cudaStream_t of
    its current stream, as torch.cuda.current_stream(index).cuda_stream
    gives it. The device is switched only where it is another, and the
    Stream object is not made: each costs 4 to 9 us of host time a call
    on an H100's host, and the solvers' df64 kernels launch hundreds of
    times a step."""
    import torch

    stream = torch._C._cuda_getCurrentRawStream(index)
    if index == torch.cuda.current_device():
        return launch(stream)
    with torch.cuda.device(index):
        return launch(stream)


def check(err: int, what: str) -> None:
    """Raise when a launch returned a non-zero cudaError_t."""
    if err != 0:
        raise RuntimeError(f"{what}: CUDA launch failed with cudaError {err}")
