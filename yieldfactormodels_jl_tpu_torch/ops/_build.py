"""Build and load the port's CUDA kernels (``csrc/*.cu``) at first use.

Each source is compiled by ``nvcc`` for Hopper (``sm_90a``) into a shared
library with a plain C interface, and loaded with ``ctypes``.  The library's
file name carries a hash of the source, the shared headers and the flags, so
an edited source or header is rebuilt and an unchanged one is loaded from the build directory
(``_kernels_build/`` beside this package's modules; ignored by git).  A build
that fails raises with the compiler's output: there is no fallback.

Nothing here runs at import time: the CPU tests import every module of the
port on a machine without ``nvcc``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_kernels_build"

#: kernel library name -> (source file under csrc/, {C entry point: argtypes},
#: extra nvcc flags); every pointer and the stream are c_void_p so ctypes never
#: cuts them to 32 bits, and host constants are c_double
KERNELS = {
    "fused_kf": ("fused_kf.cu", {
        "yfm_fused_kf": [ctypes.c_int] * 7 + [ctypes.c_void_p] * 14}),
    "fused_kf_grad": ("fused_kf_grad.cu", {
        "yfm_kf_grad_fwd": [ctypes.c_int] * 6 + [ctypes.c_void_p] * 14,
        "yfm_kf_grad_bwd": [ctypes.c_int] * 7 + [ctypes.c_void_p] * 22,
        "yfm_kf_tvl_grad_fwd": [ctypes.c_int] * 6 + [ctypes.c_void_p] * 13,
        "yfm_kf_tvl_grad_bwd": [ctypes.c_int] * 7 + [ctypes.c_void_p] * 19}),
    # K4 without FMA contraction: a fused multiply-add rounds once where the
    # plain version and the JAX kernel round twice, and on a draw whose
    # recursion overflows that turned their NaN (−inf loss) into a finite
    # value
    "fused_ssd": ("fused_ssd.cu", {
        "yfm_fused_ssd": [ctypes.c_int] * 8 + [ctypes.c_double] * 4
                         + [ctypes.c_void_p] * 5}, ("-fmad=false",)),
    # K4 again with clock64() stamps between the stages of a step and a
    # latency probe: chip_smoke.py's stage breakdown loads it, batched_loss
    # never does
    "fused_ssd_clocks": ("fused_ssd.cu", {
        "yfm_fused_ssd_clocks": [ctypes.c_int] * 8 + [ctypes.c_double] * 4
                                + [ctypes.c_void_p] * 6,
        "yfm_ssd_latencies": [ctypes.c_int] + [ctypes.c_void_p] * 3},
        ("-fmad=false", "-DYFM_SSD_CLOCKS")),
    "fused_pf": ("fused_pf.cu", {
        "yfm_fused_pf": [ctypes.c_int] * 8 + [ctypes.c_longlong] * 4
                        + [ctypes.c_double] * 2 + [ctypes.c_void_p] * 7}),
}

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_LIBS: dict = {}
#: compiler output of each library built in this process (ptxas register and
#: spill report included), for the build phase of chip_smoke.py to print
BUILD_LOGS: dict = {}


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels build only on a "
                           "machine with the CUDA toolkit")
    return path


def _flags(name: str) -> tuple:
    """nvcc flags of one library: the common ones and its own."""
    return NVCC_FLAGS + (KERNELS[name][2] if len(KERNELS[name]) > 2 else ())


def _lib_path(name: str) -> Path:
    """The library's path, named by a hash of its source, the shared headers
    it may include (``csrc/*.cuh``) and the flags."""
    h = hashlib.sha256((CSRC / KERNELS[name][0]).read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        h.update(header.read_bytes())
    h.update(" ".join(_flags(name)).encode())
    digest = h.hexdigest()[:16]
    return BUILD_DIR / f"lib{name}_{digest}.so"


def _start_build(name: str):
    """Start nvcc for one source into a temporary file; returns (proc, tmp,
    final) or None when the library for this source hash already exists."""
    final = _lib_path(name)
    if final.exists():
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = final.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_nvcc(), *_flags(name), "-o", str(tmp), str(CSRC / KERNELS[name][0])]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                            text=True)
    return proc, tmp, final


def _finish_build(name: str, started) -> None:
    proc, tmp, final = started
    log, _ = proc.communicate()
    BUILD_LOGS[name] = log
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed for {KERNELS[name][0]} "
                           f"(exit {proc.returncode}):\n{log}")
    os.replace(tmp, final)  # atomic: a concurrent loader never sees half a file


def build_all() -> None:
    """Compile every kernel source that has no library yet, all nvcc
    processes started together, and wait for them."""
    started = {name: _start_build(name) for name in KERNELS}
    for name, st in started.items():
        if st is not None:
            _finish_build(name, st)


def load(name: str):
    """The ctypes library of one kernel source, built first if needed."""
    lib = _LIBS.get(name)
    if lib is None:
        started = _start_build(name)
        if started is not None:
            _finish_build(name, started)
        lib = ctypes.CDLL(str(_lib_path(name)))
        for entry, argtypes in KERNELS[name][1].items():
            getattr(lib, entry).argtypes = argtypes
            getattr(lib, entry).restype = ctypes.c_int
        _LIBS[name] = lib
    return lib
