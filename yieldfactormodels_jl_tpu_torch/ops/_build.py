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
import signal
import subprocess
import tempfile
import time
from pathlib import Path

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_kernels_build"

#: yfm_fused_pf's arguments up to ``out``: dtype, ms, D, N, T, P, n_eff, npar;
#: the four noise strides; th, log_uniform; rows, panel, normals, uniforms,
#: scratch, out
_PF_ARGS = ([ctypes.c_int] * 8 + [ctypes.c_longlong] * 4 + [ctypes.c_double] * 2
            + [ctypes.c_void_p] * 6)

#: yfm_fused_kf's arguments up to ``out``: dtype, ms, tvl, exact, B, N, T; Z, d,
#: phi, delta, om, ovar, b0, p0, data, masks, win, mats, out
_KF_ARGS = [ctypes.c_int] * 7 + [ctypes.c_void_p] * 13
_KF_CLOCKS_ARGS = _KF_ARGS + [ctypes.c_void_p, ctypes.c_int, ctypes.c_int] + [ctypes.c_void_p] * 2

#: yfm_kf_grad_fwd's arguments up to the layout: dtype, ms, B, N, T, S; Z, d, phi,
#: delta, om, ovar, b0, p0, data, masks, win, out, chk.  yfm_kf_tvl_grad_fwd's:
#: dtype, exact, B, N, T, S; phi, delta, om, ovar, b0, p0, data, masks, win, mats,
#: out, chk
_KFG_FWD_ARGS = [ctypes.c_int] * 6 + [ctypes.c_void_p] * 13
_KFG_TVL_FWD_ARGS = [ctypes.c_int] * 6 + [ctypes.c_void_p] * 12

#: yfm_kf_grad_bwd's arguments up to the stream: dtype, ms, B, N, T, S, nC; Z, d,
#: phi, delta, om, ovar, data, masks, win, chk, g, the eight gradients, seg, pre;
#: layout, store.  yfm_kf_tvl_grad_bwd's: dtype, exact, B, N, T, S, nC; phi,
#: delta, om, ovar, data, masks, win, mats, chk, g, the six gradients, seg,
#: pre; layout, store
_KFG_BWD_ARGS = [ctypes.c_int] * 7 + [ctypes.c_void_p] * 21 + [ctypes.c_int] * 2
_KFG_TVL_BWD_ARGS = [ctypes.c_int] * 7 + [ctypes.c_void_p] * 18 + [ctypes.c_int] * 2

#: kernel library name -> (source file under csrc/, {C entry point: argtypes},
#: extra nvcc flags); every pointer and the stream are c_void_p so ctypes never
#: cuts them to 32 bits, and host constants are c_double
KERNELS = {
    "fused_kf": ("fused_kf.cu", {
        "yfm_fused_kf": _KF_ARGS + [ctypes.c_int, ctypes.c_void_p],
        "yfm_fused_kf_layout": [ctypes.c_int] * 5}),
    # K1 again with clock64() stamps between the stages of a step, and K2f's and
    # K3f's launch of the same kernels (the checkpoint store compiled in) as a
    # library of its own: chip_smoke.py's stage breakdown loads them,
    # batched_loglik and launch_forward never do.  Arguments after ``out``:
    # chk (null for K1), S, layout, clocks, stream
    "fused_kf_clocks": ("fused_kf.cu", {"yfm_fused_kf_clocks": _KF_CLOCKS_ARGS},
                        ("-DYFM_KF_CLOCKS",)),
    "fused_kf_fwd_clocks": ("fused_kf.cu", {"yfm_fused_kf_clocks": _KF_CLOCKS_ARGS},
                            ("-DYFM_KF_CLOCKS", "-DYFM_KF_CLOCKS_CHK")),
    "fused_kf_grad": ("fused_kf_grad.cu", {
        "yfm_kf_grad_fwd": _KFG_FWD_ARGS + [ctypes.c_int, ctypes.c_void_p],
        "yfm_kf_grad_bwd": _KFG_BWD_ARGS + [ctypes.c_void_p],
        "yfm_kf_tvl_grad_fwd": _KFG_TVL_FWD_ARGS + [ctypes.c_int, ctypes.c_void_p],
        "yfm_kf_tvl_grad_bwd": _KFG_TVL_BWD_ARGS + [ctypes.c_void_p],
        "yfm_kf_grad_fwd_layout": [ctypes.c_int] * 6,
        "yfm_kf_grad_bwd_layout": [ctypes.c_int] * 8}),
    # K2b/K3b again with clock64() stamps between the stages of the sweep:
    # chip_smoke.py's stage breakdown loads it, the autograd Functions never do
    "fused_kf_grad_clocks": ("fused_kf_grad.cu", {
        "yfm_kf_grad_bwd_clocks": [ctypes.c_int] * 9 + [ctypes.c_void_p] * 22
                                  + [ctypes.c_int] * 2 + [ctypes.c_void_p] * 2},
        ("-DYFM_KFG_CLOCKS",)),
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
        "yfm_fused_pf": _PF_ARGS + [ctypes.c_int, ctypes.c_void_p],
        "yfm_fused_pf_layout": [ctypes.c_int] * 6}),
    # K5 again with clock64() stamps between the stages of a step and a
    # latency probe (log, shared and DSMEM loads, the cluster barrier):
    # chip_smoke.py's stage breakdown loads it, pf_loglik_batch never does
    "fused_pf_clocks": ("fused_pf.cu", {
        "yfm_fused_pf_clocks": _PF_ARGS + [ctypes.c_int] + [ctypes.c_void_p] * 2,
        "yfm_pf_latencies": [ctypes.c_int] + [ctypes.c_void_p] * 3},
        ("-DYFM_PF_CLOCKS",)),
}

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_LIBS: dict = {}
#: compiler output of each library built in this process (ptxas register and
#: spill report included), for the build phase of chip_smoke.py to print
BUILD_LOGS: dict = {}
#: seconds from each library's nvcc start to the moment it was waited for
#: and found done (at most a wait's lateness above its compile time)
BUILD_SECONDS: dict = {}
#: builds started by :func:`start_all` and not yet waited for
_PENDING: dict = {}


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


def _start_build(name: str, niceness: int = 0):
    """Start nvcc for one source into a temporary file, its output into a
    temporary log, ``niceness`` above this process's; returns (proc, tmp,
    final, log, start time) or None when the library for this source hash
    already exists."""
    final = _lib_path(name)
    if final.exists():
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = final.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_nvcc(), *_flags(name), "-o", str(tmp), str(CSRC / KERNELS[name][0])]
    log = tempfile.TemporaryFile(mode="w+")
    # a process group of its own, so that stop_pending reaches nvcc's children
    proc = subprocess.Popen(cmd, stdout=log, stderr=subprocess.STDOUT, text=True,
                            start_new_session=True,
                            preexec_fn=(lambda: os.nice(niceness)) if niceness else None)
    return proc, tmp, final, log, time.perf_counter()


def _finish_build(name: str, started) -> None:
    proc, tmp, final, log, t0 = started
    proc.wait()
    BUILD_SECONDS[name] = time.perf_counter() - t0
    log.seek(0)
    BUILD_LOGS[name] = log.read()
    log.close()
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed for {KERNELS[name][0]} "
                           f"(exit {proc.returncode}):\n{BUILD_LOGS[name]}")
    os.replace(tmp, final)  # atomic: a concurrent loader never sees half a file


def start_all(later=()) -> None:
    """Start nvcc for every kernel source that has no library yet, all
    together, without waiting: :func:`load` waits for each library when it
    is first needed.  The libraries named in ``later`` build at the lowest
    CPU priority, on the cores the others leave."""
    for name in KERNELS:
        if name not in _PENDING and name not in _LIBS:
            started = _start_build(name, 19 if name in later else 0)
            if started is not None:
                _PENDING[name] = started


def stop_pending() -> None:
    """Kill the builds :func:`start_all` started that nothing waited for,
    nvcc and the compilers it started."""
    for name in list(_PENDING):
        proc, tmp, _, log, _ = _PENDING.pop(name)
        try:
            os.killpg(proc.pid, signal.SIGKILL)
        except ProcessLookupError:  # the group is gone: nvcc ended and was reaped
            pass
        proc.wait()
        log.close()
        tmp.unlink(missing_ok=True)


def load(name: str):
    """The ctypes library of one kernel source, built first if needed (or
    waited for, if :func:`start_all` started its build)."""
    lib = _LIBS.get(name)
    if lib is None:
        started = _PENDING.pop(name, None) or _start_build(name)
        if started is not None:
            _finish_build(name, started)
        lib = ctypes.CDLL(str(_lib_path(name)))
        for entry, argtypes in KERNELS[name][1].items():
            getattr(lib, entry).argtypes = argtypes
            getattr(lib, entry).restype = ctypes.c_int
        _LIBS[name] = lib
    return lib
