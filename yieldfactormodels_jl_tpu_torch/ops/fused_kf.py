"""Fused batched univariate Kalman log-likelihood — a hand-written CUDA kernel.

Counterpart of ``yieldfactormodels_jl_tpu/ops/pallas_kf.py``.  The kernel,
``csrc/fused_kf.cu``, replaces the Pallas TPU kernel ``pallas_kf._kernel``:
each parameter draw's whole T-step sequential-observation recursion runs in
registers, on one thread (large batches, many maturities) or on 32 or 8
lanes that share its gains (batches that leave the card latency-bound), the
shared panel staged through shared memory; every layout returns the same
bits.  As in the JAX package, unpacking, the unconditional start and the
Z/d setup stay batched tensor ops outside the kernel.

``batched_loglik`` takes a (B, n_params) batch of *constrained* draws and an
(N, T) panel and returns (B,) logliks, computing in float32 as the JAX entry
point does.  On CUDA tensors it launches the kernel (or raises); on CPU
tensors it runs the plain version, :func:`batched_loglik_reference` — the
batched univariate recursion of ``ops/univariate_kf``.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from .. import config
from ..models.kalman import (init_state, loglik_contrib_mask, measurement_setup,
                             observed_mask)
from ..models.params import unpack_kalman
from ..models.specs import ModelSpec
from . import univariate_kf
from ._build import load

_FAMILIES = ("kalman_dns", "kalman_afns", "kalman_tvl")
_DTYPE_CODES = {torch.float32: 0, torch.float64: 1}


def _prepare(spec: ModelSpec, params_batch, data, starts, ends, device, dtype):
    """Validate (JAX's errors) and put the inputs on one device in ``dtype``."""
    if spec.family not in _FAMILIES:
        raise ValueError(f"fused kernel supports the kalman families, "
                         f"not {spec.family!r}")
    params = config.as_tensor(params_batch, device, dtype)
    if params.ndim != 2 or params.shape[1] != spec.n_params:
        raise ValueError(f"params_batch must be (B, {spec.n_params}); "
                         f"got {tuple(params.shape)}")
    data = config.as_tensor(data, params.device, dtype)
    if data.ndim != 2 or data.shape[0] != spec.N:
        raise ValueError(f"data must be (N={spec.N}, T); got {tuple(data.shape)}")
    if (starts is None) != (ends is None):
        raise ValueError("starts and ends must be given together")
    if starts is not None:
        B = params.shape[0]
        starts = torch.as_tensor(starts, device=params.device).reshape(B)
        ends = torch.as_tensor(ends, device=params.device).reshape(B)
    return params, data, starts, ends


def batched_loglik_reference(spec: ModelSpec, params_batch, data, start=0,
                             end=None, starts=None, ends=None):
    """The plain PyTorch version of the kernel: the batched univariate
    recursion on the tensors' own device and dtype.  ``starts``/``ends``
    (B,) give each draw its own [start, end); the scalars are then ignored."""
    batched_loglik_reference.calls += 1
    if starts is not None:
        start, end = starts, ends
    return univariate_kf.get_loss(spec, params_batch, data, start, end)


batched_loglik_reference.calls = 0


def _lay(x, B):
    """(B, ...) draw-major -> (D, B) draw-minor, contiguous."""
    return x.reshape(B, -1).T.contiguous()


class KernelInputs(NamedTuple):
    """What one launch reads and writes: the C entry point's integer
    arguments, its buffers in argument order (``None`` for an unused one),
    and the output it fills."""
    ints: tuple
    buffers: tuple
    out: torch.Tensor


def kernel_inputs(spec: ModelSpec, params, data, start, end, starts=None,
                  ends=None) -> KernelInputs:
    """Unpack, start and lay out a batch for the kernel, as tensor ops on the
    inputs' device (the part ``pallas_kf.batched_loglik`` also runs outside
    its ``pallas_call``)."""
    B = params.shape[0]
    N, T = data.shape
    Ms = spec.state_dim
    dtype, device = params.dtype, params.device
    tvl = spec.family == "kalman_tvl"

    kp = unpack_kalman(spec, params)
    state0 = init_state(spec, kp)
    if tvl:  # state-dependent measurement: rows are built in the kernel
        Z = d = None
        mats = spec.maturities_array(device, dtype)
    else:
        Zc, dc = measurement_setup(spec, kp, dtype)
        Z = _lay(Zc, B)
        d = _lay(dc, B) if dc is not None else torch.zeros(
            N, B, dtype=dtype, device=device)
        mats = None
    masks = torch.stack([observed_mask(start, end, T, device),
                         loglik_contrib_mask(start, end, T, device)],
                        dim=1).to(torch.uint8).contiguous()
    win = None
    if starts is not None:
        win = torch.stack([starts, ends]).to(torch.int32).contiguous()

    buffers = (Z, d, _lay(kp.Phi, B), _lay(kp.delta, B),
               _lay(kp.Omega_state, B), _lay(kp.obs_var, B),
               _lay(state0.beta, B), _lay(state0.P, B), data.T.contiguous(),
               masks, win, mats)
    ints = (_DTYPE_CODES[dtype], Ms, int(tvl), int(spec.exact_jacobian), B, N, T)
    return KernelInputs(ints, buffers, torch.empty(B, dtype=dtype, device=device))


#: ``launch``'s layouts: None picks by the batch, the others force one
_LAYOUTS = {None: 0, "thread": 1, "warp": 2, "octet": 3}
_LAYOUT_NAMES = {1: "thread", 2: "warp", 3: "octet"}


def _layout_code(layout) -> int:
    if layout not in _LAYOUTS:
        raise ValueError(f"layout must be one of {list(_LAYOUTS)}; got {layout!r}")
    return _LAYOUTS[layout]


def launch(inputs: KernelInputs, layout=None) -> torch.Tensor:
    """One launch of the CUDA kernel on PyTorch's current stream; returns
    ``inputs.out``.  ``layout`` None lets the kernel pick by the batch (32
    or 8 lanes a draw while the batch leaves the card latency-bound and
    its blocks, whose shared memory grows with the maturities, fit the
    card at once; else a thread a draw); "thread", "warp" or "octet" forces
    one, so that tests can hold the layouts against each other.  Raises if
    the launch is refused: a forced layout that cannot launch is never
    replaced."""
    code = _layout_code(layout)
    out = inputs.out
    ptrs = [None if x is None else x.data_ptr() for x in inputs.buffers]
    lib = load("fused_kf")
    with torch.cuda.device(out.device):
        stream = torch.cuda.current_stream(out.device).cuda_stream
        err = lib.yfm_fused_kf(*inputs.ints, *ptrs, out.data_ptr(), code, stream)
    if err != 0:
        raise RuntimeError(f"fused_kf kernel launch failed: cudaError {err}")
    batched_loglik.launches += 1
    return out


def layout_of(inputs: KernelInputs) -> str:
    """The layout ``launch`` picks for these inputs: "thread", "warp" or
    "octet", by the batch, the state dimension, the maturities and the
    real type."""
    dtype, ms, _, _, B, N, T = inputs.ints
    lib = load("fused_kf")
    with torch.cuda.device(inputs.out.device):
        code = lib.yfm_fused_kf_layout(dtype, ms, B, N, T)
    if code < 0:
        raise RuntimeError(f"fused_kf layout query failed: cudaError {-code}")
    return _LAYOUT_NAMES[code]


def _batched_loglik(spec: ModelSpec, params_batch, data, start=0, end=None,
                    starts=None, ends=None, device=None, dtype=torch.float32):
    params, data, starts, ends = _prepare(spec, params_batch, data, starts,
                                          ends, device, dtype)
    if end is None:
        end = data.shape[1]
    if params.device.type == "cpu":
        return batched_loglik_reference(spec, params, data, start, end,
                                        starts, ends)
    if params.device.type != "cuda":
        raise ValueError(f"no fused kernel for device {params.device}")
    return launch(kernel_inputs(spec, params, data, start, end, starts, ends))


def batched_loglik(spec: ModelSpec, params_batch, data, start=0, end=None,
                   starts=None, ends=None, device=None):
    """Gaussian loglik for a batch of parameter draws, (B,), in float32.

    Numerically equivalent to the univariate engine for every Kalman family
    (DNS/AFNS with constant measurement, the TVλ EKF).  ``starts``/``ends``:
    optional (B,) per-draw estimation windows; when given, the scalar
    ``start``/``end`` are ignored.  Numpy input goes to ``device`` (``None``
    means CUDA); tensors stay where they are."""
    return _batched_loglik(spec, params_batch, data, start, end, starts, ends,
                           device, torch.float32)


#: kernel launches since the count was last set to 0
batched_loglik.launches = 0


class LoglikGraph:
    """``fn`` — a function of one tensor that launches K1 exactly once, with
    its set-up tensor ops around it — captured once as a CUDA graph on
    ``example``'s shape and replayed per call.  Eagerly, K1's set-up
    (transforms, unpacking, the unconditional start, the loadings, the
    layout) enqueues some 60 small kernels, whose host time exceeds K1's
    0.7 ms on the card for the one-draw batches of a lockstep Nelder–Mead;
    a replay enqueues them at once.  It runs the same kernels on the same
    inputs as an eager call, so it returns the same bits.  Tensors that
    ``fn`` reads besides its argument must stay alive and unchanged while
    the graph is used.  CUDA tensors only."""

    def __init__(self, fn, example):
        dev = example.device
        self.arg = example.detach().clone()
        stream = torch.cuda.Stream(dev)
        stream.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(stream):  # the libraries' lazy set-up, outside the capture
            fn(self.arg)
        torch.cuda.current_stream(dev).wait_stream(stream)
        self.graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(self.graph, stream=stream):
            self.out = fn(self.arg)
        batched_loglik.launches -= 1  # the capture recorded K1; it did not run it

    def __call__(self, x):
        self.arg.copy_(x)
        self.graph.replay()
        batched_loglik.launches += 1
        return self.out.clone()
