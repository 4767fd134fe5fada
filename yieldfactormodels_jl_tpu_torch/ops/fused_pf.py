"""Fused SV particle filter — a hand-written CUDA kernel (K5).

Counterpart of ``yieldfactormodels_jl_tpu/ops/pallas_pf.py``.  The kernel,
``csrc/fused_pf.cu``, replaces the Pallas TPU kernel ``pallas_pf._kernel``:
``ops/particle.particle_filter_loglik`` in its common-noise mode for a batch
of D draws, one thread a particle slot: one thread-block cluster a draw
while the batch's clusters fit the card at once (a few draws, as
``estimate_sv``'s step batch), otherwise one thread block a draw (above
1,024 slots, several slots a thread).  Both layouts return the same bits.

``pf_loglik_batch`` takes (D, n_params) *constrained* draws, an (N, T) panel
and the noise arrays ``normals`` (D, T−1, P) and ``uniforms`` (D, T−1), P a
multiple of 128 slots of which ``n_particles`` are live, and returns (D,)
logliks in the spec's float type.  A draw's run equals the
``n_particles``-particle filter fed ``normals[d, :, :n_particles]``.  On
CUDA tensors it launches the kernel (or raises); on CPU tensors it runs the
plain version, :func:`pf_loglik_batch_reference`, which runs the kernel's
arithmetic over (D, P) in PyTorch from the same packed rows.
"""

from __future__ import annotations

import ctypes
import math
from typing import NamedTuple

import torch

from .. import config
from ..models.params import unpack_kalman
from ..models.specs import ModelSpec
from ._build import load
from .particle import _filter, _measurement, factored_init

_LANE = 128
_BLOCK_SLOTS = 1024  # above this many slots a thread runs several, from scratch
_DTYPE_CODES = {torch.float32: 0, torch.float64: 1}


def _pack_params(spec: ModelSpec, params):
    """(D, npar) rows [Z | d | Φ | δ | Ω | σ² | β₀ | S₀] and the (D,)
    ``fac_ok`` flags, from the one shared ``particle.factored_init``; Ω is
    propagated as chol_Om chol_Omᵀ, as the filter does."""
    D = params.shape[0]
    kp = unpack_kalman(spec, params)
    Z, d = _measurement(spec, kp, params.dtype)
    state0, S0, chol_Om, fac_ok = factored_init(spec, kp, params.dtype)
    Omq = chol_Om @ chol_Om.transpose(-1, -2)
    row = torch.cat([Z.reshape(D, -1), d.reshape(D, -1), kp.Phi.reshape(D, -1),
                     kp.delta.reshape(D, -1), Omq.reshape(D, -1), kp.obs_var.reshape(D, 1),
                     state0.beta.reshape(D, -1), S0.reshape(D, -1)], dim=1)
    return row, fac_ok


def _unpack_row(rows, N: int, Ms: int):
    """The kernel's view of the packed rows: (Z, d, Φ, δ, Ω, σ², β₀, S₀,
    φ_h, σ_h), each with the leading draw axis."""
    D = rows.shape[0]
    sizes = (N * Ms, N, Ms * Ms, Ms, Ms * Ms, 1, Ms, Ms * Ms, 1, 1)
    Z, d, Phi, delta, Om, ovar, b0, S0, svp, svs = torch.split(rows, sizes, dim=1)
    return (Z.reshape(D, N, Ms), d, Phi.reshape(D, Ms, Ms), delta, Om.reshape(D, Ms, Ms),
            ovar[:, 0], b0, S0.reshape(D, Ms, Ms), svp[:, 0], svs[:, 0])


class KernelInputs(NamedTuple):
    """What one launch reads and writes."""
    rows: torch.Tensor       # (D, npar) with φ_h, σ_h appended
    fac_ok: torch.Tensor     # (D,) bool
    panel: torch.Tensor      # (T, N)
    normals: torch.Tensor    # (D, T−1, P), particle axis contiguous
    uniforms: torch.Tensor   # (D, T−1)
    n_eff: int
    ess_threshold: float
    Ms: int
    out: torch.Tensor        # (D,)


def kernel_inputs(spec: ModelSpec, params, data, normals, uniforms, n_eff: int,
                  sv_phi, sv_sigma, ess_threshold: float) -> KernelInputs:
    """Pack a batch for the kernel: the per-draw rows with (φ_h, σ_h)
    appended (scalars or per-draw (D,) vectors), the panel as (T, N), the
    noise in the working type."""
    D = params.shape[0]
    dtype, device = params.dtype, params.device
    rows, fac_ok = _pack_params(spec, params)
    sv = torch.stack([torch.as_tensor(sv_phi, dtype=dtype, device=device).expand(D),
                      torch.as_tensor(sv_sigma, dtype=dtype, device=device).expand(D)], 1)
    rows = torch.cat([rows, sv], 1).contiguous()
    normals = normals.to(dtype)  # in the working type already: the same view
    if normals.stride(-1) != 1:
        normals = normals.contiguous()
    return KernelInputs(rows, fac_ok, data.T.contiguous(), normals,
                        uniforms.to(dtype), n_eff, float(ess_threshold),
                        spec.state_dim, torch.empty(D, dtype=dtype, device=device))


def _finish(total, fac_ok):
    return torch.where(fac_ok & torch.isfinite(total), total,
                       torch.full_like(total, -math.inf))


def reference(inputs: KernelInputs) -> torch.Tensor:
    """The plain version on packed inputs: ``particle._filter`` over the D
    draws and P slots, the first ``n_eff`` live."""
    reference.calls += 1
    T, N = inputs.panel.shape
    Z, d, Phi, delta, Om, ovar, b0, S0, svp, svs = _unpack_row(inputs.rows, N, inputs.Ms)
    total, _ = _filter(Z, d, Phi, delta, Om, ovar, b0, S0, inputs.panel.T,
                       inputs.normals, inputs.uniforms, inputs.n_eff, svp, svs,
                       inputs.ess_threshold)
    return _finish(total, inputs.fac_ok)


reference.calls = 0


#: ``launch``'s layouts: None picks by the batch, the others force one
_LAYOUTS = {None: 0, "block": 1, "cluster": 2}
_LAYOUT_NAMES = {1: "block", 2: "cluster", 3: "multi"}


def _scratch(inputs: KernelInputs):
    """The state scratch of the kernel above 1,024 slots, (D, 2·RW + 2, P)
    with RW = Ms + Ms(Ms+1)/2 + 1; None at or below."""
    P = inputs.normals.shape[-1]
    if P <= _BLOCK_SLOTS:
        return None
    Ms, out = inputs.Ms, inputs.out
    rw = Ms + Ms * (Ms + 1) // 2 + 1
    return torch.empty((out.shape[0], 2 * rw + 2, P), dtype=out.dtype, device=out.device)


def launch_args(inputs: KernelInputs, scratch=None) -> tuple:
    """The C entry point's arguments up to ``out``, in its order."""
    D, npar = inputs.rows.shape
    T, N = inputs.panel.shape
    nz, us = inputs.normals, inputs.uniforms
    return (_DTYPE_CODES[inputs.out.dtype], inputs.Ms, D, N, T, nz.shape[-1], inputs.n_eff,
            npar, nz.stride(0), nz.stride(1), us.stride(0), us.stride(1),
            ctypes.c_double(inputs.ess_threshold * inputs.n_eff),
            ctypes.c_double(-math.log(float(inputs.n_eff))),
            inputs.rows.data_ptr(), inputs.panel.data_ptr(), nz.data_ptr(), us.data_ptr(),
            None if scratch is None else scratch.data_ptr(), inputs.out.data_ptr())


def _layout_code(layout) -> int:
    if layout not in _LAYOUTS:
        raise ValueError(f"layout must be one of {list(_LAYOUTS)}; got {layout!r}")
    return _LAYOUTS[layout]


def launch(inputs: KernelInputs, layout=None) -> torch.Tensor:
    """One launch of the CUDA kernel on PyTorch's current stream; returns the
    (D,) logliks with the ``fac_ok`` sentinel applied.  Above 1,024 slots it
    allocates the kernel's state scratch.  ``layout`` None lets the kernel
    pick by the batch (a thread-block cluster a draw while the batch's
    clusters fit the card at once, else a block a draw); "block" or
    "cluster" forces one, so that tests can hold the two against each other.
    Raises if the launch is refused."""
    code = _layout_code(layout)
    out = inputs.out
    lib = load("fused_pf")
    with torch.cuda.device(out.device):
        stream = torch.cuda.current_stream(out.device).cuda_stream
        err = lib.yfm_fused_pf(*launch_args(inputs, _scratch(inputs)), code, stream)
    if err != 0:
        raise RuntimeError(f"fused_pf kernel launch failed: cudaError {err}")
    pf_loglik_batch.launches += 1
    return _finish(out, inputs.fac_ok)


def layout_of(inputs: KernelInputs) -> str:
    """The layout ``launch`` picks for these inputs on their card: "block",
    "cluster" or "multi" (several slots a thread)."""
    D, npar = inputs.rows.shape
    with torch.cuda.device(inputs.out.device):
        code = load("fused_pf").yfm_fused_pf_layout(
            _DTYPE_CODES[inputs.out.dtype], inputs.Ms, D, inputs.panel.shape[1],
            inputs.normals.shape[-1], npar)
    if code < 0:
        raise RuntimeError(f"fused_pf layout query failed: cudaError {-code}")
    return _LAYOUT_NAMES[code]


def _prepare(spec: ModelSpec, params_batch, data, normals, uniforms, n_particles,
             sv_phi, sv_sigma, ess_threshold, device):
    """The JAX entry point's three refusals and the packing."""
    if not spec.has_constant_measurement:
        raise ValueError(f"fused PF kernel supports the constant-measurement kalman "
                         f"families, not {spec.family!r}")
    params = config.as_tensor(params_batch, device, spec.dtype)
    if params.ndim != 2 or params.shape[1] != spec.n_params:
        raise ValueError(f"params_batch must be (D, {spec.n_params}); "
                         f"got {tuple(params.shape)}")
    data = config.as_tensor(data, params.device, spec.dtype)
    normals = config.as_tensor(normals, params.device)
    uniforms = config.as_tensor(uniforms, params.device)
    D = params.shape[0]
    T = data.shape[1]
    P = normals.shape[-1]
    if P % _LANE:
        raise ValueError(f"particle count must be a multiple of {_LANE}")
    if tuple(normals.shape) != (D, T - 1, P) or tuple(uniforms.shape) != (D, T - 1):
        raise ValueError(
            f"noise shapes must be ({D}, {T - 1}, {P}) / ({D}, {T - 1}); "
            f"got {tuple(normals.shape)} / {tuple(uniforms.shape)}")
    n_eff = P if n_particles is None else int(n_particles)
    if not 0 < n_eff <= P:
        raise ValueError(f"n_particles must be in (0, {P}]; got {n_eff}")
    return kernel_inputs(spec, params, data, normals, uniforms, n_eff, sv_phi, sv_sigma,
                         ess_threshold)


def pf_loglik_batch_reference(spec: ModelSpec, params_batch, data, normals, uniforms,
                              n_particles=None, sv_phi=0.95, sv_sigma=0.2,
                              ess_threshold=0.5, device=None):
    """The plain version of :func:`pf_loglik_batch` on any device."""
    return reference(_prepare(spec, params_batch, data, normals, uniforms, n_particles,
                              sv_phi, sv_sigma, ess_threshold, device))


def pf_loglik_batch(spec: ModelSpec, params_batch, data, normals, uniforms,
                    n_particles=None, sv_phi=0.95, sv_sigma=0.2, ess_threshold=0.5,
                    device=None):
    """SV marginal loglik for a batch of draws, (D,), in the spec's float type.

    ``normals`` (D, T−1, P) / ``uniforms`` (D, T−1) are the common-noise
    arrays (P a multiple of 128; an expanded draw axis is read in place).
    ``n_particles`` ≤ P live slots (default P): the run equals
    the ``n_particles``-particle filter fed ``normals[..., :n_particles]``.
    ``sv_phi``/``sv_sigma``: scalars or per-draw (D,) vectors.  The −Inf
    sentinel covers failed factorizations and non-finite paths.  Numpy input
    goes to ``device`` (``None`` means CUDA); tensors stay where they are."""
    inputs = _prepare(spec, params_batch, data, normals, uniforms, n_particles, sv_phi,
                      sv_sigma, ess_threshold, device)
    dev = inputs.out.device
    if dev.type == "cpu":
        return reference(inputs)
    if dev.type != "cuda":
        raise ValueError(f"no fused kernel for device {dev}")
    return launch(inputs)


#: kernel launches since the count was last set to 0
pf_loglik_batch.launches = 0
