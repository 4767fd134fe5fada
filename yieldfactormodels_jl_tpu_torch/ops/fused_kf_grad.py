"""Differentiable fused Kalman log-likelihood: hand-written CUDA forward and
adjoint kernels behind a ``torch.autograd.Function``.

Counterpart of ``yieldfactormodels_jl_tpu/ops/pallas_kf_grad.py`` for the
constant-measurement families (DNS "1C", AFNS).  The forward kernel (K2f,
``csrc/fused_kf_grad.cu``) runs the univariate recursion of K1 and saves the
(β, P) carry every S ≈ √T steps; the adjoint kernel (K2b) recomputes each
segment from its checkpoint and sweeps it in reverse, accumulating

  (∂Z, ∂d, ∂Φ, ∂δ, ∂Ω, ∂σ², ∂β₀, ∂P₀)

with the hand-derived adjoints of the rank-1 measurement update

    zP = Pᵀz,  f = z·zP + σ²,  v = y − d − z·b,  K = zP/f,
    b' = b + K v,  P' = P − K zPᵀ,  ll += −½(log f + v²/f + log 2π):

    K̄ = −P̄' zP + v b̄',          z̄P = −P̄'ᵀ K + K̄/f + f̄ z
    v̄ = K·b̄' − w v/f,           f̄ = −(K̄·K)/f − ½ w (1/f − v²/f²)
    b̄ = b̄' − fin·v̄·z,           P̄ = P̄' + z z̄Pᵀ
    z̄ += −fin·v̄·b + f̄·zP + P z̄P,  d̄ += −fin·v̄,  σ̄² += f̄

(w = cotangent × observed × contributing) and of the transition
β⁺ = δ + Φβ_m, P⁺ = ΦP_mΦᵀ + Ω:

    δ̄ += β̄⁺,  Ω̄ += P̄⁺,  Φ̄ += β̄⁺β_mᵀ + (P̄⁺ + P̄⁺ᵀ) Φ P_m,
    β̄_m = Φᵀβ̄⁺,  P̄_m = ΦᵀP̄⁺Φ.

``forward_reference`` and ``adjoint_reference`` are the plain versions of the
two kernels, batched over draws as torch ops: the adjoint is the CPU-testable
definition of K2b's algebra.  Both keep the pre-update state of every rank-1
update of a step instead of rebuilding it by inverting the update as the
Pallas kernel does (``P_pre = P_post + K zPᵀ``): the inversion loses
accuracy in float32 over N updates, the stored state is exact, and the
algebra is otherwise the same.

As in the JAX package, unpacking, the unconditional start and the Z/d set-up
(with the AFNS yield adjustment) stay torch ops outside the Function, so
their gradients come from autograd.
"""

from __future__ import annotations

import math

import torch

from ..models.kalman import (init_state, loglik_contrib_mask, measurement_setup,
                             observed_mask)
from ..models.params import unpack_kalman
from ..models.specs import ModelSpec
from . import fused_kf
from ._build import load

_LOG_2PI = math.log(2.0 * math.pi)


def _seg(T: int):
    """(segment length, #checkpoints) ≈ √T blocking."""
    S = max(1, int(math.ceil(math.sqrt(T))))
    return S, -(-T // S)


# ---------------------------------------------------------------------------
# plain versions (batched torch ops)
# ---------------------------------------------------------------------------

def _step_masks(masks, win, B, T, device):
    """(B, T) in-window and loglik-contributing masks, from the shared (T, 2)
    ``masks`` or from the (2, B) per-draw window ``win``."""
    if win is None:
        m = masks.to(device=device, dtype=torch.bool)
        return m[None, :, 0].expand(B, T), m[None, :, 1].expand(B, T)
    t = torch.arange(T, device=device)
    lo, hi = win[0].to(device)[:, None], win[1].to(device)[:, None]
    return (t >= lo) & (t < hi), (t >= lo + 1) & (t <= hi - 2)


def _chain(Z, d, ovar, y, fin, b, P, keep=None):
    """The N rank-1 measurement updates of one step.  ``y`` (N,) is the data
    column with NaNs replaced, ``fin`` its per-cell finiteness (Python
    bools).  Returns (b_u, P_u symmetrized, ll_step, ok); when ``keep`` is a
    list, each update's pre-state (b, P) is appended to it."""
    fs, vs = [], []
    for i in range(Z.shape[1]):
        if keep is not None:
            keep.append((b, P))
        z = Z[:, i]
        zP = (z[:, None, :] @ P)[:, 0]
        f = (zP * z).sum(-1) + ovar
        fsafe = torch.where(f > 0, f, torch.ones_like(f))
        v = y[i] - d[:, i] - (z * b).sum(-1) if fin[i] else torch.zeros_like(f)
        K = zP / fsafe[:, None]
        b = b + K * v[:, None]
        P = P - K[:, :, None] * zP[:, None, :]
        fs.append(f)
        vs.append(v)
    # the step's terms at once: (N, B)
    f, v = torch.stack(fs), torch.stack(vs)
    ok = ((f > 0) & torch.isfinite(f)).all(0)
    fsafe = torch.where(f > 0, f, torch.ones_like(f))
    ll = -0.5 * (torch.log(fsafe) + v * v / fsafe + _LOG_2PI).sum(0)
    return b, 0.5 * (P + P.transpose(-1, -2)), ll, ok


def _transition(Phi, delta, Om, b_m, P_m):
    return (delta + (Phi @ b_m[..., None])[..., 0],
            Phi @ P_m @ Phi.transpose(-1, -2) + Om)


def _columns(data):
    """(data with NaNs as 0, per-cell finiteness as Python lists, per-step
    all-finite flags): the panel is shared by every draw, so its missing
    pattern is read once."""
    fin = torch.isfinite(data)
    return (torch.where(fin, data, torch.zeros_like(data)),
            fin.T.tolist(), fin.all(0).tolist())


def forward_reference(Z, d, Phi, delta, Om, ovar, beta0, P0, data, masks, win):
    """Plain version of K2f: (ll (B,), checkpoints (B, nC, Ms+Ms²)).

    ``Z`` (B, N, Ms), ``d`` (B, N), ``Phi``/``Om`` (B, Ms, Ms), ``delta``/
    ``beta0`` (B, Ms), ``ovar`` (B,), ``P0`` (B, Ms, Ms), ``data`` (N, T);
    ``masks`` (T, 2) observed/contributing for a shared window, or ``win``
    (2, B) per-draw [start, end).  The checkpoints hold the predicted
    (β, P) at t = 0, S, 2S, …  Differentiable by autograd (the tests use
    that as a witness for the adjoint)."""
    forward_reference.calls += 1
    B, Ms = delta.shape
    T = data.shape[1]
    S, _ = _seg(T)
    obs_m, con_m = _step_masks(masks, win, B, T, Z.device)
    ysafe, fin, fin_all = _columns(data)
    beta, P = beta0, P0
    ll = torch.zeros_like(ovar)
    chk = []
    for t in range(T):
        if t % S == 0:
            chk.append(torch.cat([beta, P.reshape(B, Ms * Ms)], dim=1))
        obs = obs_m[:, t] & fin_all[t]
        if fin_all[t] and bool(obs.any()):
            b_u, P_u, ll_step, ok = _chain(Z, d, ovar, ysafe[:, t], fin[t], beta, P)
            b_m = torch.where(obs[:, None], b_u, beta)
            P_m = torch.where(obs[:, None, None], P_u, P)
            ll_t = torch.where(ok, ll_step, torch.full_like(ll_step, -math.inf))
            ll = ll + torch.where(obs & con_m[:, t], ll_t, torch.zeros_like(ll_t))
        else:  # predict-only for every draw: the chain's result is discarded
            b_m, P_m = beta, P
        beta, P = _transition(Phi, delta, Om, b_m, P_m)
    ll = torch.where(torch.isfinite(ll), ll, torch.full_like(ll, -math.inf))
    return ll, torch.stack(chk, dim=1)


forward_reference.calls = 0


def _step_adjoint(Z, d, Phi, ovar, y, fin, obs, w, beta, P, bbar_n, Pbar_n, acc):
    """Adjoint of one step, given its incoming state (β, P) and the adjoint
    (β̄⁺, P̄⁺) of the state it hands on; accumulates into ``acc`` and returns
    the adjoint of (β, P)."""
    gZ, gd, gPhi, gdelta, gOm, govar = acc
    keep = []
    observed = bool(obs.any())
    b_m, P_m = beta, P
    if observed:  # else every draw's step is predict-only: no chain to undo
        b_u, P_u, _, _ = _chain(Z, d, ovar, y, fin, beta, P, keep)
        b_m = torch.where(obs[:, None], b_u, beta)
        P_m = torch.where(obs[:, None, None], P_u, P)

    # transition
    gdelta += bbar_n
    gOm += Pbar_n
    PbS = Pbar_n + Pbar_n.transpose(-1, -2)
    gPhi += bbar_n[:, :, None] * b_m[:, None, :] + PbS @ (Phi @ P_m)
    bbar_m = (Phi.transpose(-1, -2) @ bbar_n[..., None])[..., 0]
    Pbar_m = Phi.transpose(-1, -2) @ Pbar_n @ Phi
    if not observed:
        return bbar_m, Pbar_m

    # blend β_m = obs ? β_u : β, then the symmetrization of P_u
    obs_f = obs.to(beta.dtype)
    bbar = obs_f[:, None] * bbar_m
    bbar_pre = (1.0 - obs_f)[:, None] * bbar_m
    Pbar_u = obs_f[:, None, None] * Pbar_m
    Pbar_pre = (1.0 - obs_f)[:, None, None] * Pbar_m
    Pbar = 0.5 * (Pbar_u + Pbar_u.transpose(-1, -2))

    # the N rank-1 updates, last first
    for i in reversed(range(Z.shape[1])):
        b_pre, P_pre = keep[i]
        z = Z[:, i]
        zP = (z[:, None, :] @ P_pre)[:, 0]
        f = (zP * z).sum(-1) + ovar
        fsafe = torch.where(f > 0, f, torch.ones_like(f))
        pred = (z * b_pre).sum(-1) + d[:, i]
        v = y[i] - pred if fin[i] else torch.zeros_like(pred)
        inv_f = 1.0 / fsafe
        K = zP * inv_f[:, None]
        Kbar = -(Pbar @ zP[..., None])[..., 0] + v[:, None] * bbar
        zPbar = -(Pbar.transpose(-1, -2) @ K[..., None])[..., 0] + Kbar * inv_f[:, None]
        vbar = (K * bbar).sum(-1) - w * v * inv_f
        fbar = (-(Kbar * K).sum(-1) * inv_f
                - 0.5 * w * (inv_f - v * v * inv_f * inv_f))
        zPbar = zPbar + fbar[:, None] * z
        govar += fbar
        if fin[i]:
            bbar = bbar - vbar[:, None] * z
            gd[:, i] -= vbar
            gZ[:, i] -= vbar[:, None] * b_pre
        gZ[:, i] += fbar[:, None] * zP + (P_pre @ zPbar[..., None])[..., 0]
        Pbar = Pbar + z[:, :, None] * zPbar[:, None, :]
    return bbar + bbar_pre, Pbar + Pbar_pre


def adjoint_reference(Z, d, Phi, delta, Om, ovar, data, masks, win, chk, g):
    """Plain version of K2b: the gradients (∂Z, ∂d, ∂Φ, ∂δ, ∂Ω, ∂σ², ∂β₀,
    ∂P₀) of Σ g·ll, in the inputs' shapes.  ``chk`` comes from
    :func:`forward_reference`; ``g`` (B,) is the cotangent, already zero
    for draws whose loglik is not finite: their rows come back zero."""
    adjoint_reference.calls += 1
    B, N, Ms = Z.shape
    T = data.shape[1]
    S, nC = _seg(T)
    obs_m, con_m = _step_masks(masks, win, B, T, Z.device)
    ysafe, fin, fin_all = _columns(data)
    acc = (torch.zeros_like(Z), torch.zeros_like(d), torch.zeros_like(Phi),
           torch.zeros_like(delta), torch.zeros_like(Om), torch.zeros_like(ovar))
    bbar = torch.zeros_like(delta)
    Pbar = torch.zeros_like(Phi)
    zero = torch.zeros_like(g)
    for c in reversed(range(nC)):
        beta, P = chk[:, c, :Ms], chk[:, c, Ms:].reshape(B, Ms, Ms)
        ts = range(c * S, min((c + 1) * S, T))
        states = []
        for t in ts[:-1]:  # recompute the segment's incoming states
            states.append((beta, P))
            obs = obs_m[:, t] & fin_all[t]
            b_m, P_m = beta, P
            if bool(obs.any()):
                b_u, P_u, _, _ = _chain(Z, d, ovar, ysafe[:, t], fin[t], beta, P)
                b_m = torch.where(obs[:, None], b_u, beta)
                P_m = torch.where(obs[:, None, None], P_u, P)
            beta, P = _transition(Phi, delta, Om, b_m, P_m)
        states.append((beta, P))
        for t in reversed(ts):
            obs = obs_m[:, t] & fin_all[t]
            w = torch.where(obs & con_m[:, t], g, zero)
            beta, P = states[t - c * S]
            bbar, Pbar = _step_adjoint(Z, d, Phi, ovar, ysafe[:, t], fin[t], obs,
                                       w, beta, P, bbar, Pbar, acc)
    live = g != 0
    return tuple(torch.where(live.reshape((B,) + (1,) * (x.ndim - 1)), x,
                             torch.zeros_like(x))
                 for x in (*acc, bbar, Pbar))


adjoint_reference.calls = 0


# ---------------------------------------------------------------------------
# the CUDA kernels
# ---------------------------------------------------------------------------

def lay_out(Z, d, Phi, delta, Om, ovar, beta0, P0, data, masks, win):
    """The kernels' buffers for the arguments of :func:`forward_reference`:
    per-draw tensors draw-minor (D, B), the panel as (T, N), in the C entry
    points' order."""
    B = Z.shape[0]
    return ([fused_kf._lay(x, B) for x in (Z, d, Phi, delta, Om, ovar, beta0, P0)]
            + [data.T.contiguous(), masks.contiguous(),
               None if win is None else win.contiguous()])


def _ptrs(bufs):
    return [None if x is None else x.data_ptr() for x in bufs]


def _sizes(bufs):
    """(dtype code, Ms, B, N, T, S, nC) of a :func:`lay_out` buffer list."""
    Ms, B = bufs[3].shape
    T, N = bufs[8].shape
    if Ms * Ms != bufs[2].shape[0] or bufs[0].shape != (N * Ms, B):
        raise ValueError("fused_kf_grad: inconsistent buffer shapes")
    return (fused_kf._DTYPE_CODES[bufs[0].dtype], Ms, B, N, T) + _seg(T)


def launch_forward(bufs):
    """One launch of K2f on PyTorch's current stream, on :func:`lay_out`
    buffers (CUDA, one float type).  Returns (ll (B,), checkpoints
    (nC·(Ms+Ms²), B) draw-minor); raises if the launch is refused."""
    code, Ms, B, N, T, S, nC = _sizes(bufs)
    dev, dtype = bufs[0].device, bufs[0].dtype
    out = torch.empty(B, dtype=dtype, device=dev)
    chk = torch.empty(nC * (Ms + Ms * Ms), B, dtype=dtype, device=dev)
    lib = load("fused_kf_grad")
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.yfm_kf_grad_fwd(code, Ms, B, N, T, S, *_ptrs(bufs),
                                  out.data_ptr(), chk.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"K2f (fused_kf_grad forward) launch failed: cudaError {err}")
    launch_forward.launches += 1
    return out, chk


launch_forward.launches = 0


def launch_backward(bufs, chk, g):
    """One launch of K2b on PyTorch's current stream: :func:`lay_out`
    buffers, the checkpoints of :func:`launch_forward` and the gated
    cotangent g (B,).  Returns the eight gradients (∂Z, ∂d, ∂Φ, ∂δ, ∂Ω, ∂σ²,
    ∂β₀, ∂P₀) draw-minor, (D, B) each.  The segment states and the
    per-update pre-states live in draw-minor scratch allocated here."""
    code, Ms, B, N, T, S, nC = _sizes(bufs)
    dev, dtype = bufs[0].device, bufs[0].dtype
    D = Ms + Ms * Ms
    rows = (N * Ms, N, Ms * Ms, Ms, Ms * Ms, 1, Ms, Ms * Ms)
    grads = [torch.empty(r, B, dtype=dtype, device=dev) for r in rows]
    seg = torch.empty(S * D, B, dtype=dtype, device=dev)
    pre = torch.empty(N * D, B, dtype=dtype, device=dev)
    ins = bufs[:6] + bufs[8:] + [chk, g.contiguous()]
    lib = load("fused_kf_grad")
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.yfm_kf_grad_bwd(code, Ms, B, N, T, S, nC, *_ptrs(ins),
                                  *_ptrs(grads + [seg, pre]), stream)
    if err != 0:
        raise RuntimeError(f"K2b (fused_kf_grad backward) launch failed: cudaError {err}")
    launch_backward.launches += 1
    return grads


launch_backward.launches = 0


class _KalmanCore(torch.autograd.Function):
    """ll = K2f(Z, d, Φ, δ, Ω, σ², β₀, P₀; data, masks, win), with K2b as its
    backward; the plain versions on CPU tensors.  The counterpart of
    ``pallas_kf_grad._core``'s ``custom_vjp``."""

    @staticmethod
    def forward(ctx, Z, d, Phi, delta, Om, ovar, beta0, P0, data, masks, win):
        args = (Z, d, Phi, delta, Om, ovar, beta0, P0, data, masks, win)
        if Z.device.type == "cuda":
            saved = lay_out(*args)
            ll, chk = launch_forward(saved)
        elif Z.device.type == "cpu":
            saved = args
            ll, chk = forward_reference(*args)
        else:
            raise ValueError(f"no fused kernel for device {Z.device}")
        ctx.shapes = [x.shape for x in args[:8]]
        ctx.save_for_backward(*saved, chk, ll)
        return ll

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, g):
        *saved, chk, ll = ctx.saved_tensors
        # where the forward hit the −Inf sentinel the loss is constant
        g = torch.where(torch.isfinite(ll), g, torch.zeros_like(g))
        if ll.is_cuda:
            grads = [x.T.reshape(shape) for x, shape in
                     zip(launch_backward(list(saved), chk, g), ctx.shapes)]
        else:
            grads = adjoint_reference(*saved[:6], *saved[8:], chk, g)
        return (*grads, None, None, None)


def core_inputs(spec: ModelSpec, params, data, start, end, starts=None, ends=None):
    """The arguments of :func:`forward_reference` for a (B, n_params) batch
    of constrained draws: unpacking, the unconditional start and the Z/d
    set-up as differentiable tensor ops, and the window masks."""
    kp = unpack_kalman(spec, params)
    state0 = init_state(spec, kp)
    Z, d = measurement_setup(spec, kp, params.dtype)
    if d is None:
        d = torch.zeros(params.shape[0], spec.N, dtype=params.dtype,
                        device=params.device)
    T = data.shape[1]
    masks = torch.stack([observed_mask(start, end, T, params.device),
                         loglik_contrib_mask(start, end, T, params.device)],
                        dim=1).to(torch.uint8)
    win = None if starts is None else torch.stack([starts, ends]).to(torch.int32)
    return (Z, d, kp.Phi, kp.delta, kp.Omega_state, kp.obs_var, state0.beta,
            state0.P, data, masks, win)


def batched_loglik_diff(spec: ModelSpec, params_batch, data, start=0, end=None,
                        starts=None, ends=None, device=None, dtype=None):
    """Differentiable fused loglik: (B, n_params) constrained draws → (B,).

    ``torch.autograd`` flows through K2b for the state-space tensors and
    through ordinary autograd for the unpacking and loading set-up.
    ``dtype`` defaults to float32 (the kernels' working type); float64 is
    accepted.  ``starts``/``ends``: optional (B,) per-draw windows; the
    scalar ``start``/``end`` are then ignored.  Numpy input goes to
    ``device`` (``None`` means CUDA); tensors stay where they are.  TVλ
    (state-dependent measurement) is not ported yet."""
    if spec.family == "kalman_tvl":
        raise NotImplementedError(
            "the TVλ adjoint is not ported to PyTorch yet; see ROADMAP.md "
            "Queue 2 K3f/K3b")
    if spec.family not in ("kalman_dns", "kalman_afns"):
        raise ValueError(f"differentiable fused kernel supports the kalman "
                         f"families, not {spec.family!r}")
    dtype = torch.float32 if dtype is None else dtype
    params, data, starts, ends = fused_kf._prepare(
        spec, params_batch, data, starts, ends, device, dtype)
    if end is None:
        end = data.shape[1]
    return _KalmanCore.apply(*core_inputs(spec, params, data, start, end,
                                          starts, ends))
