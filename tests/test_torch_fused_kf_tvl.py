"""The port's TVλ differentiable fused loglik (K3f/K3b) against JAX.

On the CPU ``batched_loglik_diff`` runs the kernels' plain versions,
``forward_reference_tvl`` and ``adjoint_reference_tvl``: the hand-derived
step adjoint, whose row part is ``tvl_rows_adjoint`` (not autograd).  All
in float64, at N=6 maturities (test_pallas_grad.py's), under both
``exact_jacobian`` settings:

- the row build and its adjoint against JAX's: rtol 1e-12 on each value,
  with an atol of 1e-12 times the largest entry of the row (or of β̄),
  since an entry that is a sum of terms of both signs keeps only the
  precision of its largest term, in JAX as here;
- value and gradient through ``torch.autograd.grad`` against
  ``jax.value_and_grad`` of the JAX univariate engine at
  tests/test_pallas_grad.py's tolerances (value rtol 1e-9, atol 1e-8;
  gradient rtol 1e-6, atol 1e-7);
- once, against the Pallas kernel ``_core_tvl`` in interpret mode.

The CUDA kernels run only on the card: tests/test_torch_cuda.py and
chip_smoke.py hold them against these plain versions there.
"""

import dataclasses
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)  # tiny tensors; leave the cores to the other test workers

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import yieldfactormodels_jl_tpu as J  # noqa: E402
import yieldfactormodels_jl_tpu_torch as P  # noqa: E402
from yieldfactormodels_jl_tpu.models import kalman as jax_kalman  # noqa: E402
from yieldfactormodels_jl_tpu.ops import pallas_kf, pallas_kf_grad  # noqa: E402
from yieldfactormodels_jl_tpu_torch.ops import fused_kf_grad as G  # noqa: E402
from tests.test_torch_fused_kf_grad import (GRAD_TOL, MATS, VALUE_TOL,  # noqa: E402
                                            _jax_value_and_grad, _panel, _params,
                                            _port_value_and_grad)

F64 = torch.float64
ROW_TOL = 1e-12


@functools.lru_cache(maxsize=None)
def _specs(exact):
    js, _ = J.create_model("TVλ", MATS, float_type="float64")
    ts, _ = P.create_model("TVλ", MATS, float_type="float64")
    return (dataclasses.replace(js, exact_jacobian=exact),
            dataclasses.replace(ts, exact_jacobian=exact))


def _close(got, ref, what):
    """rtol ROW_TOL with an atol of ROW_TOL × the row's largest entry."""
    got, ref = np.asarray(got), np.asarray(ref)
    scale = np.abs(ref).reshape(ref.shape[0], -1).max(1)
    scale = scale.reshape((-1,) + (1,) * (ref.ndim - 1))
    err = np.abs(got - ref)
    assert (err <= ROW_TOL * (np.abs(ref) + scale)).all(), (
        f"{what}: max error / scale {(err / scale).max():.3e}")


def _betas(lams, rng):
    """Predicted states near the TVλ fit's (level 5, slope −1, curvature
    0.5), one per λ = 1e-2 + e^{β₃}."""
    B = len(lams)
    beta = np.stack([5 + 0.1 * rng.standard_normal(B), -1 + 0.1 * rng.standard_normal(B),
                     0.5 + 0.1 * rng.standard_normal(B),
                     np.log(np.asarray(lams) - 1e-2)], axis=1)
    return beta


def _port_rows(beta, mats, exact, Zbar, jbbar):
    b, m = torch.tensor(beta), torch.tensor(mats)
    Z, jb = G.tvl_rows_reference(b, m, exact)
    bbar = G.tvl_rows_adjoint(b, m, exact, torch.tensor(Zbar), torch.tensor(jbbar))
    return Z.numpy(), jb.numpy(), bbar.numpy()


def _jax_rows(build, beta, Zbar, jbbar):
    """(Z, jb) of ``build`` (one β → ((N, 4), (N,))) and its jax.vjp, per row."""
    out = []
    for k in range(beta.shape[0]):
        (Z, jb), vjp = jax.vjp(build, jnp.asarray(beta[k]))
        out.append((np.asarray(Z), np.asarray(jb),
                    np.asarray(vjp((jnp.asarray(Zbar[k]), jnp.asarray(jbbar[k])))[0])))
    return [np.stack(x) for x in zip(*out)]


@pytest.mark.parametrize("exact", [False, True])
def test_tvl_rows_and_adjoint_match_jax(exact, rng):
    """Against jax.vjp of the JAX package's two TVλ row builds, over λ from
    0.05 to 1.2 and τ from 0.25 to 30:

    - ``pallas_kf.tvl_rows`` where λτ ≤ 10.  That build recovers e^{−λτ}
      as z₂ − z₃, which keeps about 1e-16/(λτ e^{−λτ}) of relative
      precision: 2e-13 at λτ = 10, 1e-2 at λτ = 36.  Beyond λτ = 10 it is
      not a 1e-12 reference.
    - the univariate engine's ``_tvl_measurement``, which takes e^{−λτ} by
      exp as the port and its kernels do, on the whole grid (its Z and
      jb = jac·β₃)."""
    _, ts = _specs(exact)
    lams = [0.05, 0.3, 0.6, 1.2]
    beta = _betas(lams, rng)
    mats = np.array([0.25, 1.0, 3.0, 7.0, 15.0, 30.0])
    Zbar = rng.uniform(0.5, 1.5, (len(lams), len(mats), 4))
    jbbar = rng.uniform(0.5, 1.5, (len(lams), len(mats)))
    Z, jb, bbar = _port_rows(beta, mats, exact, Zbar, jbbar)

    def univariate(b):
        Zj, _ = jax_kalman._tvl_measurement(ts, b, jnp.asarray(mats))
        return Zj, Zj[:, 3] * b[3]

    ref = _jax_rows(univariate, beta, Zbar, jbbar)
    for got, r, what in zip((Z, jb, bbar), ref, ("Z", "jb", "β̄")):
        _close(got, r, f"{what} vs the univariate engine's rows")

    for k, lam in enumerate(lams):
        keep = lam * mats <= 10.0
        sub = mats[keep]

        def pallas(b, sub=tuple(sub)):
            rows = pallas_kf.tvl_rows(b, sub, exact)
            return jnp.stack([jnp.stack(z) for z, _ in rows]), jnp.stack([j for _, j in rows])

        Zs, jbs, bbars = _port_rows(beta[k:k + 1], sub, exact, Zbar[k:k + 1, keep],
                                    jbbar[k:k + 1, keep])
        ref = _jax_rows(pallas, beta[k:k + 1], Zbar[k:k + 1, keep], jbbar[k:k + 1, keep])
        for got, r, what in zip((Zs, jbs, bbars), ref, ("Z", "jb", "β̄")):
            _close(got, r, f"λ={lam}: {what} vs pallas_kf.tvl_rows")


@pytest.mark.parametrize("exact", [False, True])
@pytest.mark.parametrize("window", ["shared", "per_draw"])
def test_value_and_grad_match_jax(exact, window, rng):
    """The plain K3f value against the JAX univariate loss and the _TvlCore
    gradient against its jax.grad: an interior NaN column, a NaN forecast
    tail (shared window (2, T−1)) or per-draw windows."""
    js, ts = _specs(exact)
    B, T = 3, 18
    p = _params(js, B, rng)
    if window == "shared":
        data = _panel(rng, T, nan_tail=3, nan_interior=True)
        start, end, kw = 2, T - 1, {"start": 2, "end": T - 1}
    else:
        data = _panel(rng, T, nan_interior=True)
        start, end = [0, 2, 5], [18, 12, 14]
        kw = {"starts": torch.tensor(start), "ends": torch.tensor(end)}
    calls = (G.forward_reference_tvl.calls, G.adjoint_reference_tvl.calls)
    got_v, got_g = _port_value_and_grad(ts, p, data, **kw)
    assert (G.forward_reference_tvl.calls, G.adjoint_reference_tvl.calls) == (
        calls[0] + 1, calls[1] + 1)
    ref_v, ref_g = _jax_value_and_grad(js, p, data, start, end)
    np.testing.assert_allclose(got_v, ref_v, **VALUE_TOL)
    np.testing.assert_allclose(got_g, ref_g, **GRAD_TOL)


def test_tvl_core_gradcheck(rng):
    """Finite differences of the plain forward against the plain adjoint,
    through the autograd.Function, for its six differentiable inputs."""
    _, ts = _specs(True)
    T = 5
    p = torch.tensor(_params(ts, 2, rng), dtype=F64)
    data = torch.tensor(_panel(rng, T), dtype=F64)
    data[1, 2] = float("nan")
    args = G.core_inputs(ts, p, data, 0, T)
    masks = torch.tensor([[1, 0], [1, 1], [1, 1], [1, 1], [1, 0]], dtype=torch.uint8)
    inputs = [x.detach().clone().requires_grad_(True) for x in args[:6]]
    assert torch.autograd.gradcheck(
        lambda *xs: G._TvlCore.apply(*xs, data, masks, None, args[9], args[10]),
        inputs, eps=1e-6, atol=1e-5, rtol=1e-4)


def test_invalid_draw_is_gated(rng):
    """A draw with a negative measurement variance has f ≤ 0 → −inf and a zero
    gradient row; neither it nor a NaN draw moves its neighbours' values or
    gradients (rtol 1e-12: the same rows computed in a batch of another
    size)."""
    _, ts = _specs(False)
    T = 12
    p = _params(ts, 3, rng)
    data = _panel(rng, T)
    alone_v, alone_g = _port_value_and_grad(ts, p[[0, 2]], data)
    neg = p.copy()
    neg[1, ts.layout["obs_var"][0]] = -5.0
    nan = p.copy()
    nan[1] = np.nan
    for bad in (neg, nan):
        v, g = _port_value_and_grad(ts, bad, data)
        assert v[1] == -np.inf and np.isfinite(v[[0, 2]]).all()
        np.testing.assert_allclose(v[[0, 2]], alone_v, rtol=1e-12)
        np.testing.assert_allclose(g[[0, 2]], alone_g, rtol=1e-12, atol=1e-12)
        if bad is neg:
            assert np.array_equal(g[1], np.zeros_like(g[1]))


def test_matches_the_pallas_kernel_in_interpret_mode(rng):
    """Directly against pallas_kf_grad.batched_loglik_diff on TVλ, whose
    backward runs jax.vjp of each step inside the kernel, in interpret mode
    as the JAX package's own tests run it on the CPU; on 3 maturities and
    T = 8, since the interpret-mode kernels unroll over them and their
    compile dominates."""
    mats = tuple(np.array([3, 36, 360]) / 12.0)
    js, _ = J.create_model("TVλ", mats, float_type="float64")
    ts, _ = P.create_model("TVλ", mats, float_type="float64")
    T = 8
    p = _params(js, 2, rng)
    data = 0.5 * rng.standard_normal((len(mats), T)) + 4.0
    data[:, -2:] = np.nan

    def total(pb):
        return jnp.sum(pallas_kf_grad.batched_loglik_diff(
            js, pb, data, 1, T - 1, interpret=True, dtype=jnp.float64))

    ref_v, ref_g = jax.jit(jax.value_and_grad(total))(jnp.asarray(p))
    got_v, got_g = _port_value_and_grad(ts, p, data, start=1, end=T - 1)
    np.testing.assert_allclose(got_v.sum(), float(ref_v), **VALUE_TOL)
    np.testing.assert_allclose(got_g, np.asarray(ref_g), **GRAD_TOL)
