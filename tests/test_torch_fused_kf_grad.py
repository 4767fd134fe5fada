"""The port's differentiable fused loglik (K2f/K2b) against JAX.

On the CPU ``batched_loglik_diff`` runs the kernels' plain versions,
``forward_reference`` and ``adjoint_reference`` (the hand-derived adjoint,
not autograd of the forward).  Value and gradient through
``torch.autograd.grad`` are held against ``jax.value_and_grad`` of the JAX
univariate engine in float64 at tests/test_pallas_grad.py's tolerances:
value rtol 1e-9, atol 1e-8 (the same recursion summed in another order);
gradient rtol 1e-6, atol 1e-7 (a hand-derived adjoint against JAX's
autodiff of the same algebra, both in float64).  The CUDA kernels run only
on the card: tests/test_torch_cuda.py and chip_smoke.py hold them against
these plain versions there.
"""

import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)  # tiny tensors; leave the cores to the other test workers

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import yieldfactormodels_jl_tpu as J  # noqa: E402
import yieldfactormodels_jl_tpu_torch as P  # noqa: E402
from yieldfactormodels_jl_tpu.ops import pallas_kf_grad, univariate_kf  # noqa: E402
from yieldfactormodels_jl_tpu_torch.ops import fused_kf_grad  # noqa: E402

MATS = tuple(np.array([3, 12, 36, 84, 180, 360]) / 12.0)  # test_pallas_grad.py's
CPU = "cpu"
F64 = torch.float64
VALUE_TOL = {"rtol": 1e-9, "atol": 1e-8}
GRAD_TOL = {"rtol": 1e-6, "atol": 1e-7}


def _specs(code):
    js, _ = J.create_model(code, MATS, float_type="float64")
    ts, _ = P.create_model(code, MATS, float_type="float64")
    return js, ts


def _params(spec, B, rng):
    """Stationary constrained draws, jittered (test_pallas_grad.py's point)."""
    p = np.zeros((B, spec.n_params))
    if "gamma" in spec.layout:
        lo, hi = spec.layout["gamma"]
        p[:, lo:hi] = np.log(0.4) + 0.2 * rng.standard_normal((B, hi - lo))
    p[:, spec.layout["obs_var"][0]] = 0.01
    Ms = spec.state_dim
    k = spec.layout["chol"][0]
    for j in range(Ms):
        for i in range(j + 1):
            p[:, k] = (0.1 if i == j else 0.01) * (1 + 0.1 * rng.standard_normal())
            k += 1
    lo, hi = spec.layout["delta"]
    p[:, lo:hi] = 0.2 * rng.standard_normal((B, Ms))
    lo, hi = spec.layout["phi"]
    p[:, lo:hi] = (0.9 * np.eye(Ms)).reshape(-1) + 0.01 * rng.standard_normal((B, Ms * Ms))
    return p


def _panel(rng, T, nan_tail=0, nan_interior=False):
    data = 0.5 * rng.standard_normal((len(MATS), T)) + 4.0
    if nan_tail:
        data[:, -nan_tail:] = np.nan
    if nan_interior:
        data[2, T // 3] = np.nan  # partial NaN → whole column missing
    return data


@functools.lru_cache(maxsize=None)
def _jax_rows_vjp(js):
    """Jitted (value, cotangent-weighted gradient) of the JAX univariate loss
    of every row, each row with its own window: one compile per spec and
    shape, shared by the tests."""
    def rows(pb, data, starts, ends):
        return jax.vmap(lambda q, s, e: univariate_kf.get_loss(js, q, data, s, e))(
            pb, starts, ends)

    def value_and_vjp(pb, data, s, e, cot):
        vals, vjp = jax.vjp(lambda q: rows(q, data, s, e), pb)
        return vals, vjp(cot)[0]

    return jax.jit(value_and_vjp)


def _jax_value_and_grad(js, p, data, start, end, shape=(3, 18)):
    """The JAX univariate loss of every row and its gradient; ``start``/
    ``end`` are ints (one window) or per-row lists.  Rows and columns are
    padded to ``shape`` so that every call for a spec shares one compile:
    extra rows repeat the last draw and are dropped, extra columns are NaN
    and lie after every window's end, where they are predict-only steps that
    touch neither the loss nor its gradient."""
    B, T = p.shape[0], data.shape[1]
    Bp, Tp = max(B, shape[0]), max(T, shape[1])
    starts = np.broadcast_to(np.asarray(start, np.int32), (B,))
    ends = np.broadcast_to(np.asarray(end, np.int32), (B,))
    assert ends.max() <= T
    rows = np.concatenate([np.arange(B), np.full(Bp - B, B - 1)])
    data = np.concatenate([data, np.full((data.shape[0], Tp - T), np.nan)], axis=1)
    cot = jnp.asarray((np.arange(Bp) < B).astype(np.float64))
    vals, grad = _jax_rows_vjp(js)(jnp.asarray(p[rows]), jnp.asarray(data),
                                   jnp.asarray(starts[rows]), jnp.asarray(ends[rows]), cot)
    return np.asarray(vals)[:B], np.asarray(grad)[:B]


def _port_value_and_grad(ts, p, data, **kw):
    pt = torch.tensor(p, dtype=F64, requires_grad=True)
    vals = P.batched_loglik_diff(ts, pt, data, device=CPU, dtype=F64, **kw)
    (grad,) = torch.autograd.grad(vals.sum(), pt)
    return vals.detach().numpy(), grad.numpy()


@pytest.mark.parametrize("code", ["1C", "AFNS3", "AFNS5"])
def test_value_and_grad_match_jax(code, rng):
    """NaN forecast tail, an interior NaN cell and a window (2, T−1)."""
    js, ts = _specs(code)
    B, T = 3, 18
    p = _params(js, B, rng)
    data = _panel(rng, T, nan_tail=3, nan_interior=True)
    calls = (fused_kf_grad.forward_reference.calls, fused_kf_grad.adjoint_reference.calls)
    got_v, got_g = _port_value_and_grad(ts, p, data, start=2, end=T - 1)
    assert (fused_kf_grad.forward_reference.calls,
            fused_kf_grad.adjoint_reference.calls) == (calls[0] + 1, calls[1] + 1)
    ref_v, ref_g = _jax_value_and_grad(js, p, data, 2, T - 1)
    np.testing.assert_allclose(got_v, ref_v, **VALUE_TOL)
    np.testing.assert_allclose(got_g, ref_g, **GRAD_TOL)


@pytest.mark.parametrize("T", [7, 13])
def test_odd_T_covers_the_tail_segment(T, rng):
    """T not a multiple of the ⌈√T⌉ segment length: the last segment is short."""
    js, ts = _specs("1C")
    p = _params(js, 2, rng)
    data = _panel(rng, T)
    got_v, got_g = _port_value_and_grad(ts, p, data)
    ref_v, ref_g = _jax_value_and_grad(js, p, data, 0, T)
    np.testing.assert_allclose(got_v, ref_v, **VALUE_TOL)
    np.testing.assert_allclose(got_g, ref_g, **GRAD_TOL)


def test_per_draw_windows(rng):
    js, ts = _specs("AFNS3")
    T = 18
    p = _params(js, 3, rng)
    data = _panel(rng, T, nan_interior=True)
    starts, ends = [0, 2, 5], [18, 12, 14]
    got_v, got_g = _port_value_and_grad(ts, p, data, starts=torch.tensor(starts),
                                        ends=torch.tensor(ends))
    ref_v, ref_g = _jax_value_and_grad(js, p, data, starts, ends)
    np.testing.assert_allclose(got_v, ref_v, **VALUE_TOL)
    np.testing.assert_allclose(got_g, ref_g, **GRAD_TOL)


def test_invalid_draw_is_gated(rng):
    """A draw with a negative measurement variance has f ≤ 0 → −inf and a zero
    gradient row; neither it nor a NaN draw moves its neighbours' values or
    gradients (rtol 1e-12: the same rows computed in a batch of another
    size)."""
    _, ts = _specs("1C")
    T = 12
    p = _params(ts, 3, rng)
    data = _panel(rng, T)
    neg = p.copy()
    neg[1, ts.layout["obs_var"][0]] = -5.0
    v, g = _port_value_and_grad(ts, neg, data)
    assert v[1] == -np.inf and np.isfinite(v[[0, 2]]).all()
    assert np.array_equal(g[1], np.zeros_like(g[1]))
    alone_v, alone_g = _port_value_and_grad(ts, p[[0, 2]], data)
    np.testing.assert_allclose(v[[0, 2]], alone_v, rtol=1e-12)
    np.testing.assert_allclose(g[[0, 2]], alone_g, rtol=1e-12, atol=1e-12)
    bad = p.copy()
    bad[1] = np.nan
    v, g = _port_value_and_grad(ts, bad, data)
    assert v[1] == -np.inf
    np.testing.assert_allclose(v[[0, 2]], alone_v, rtol=1e-12)
    np.testing.assert_allclose(g[[0, 2]], alone_g, rtol=1e-12, atol=1e-12)


def test_matches_the_pallas_kernel_in_interpret_mode(rng):
    """Directly against pallas_kf_grad.batched_loglik_diff, run as the JAX
    package's own tests run it on the CPU; on 4 maturities, since the
    interpret-mode kernels unroll over them and their compile dominates."""
    mats = tuple(np.array([3, 36, 120, 360]) / 12.0)
    js, _ = J.create_model("1C", mats, float_type="float64")
    ts, _ = P.create_model("1C", mats, float_type="float64")
    T = 13
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


def test_kalman_core_gradcheck(rng):
    """Finite differences of the plain forward against the plain adjoint,
    through the autograd.Function, for all eight differentiable inputs."""
    from yieldfactormodels_jl_tpu_torch.models.kalman import init_state, measurement_setup
    from yieldfactormodels_jl_tpu_torch.models.params import unpack_kalman

    _, ts = _specs("AFNS3")
    T = 5
    p = torch.tensor(_params(ts, 2, rng), dtype=F64)
    kp = unpack_kalman(ts, p)
    st = init_state(ts, kp)
    Z, d = measurement_setup(ts, kp, F64)
    data = torch.tensor(_panel(rng, T), dtype=F64)
    data[1, 2] = float("nan")
    masks = torch.tensor([[1, 0], [1, 1], [1, 1], [1, 1], [1, 0]], dtype=torch.uint8)
    inputs = [x.detach().clone().requires_grad_(True) for x in
              (Z, d, kp.Phi, kp.delta, kp.Omega_state, kp.obs_var, st.beta, st.P)]
    assert torch.autograd.gradcheck(
        lambda *xs: fused_kf_grad._KalmanCore.apply(*xs, data, masks, None),
        inputs, eps=1e-6, atol=1e-5, rtol=1e-4)


def test_unsupported_families_and_devices(rng):
    _, tvl = _specs("TVλ")  # TVλ runs (K3f/K3b's plain versions on the CPU)
    v = P.batched_loglik_diff(tvl, _params(tvl, 2, rng), _panel(rng, 6), device=CPU)
    assert v.shape == (2,) and bool(torch.isfinite(v).all())
    ns, _ = P.create_model("NS", MATS, float_type="float64")
    with pytest.raises(ValueError, match="kalman families"):
        P.batched_loglik_diff(ns, np.zeros((2, ns.n_params)), _panel(rng, 6), device=CPU)
    _, ts = _specs("1C")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            P.batched_loglik_diff(ts, _params(ts, 2, rng), _panel(rng, 6))
    launches = (fused_kf_grad.launch_forward.launches, fused_kf_grad.launch_backward.launches)
    v = P.batched_loglik_diff(ts, _params(ts, 2, rng), _panel(rng, 6), device=CPU)
    assert v.dtype == torch.float32 and v.device.type == "cpu"
    assert (fused_kf_grad.launch_forward.launches,
            fused_kf_grad.launch_backward.launches) == launches


@pytest.mark.parametrize("tvl", [False, True])
def test_forward_refuses_an_unknown_layout_before_any_build(monkeypatch, tvl):
    """``launch_forward[_tvl](layout=)`` take None (the kernel's pick),
    "thread", "warp" or "octet"; any other name raises ValueError before a
    library is built or loaded or a buffer allocated."""
    def no_build(name):
        raise AssertionError(f"built or loaded {name}")

    monkeypatch.setattr(fused_kf_grad, "load", no_build)
    bufs = [torch.zeros(1)]  # never read: the layout is checked first
    counter = fused_kf_grad.launch_forward_tvl if tvl else fused_kf_grad.launch_forward
    launches = counter.launches
    for layout in ("block", "Warp", 2, "pick"):
        with pytest.raises(ValueError, match="layout must be one of"):
            if tvl:
                fused_kf_grad.launch_forward_tvl(bufs, False, layout=layout)
            else:
                fused_kf_grad.launch_forward(bufs, layout=layout)
    assert counter.launches == launches


@pytest.mark.parametrize("tvl", [False, True])
def test_backward_refuses_an_unknown_layout_before_any_build(monkeypatch, tvl):
    """``launch_backward[_tvl](layout=, store=)`` take None (the kernel's
    pick), "thread", "warp" or "octet", and for a group layout None,
    "segment" or "step"; any other choice raises ValueError before a
    library is built or loaded or a buffer allocated."""
    def no_build(name):
        raise AssertionError(f"built or loaded {name}")

    monkeypatch.setattr(fused_kf_grad, "load", no_build)
    bufs = [torch.zeros(1)]  # never read: the choice is checked first
    counter = fused_kf_grad.launch_backward_tvl if tvl else fused_kf_grad.launch_backward
    launches = counter.launches
    for kw in ({"layout": "block"}, {"layout": "Warp"}, {"layout": 2},
               {"layout": "warp", "store": "chunk"}, {"store": 1},
               {"layout": "thread", "store": "segment"}):
        with pytest.raises(ValueError, match="layout must be one of|store must"):
            if tvl:
                fused_kf_grad.launch_backward_tvl(bufs, False, None, None, **kw)
            else:
                fused_kf_grad.launch_backward(bufs, None, None, **kw)
    assert counter.launches == launches
