"""The port's batched L-BFGS and fused ``estimate`` against the JAX package.

``batched_lbfgs`` is a transcription of the JAX optimizer, so on the same
objective from the same starts it takes the same steps: the quadratics of
tests/test_batched_lbfgs.py give the same x, f, iterations and convergence
flags (atol 1e-12: the same float64 arithmetic in another summation order),
and a 1C float64 MLE through the port's plain fused objective against the
JAX ``vmapped_value_and_grad`` (value-only Armijo probes on both sides)
gives the same iterations and f within rtol 1e-8 (two float64
implementations of one likelihood, 1e-12 apart per evaluation, over a few
L-BFGS steps).

``estimate(..., device="cpu")`` runs the kernels' plain versions; it is held
against JAX ``estimate(objective="fused")`` in interpret mode at the tiny
shape of test_fused_estimate_composition_interpret, both in float32: ll
within rtol 1e-4 (float32 sums in another order).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)  # tiny tensors; leave the cores to the other test workers

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import yieldfactormodels_jl_tpu as J  # noqa: E402
import yieldfactormodels_jl_tpu_torch as P  # noqa: E402
from yieldfactormodels_jl_tpu.estimation import optimize as jopt  # noqa: E402
from yieldfactormodels_jl_tpu.estimation.batched_lbfgs import batched_lbfgs as jax_lbfgs  # noqa: E402
from yieldfactormodels_jl_tpu_torch.estimation import optimize as topt  # noqa: E402
from yieldfactormodels_jl_tpu_torch.estimation.batched_lbfgs import batched_lbfgs  # noqa: E402
from yieldfactormodels_jl_tpu_torch.ops import fused_kf, fused_kf_grad  # noqa: E402

CPU = "cpu"
F64 = torch.float64


def _quadratics():
    """test_batched_lbfgs.py's S anisotropic quadratics with known minima."""
    rng = np.random.default_rng(1)
    S, Pn = 5, 7
    centers = rng.standard_normal((S, Pn))
    scales = 1.0 + rng.uniform(size=(S, Pn)) * 9.0
    return centers, scales, np.zeros((S, Pn)), {"max_iters": 200, "g_tol": 1e-10,
                                                "f_abstol": 0.0}


def _frozen():
    """test_batched_lbfgs.py's frozen row: row 0 starts at its optimum."""
    centers = np.array([[0.0, 0.0], [3.0, -2.0]])
    return centers, np.ones_like(centers), np.array([[0.0, 0.0], [10.0, 10.0]]), {
        "max_iters": 100, "g_tol": 1e-8, "f_abstol": 0.0}


@pytest.mark.parametrize("problem", [_quadratics, _frozen], ids=["quadratics", "frozen"])
def test_batched_lbfgs_matches_jax_on_quadratics(problem):
    centers, scales, x0, kw = problem()

    def jax_vag(X):
        r = (X - centers) * scales
        return 0.5 * jnp.sum(r * r, axis=-1), r * scales

    c, s = torch.tensor(centers), torch.tensor(scales)

    def port_vag(X):
        r = (X - c) * s
        return 0.5 * (r * r).sum(-1), r * s

    ref = jax.jit(lambda x: jax_lbfgs(jax_vag, x, **kw))(jnp.asarray(x0))
    got = batched_lbfgs(port_vag, torch.tensor(x0), **kw)
    np.testing.assert_allclose(got.x.numpy(), np.asarray(ref.x), rtol=0, atol=1e-12)
    np.testing.assert_allclose(got.f.numpy(), np.asarray(ref.f), rtol=0, atol=1e-12)
    np.testing.assert_array_equal(got.iters.numpy(), np.asarray(ref.iters))
    np.testing.assert_array_equal(got.converged.numpy(), np.asarray(ref.converged))
    np.testing.assert_allclose(got.x.numpy(), centers, atol=1e-6)


def _stable_1c(spec, obs_var=0.25, chol=0.3, phi=0.5):
    p = np.zeros(spec.n_params)
    p[spec.layout["gamma"][0]] = np.log(0.49)
    p[spec.layout["obs_var"][0]] = obs_var
    k = spec.layout["chol"][0]
    for j in range(3):
        for i in range(j + 1):
            p[k] = chol if i == j else 0.01
            k += 1
    lo, hi = spec.layout["phi"]
    p[lo:hi] = (phi * np.eye(3)).reshape(-1)
    return p


def test_batched_lbfgs_matches_jax_on_a_1c_mle():
    """S = 3 starts around a stationary point, on a panel whose scale lets
    the first steepest-descent step pass the Armijo test (on a yield panel
    at its natural level every start stops at iteration 0, in both packages:
    the first step is −g with at most 25 backtracks)."""
    mats = tuple(np.array([3, 12, 36, 84, 180, 360]) / 12.0)
    js, _ = J.create_model("1C", mats, float_type="float64")
    ts, _ = P.create_model("1C", mats, float_type="float64")
    rng = np.random.default_rng(0)
    T = 60
    data = 0.5 * rng.standard_normal((len(mats), T))
    base = _stable_1c(js)
    starts = np.stack([base * (1 + 0.05 * rng.standard_normal(js.n_params))
                       for _ in range(3)])
    raw = np.nan_to_num(P.untransform_params(ts, torch.tensor(starts)).numpy())
    kw = {"max_iters": 4, "g_tol": 1e-6, "f_abstol": 1e-6}

    jdata = jnp.asarray(data)
    jax_vag = jopt.vmapped_value_and_grad(js, jdata, 0, T)
    jax_value = jax.vmap(lambda r: jopt._finite_objective(js, jdata, r, 0, T))
    ref = jax.jit(lambda x: jax_lbfgs(jax_vag, x, value_fn=jax_value, **kw))(
        jnp.asarray(raw))

    def port_value(X):
        v = -P.batched_loglik_diff(ts, P.transform_params(ts, X), data, device=CPU,
                                   dtype=F64)
        return torch.where(torch.isfinite(v), v, torch.full_like(v, topt.PENALTY))

    def port_vag(X):
        X = X.detach().requires_grad_(True)
        v = port_value(X)
        (g,) = torch.autograd.grad(v, X, torch.ones_like(v))
        return v.detach(), torch.where(torch.isfinite(g), g, torch.zeros_like(g))

    got = batched_lbfgs(port_vag, torch.tensor(raw), value_fn=port_value, **kw)
    np.testing.assert_array_equal(got.iters.numpy(), np.asarray(ref.iters))
    assert (got.iters.numpy() > 0).all()
    np.testing.assert_allclose(got.f.numpy(), np.asarray(ref.f), rtol=1e-8)
    np.testing.assert_array_equal(got.converged.numpy(), np.asarray(ref.converged))


def test_estimate_matches_jax_fused_estimate(yields_panel):
    """test_fused_estimate_composition_interpret's shape: 1C, 4 maturities,
    T = 10, S = 2, max_iters = 2, float32 on both sides."""
    mats = tuple(np.array([3, 36, 120, 360]) / 12.0)
    js, _ = J.create_model("1C", mats, float_type="float32")
    ts, _ = P.create_model("1C", mats, float_type="float32")
    data = np.asarray(yields_panel[:4, :10], dtype=np.float32)
    p = _stable_1c(js, obs_var=0.01, chol=0.1, phi=0.9)
    p[js.layout["gamma"][0]] = 0.5
    starts = np.stack([p, p * 1.02], axis=1)  # (P, S=2) constrained

    _, ref_ll, _, ref_conv = jopt.estimate(js, data, starts, max_iters=2,
                                           objective="fused")
    ref_rep = jopt.last_multistart_report()
    counts = (fused_kf_grad.forward_reference.calls, fused_kf_grad.adjoint_reference.calls)
    init, ll, best, conv = P.estimate(ts, data, starts, max_iters=2, device=CPU)
    rep = P.last_multistart_report()
    assert fused_kf_grad.forward_reference.calls > counts[0]
    assert fused_kf_grad.adjoint_reference.calls > counts[1]
    np.testing.assert_allclose(ll, ref_ll, rtol=1e-4)
    assert isinstance(conv, P.Convergence) and conv.iterations == ref_conv.iterations
    assert bool(conv) == bool(ref_conv)
    assert rep.keys() == ref_rep.keys()
    assert rep["best"] == ref_rep["best"]
    assert rep["iters"] == ref_rep["iters"]
    assert rep["converged"] == ref_rep["converged"] and rep["phase"] == ref_rep["phase"]
    np.testing.assert_allclose(rep["lls"], ref_rep["lls"], rtol=1e-4)
    assert init.shape == best.shape == (ts.n_params,)
    np.testing.assert_allclose(init, starts[:, rep["best"]], rtol=1e-5)
    # both packages' losses at the port's winner; the JAX side through the
    # loss its estimate compiled for its own re-evaluation (no new compile)
    from yieldfactormodels_jl_tpu.models.params import transform_params as jax_transform

    raw = P.untransform_params(ts, torch.tensor(best))
    jax_loss = -float(jopt._jitted_loss(js, data.shape[1])(
        jax_transform(js, jnp.asarray(raw.numpy())), jnp.asarray(data),
        jnp.asarray(0), jnp.asarray(data.shape[1])))
    np.testing.assert_allclose(float(topt.compute_loss(ts, torch.tensor(data), raw)),
                               jax_loss, rtol=1e-5)


def _chip_smoke():
    """chip_smoke.py (repository root) as a module: its panel and draws."""
    import importlib.util
    import os

    path = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                        "chip_smoke.py")
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.slow
def test_full_width_starts_stop_at_iteration_zero_in_both_packages():
    """chip_smoke.py phase 7's panel and starts — AFNS5, N=20, T=360, the
    panel simulated from the model at the first of the bench's draws — on
    8 of its 256 starts: the JAX package's batched L-BFGS (the optimizer of
    its estimate(objective="fused")) on its own float64 univariate
    objective, and the port's estimate on the CPU, stop every start at
    iteration 0 with the same values — within rtol 5e-4, since the port's
    fused objective works in float32, as the JAX package's does, and that
    is tests/test_pallas_kf.py's float32 tolerance.  Their first step is −g from
    α = 1 with 25 backtracks by 0.8, and ‖g‖ is 1e6–1e8 at these starts.
    JAX estimate(objective="fused") itself runs its Pallas kernels in
    interpret mode on the CPU, whose compile at this width runs past
    17 GB, so its optimizer is driven here on the plain objective."""
    smoke = _chip_smoke()
    ts, _ = P.create_model("AFNS5", smoke.MATURITIES, float_type="float64")
    js, _ = J.create_model("AFNS5", tuple(smoke.MATURITIES), float_type="float64")
    T = smoke.T_MONTHS
    sim = smoke.simulate_panel(ts, smoke.make_param_batch(ts.n_params, 1024)[0], seed=9)
    starts = smoke.make_param_batch(ts.n_params, 256, seed=11)[:8]
    raw = np.nan_to_num(P.untransform_params(ts, torch.tensor(starts)).numpy())
    jdata = jnp.asarray(sim)
    jax_vag = jopt.vmapped_value_and_grad(js, jdata, 0, T)
    jax_value = jax.vmap(lambda r: jopt._finite_objective(js, jdata, r, 0, T))
    ref = jax.jit(lambda x: jax_lbfgs(
        jax_vag, x, 50, g_tol=1e-6, f_abstol=1e-6, invalid_above=topt.PENALTY_THRESH,
        value_fn=jax_value))(jnp.asarray(raw))
    assert (np.asarray(ref.iters) == 0).all()
    _, ll, _, conv = P.estimate(ts, sim, starts.T, max_iters=50, device=CPU)
    rep = P.last_multistart_report()
    assert rep["iters"] == [0] * 8 and conv.iterations == 0
    np.testing.assert_allclose(rep["lls"], -np.asarray(ref.f), rtol=5e-4)


def _tiny(yields_panel):
    mats = tuple(np.array([3, 36, 120, 360]) / 12.0)
    ts, _ = P.create_model("1C", mats, float_type="float32")
    p = _stable_1c(ts, obs_var=0.01, chol=0.1, phi=0.9)
    return ts, np.asarray(yields_panel[:4, :10], dtype=np.float32), p[:, None]


@pytest.mark.parametrize("kw,env,match", [
    ({"objective": "vmap"}, {}, "Queue 1 item 4"),
    ({"objective": "time_sharded"}, {}, "Queue 1 item 10"),
    ({"second_order": True}, {}, "Newton polish"),
    ({}, {"YFM_NEWTON": "1"}, "Newton polish"),
    ({"warm_start": True}, {}, "amortized warm start"),
    ({}, {"YFM_AMORT": "1"}, "amortized warm start"),
    ({}, {"YFM_ESCALATE": "1"}, "escalation ladder"),
])
def test_estimate_refuses_what_is_not_ported(kw, env, match, yields_panel, monkeypatch):
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    ts, data, starts = _tiny(yields_panel)
    with pytest.raises(NotImplementedError, match=match):
        P.estimate(ts, data, starts, max_iters=1, device=CPU, **kw)


def test_estimate_errors_and_device_rule(yields_panel):
    ts, data, starts = _tiny(yields_panel)
    with pytest.raises(ValueError, match="unknown objective 'newton'; pick from"):
        P.estimate(ts, data, starts, objective="newton", device=CPU)
    tvl, _ = P.create_model("TVλ", ts.maturities)
    with pytest.raises(NotImplementedError, match="Queue 2 K3f/K3b"):
        P.estimate(tvl, data, np.zeros((tvl.n_params, 1)), device=CPU)
    ssd, _ = P.create_model("1SSD-NNS", ts.maturities)
    with pytest.raises(NotImplementedError, match="not ported"):
        P.estimate(ssd, data, np.zeros((ssd.n_params, 1)), device=CPU)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            P.estimate(ts, data, starts, max_iters=1)


def test_trust_but_verify(yields_panel, monkeypatch, capsys):
    """A winner whose plain-engine re-evaluation disagrees by more than 0.5%
    raises under the default policy and only warns under
    YFM_FUSED_CHECK=warn."""
    ts, data, starts = _tiny(yields_panel)
    monkeypatch.setattr(topt.api, "get_loss",
                        lambda spec, p, d, s, e: 2 * fused_kf.batched_loglik_reference(
                            spec, p[None], d, s, e)[0])
    with pytest.raises(RuntimeError, match="disagrees with the plain engine"):
        P.estimate(ts, data, starts, max_iters=1, device=CPU)
    assert "fused-kernel optimum disagrees" in capsys.readouterr().err
    monkeypatch.setenv("YFM_FUSED_CHECK", "warn")
    _, ll, _, _ = P.estimate(ts, data, starts, max_iters=1, device=CPU)
    assert np.isfinite(ll)
    assert "YFM_FUSED_CHECK=warn" in capsys.readouterr().err
