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

``estimate`` on "SD-NS" (which ``"auto"`` sends to ``objective="vmap"``)
runs, its ll JAX's loss at its optimum at rtol 1e-10
(tests/test_torch_per_start.py holds ``"vmap"`` and the score-driven
gradient against JAX's).  A fused winner whose plain re-evaluation
disagrees re-runs ``"vmap"`` (``estimate``, ``estimate_windows``) or the
plain engines (``estimate_steps``) on the CPU, and raises on CUDA data.
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
from tests import oracle  # noqa: E402
from tests.conftest import MATURITIES  # noqa: E402
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


MATS6 = tuple(np.array([3, 12, 36, 84, 180, 360]) / 12.0)
T_FIT = 24


def _stable_tvl(spec, obs_var=0.25, chol=0.3, phi=0.5):
    """A stationary TVλ point at the scale of a unit panel: β₁…₃ around 0,
    λ around 0.5."""
    p = np.zeros(spec.n_params)
    p[spec.layout["obs_var"][0]] = obs_var
    a, _ = spec.layout["chol"]
    for k, (r, c) in enumerate(zip(*spec.chol_indices)):
        p[a + k] = chol if r == c else 0.01
    lo, hi = spec.layout["delta"]
    p[lo:hi] = [0.0, 0.0, 0.0, (1 - phi) * np.log(0.49)]
    lo, hi = spec.layout["phi"]
    p[lo:hi] = (phi * np.eye(4)).reshape(-1)
    return p


def _fit_case(code):
    """(JAX spec, port spec, unit-scale (6, T_FIT) panel, (4, P) raw starts
    around a stationary point), float64."""
    js, _ = J.create_model(code, MATS6, float_type="float64")
    ts, _ = P.create_model(code, MATS6, float_type="float64")
    rng = np.random.default_rng(0)
    data = 0.5 * rng.standard_normal((len(MATS6), T_FIT))
    base = _stable_tvl(ts) if code == "TVλ" else _stable_1c(ts)
    starts = np.stack([base * (1 + 0.05 * rng.standard_normal(ts.n_params))
                       for _ in range(4)])
    raw = np.nan_to_num(P.untransform_params(ts, torch.tensor(starts)).numpy())
    return js, ts, data, raw


FIT_KW = {"max_iters": 3, "g_tol": 1e-6, "f_abstol": 1e-6}


@functools.lru_cache(maxsize=None)
def _jax_windowed_lbfgs(js):
    """JAX's batched L-BFGS over jax.value_and_grad of its float64 univariate
    objective, each of 4 rows with its own [start, end): one compile per
    spec, shared by the estimate and estimate_windows tests."""
    def run(X0, data, starts, ends):
        def objective(r, s, e):
            return jopt._finite_objective(js, data, r, s, e)

        def vag(X):
            return jax.vmap(jax.value_and_grad(objective))(X, starts, ends)

        return jax_lbfgs(vag, X0, **FIT_KW, invalid_above=topt.PENALTY_THRESH,
                         value_fn=lambda X: jax.vmap(objective)(X, starts, ends))

    return jax.jit(run)


def test_tvl_estimate_matches_jax_lbfgs():
    """TVλ estimate (N=6, T=24, S=3 on a unit-scale panel, float64) against
    JAX's batched L-BFGS on its univariate objective from the same starts
    (a fourth row, the last start again, is dropped): the same iterations
    and best start, every start's final NLL within rtol 1e-6 (two float64
    implementations of one likelihood, ~1e-12 apart per evaluation, over
    a few L-BFGS steps)."""
    js, ts, data, raw = _fit_case("TVλ")
    X0 = raw[[0, 1, 2, 2]]
    ref = _jax_windowed_lbfgs(js)(jnp.asarray(X0), jnp.asarray(data),
                                  jnp.zeros(4, jnp.int32), jnp.full(4, T_FIT, jnp.int32))
    ref_ll = -np.asarray(ref.f)[:3]
    calls = (fused_kf_grad.forward_reference_tvl.calls,
             fused_kf_grad.adjoint_reference_tvl.calls)
    starts = P.transform_params(ts, torch.tensor(raw[:3])).numpy().T
    _, ll, _, conv = P.estimate(ts, data, starts, device=CPU, **FIT_KW)
    rep = P.last_multistart_report()
    assert fused_kf_grad.forward_reference_tvl.calls > calls[0]
    assert fused_kf_grad.adjoint_reference_tvl.calls > calls[1]
    assert rep["iters"] == np.asarray(ref.iters)[:3].tolist() and min(rep["iters"]) > 0
    assert rep["best"] == int(np.argmax(ref_ll)) and conv.iterations == rep["iters"][rep["best"]]
    np.testing.assert_allclose(rep["lls"], ref_ll, rtol=1e-6)
    np.testing.assert_allclose(ll, ref_ll.max(), rtol=1e-6)


@pytest.mark.parametrize("code", ["1C", "TVλ"])
def test_estimate_windows_matches_jax_lbfgs(code):
    """estimate_windows over W=2 windows ([0, 20), [3, 24)) × S=2 starts
    against JAX's batched L-BFGS on the same 4 rows with per-row windows:
    each cell's final NLL within rtol 1e-6, the same best start per window
    and the same iterations."""
    js, ts, data, raw = _fit_case(code)
    ws, we = np.array([0, 3]), np.array([20, T_FIT])
    ref = _jax_windowed_lbfgs(js)(jnp.asarray(raw[[0, 1, 0, 1]]), jnp.asarray(data),
                                  jnp.asarray(np.repeat(ws, 2), jnp.int32),
                                  jnp.asarray(np.repeat(we, 2), jnp.int32))
    ref_ll = -np.asarray(ref.f).reshape(2, 2)
    xs, lls = P.estimate_windows(ts, data, raw[:2], ws, we, device=CPU, **FIT_KW)
    assert xs.shape == (2, 2, ts.n_params) and lls.shape == (2, 2)
    assert (np.asarray(ref.iters) > 0).all()
    np.testing.assert_allclose(lls, ref_ll, rtol=1e-6)
    np.testing.assert_array_equal(lls.argmax(1), ref_ll.argmax(1))
    # each window's rows moved as JAX's did: the same accepted points
    np.testing.assert_allclose(xs.reshape(4, -1), np.asarray(ref.x), rtol=1e-5, atol=1e-8)


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


@pytest.mark.parametrize("kw,env,match", [
    ({"objective": "time_sharded"}, {}, "Queue 1 item 10"),
    ({"second_order": True}, {}, "Newton polish"),
    ({}, {"YFM_NEWTON": "1"}, "Newton polish"),
    ({"warm_start": True}, {}, "amortized warm start"),
    ({}, {"YFM_AMORT": "1"}, "amortized warm start"),
    ({}, {"YFM_ESCALATE": "1"}, "escalation ladder"),
])
def test_estimate_windows_refuses_what_is_not_ported(kw, env, match, yields_panel,
                                                     monkeypatch):
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    ts, data, starts = _tiny(yields_panel)
    raw = P.untransform_params(ts, torch.tensor(starts.T)).numpy()
    with pytest.raises(NotImplementedError, match=match):
        P.estimate_windows(ts, data, raw, [0], [10], max_iters=1, device=CPU, **kw)


def test_estimate_errors_and_device_rule(yields_panel):
    ts, data, starts = _tiny(yields_panel)
    with pytest.raises(ValueError, match="unknown objective 'newton'; pick from"):
        P.estimate(ts, data, starts, objective="newton", device=CPU)
    tvl, _ = P.create_model("TVλ", ts.maturities)  # TVλ runs (K3f/K3b)
    _, ll, _, _ = P.estimate(tvl, data, oracle.stable_tvl_params(tvl)[:, None],
                             max_iters=1, device=CPU)
    assert np.isfinite(ll)
    # a score-driven spec runs the "vmap" objective ("auto"; "fused" is for
    # the Kalman families): its gradient through the inner score, as JAX's
    sd, _ = P.create_model("SD-NS", ts.maturities, float_type="float64")
    jsd, _ = J.create_model("SD-NS", ts.maturities, float_type="float64")
    with pytest.raises(ValueError, match="fused objective unavailable"):
        P.estimate(sd, data, np.zeros((sd.n_params, 1)), objective="fused", device=CPU)
    p_sd = oracle.stable_msed_params(sd)
    data64 = data.astype(np.float64)
    _, ll, best, conv = P.estimate(sd, data64, p_sd[:, None], max_iters=2, device=CPU)
    assert conv.iterations == 2 and ll > float(P.get_loss(sd, p_sd, data64, device=CPU))
    np.testing.assert_allclose(ll, float(J.get_loss(jsd, best, data64)), rtol=1e-10)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            P.estimate(ts, data, starts, max_iters=1)


def test_trust_but_verify(yields_panel, monkeypatch, capsys):
    """A kernel-reported winner whose plain-engine re-evaluation disagrees by
    more than 0.5% (the fused kernels' value doubled) re-runs on the plain
    engines under the default policy, as the JAX package does: ``estimate``
    and ``estimate_windows`` give the ``objective="vmap"`` result and
    ``estimate_steps`` its plain-engine run (``_force_scan``); under
    YFM_FUSED_CHECK=warn the kernels' result stands with the stderr line."""
    ts, data, starts = _tiny(yields_panel)
    raw = P.untransform_params(ts, torch.tensor(starts.T)).numpy()
    groups = P.get_param_groups(ts)
    nm = {"1": ("neldermead", dict(max_iters=2))}
    want = P.estimate(ts, data, starts, max_iters=1, objective="vmap", device=CPU)
    want_w = P.estimate_windows(ts, data, raw, [0], [10], max_iters=1, objective="vmap",
                                device=CPU)
    want_s = P.estimate_steps(ts, data, starts, groups, max_group_iters=1, optimizers=nm,
                              device=CPU, _force_scan=True)
    diff, k1 = fused_kf_grad.batched_loglik_diff, fused_kf._batched_loglik
    monkeypatch.setattr(fused_kf_grad, "batched_loglik_diff", lambda *a, **k: 2 * diff(*a, **k))
    monkeypatch.setattr(fused_kf, "_batched_loglik", lambda *a, **k: 2 * k1(*a, **k))
    got = P.estimate(ts, data, starts, max_iters=1, device=CPU)
    assert "fused-kernel optimum disagrees" in capsys.readouterr().err
    assert got[1] == want[1] and np.array_equal(got[2], want[2]) and got[3] == want[3]
    got_w = P.estimate_windows(ts, data, raw, [0], [10], max_iters=1, device=CPU)
    assert np.array_equal(got_w[0], want_w[0]) and np.array_equal(got_w[1], want_w[1])
    got_s = P.estimate_steps(ts, data, starts, groups, max_group_iters=1, optimizers=nm,
                             device=CPU)
    assert got_s[1] == want_s[1] and np.array_equal(got_s[2], want_s[2])
    assert capsys.readouterr().err.count("fused-kernel optimum disagrees") == 2
    monkeypatch.setenv("YFM_FUSED_CHECK", "warn")
    _, ll, _, _ = P.estimate(ts, data, starts, max_iters=1, device=CPU)
    assert np.isfinite(ll) and abs(ll - 2 * want[1]) < 0.5 * abs(want[1])
    assert "YFM_FUSED_CHECK=warn" in capsys.readouterr().err


def test_trust_but_verify_raises_on_the_card(yields_panel, monkeypatch, capsys):
    """On CUDA data a disagreement under the default policy raises: no path
    gives way to the plain engines on the card.  The plain re-evaluation is
    patched to disagree, and the data stands in for a CUDA tensor."""
    ts, _, starts = _tiny(yields_panel)
    best = torch.as_tensor(starts[:, 0])
    monkeypatch.setattr(topt.api, "get_loss", lambda *a, **k: torch.tensor(-10.0))

    class OnTheCard:
        is_cuda = True

    with pytest.raises(RuntimeError, match="disagrees with the plain engine's -10.0 by "
                                           "more than 0.5% on the card"):
        topt._falls_back("estimate()", ts, best, -5.0, OnTheCard(), 0, 10)
    monkeypatch.setattr(OnTheCard, "is_cuda", False)
    assert topt._falls_back("estimate()", ts, best, -5.0, OnTheCard(), 0, 10)
    assert not topt._falls_back("estimate()", ts, best, -10.01, OnTheCard(), 0, 10)
    monkeypatch.setenv("YFM_FUSED_CHECK", "warn")
    monkeypatch.setattr(OnTheCard, "is_cuda", True)
    assert not topt._falls_back("estimate()", ts, best, -5.0, OnTheCard(), 0, 10)
    assert capsys.readouterr().err.count("fused-kernel optimum disagrees") == 3
