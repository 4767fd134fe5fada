"""The port's per-start optimizers (``estimation/per_start.py``), its batched
autograd objective and the gradient groups of ``estimate_steps`` against the
JAX package, on the CPU, in float64, at N = 6 maturities, T ≤ 24.

- ``run_lbfgs`` and ``run_adam`` against JAX's ``_run_lbfgs`` and
  ``_run_adam`` under ``jax.vmap`` on 4 Rosenbrock lanes (shifted by 1 so
  that f is of order 1) that stop at different iterations: the same
  iterations per lane, x and f within rtol 1e-10; then the per-start L-BFGS
  on the "1C" objective (``_jitted_multistart_lbfgs``), max_iters=5: the
  same iterations, x within rtol 1e-8; and the same lanes through
  ``estimate(objective="vmap")`` (ll rtol 1e-8, the same winner) and
  ``estimate_windows(objective="vmap")`` over two windows (x and ll
  within rtol 1e-8).
- ``vmapped_value_and_grad`` for "1C", "SD-NS" and "NS" at rtol 1e-10.
- ``estimate_steps`` on "SD-NS" off the closed form, group "2" L-BFGS
  capped at 2 iterations (the head is the placeholder group "-1", so that
  JAX compiles its interpret-mode kernel into no Nelder–Mead loop), one
  group iteration, against JAX with its Pallas kernel in interpret mode
  (``YFM_SSD_PALLAS=force``: JAX's batched L-BFGS with the kernel's values
  and the scan's gradients, as the port's ``_group_opt_ssd``): a panel
  whose first column is NaN (a transition-only step the closed form does
  not take), and ``YFM_MSED_CLOSED=0``.  ll within rtol 1e-6, parameters
  within atol 1e-6.
- ``estimate(objective="vmap")`` on "NS" (3 starts) and ``estimate_steps``
  on "RW" (its (δ, Φ) group "2" by the per-start L-BFGS) against JAX: ll
  within rtol 1e-8, the same winner.

Each JAX reference compiles once in this module.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)  # tiny tensors; leave the cores to the other test workers

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import yieldfactormodels_jl_tpu as J  # noqa: E402
import yieldfactormodels_jl_tpu_torch as P  # noqa: E402
from tests import oracle  # noqa: E402
from tests.test_torch_static import MATS, _panel  # noqa: E402
from yieldfactormodels_jl_tpu.estimation import optimize as jopt  # noqa: E402
from yieldfactormodels_jl_tpu_torch.estimation import optimize as topt  # noqa: E402
from yieldfactormodels_jl_tpu_torch.estimation import per_start  # noqa: E402
from yieldfactormodels_jl_tpu_torch.models.params import get_new_initial_params  # noqa: E402
from yieldfactormodels_jl_tpu_torch.ops import fused_ssd  # noqa: E402

CPU = "cpu"


def _specs(code):
    return (P.create_model(code, MATS, float_type="float64")[0],
            J.create_model(code, MATS, float_type="float64")[0])


def _rosen_jax(x):
    return 1.0 + jnp.sum(100.0 * (x[1:] - x[:-1] ** 2) ** 2 + (1 - x[:-1]) ** 2)


def _rosen_torch(X, rows=None):
    return 1.0 + (100.0 * (X[..., 1:] - X[..., :-1] ** 2) ** 2
                  + (1 - X[..., :-1]) ** 2).sum(-1)


def _rosen_vag(X, rows):
    return topt._values_and_grads(_rosen_torch, X)


def _raw_starts(spec, p, n, scale, seed):
    raw = P.untransform_params(spec, torch.as_tensor(p)).numpy()
    return raw[None] + scale * np.random.default_rng(seed).standard_normal((n, raw.size))


def test_per_start_optimizers_match_jax():
    X0 = np.random.default_rng(0).standard_normal((4, 4))
    X0[1] *= 0.3
    X0[3] = 1.0 + 1e-4 * X0[3]  # next to the optimum: stops after 2 iterations
    lb = jax.jit(jax.vmap(lambda x: jopt._run_lbfgs(_rosen_jax, x, 200, 1e-6, 1e-6)))
    xj, fj, itj, cj = lb(jnp.asarray(X0))
    got = per_start.run_lbfgs(_rosen_torch, _rosen_vag, torch.as_tensor(X0), 200)
    assert len(set(np.asarray(itj).tolist())) == 4  # each lane stops at its own iteration
    np.testing.assert_array_equal(got.iters.numpy(), np.asarray(itj))
    np.testing.assert_array_equal(got.converged.numpy(), np.asarray(cj))
    np.testing.assert_allclose(got.x.numpy(), np.asarray(xj), rtol=1e-10)
    np.testing.assert_allclose(got.f.numpy(), np.asarray(fj), rtol=1e-10)

    ad = jax.jit(jax.vmap(lambda x: jopt._run_adam(_rosen_jax, x, 400, 1e-2, 5.0)))
    xj, fj, itj, cj = ad(jnp.asarray(X0))
    got = per_start.run_adam(_rosen_vag, torch.as_tensor(X0), 400, 1e-2, 5.0)
    assert len(set(np.asarray(itj).tolist())) > 1
    np.testing.assert_array_equal(got.iters.numpy(), np.asarray(itj))
    np.testing.assert_array_equal(got.converged.numpy(), np.asarray(cj))
    np.testing.assert_allclose(got.x.numpy(), np.asarray(xj), rtol=1e-10)
    np.testing.assert_allclose(got.f.numpy(), np.asarray(fj), rtol=1e-10)

    # the per-start L-BFGS of estimate(objective="vmap") on the "1C" objective
    ts, js = _specs("1C")
    data, T = _panel(24), 24
    X1 = _raw_starts(ts, oracle.stable_1c_params(ts, np.float64), 3, 0.05, 1)
    lanes = jopt._jitted_multistart_lbfgs(js, T, 5, 1e-6, 1e-6)
    xj, fj, itj, _ = (np.asarray(v) for v in lanes(jnp.asarray(X1), jnp.asarray(data),
                                                  jnp.asarray(0), jnp.asarray(T)))
    got = per_start.run_lbfgs(*topt._lane_objectives(ts, torch.as_tensor(data), [0] * 3,
                                                     [T] * 3), torch.as_tensor(X1), 5)
    np.testing.assert_array_equal(got.iters.numpy(), itj)
    np.testing.assert_allclose(got.x.numpy(), xj, rtol=1e-8)
    np.testing.assert_allclose(got.f.numpy(), fj, rtol=1e-8)
    # the same lanes through estimate(objective="vmap") (constrained starts)
    # and estimate_windows(objective="vmap") over [0, 20) and [0, 24)
    cons = P.transform_params(ts, torch.as_tensor(X1)).numpy().T
    _, ll, best, conv = P.estimate(ts, data, cons, max_iters=5, objective="vmap",
                                   device=CPU)
    rep = P.last_multistart_report()
    assert rep["iters"] == itj.tolist() and rep["best"] == int(np.argmin(fj))
    np.testing.assert_allclose(rep["lls"], -fj, rtol=1e-8)
    np.testing.assert_allclose(ll, -fj.min(), rtol=1e-8)
    assert conv.iterations == itj[rep["best"]]
    np.testing.assert_allclose(P.untransform_params(ts, torch.as_tensor(best)).numpy(),
                               xj[rep["best"]], rtol=1e-6, atol=1e-9)
    xj20, fj20 = (np.asarray(v) for v in lanes(jnp.asarray(X1), jnp.asarray(data),
                                               jnp.asarray(0), jnp.asarray(20))[:2])
    xs, lls = P.estimate_windows(ts, data, X1, [0, 0], [20, T], max_iters=5,
                                 objective="vmap", device=CPU)
    assert xs.shape == (2, 3, ts.n_params) and lls.shape == (2, 3)
    np.testing.assert_allclose(lls, -np.stack([fj20, fj]), rtol=1e-8)
    np.testing.assert_allclose(xs, np.stack([xj20, xj]), rtol=1e-8)


def test_vmapped_value_and_grad_matches_jax():
    """One autograd pass over the batch: the univariate Kalman engine, the
    score-driven scan (through the inner score) and the static loss."""
    data = _panel(24)
    points = {"1C": lambda s: oracle.stable_1c_params(s, np.float64),
              "SD-NS": oracle.stable_msed_params,
              "NS": lambda s: oracle.stable_ns_params(s, np.float64)}
    for code, point in points.items():
        ts, js = _specs(code)
        X = _raw_starts(ts, point(ts), 3, 0.05, 2)
        fj, gj = jax.jit(jopt.vmapped_value_and_grad(js, jnp.asarray(data), 0, 24))(
            jnp.asarray(X))
        ft, gt = topt.vmapped_value_and_grad(ts, torch.as_tensor(data), 0, 24)(
            torch.as_tensor(X))
        np.testing.assert_allclose(ft.numpy(), np.asarray(fj), rtol=1e-10, err_msg=code)
        np.testing.assert_allclose(gt.numpy(), np.asarray(gj), rtol=1e-10,
                                   atol=1e-10 * np.abs(np.asarray(gj)).max(), err_msg=code)


def test_estimate_steps_sd_ns_off_the_closed_form_matches_jax(monkeypatch):
    """Group "2" runs ``_group_opt_ssd``'s L-BFGS: its Armijo probes on K4's
    plain version, its gradients from the scan."""
    ts, js = _specs("SD-NS")
    data = _panel(20)
    gapped = data.copy()
    gapped[:, 0] = np.nan  # a transition-only step: not a target, not closed-form
    p = oracle.stable_msed_params(ts)[:, None]
    # the head is the placeholder group "-1" (skipped): group "2" alone
    groups = ["-1" if g == "1" else g for g in P.get_param_groups(ts)]
    budgets = {"1": ("neldermead", dict(max_iters=5)),
               "2": ("lbfgs", dict(max_iters=2, g_tol=1e-6, f_abstol=1e-6))}
    monkeypatch.setenv("YFM_SSD_PALLAS", "force")
    lbfgs_groups, batched_lbfgs = [], topt.batched_lbfgs

    def counted_lbfgs(*a, **k):
        lbfgs_groups.append(a[1].shape)
        return batched_lbfgs(*a, **k)

    monkeypatch.setattr(topt, "batched_lbfgs", counted_lbfgs)
    for panel, closed in ((gapped, "1"), (data, "0")):
        monkeypatch.setenv("YFM_MSED_CLOSED", closed)
        _, ll_j, best_j, conv_j = jopt.estimate_steps(js, panel, p, groups, max_group_iters=1,
                                                      optimizers=budgets)
        calls = fused_ssd.batched_loss_reference.calls
        _, ll_t, best_t, conv_t = P.estimate_steps(ts, panel, p, groups, max_group_iters=1,
                                                   optimizers=budgets, device=CPU)
        assert fused_ssd.batched_loss_reference.calls > calls
        np.testing.assert_allclose(ll_t, ll_j, rtol=1e-6)
        np.testing.assert_allclose(best_t, np.asarray(best_j), rtol=0, atol=1e-6)
        assert tuple(conv_t) == tuple(conv_j)
    assert lbfgs_groups == [(1, 12), (1, 12)]  # group "2", (δ, Φ), of the one start


def test_estimate_vmap_and_random_walk_match_jax():
    ts, js = _specs("NS")
    data = _panel(24)
    p0 = oracle.stable_ns_params(ts, np.float64)
    starts = np.stack([p0] + [get_new_initial_params(ts, p0, t) for t in (1, 2)], 1)
    _, ll_j, best_j, conv_j = jopt.estimate(js, data, starts, max_iters=50, objective="vmap")
    rep_j = jopt.last_multistart_report()
    _, ll_t, best_t, conv_t = P.estimate(ts, data, starts, max_iters=50, device=CPU)
    rep_t = P.last_multistart_report()
    assert rep_t["best"] == rep_j["best"] and rep_t["iters"] == rep_j["iters"]
    np.testing.assert_allclose(rep_t["lls"], rep_j["lls"], rtol=1e-8)
    np.testing.assert_allclose(ll_t, ll_j, rtol=1e-8)
    np.testing.assert_allclose(best_t, np.asarray(best_j), rtol=1e-6, atol=1e-8)
    assert tuple(conv_t) == tuple(conv_j)

    rw, jrw = _specs("RW")
    start = np.full((rw.n_params, 1), 0.3)
    # the (δ, Φ) group, never in closed form; γ, which the random walk's
    # loss does not read, is the placeholder group "-1"
    groups = ["-1" if g == "1" else g for g in P.get_param_groups(rw)]
    assert groups.count("2") == 12
    _, ll_j, best_j, conv_j = jopt.estimate_steps(jrw, data, start, groups, max_group_iters=2)
    _, ll_t, best_t, conv_t = P.estimate_steps(rw, data, start, groups, max_group_iters=2,
                                               device=CPU)
    np.testing.assert_allclose(ll_t, ll_j, rtol=1e-8)
    np.testing.assert_allclose(best_t, np.asarray(best_j), rtol=1e-8)
    assert tuple(conv_t) == tuple(conv_j)
    assert P.last_multistart_report()["best"] == jopt.last_multistart_report()["best"]
