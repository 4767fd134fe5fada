"""The port's block-coordinate ``estimate_steps`` and its pieces against the
JAX package, on the CPU (the kernels' plain versions run there).

- ``nelder_mead_batched`` and ``nelder_mead`` against the JAX optimizers on
  Rosenbrock, at the bar of tests/test_pallas_ssd.py's trajectory-parity
  test (x rtol 1e-6 / atol 1e-9, f rtol 1e-6, iterations within 10).
- The closed-form (δ, Φ) solve against the NumPy oracle
  (``oracle.msed_lambda_closed_delta_phi``) at the JAX suite's rtol 1e-6.
- ``try_initializations``: the same grid winner as JAX for 1SSD-NNS (256
  candidates and the start) and SSD-NS (30 and the start).
- ``estimate_steps`` on 1SSD-NNS, T = 40, group "1" Nelder–Mead with 25
  iterations and the closed-form group "2", one group iteration, against
  JAX ``estimate_steps`` with its Pallas kernel off (``YFM_SSD_PALLAS=0``,
  the scan engine): the same grid winner, ll within 1e-6 relative, best
  parameters within 1e-5.  Optimizer parity is tolerance-based: the port's
  Nelder–Mead values come from the kernel's plain version, JAX's from its
  scan, two float64 evaluations of one loss.
- A ``detach_inner_beta=False`` spec (SSD-NS, 8 maturities, T = 40, a
  random-walk panel, every start parameter 0.5): K4 refuses it, so the
  grid and the Nelder–Mead blocks run the plain scan, as JAX's run its
  vmapped scan; the same (15, 1) start matrix, and ``estimate_steps`` at
  the bar above.
- The groups off the closed form run: "NS" with a NaN first column (group
  "2" by the per-start L-BFGS; its ll JAX's loss at its optimum at rtol
  1e-10), the random walk and "SD-NS" under ``YFM_MSED_CLOSED=0``
  (tests/test_torch_per_start.py holds these groups against JAX's).
"""

import dataclasses

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
from tests.test_score_driven import _neural_params  # noqa: E402
from yieldfactormodels_jl_tpu.estimation import neldermead as jnm  # noqa: E402
from yieldfactormodels_jl_tpu.estimation import optimize as jopt  # noqa: E402
from yieldfactormodels_jl_tpu_torch.estimation import neldermead as tnm  # noqa: E402
from yieldfactormodels_jl_tpu_torch.estimation import optimize as topt  # noqa: E402
from yieldfactormodels_jl_tpu_torch.ops import fused_ssd  # noqa: E402

CPU = "cpu"
MATS = np.asarray(MATURITIES) / 12.0


def _rosen_jax(x):
    return jnp.sum(100.0 * (x[1:] - x[:-1] ** 2) ** 2 + (1 - x[:-1]) ** 2)


def _rosen_torch(x):
    return (100.0 * (x[..., 1:] - x[..., :-1] ** 2) ** 2 + (1 - x[..., :-1]) ** 2).sum(-1)


def test_nelder_mead_matches_jax_on_rosenbrock():
    X0 = np.random.default_rng(0).standard_normal((3, 5))
    Xj, fj, itj = jnm.nelder_mead_batched(jax.jit(jax.vmap(jax.vmap(_rosen_jax))),
                                          jnp.asarray(X0), max_iters=300)
    Xt, ft, itt = tnm.nelder_mead_batched(_rosen_torch, torch.as_tensor(X0), max_iters=300)
    np.testing.assert_allclose(Xt.numpy(), np.asarray(Xj), rtol=1e-6, atol=1e-9)
    np.testing.assert_allclose(ft.numpy(), np.asarray(fj), rtol=1e-6, atol=1e-12)
    assert np.abs(itt.numpy() - np.asarray(itj)).max() <= 10
    for s in range(3):  # the sequential optimizer follows the same trajectory
        xs, fs, its = jnm.nelder_mead(jax.jit(_rosen_jax), jnp.asarray(X0[s]), max_iters=300)
        xt, ft1, it1 = tnm.nelder_mead(_rosen_torch, torch.as_tensor(X0[s]), max_iters=300)
        np.testing.assert_allclose(xt.numpy(), np.asarray(xs), rtol=1e-6, atol=1e-9)
        np.testing.assert_allclose(float(ft1), float(fs), rtol=1e-6, atol=1e-12)
        assert abs(it1 - int(its)) <= 10


def test_nelder_mead_batched_freezes_converged_starts():
    """A start whose simplex is flat from the outset never moves."""
    X0 = torch.as_tensor(np.array([[1.0, 1.0], [-1.2, 1.0]]))

    def flat_first(X):
        f = _rosen_torch(X)
        return torch.where(torch.arange(2)[:, None] == 0, torch.zeros_like(f), f)

    X, f, iters = tnm.nelder_mead_batched(flat_first, X0, max_iters=50)
    np.testing.assert_array_equal(X[0].numpy(), X0[0].numpy())
    assert int(iters[0]) == 0 and int(iters[1]) == 50


def test_closed_form_matches_numpy_oracle(yields_panel):
    """The (δ, Φ) solve on a fully observed panel against the independent
    NumPy filter loop and lstsq of tests/oracle.py."""
    spec, _ = P.create_model("SD-NS", tuple(MATS), float_type="float64")
    cons = oracle.stable_msed_params(spec)
    lo_d, hi_d = spec.layout["delta"]
    lo_p, hi_p = spec.layout["phi"]
    cons[lo_d:hi_p] *= 0.8
    raw = P.untransform_params(spec, torch.as_tensor(cons))[None]
    data = torch.as_tensor(yields_panel)
    X_new, _ = topt._msed_closed_group(spec, raw, data, 0, data.shape[1])
    got = P.transform_params(spec, X_new[0]).numpy()
    struct = {"A": cons[0:1], "B": cons[1:2], "omega": cons[2:3],
              "delta": cons[lo_d:hi_d], "Phi": cons[lo_p:hi_p].reshape(3, 3).T}
    want_delta, want_Phi = oracle.msed_lambda_closed_delta_phi(struct, MATS, yields_panel)
    np.testing.assert_allclose(got[lo_d:hi_d], want_delta, rtol=1e-6)
    np.testing.assert_allclose(got[lo_p:hi_p].reshape(3, 3).T, want_Phi, rtol=1e-6, atol=1e-8)
    assert topt._msed_closed_applicable(spec, tuple(range(lo_d, hi_p)), data, 0, 80)
    gapped = data.clone()
    gapped[:, 30] = float("nan")
    assert not topt._msed_closed_applicable(spec, tuple(range(lo_d, hi_p)), gapped, 0, 80)
    assert topt._msed_closed_applicable(spec, tuple(range(lo_d, hi_p)), gapped, 31, 80)


@pytest.mark.parametrize("code", ["1SSD-NNS", "SSD-NS"])
def test_try_initializations_matches_jax(code, yields_panel):
    js, _ = J.create_model(code, tuple(MATS), float_type="float64")
    ts, _ = P.create_model(code, tuple(MATS), float_type="float64")
    if js.family == "msed_neural":
        p, _ = _neural_params(js, np.random.default_rng(7))
    else:
        p = oracle.stable_msed_params(js)
    data = yields_panel[:, :40]
    calls = fused_ssd.batched_loss_reference.calls
    got = P.try_initializations(ts, p, data, start=2, end=38, device=CPU)
    assert fused_ssd.batched_loss_reference.calls == calls + 1  # one batched call
    want = jopt.try_initializations(js, p, data, start=2, end=38)
    assert got.shape == want.shape == (js.n_params, 1)
    np.testing.assert_array_equal(got, want)


def test_estimate_steps_matches_jax(yields_panel, monkeypatch):
    monkeypatch.setenv("YFM_SSD_PALLAS", "0")  # JAX on its scan engine
    js, _ = J.create_model("1SSD-NNS", tuple(MATS), float_type="float64")
    ts, _ = P.create_model("1SSD-NNS", tuple(MATS), float_type="float64")
    p, _ = _neural_params(js, np.random.default_rng(7))
    data = yields_panel[:, :40]
    groups = list(J.models.api.get_param_groups(js, None))
    budgets = {"1": ("neldermead", dict(max_iters=25)),
               "2": ("lbfgs", dict(max_iters=8, g_tol=1e-6, f_abstol=1e-6))}
    assert jopt._msed_closed_applicable(js, tuple(range(22, 34)), jnp.asarray(data), 0, 40)
    init_j, ll_j, best_j, conv_j = jopt.estimate_steps(js, data, p[:, None], groups,
                                                      max_group_iters=1, optimizers=budgets)
    init_t, ll_t, best_t, conv_t = P.estimate_steps(ts, data, p[:, None], groups,
                                                    max_group_iters=1, optimizers=budgets,
                                                    device=CPU)
    np.testing.assert_allclose(init_t, np.asarray(init_j), rtol=1e-12)  # the grid winner
    np.testing.assert_allclose(ll_t, ll_j, rtol=1e-6)
    np.testing.assert_allclose(best_t, np.asarray(best_j), rtol=1e-5, atol=1e-9)
    assert tuple(conv_t) == tuple(conv_j)
    rep = P.last_multistart_report()
    assert rep["best"] == 0 and rep["iters"] == [1] and np.isfinite(rep["lls"][0])


def test_estimate_steps_refusals(yields_panel, monkeypatch):
    data = yields_panel[:, :20]
    sd, _ = P.create_model("SD-NS", tuple(MATS), float_type="float64")
    p = oracle.stable_msed_params(sd)[:, None]
    groups = list(P.get_param_groups(sd))
    budgets = {"1": ("neldermead", dict(max_iters=2)),
               "2": ("lbfgs", dict(max_iters=3, g_tol=1e-6, f_abstol=1e-6))}
    # the static families' (δ, Φ) group off the closed form (a NaN first
    # column: a transition-only step) runs the per-start L-BFGS, as JAX's
    ns, _ = P.create_model("NS", tuple(MATS), float_type="float64")
    jns, _ = J.create_model("NS", tuple(MATS), float_type="float64")
    p_ns = oracle.stable_ns_params(ns, np.float64)[:, None]
    gapped = data.copy()
    gapped[:, 0] = np.nan
    ns_groups = list(P.get_param_groups(ns))
    _, ll, best, conv = P.estimate_steps(ns, gapped, p_ns, ns_groups, max_group_iters=1,
                                         optimizers=budgets, device=CPU)
    assert conv.iterations == 1 and ll > float(P.get_loss(ns, p_ns[:, 0], gapped, device=CPU))
    np.testing.assert_allclose(ll, float(J.get_loss(jns, best, gapped)), rtol=1e-10)
    # and the random walk, whose (δ, Φ) group never takes the closed form
    rw, _ = P.create_model("RW", tuple(MATS), float_type="float64")
    _, ll, best, conv = P.estimate_steps(rw, data, np.full((rw.n_params, 1), 0.3),
                                         P.get_param_groups(rw), max_group_iters=1,
                                         optimizers=budgets, device=CPU)
    assert np.isfinite(ll) and np.isfinite(best).all() and conv.iterations == 1
    # the Kalman families run (tests/test_torch_kalman_steps.py holds them
    # against JAX)
    c1, _ = P.create_model("1C", tuple(MATS), float_type="float64")
    _, ll, best, conv = P.estimate_steps(
        c1, data, oracle.stable_1c_params(c1, np.float64)[:, None], P.get_param_groups(c1),
        max_group_iters=1, optimizers={"1": ("neldermead", dict(max_iters=2))}, device=CPU)
    assert np.isfinite(ll) and np.isfinite(best).all() and conv.iterations == 1
    with pytest.raises(NotImplementedError, match="item 11"):
        P.estimate_steps(sd, data, p, groups, checkpoint=object(), device=CPU)
    with pytest.raises(NotImplementedError, match="item 9"):
        P.estimate_steps(sd, data, p, groups, second_order="fisher", device=CPU)
    monkeypatch.setenv("YFM_MSED_CLOSED", "0")  # group "2" falls to L-BFGS on K4
    calls = fused_ssd.batched_loss_reference.calls
    _, ll, best, conv = P.estimate_steps(sd, data, p, groups, max_group_iters=1,
                                         optimizers=budgets, device=CPU)
    assert np.isfinite(ll) and np.isfinite(best).all() and conv.iterations == 1
    assert fused_ssd.batched_loss_reference.calls > calls
    if not torch.cuda.is_available():
        monkeypatch.delenv("YFM_MSED_CLOSED")
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            P.estimate_steps(sd, data, p, groups, max_group_iters=1)


def _exact_inner_beta_case():
    """The SSD-NS spec with ``detach_inner_beta=False`` in both packages,
    8 maturities 3–120 months, a random-walk panel (N, 40) and every start
    parameter 0.5."""
    mats = tuple(np.array([3, 6, 12, 24, 36, 60, 84, 120]) / 12.0)
    rng = np.random.default_rng(0)
    data = 4.0 + np.cumsum(0.05 * rng.standard_normal((len(mats), 40)), axis=1)
    js, _ = J.create_model("SSD-NS", mats, float_type="float64")
    ts, _ = P.create_model("SSD-NS", mats, float_type="float64")
    js = dataclasses.replace(js, detach_inner_beta=False)
    ts = dataclasses.replace(ts, detach_inner_beta=False)
    return js, ts, data, np.full(ts.n_params, 0.5)


def test_try_initializations_runs_exact_inner_beta_specs():
    js, ts, data, p = _exact_inner_beta_case()
    with pytest.raises(ValueError, match="detached"):
        fused_ssd.batched_loss(ts, p[None], data, device=CPU)
    calls = fused_ssd.batched_loss_reference.calls
    got = P.try_initializations(ts, p, data, device=CPU)
    assert fused_ssd.batched_loss_reference.calls == calls  # the scan, not K4
    want = jopt.try_initializations(js, p, data)
    assert got.shape == want.shape == (15, 1)
    np.testing.assert_array_equal(got, want)


def test_estimate_steps_runs_exact_inner_beta_specs():
    js, ts, data, p = _exact_inner_beta_case()
    groups = list(J.models.api.get_param_groups(js, None))
    budgets = {"1": ("neldermead", dict(max_iters=10)),
               "2": ("lbfgs", dict(max_iters=8, g_tol=1e-6, f_abstol=1e-6))}
    init_j, ll_j, best_j, conv_j = jopt.estimate_steps(js, data, p[:, None], groups,
                                                      max_group_iters=1, optimizers=budgets)
    calls = fused_ssd.batched_loss_reference.calls
    init_t, ll_t, best_t, conv_t = P.estimate_steps(ts, data, p[:, None], groups,
                                                    max_group_iters=1, optimizers=budgets,
                                                    device=CPU)
    assert fused_ssd.batched_loss_reference.calls == calls
    np.testing.assert_allclose(init_t, np.asarray(init_j), rtol=1e-12)
    np.testing.assert_allclose(ll_t, ll_j, rtol=1e-6)
    np.testing.assert_allclose(best_t, np.asarray(best_j), rtol=1e-5, atol=1e-9)
    assert tuple(conv_t) == tuple(conv_j)
