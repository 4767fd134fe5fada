"""The port's Kalman ``get_loss_array`` and block-coordinate
``estimate_steps`` against the JAX package, on the CPU in float64 (K1's
plain version, the batched univariate recursion, runs there).

- ``kalman.get_loss_array`` for "1C", "AFNS5" and TVλ: one filter pass
  (K = 1) and two passes with the scan carry chained (K = 2), on the full
  panel, on a [start, end) window and on a panel with a NaN column, at rtol
  1e-10 (the T-step recursions sum in another order).
- ``estimate_steps`` on "1C" and AFNS5 from ``tests/oracle.py``'s stationary
  points, every parameter in group "1" (the families' default), Nelder–Mead
  with 25 iterations, one group iteration, against JAX ``estimate_steps``
  (its vmapped univariate loss): ll rtol 1e-6, best parameters rtol 1e-5 /
  atol 1e-9, the same ``Convergence`` — the bar of the score-driven
  ``test_estimate_steps_matches_jax``.  Each Nelder–Mead candidate batch is
  one call of K1's plain version, and one call each gives the start's and
  the final ll.
- An L-BFGS group on "1C" (every parameter, 3 iterations): the per-start
  L-BFGS on the plain univariate engine runs; its ll is JAX's loss at its
  optimum at rtol 1e-10 (tests/test_torch_per_start.py holds the
  per-start L-BFGS on "1C" against JAX's).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)  # tiny tensors; leave the cores to the other test workers

import jax  # noqa: E402

import yieldfactormodels_jl_tpu as J  # noqa: E402
import yieldfactormodels_jl_tpu_torch as P  # noqa: E402
from tests import oracle  # noqa: E402
from yieldfactormodels_jl_tpu.estimation import optimize as jopt  # noqa: E402
from yieldfactormodels_jl_tpu.models import kalman as jkalman  # noqa: E402
from yieldfactormodels_jl_tpu_torch.estimation import optimize as topt  # noqa: E402
from yieldfactormodels_jl_tpu_torch.models import kalman as tkalman  # noqa: E402
from yieldfactormodels_jl_tpu_torch.ops import fused_kf  # noqa: E402

CPU = "cpu"
MATS = tuple(np.array([3.0, 12.0, 24.0, 60.0, 120.0, 360.0]) / 12.0)   # N = 6
T = 30
CODES = ("1C", "AFNS5", "TVλ")
#: (label, start, end, K, with a NaN column)
LOSS_ARRAY_CASES = (("K1", 0, None, 1, False), ("K2", 0, None, 2, False),
                    ("window_K2", 3, 25, 2, False), ("nan_column_K2", 0, None, 2, True))
BUDGETS = {"1": ("neldermead", dict(max_iters=25))}


def _specs(code):
    js, _ = J.create_model(code, MATS, float_type="float64")
    ts, _ = P.create_model(code, MATS, float_type="float64")
    return js, ts


def _point(spec):
    if spec.family == "kalman_dns":
        return oracle.stable_1c_params(spec, np.float64)
    return oracle.generic_stable_params(spec, np.random.default_rng(3))


def _panels():
    data = oracle.simulate_dns_panel(np.random.default_rng(0), np.asarray(MATS), T=T)
    gapped = data.copy()
    gapped[:, 12] = np.nan      # a missing column
    gapped[2, 20] = np.nan      # a partially missing one: the whole step is missing
    return data, gapped


@pytest.fixture(scope="module")
def loss_array_refs():
    """JAX ``get_loss_array`` for every code and case, computed once."""
    data, gapped = _panels()
    refs = {}
    for code in CODES:
        js, _ = _specs(code)
        p = _point(js)
        # one compile a code: both pass counts in one program, the panel and
        # the window traced
        arrays = jax.jit(lambda p, panel, start, end, js=js: [
            jkalman.get_loss_array(js, p, panel, start, end, K) for K in (1, 2)])
        for label, start, end, K, nan in LOSS_ARRAY_CASES:
            panel = gapped if nan else data
            refs[code, label] = np.asarray(arrays(p, panel, start, T if end is None else end)[K - 1])
    return refs


def test_get_loss_array_matches_jax(loss_array_refs):
    """Every code and case at rtol 1e-10; a second pass starts from the
    first one's end state; a (B, P) batch gives each draw's array."""
    data, gapped = _panels()
    for code in CODES:
        _, ts = _specs(code)
        for label, start, end, K, nan in LOSS_ARRAY_CASES:
            panel = gapped if nan else data
            want = loss_array_refs[code, label]
            got = P.get_loss_array(ts, _point(ts), panel, start, end, K=K, device=CPU)
            assert got.shape == want.shape == (T - 1,)
            assert np.isfinite(want).all() and (want < 0).any()
            np.testing.assert_allclose(got.numpy(), want, rtol=1e-10, atol=1e-14,
                                       err_msg=f"{code} {label}")
            if K == 2:
                once = P.get_loss_array(ts, _point(ts), panel, start, end, K=1, device=CPU)
                assert not torch.equal(got, once)
    _, ts = _specs("AFNS5")
    p = np.stack([_point(ts), 0.98 * _point(ts)])
    got = tkalman.get_loss_array(ts, torch.as_tensor(p), torch.as_tensor(data), 2, 27, K=2)
    for b in range(2):
        one = tkalman.get_loss_array(ts, torch.as_tensor(p[b]), torch.as_tensor(data), 2, 27, K=2)
        np.testing.assert_allclose(got[b].numpy(), one.numpy(), rtol=1e-13, atol=1e-15)


@pytest.fixture(scope="module")
def steps_refs():
    """JAX ``estimate_steps`` on "1C" and AFNS5, computed once."""
    data, _ = _panels()
    refs = {}
    for code in ("1C", "AFNS5"):
        js, _ = _specs(code)
        groups = list(J.models.api.get_param_groups(js, None))
        refs[code] = jopt.estimate_steps(js, data, _point(js)[:, None], groups,
                                         max_group_iters=1, optimizers=BUDGETS)
    return refs


@pytest.mark.parametrize("code", ["1C", "AFNS5"])
def test_estimate_steps_matches_jax(steps_refs, code, monkeypatch):
    _, ts = _specs(code)
    data, _ = _panels()
    groups = list(P.get_param_groups(ts))
    assert set(groups) == {"1"}
    batches, nm_calls = [], [0]
    plain = fused_kf.batched_loglik_reference

    def counted_plain(spec, params, *a, **k):
        batches.append(params.shape[0])
        return plain(spec, params, *a, **k)

    counted_plain.calls = 0  # the plain version counts itself by its module name
    nm = topt.nelder_mead_batched

    def counted_nm(batch_fun, *a, **k):
        def counted(X):
            nm_calls[0] += 1
            return batch_fun(X)
        return nm(counted, *a, **k)

    monkeypatch.setattr(fused_kf, "batched_loglik_reference", counted_plain)
    monkeypatch.setattr(topt, "nelder_mead_batched", counted_nm)
    init_t, ll_t, best_t, conv_t = P.estimate_steps(ts, data, _point(ts)[:, None], groups,
                                                    max_group_iters=1, optimizers=BUDGETS,
                                                    device=CPU)
    init_j, ll_j, best_j, conv_j = steps_refs[code]
    np.testing.assert_allclose(init_t, np.asarray(init_j), rtol=1e-12)
    np.testing.assert_allclose(ll_t, ll_j, rtol=1e-6)
    np.testing.assert_allclose(best_t, np.asarray(best_j), rtol=1e-5, atol=1e-9)
    assert tuple(conv_t) == tuple(conv_j)
    assert ll_t > float(P.get_loss(ts, _point(ts), data, device=CPU))  # it moved
    # one plain K1 call for the start's ll, one per candidate batch (the
    # simplex's P + 1 draws, then single draws or a shrink's P) and one for
    # the final ll
    assert len(batches) == nm_calls[0] + 2
    assert batches[:2] == [1, ts.n_params + 1] and batches[-1] == 1
    assert set(batches[2:]) <= {1, ts.n_params}
    rep = P.last_multistart_report()
    assert rep["best"] == 0 and rep["iters"] == [1] and rep["lls"] == [ll_t]


def test_estimate_steps_kalman_refusals():
    """A Kalman group under L-BFGS runs the per-start L-BFGS on the plain
    engine, as JAX's does; the checkpointed run is still refused."""
    js, ts = _specs("1C")
    data, _ = _panels()
    p = _point(ts)[:, None]
    groups = list(P.get_param_groups(ts))
    lbfgs = {"1": ("lbfgs", dict(max_iters=3, g_tol=1e-6, f_abstol=1e-6))}
    _, ll_t, best_t, conv_t = P.estimate_steps(ts, data, p, groups, max_group_iters=1,
                                               optimizers=lbfgs, device=CPU)
    assert conv_t.iterations == 1
    assert ll_t > float(P.get_loss(ts, _point(ts), data, device=CPU))  # it moved
    ll_j = jopt._jitted_loss(js, T)(best_t, data, 0, T)  # compiled by steps_refs
    np.testing.assert_allclose(ll_t, float(ll_j), rtol=1e-10)
    with pytest.raises(NotImplementedError, match="item 11"):
        P.estimate_steps(ts, data, p, groups, checkpoint=object(), device=CPU)
