"""The port's static families (``models/static_model.py``) and their
estimation pieces against the JAX package, on the CPU, in float64 at N = 6
maturities, T = 40.

- ``get_loss``, ``get_loss_array`` and ``predict`` for "NS", "NNS",
  "NNS-Anchored" and "RW" at rtol 1e-10 / atol 1e-12 on: a clean panel; a
  NaN column at the window's first step (a transition-only step that is no
  target); a NaN column inside the window (a target: −Inf in both); a
  partially NaN column (−Inf in both); the window [5, 30) (steps outside
  it); a NaN forecast tail (12 transition-only steps).  A draw batch
  agrees with its rows one at a time at rtol 1e-12 (a batched matmul may
  round otherwise), and the coded loss equals JAX's.
- ``get_new_initial_params`` and ``try_initializations`` for the static
  codes, bit for bit (the jitter draws ``np.random.default_rng(trial)``).
- The closed-form (δ, Φ) group against JAX's
  ``_jitted_group_opt_msed_closed`` for "NS" and "NNS" at rtol 1e-8, and
  against ``tests/oracle.static_closed_delta_phi``; the random walk and a
  gapped window fall outside it.
- The entry-point rules: an explicit ``engine=`` on a static spec is a
  ValueError, as in JAX; ``estimate`` runs the per-start "vmap" objective
  (tests/test_torch_per_start.py holds it against JAX's), its ll JAX's
  loss at its optimum at rtol 1e-10.
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
from yieldfactormodels_jl_tpu.estimation import optimize as jopt  # noqa: E402
from yieldfactormodels_jl_tpu.models import params as jparams  # noqa: E402
from yieldfactormodels_jl_tpu.models import static_model as jstatic  # noqa: E402
from yieldfactormodels_jl_tpu_torch.estimation import optimize as topt  # noqa: E402
from yieldfactormodels_jl_tpu_torch.models import params as tparams  # noqa: E402
from yieldfactormodels_jl_tpu_torch.models import static_model as tstatic  # noqa: E402

CPU = "cpu"
MATS = tuple(np.array([3.0, 12.0, 24.0, 60.0, 120.0, 360.0]) / 12.0)
T = 40
CODES = ("NS", "NNS", "NNS-Anchored", "RW")
PHI = np.array([[0.95, 0.02, 0.0], [0.01, 0.9, 0.03], [0.0, 0.02, 0.85]])


def _panel(T=T):
    """Yields from the NS model itself: a stationary VAR(1) for β (Φ above,
    mean (3.5, −1, 0.5)) through the λ = 0.5 loadings, plus noise."""
    rng = np.random.default_rng(3)
    tau = 0.5 * np.asarray(MATS)
    z2 = (1 - np.exp(-tau)) / tau
    Z = np.stack([np.ones_like(tau), z2, z2 - np.exp(-tau)], 1)
    mean = np.array([3.5, -1.0, 0.5])
    beta, cols = mean.copy(), []
    for _ in range(T):
        beta = mean + PHI @ (beta - mean) + 0.1 * rng.standard_normal(3)
        cols.append(Z @ beta + 0.02 * rng.standard_normal(len(MATS)))
    return np.stack(cols, axis=1)


def _specs(code):
    js, _ = J.create_model(code, MATS, float_type="float64")
    ts, _ = P.create_model(code, MATS, float_type="float64")
    return js, ts


def static_params(spec, seed=0):
    """A stationary point: λ = 0.5 (or seeded neural weights), δ and Φ of
    tests/test_static.py."""
    p = np.zeros(spec.n_params)
    L = spec.L
    if spec.family == "static_neural":
        p[:L] = 0.3 * np.random.default_rng(seed).standard_normal(L)
    else:
        p[0] = np.log(0.5)
    p[L:L + 3] = [0.3, -0.1, 0.05]
    p[L + 3:] = PHI.T.reshape(-1)
    return p


def _cases():
    d = _panel()
    first, inside, partial = d.copy(), d.copy(), d.copy()
    first[:, 5] = np.nan
    inside[:, 17] = np.nan
    partial[2, 21] = np.nan
    tail = np.concatenate([d, np.full((len(MATS), 12), np.nan)], axis=1)
    return {"clean": (d, 0, T), "NaN column at the window's first step": (first, 5, 30),
            "NaN column inside": (inside, 0, T), "partial NaN column": (partial, 0, T),
            "window [5, 30)": (d, 5, 30), "NaN forecast tail": (tail, 0, T)}


def _jax_static(js):
    """JAX's loss, loss array, coded loss and predict of one spec as one
    jitted function (one compile a panel shape; the window bounds traced)."""
    return jax.jit(lambda p, d, s, e: (J.get_loss(js, p, d, s, e),
                                       J.get_loss_array(js, p, d, s, e),
                                       jstatic.get_loss_coded(js, p, d, s, e),
                                       J.predict(js, p, d)))


def _close(got, want, what):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape, what
    np.testing.assert_allclose(got, want, rtol=1e-10, atol=1e-12, err_msg=what)


@pytest.mark.parametrize("code", CODES)
def test_static_filters_match_jax(code):
    js, ts = _specs(code)
    jax_fns = _jax_static(js)
    p = static_params(js)
    for name, (d, s, e) in _cases().items():
        what = f"{code}, {name}"
        pj, dj = jnp.asarray(p), jnp.asarray(d)
        loss_j, array_j, (ll_cj, code_cj), res_j = jax_fns(pj, dj, s, e)
        lj = float(loss_j)
        lt = P.get_loss(ts, p, d, s, e, device=CPU)
        assert lt.shape == () and lt.dtype == torch.float64
        if name in ("NaN column inside", "partial NaN column"):
            assert lj == float(lt) == -np.inf, what
        else:
            assert np.isfinite(lj), what
            _close(lt, lj, what)
        _close(P.get_loss_array(ts, p, d, s, e, device=CPU), array_j, f"{what}: loss array")
        ll_c, code_c = tstatic.get_loss_coded(ts, torch.as_tensor(p), torch.as_tensor(d), s, e)
        assert int(code_c) == int(code_cj) and float(ll_c) == float(lt), what
        res_t = P.predict(ts, p, d, device=CPU)
        assert sorted(res_t) == sorted(res_j)
        for k in res_j:
            _close(res_t[k], res_j[k], f"{what}: predict {k}")
    # a draw batch: each row agrees with its own call
    d = _panel()
    pb = np.stack([static_params(js, seed) for seed in range(3)])
    pb[1, js.L:js.L + 3] += 0.1
    got = P.get_loss(ts, pb, d, 2, 35, device=CPU).numpy()
    for i in range(3):
        np.testing.assert_allclose(got[i], float(P.get_loss(ts, pb[i], d, 2, 35, device=CPU)),
                                   rtol=1e-12)
        _close(got[i], jax_fns(jnp.asarray(pb[i]), jnp.asarray(d), 2, 35)[0], f"{code} row {i}")
    batched = P.predict(ts, pb, d, device=CPU)
    assert batched["preds"].shape == (3, len(MATS), T)
    np.testing.assert_allclose(batched["factors"][1].numpy(),
                               P.predict(ts, pb[1], d, device=CPU)["factors"].numpy(),
                               rtol=1e-12)


@pytest.mark.parametrize("code", CODES)
def test_initial_proposals_match_jax(code):
    js, ts = _specs(code)
    p = static_params(js)
    for trial in (1, 2, 7):
        np.testing.assert_array_equal(tparams.get_new_initial_params(ts, p, trial),
                                      jparams.get_new_initial_params(js, p, trial))
    rng_j, rng_t = np.random.default_rng(11), np.random.default_rng(11)
    np.testing.assert_array_equal(tparams.get_new_initial_params(ts, p, 3, rng=rng_t),
                                  jparams.get_new_initial_params(js, p, 3, rng=rng_j))
    d = _panel()
    for tries in (0, 4):
        got = P.try_initializations(ts, p, d, max_tries=tries, device=CPU)
        want = jopt.try_initializations(js, p, d, max_tries=tries)
        assert got.shape == want.shape == (js.n_params, 1 if code == "RW" else tries + 1)
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("code", ["NS", "NNS"])
def test_closed_form_group_matches_jax_and_the_oracle(code):
    js, ts = _specs(code)
    d = _panel()
    lo_d, hi_d = ts.layout["delta"]
    lo_p, hi_p = ts.layout["phi"]
    cons = np.stack([static_params(js, seed) for seed in range(2)])
    cons[:, lo_d:hi_p] *= 0.8
    raw = P.untransform_params(ts, torch.as_tensor(cons))
    X_t, f_t = topt._msed_closed_group(ts, raw, torch.as_tensor(d), 0, T)
    X_j, f_j = jopt._jitted_group_opt_msed_closed(js, T)(jnp.asarray(raw.numpy()),
                                                          jnp.asarray(d), 0, T)
    np.testing.assert_allclose(X_t.numpy(), np.asarray(X_j), rtol=1e-8, atol=1e-12)
    np.testing.assert_allclose(f_t.numpy(), np.asarray(f_j), rtol=1e-8)
    f_old = topt._finite_objective(ts, torch.as_tensor(d), raw, 0, T)
    assert (f_t < f_old).all()                       # the candidates were taken
    got = P.transform_params(ts, X_t).numpy()
    for s in range(2):
        Z = tstatic.loadings_fn(ts, torch.as_tensor(cons[s, :ts.L])).numpy()
        want_delta, want_Phi = oracle.static_closed_delta_phi(Z, d)
        np.testing.assert_allclose(got[s, lo_d:hi_d], want_delta, rtol=1e-6)
        np.testing.assert_allclose(got[s, lo_p:hi_p].reshape(3, 3).T, want_Phi,
                                   rtol=1e-6, atol=1e-8)
    inds = tuple(range(lo_d, hi_p))
    data = torch.as_tensor(d)
    assert topt._msed_closed_applicable(ts, inds, data, 0, T)
    gapped = data.clone()
    gapped[:, 12] = float("nan")
    assert not topt._msed_closed_applicable(ts, inds, gapped, 0, T)
    rw, _ = P.create_model("RW", MATS, float_type="float64")
    assert not topt._msed_closed_applicable(rw, inds, data, 0, T)


def test_static_entry_point_rules():
    js, ts = _specs("NS")
    p, d = static_params(ts), _panel()
    with pytest.raises(ValueError, match="not applicable"):
        P.get_loss(ts, p, d, engine="scan", device=CPU)
    _, ll, best, conv = P.estimate(ts, d, p[:, None], max_iters=3, device=CPU)
    assert conv.iterations == 3 and ll > float(P.get_loss(ts, p, d, device=CPU))
    np.testing.assert_allclose(ll, float(J.get_loss(js, best, d)), rtol=1e-10)
    assert P.estimate(ts, d, p[:, None], max_iters=3, objective="vmap", device=CPU)[1] == ll
    assert P.get_loss(ts, p, d, K=3, device=CPU).shape == ()
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            P.get_loss(ts, p, d)
