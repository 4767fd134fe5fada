"""The port's score-driven (MSED) family and its fused loss kernel (K4)
against the JAX package, on the CPU.

- ``models/score_driven`` (``get_loss``, ``get_loss_array``, ``predict``)
  against the JAX scan engine, float64, rtol 1e-9 (atol 1e-12 for the
  near-zero factors): two float64 implementations of one recursion whose
  inner score is autograd on both sides.
- K4's plain version ``ops/fused_ssd.batched_loss_reference`` against the
  JAX scan engine at rtol 1e-6, the bar of the JAX suite's own kernel tests
  (tests/test_pallas_ssd.py): the recursion amplifies last-ulp differences
  through T steps, and the plain version takes the hand-derived sweep where
  the scan takes autograd.  Once against the NumPy oracle
  (tests/oracle.msed_neural_filter), and against the Pallas kernel in
  interpret mode (one neural and one λ case, 6 maturities, T = 20, to keep
  its compile short).
- The plain version's hand-derived per-step score against autograd of
  −‖y − Z(γ)β̄‖², both transform variants and the λ family, rtol 1e-10.

Panels: a finite panel (windowed, and with K = 2 filter passes), one with an
interior NaN column, a partially NaN column (→ −Inf) and a NaN tail, and a
window that ends before the NaN column.
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
from tests.test_score_driven import _lambda_params, _neural_params  # noqa: E402
from yieldfactormodels_jl_tpu import config as jconfig  # noqa: E402
from yieldfactormodels_jl_tpu.models import api as japi  # noqa: E402
from yieldfactormodels_jl_tpu.models import params as jparams  # noqa: E402
from yieldfactormodels_jl_tpu.models import score_driven as JSD  # noqa: E402
from yieldfactormodels_jl_tpu.ops import linalg as jlinalg  # noqa: E402
from yieldfactormodels_jl_tpu.utils import nn_transform as jnn  # noqa: E402
from yieldfactormodels_jl_tpu_torch import config as tconfig  # noqa: E402
from yieldfactormodels_jl_tpu_torch.models import params as tparams  # noqa: E402
from yieldfactormodels_jl_tpu_torch.models import score_driven as TSD  # noqa: E402
from yieldfactormodels_jl_tpu_torch.ops import fused_ssd, linalg as tlinalg  # noqa: E402
from yieldfactormodels_jl_tpu_torch.utils import nn_transform as tnn  # noqa: E402

CPU = "cpu"
MATS = np.asarray(MATURITIES) / 12.0
CODES = ["1SSD-NNS", "1SD-NNS-Anchored", "1RWSD-NNS", "2SD-NNS", "SD-NS", "SRWSD-NS"]
T = 30
WINDOW = (3, 27)      # on the finite panel
SHORT = (0, 9)        # on the gapped panel: ends before its NaN column


def _specs(code):
    js, _ = J.create_model(code, tuple(MATS), float_type="float64")
    ts, _ = P.create_model(code, tuple(MATS), float_type="float64")
    return js, ts


def _params(js, n_draws=2, seed=7):
    """(n_draws, P) constrained draws around the JAX suite's stable points."""
    rng = np.random.default_rng(seed)
    if js.family == "msed_lambda":
        p, _ = _lambda_params(js, js.random_walk)
    elif js.n_unique == 2:
        p, _ = _neural_params(js, rng, js.random_walk)
    else:  # block-diagonal or diagonal dynamics: more step sizes
        p = np.zeros(js.n_params)
        for name, val in (("A", 2e-4), ("B", 0.97)):
            if name in js.layout:
                p[slice(*js.layout[name])] = val
        p[slice(*js.layout["omega"])] = rng.standard_normal(18) / 10
        p[slice(*js.layout["delta"])] = [0.3, -0.1, 0.05]
        p[slice(*js.layout["phi"])] = np.diag([0.95, 0.9, 0.85]).T.reshape(-1)
    batch = np.tile(p, (n_draws, 1))
    batch[1:] += 1e-4 * rng.standard_normal((n_draws - 1, p.shape[0]))
    return batch


@functools.lru_cache(maxsize=None)
def _panels():
    rng = np.random.default_rng(0)
    finite = oracle.simulate_dns_panel(rng, MATS, T=T)
    gapped = finite.copy()
    gapped[:, 10] = np.nan          # interior NaN column: transition-only
    gapped[4, 18] = np.nan          # partially NaN observed column: poisons
    gapped[:, T - 2:] = np.nan      # NaN tail: forecasts
    return finite, gapped


@functools.lru_cache(maxsize=None)
def _jax_results(code):
    """Every JAX quantity the tests compare, from one jitted program."""
    js, _ = _specs(code)
    finite, gapped = (jnp.asarray(x) for x in _panels())

    def one(p):
        return {
            "loss_window": JSD.get_loss(js, p, finite, *WINDOW),
            "loss_K2": JSD.get_loss(js, p, finite, 0, T, K=2),
            "loss_full": JSD.get_loss(js, p, finite),
            "loss_short": JSD.get_loss(js, p, gapped, *SHORT),
            "loss_gapped": JSD.get_loss(js, p, gapped),
            "array_gapped": JSD.get_loss_array(js, p, gapped, 0, T, K=2),
            "predict": JSD.predict(js, p, gapped),
        }

    out = jax.jit(jax.vmap(one))(jnp.asarray(_params(js)))
    return jax.tree_util.tree_map(np.asarray, out)


def _close(got, want, rtol, atol=0.0, what=""):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    np.testing.assert_array_equal(np.isfinite(got), np.isfinite(want), err_msg=what)
    fin = np.isfinite(want)
    np.testing.assert_allclose(got[fin], want[fin], rtol=rtol, atol=atol, err_msg=what)


@pytest.mark.parametrize("code", CODES)
def test_scan_matches_jax(code):
    _, ts = _specs(code)
    finite, gapped = _panels()
    want = _jax_results(code)
    p = torch.as_tensor(_params(ts))
    _close(P.get_loss(ts, p, finite, *WINDOW, device=CPU), want["loss_window"], 1e-9)
    _close(P.get_loss(ts, p, finite, 0, T, K=2, device=CPU), want["loss_K2"], 1e-9)
    _close(P.get_loss(ts, p, gapped, *SHORT, device=CPU), want["loss_short"], 1e-9)
    got = P.get_loss(ts, p, gapped, device=CPU)
    assert np.all(want["loss_gapped"] == -np.inf) and bool((got == -np.inf).all())
    _close(P.get_loss_array(ts, p, gapped, 0, T, K=2, device=CPU),
           want["array_gapped"], 1e-9)
    pred = P.predict(ts, p, gapped, device=CPU)
    assert set(pred) == set(want["predict"])
    for key, val in want["predict"].items():
        assert pred[key].shape == val.shape, key
        _close(pred[key], val, 1e-9, 1e-12, key)
    # one parameter vector: the JAX package's unbatched shapes
    one = P.predict(ts, p[0], gapped, device=CPU)
    _close(one["preds"], want["predict"]["preds"][0], 1e-9, 1e-12)


@pytest.mark.parametrize("code", CODES)
def test_kernel_plain_version_matches_jax_scan(code):
    _, ts = _specs(code)
    finite, gapped = (torch.as_tensor(x) for x in _panels())
    want = _jax_results(code)
    p = torch.as_tensor(_params(ts))
    calls = fused_ssd.batched_loss_reference.calls
    for key, data, (s, e) in (("loss_window", finite, WINDOW), ("loss_full", finite, (0, T)),
                              ("loss_short", gapped, SHORT), ("loss_gapped", gapped, (0, T))):
        _close(P.batched_loss(ts, p, data, s, e), want[key], 1e-6, what=key)
    assert fused_ssd.batched_loss_reference.calls == calls + 4  # the CPU path
    assert fused_ssd.batched_loss.launches == 0


def test_kernel_plain_version_matches_numpy_oracle():
    """The second witness: the independent NumPy loop (finite-difference
    scores) of the JAX suite, at its rtol 1e-6."""
    _, ts = _specs("1SSD-NNS")
    data = _panels()[0]
    p, struct = _neural_params(ts, np.random.default_rng(7))
    preds = oracle.msed_neural_filter(struct, MATS, data, True, scale_grad=True,
                                      forget_factor=ts.forget_factor)
    want = oracle.msed_loss_from_preds(preds, data)
    got = P.batched_loss(ts, p[None], data, device=CPU)
    np.testing.assert_allclose(got.numpy(), [want], rtol=1e-6)


@pytest.mark.parametrize("code", ["1SSD-NNS", "SSD-NS"])
def test_kernel_plain_version_matches_pallas_interpret(code):
    from yieldfactormodels_jl_tpu.ops.pallas_ssd import batched_loss as pallas_loss

    mats = np.linspace(0.25, 30.0, 6)
    js, _ = J.create_model(code, tuple(mats), float_type="float64")
    ts, _ = P.create_model(code, tuple(mats), float_type="float64")
    data = oracle.simulate_dns_panel(np.random.default_rng(1), mats, T=20)
    p = _params(js, n_draws=3)
    p[2, 0] = np.nan                                  # an invalid draw: −Inf
    want = np.asarray(pallas_loss(js, jnp.asarray(p), jnp.asarray(data), 2, 19,
                                  interpret=True))
    got = P.batched_loss(ts, p, data, 2, 19, device=CPU)
    assert want[2] == -np.inf
    _close(got, want, 1e-6)


@pytest.mark.parametrize("code", ["1SD-NNS", "1SD-NNS-Anchored", "SD-NS"])
def test_hand_derived_score_matches_autograd(code):
    _, ts = _specs(code)
    rng = np.random.default_rng(3)
    B = 4
    L = ts.L
    gamma = torch.as_tensor(rng.standard_normal((B, L)) * (0.3 if L > 1 else 0.1)
                            + (0.0 if L > 1 else np.log(0.5)))
    beta = torch.as_tensor(np.array([4.0, -1.0, 0.5]) + 0.1 * rng.standard_normal((B, 3)))
    y = torch.as_tensor(4.0 + 0.3 * rng.standard_normal(ts.N))
    geo = fused_ssd._geometry(ts)
    tau = torch.tensor(geo.mats, dtype=torch.float64)
    z2, z3, aux = fused_ssd._build(ts, gamma, tau, geo)
    Z = TSD.loadings_fn(ts, gamma)
    np.testing.assert_allclose(z2.numpy(), Z[..., 1].numpy(), rtol=1e-12, atol=1e-14)
    np.testing.assert_allclose(z3.numpy(), Z[..., 2].numpy(), rtol=1e-12, atol=1e-14)
    got = fused_ssd._score(ts, gamma, tau, geo, z2, z3, aux, beta, y)
    want = TSD._score(ts, gamma, beta, y)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-10,
                               atol=1e-10 * float(want.abs().max()))


def test_batched_loss_refusals():
    ts, _ = P.create_model("1C", tuple(MATS), float_type="float64")
    with pytest.raises(ValueError, match="MSED"):
        P.batched_loss(ts, np.zeros((1, ts.n_params)), np.zeros((ts.N, 10)), device=CPU)
    import dataclasses

    _, sd = _specs("SD-NS")
    exact = dataclasses.replace(sd, detach_inner_beta=False)
    with pytest.raises(ValueError, match="detached"):
        P.batched_loss(exact, _params(sd), _panels()[0], device=CPU)
    with pytest.raises(ValueError, match="params_batch must be"):
        P.batched_loss(sd, _params(sd)[0], _panels()[0], device=CPU)
    with pytest.raises(ValueError, match="data must be"):
        P.batched_loss(sd, _params(sd), _panels()[0][:5], device=CPU)


# ---------------------------------------------------------------------------
# the modules under the recursion
# ---------------------------------------------------------------------------

def test_nn_transforms_loadings_and_ols_match_jax():
    rng = np.random.default_rng(5)
    raw = rng.standard_normal((4, len(MATS)))
    mats_j, mats_t = jnp.asarray(MATS), torch.as_tensor(MATS)
    for tb in (True, False):
        for jf, tf in ((jnn.transform_net_1, tnn.transform_net_1),
                       (jnn.transform_net_2, tnn.transform_net_2)):
            np.testing.assert_allclose(tf(torch.as_tensor(raw), mats_t, tb).numpy(),
                                       np.asarray(jf(jnp.asarray(raw), mats_j, tb)),
                                       rtol=1e-12, atol=1e-15)
    gam = rng.standard_normal((3, 18)) / 5
    from yieldfactormodels_jl_tpu.models import loadings as jl
    from yieldfactormodels_jl_tpu_torch.models import loadings as tl
    for tb in (True, False):
        want = np.asarray(jax.vmap(lambda g: jl.neural_loadings(g, mats_j, tb))(
            jnp.asarray(gam)))
        np.testing.assert_allclose(tl.neural_loadings(torch.as_tensor(gam), mats_t, tb)
                                   .numpy(), want, rtol=1e-12, atol=1e-15)
    Z = np.stack([np.ones(len(MATS)), MATS, MATS ** 2], 1)
    Zs = np.stack([Z, Z * [1.0, 0.5, 0.25], np.stack([np.ones(len(MATS))] * 3, 1)])
    y = 4.0 + rng.standard_normal(len(MATS))
    got = tlinalg.ols_solve(torch.as_tensor(Zs), torch.as_tensor(y)).numpy()
    want = np.asarray(jax.vmap(lambda z: jlinalg.ols_solve(z, jnp.asarray(y)))(
        jnp.asarray(Zs)))
    np.testing.assert_allclose(got, want, rtol=1e-9)  # the third ZᵀZ is singular: ridge
    nan_Z = Zs.copy()
    nan_Z[0, 3, 1] = np.nan
    got = tlinalg.ols_solve(torch.as_tensor(nan_Z), torch.as_tensor(y)).numpy()
    assert np.isnan(got[0]).all() and np.isfinite(got[1:]).all()


@pytest.mark.parametrize("code", CODES + ["3SRWSD-NNS-Anchored"])
def test_unpack_and_initial_grid_match_jax(code):
    js, ts = _specs(code)
    p = _params(js, n_draws=3)
    want = jax.vmap(lambda q: jparams.unpack_msed(js, q))(jnp.asarray(p))
    got = tparams.unpack_msed(ts, torch.as_tensor(p))
    for name in want._fields:
        w = getattr(want, name)
        g = getattr(got, name)
        if w is None:
            assert g is None, name
            continue
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-14, err_msg=name)
    t = 1
    while True:
        w = jparams.get_new_initial_params(js, p[0], t)
        g = tparams.get_new_initial_params(ts, p[0], t)
        if w is None:
            assert g is None
            break
        np.testing.assert_array_equal(g, w)
        t += 1
    assert t - 1 == {"1SSD-NNS": 256, "2SD-NNS": 256, "SD-NS": 30}.get(code, t - 1)
    static = np.arange(12 + js.L, dtype=np.float64)
    np.testing.assert_array_equal(tparams.initialize_with_static_params(ts, p[0], static),
                                  jparams.initialize_with_static_params(js, p[0], static))


def test_engines_groups_and_refusals():
    for code in ("1SSD-NNS", "SD-NS", "NS", "1C", "TVλ"):
        js, ts = _specs(code)
        assert tconfig.engines_for(ts) == jconfig.engines_for(js), code
        assert P.get_param_groups(ts) == japi.get_param_groups(js, None), code
        from yieldfactormodels_jl_tpu_torch.models import api as tapi
        assert tapi.get_static_model_type(ts) == japi.get_static_model_type(js), code
    js, ts = _specs("SD-NS")
    groups = ["1"] * ts.n_params
    assert P.get_param_groups(ts, groups) == tuple(groups)
    p, data = _params(js), _panels()[0]
    with pytest.raises(NotImplementedError, match="item 10"):
        P.get_loss(ts, p, data, engine="score_tree", device=CPU)
    with pytest.raises(ValueError, match="K=1 only"):
        P.get_loss(ts, p, data, K=2, engine="score_tree", device=CPU)
    _, ssd = _specs("SSD-NS")  # EWMA-scaled: no tree engine
    with pytest.raises(ValueError, match="not applicable"):
        P.get_loss(ssd, p, data, engine="score_tree", device=CPU)
    with pytest.raises(ValueError, match="not applicable"):
        P.get_loss(ts, p, data, engine="univariate", device=CPU)
    # the static families run now (tests/test_torch_static.py holds them
    # against JAX)
    _, ns = _specs("NS")
    assert P.get_loss(ns, np.zeros(ns.n_params), data, device=CPU).shape == ()
    res = P.predict(ns, np.zeros(ns.n_params), data, device=CPU)
    assert res["preds"].shape == data.shape and res["factors"].shape == (3, data.shape[1])
