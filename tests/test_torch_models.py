"""The PyTorch port's model layer and Kalman filters against the JAX package.

Same inputs, made with numpy from a seed, go through the JAX function and its
counterpart in ``yieldfactormodels_jl_tpu_torch``, on the CPU, in float64.
Tolerances: 1e-12 for the closed-form pieces (transforms, unpacking, the
unconditional start, loadings) and 1e-10 relative for the log-likelihoods
and forecasts, whose T-step recursions sum in another order.
"""

import ast
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)  # tiny tensors; leave the cores to the other test workers

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import yieldfactormodels_jl_tpu as J  # noqa: E402
import yieldfactormodels_jl_tpu_torch as P  # noqa: E402
from yieldfactormodels_jl_tpu.models import afns as j_afns  # noqa: E402
from yieldfactormodels_jl_tpu.models import api as j_api  # noqa: E402
from yieldfactormodels_jl_tpu.models import kalman as j_kalman  # noqa: E402
from yieldfactormodels_jl_tpu.models import loadings as j_loadings  # noqa: E402
from yieldfactormodels_jl_tpu.models import params as j_params  # noqa: E402
from yieldfactormodels_jl_tpu.models import registry as j_registry  # noqa: E402
from yieldfactormodels_jl_tpu_torch.models import afns as t_afns  # noqa: E402
from yieldfactormodels_jl_tpu_torch.models import kalman as t_kalman  # noqa: E402
from yieldfactormodels_jl_tpu_torch.models import loadings as t_loadings  # noqa: E402
from yieldfactormodels_jl_tpu_torch.models import params as t_params  # noqa: E402
from yieldfactormodels_jl_tpu_torch.models import registry as t_registry  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MATS = tuple(np.array([3, 12, 36, 60, 120, 240]) / 12.0)          # N = 6
MATS20 = tuple(np.array([3, 6, 9, 12, 15, 18, 21, 24, 30, 36, 48, 60, 72, 84,
                         96, 108, 120, 180, 240, 360]) / 12.0)
CPU = "cpu"
KALMAN_CASES = ["1C", "AFNS5", "TVλ", "TVλ-exact"]


def _specs(code, mats=MATS):
    """(JAX spec, port spec) in float64; "TVλ-exact" is TVλ with the exact
    EKF Jacobian."""
    import dataclasses

    base = "TVλ" if code == "TVλ-exact" else code
    js, _ = J.create_model(base, mats, float_type="float64")
    ts, _ = P.create_model(base, mats, float_type="float64")
    if code == "TVλ-exact":
        js = dataclasses.replace(js, exact_jacobian=True)
        ts = dataclasses.replace(ts, exact_jacobian=True)
    return js, ts


def _kalman_params(spec, B, rng):
    """(B, n_params) stationary constrained draws for any Kalman spec."""
    p = np.zeros((B, spec.n_params))
    if "gamma" in spec.layout:
        lo, hi = spec.layout["gamma"]
        p[:, lo:hi] = np.log(0.4) + 0.2 * rng.standard_normal((B, hi - lo))
    p[:, spec.layout["obs_var"][0]] = 0.01
    a, _ = spec.layout["chol"]
    rows, cols = spec.chol_indices
    for k, (r, c) in enumerate(zip(rows, cols)):
        p[:, a + k] = 0.1 if r == c else 0.01 + 0.01 * rng.random(B)
    Ms = spec.state_dim
    lo, hi = spec.layout["delta"]
    p[:, lo:hi] = 0.2 * rng.standard_normal((B, Ms))
    lo, hi = spec.layout["phi"]
    phi = 0.9 * np.eye(Ms) + 0.02 * rng.standard_normal((B, Ms, Ms))
    p[:, lo:hi] = phi.reshape(B, -1)
    return p


def _panel(rng, N, T):
    data = 0.5 * rng.standard_normal((N, T)) + 4.0
    data[:, -3:] = np.nan      # forecast tail → predict-only steps
    data[2, 10] = np.nan       # interior partial NaN → whole column missing
    data[:, 15] = np.nan
    return data


def _t(x):
    return torch.as_tensor(np.asarray(x), dtype=torch.float64)


# ---------------------------------------------------------------------------
# specs and the registry
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("code", j_registry.MODEL_CODES)
def test_create_model_matches_jax(code):
    js, jc = J.create_model(code, MATS20, float_type="float64")
    ts, tc = P.create_model(code, MATS20, float_type="float64")
    assert tc == jc
    if js is None:
        assert ts is None
        return
    assert ts.family == js.family and ts.model_code == js.model_code
    assert ts.n_params == js.n_params
    assert ts.layout == js.layout
    assert ts.transform_codes == js.transform_codes
    assert ts.state_dim == js.state_dim and ts.n_lambdas == js.n_lambdas
    assert ts.n_unique == js.n_unique and ts.duplicator == js.duplicator
    assert ts.default_param_groups() == js.default_param_groups()
    assert ts.A_guesses == js.A_guesses and ts.B_guesses == js.B_guesses
    for a, b in zip(ts.chol_indices, js.chol_indices):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(ts.transform_codes_array().numpy(),
                                  np.asarray(js.transform_codes_array))
    np.testing.assert_allclose(ts.maturities_array(CPU).numpy(),
                               np.asarray(js.maturities_array), rtol=0)


def test_aliases_and_codes_match_jax():
    for alias in j_registry._TABLE:
        assert P.create_model(alias, MATS)[1] == J.create_model(alias, MATS)[1]
    assert set(t_registry.valid_codes()) == set(j_registry.MODEL_CODES)
    with pytest.raises(ValueError, match="Invalid model type"):
        P.create_model("no-such-model", MATS)


@pytest.mark.parametrize("code", t_registry.PROGRAM_CODES)
def test_program_codes_say_not_ported(code):
    assert code in j_registry.valid_codes()  # a real code in the JAX package
    with pytest.raises(ValueError, match="program/ layer is not ported"):
        P.create_model(code, MATS)


# ---------------------------------------------------------------------------
# transforms, unpacking, start, loadings (1e-12)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("code", ["1C", "AFNS5", "TVλ", "SD-NS", "1RWSD-NNS", "NS"])
def test_transforms_round_trip_against_jax(code, rng):
    js, ts = _specs(code)
    raw = rng.standard_normal((3, js.n_params))
    con_j = np.asarray(j_params.transform_params(js, jnp.asarray(raw)))
    con_t = P.transform_params(ts, _t(raw))
    np.testing.assert_allclose(con_t.numpy(), con_j, rtol=1e-12, atol=1e-12)
    back_j = np.asarray(j_params.untransform_params(js, jnp.asarray(con_j)))
    back_t = P.untransform_params(ts, con_t)
    np.testing.assert_allclose(back_t.numpy(), back_j, rtol=1e-12, atol=1e-12)
    np.testing.assert_allclose(back_t.numpy(), raw, rtol=1e-10, atol=1e-10)


def test_expand_and_unique_params_match_jax(rng):
    dup = (0, 0, 1, 1, 2, 2)
    u = rng.standard_normal((2, 3))
    full = t_params.expand_params(_t(u), dup)
    np.testing.assert_array_equal(full.numpy(),
                                  np.asarray(j_params.expand_params(jnp.asarray(u), dup)))
    np.testing.assert_array_equal(t_params.get_unique_params(full, dup).numpy(), u)


@pytest.mark.parametrize("code", ["1C", "AFNS3", "AFNS5", "TVλ"])
def test_unpack_and_init_state_match_jax(code, rng):
    js, ts = _specs(code)
    p = _kalman_params(js, 3, rng)
    kt = t_params.unpack_kalman(ts, _t(p))
    st = t_kalman.init_state(ts, kt)
    def jax_side(q):
        kj = j_params.unpack_kalman(js, q)
        return kj, j_kalman.init_state(js, kj)

    kj, sj = jax.jit(jax.vmap(jax_side))(jnp.asarray(p))
    for name in ("obs_var", "Omega_state", "delta", "Phi"):
        np.testing.assert_allclose(getattr(kt, name).numpy(),
                                   np.asarray(getattr(kj, name)),
                                   rtol=1e-12, atol=1e-12, err_msg=name)
    if kj.gamma is None:
        assert kt.gamma is None
    else:
        np.testing.assert_array_equal(kt.gamma.numpy(), np.asarray(kj.gamma))
    np.testing.assert_allclose(st.beta.numpy(), np.asarray(sj.beta),
                               rtol=1e-12, atol=1e-12)
    np.testing.assert_allclose(st.P.numpy(), np.asarray(sj.P), rtol=1e-12, atol=1e-12)


def test_init_state_singular_phi_gives_nan_like_jax():
    js, ts = _specs("1C")
    p = np.zeros(js.n_params)
    lo, hi = js.layout["phi"]
    p[lo:hi] = np.eye(3).reshape(-1)          # I − Φ singular
    st = t_kalman.init_state(ts, t_params.unpack_kalman(ts, _t(p)))
    sj = j_kalman.init_state(js, j_params.unpack_kalman(js, jnp.asarray(p)))
    assert not np.isfinite(np.asarray(sj.beta)).all()
    assert torch.isnan(st.beta).all() and torch.isnan(st.P).all()


@pytest.mark.parametrize("code", ["AFNS3", "AFNS5"])
def test_afns_loadings_and_yield_adjustment_match_jax(code, rng):
    js, ts = _specs(code, MATS20)
    p = _kalman_params(js, 2, rng)
    kt = t_params.unpack_kalman(ts, _t(p))
    mats_t = ts.maturities_array(CPU)
    Zt = t_afns.afns_loadings(kt.gamma, mats_t, ts.M)
    dt = t_afns.yield_adjustment(kt.gamma, kt.Omega_state, mats_t, ts.M)
    for b in range(2):
        kj = j_params.unpack_kalman(js, jnp.asarray(p[b]))
        Zj = j_afns.afns_loadings(kj.gamma, js.maturities_array, js.M)
        dj = j_afns.yield_adjustment(kj.gamma, kj.Omega_state, js.maturities_array, js.M)
        np.testing.assert_allclose(Zt[b].numpy(), np.asarray(Zj), rtol=1e-12, atol=1e-12)
        np.testing.assert_allclose(dt[b].numpy(), np.asarray(dj), rtol=1e-12, atol=1e-14)


def test_dns_loadings_match_jax(rng):
    gamma = rng.standard_normal((4, 1))
    mats = np.asarray(MATS20)
    Zt = t_loadings.dns_loadings(_t(gamma), _t(mats))
    for b in range(4):
        Zj = j_loadings.dns_loadings(jnp.asarray(gamma[b]), jnp.asarray(mats))
        np.testing.assert_allclose(Zt[b].numpy(), np.asarray(Zj), rtol=1e-12, atol=1e-14)
    assert t_loadings.LAMBDA_FLOOR == j_loadings.LAMBDA_FLOOR


# ---------------------------------------------------------------------------
# log-likelihood and forecasts (rtol 1e-10)
# ---------------------------------------------------------------------------

def _jax_losses(js, p, data, windows, engine):
    """JAX losses of each draw for each (start, end) window: one compile,
    the window passed as traced scalars."""
    fn = jax.jit(jax.vmap(
        lambda q, s, e: j_api.get_loss(js, q, jnp.asarray(data), s, e, engine=engine),
        in_axes=(0, None, None)))
    T = data.shape[1]
    return [np.asarray(fn(jnp.asarray(p), s, T if e is None else e))
            for s, e in windows]


@pytest.mark.parametrize("engine", ["univariate", "joint"])
@pytest.mark.parametrize("code", KALMAN_CASES)
def test_get_loss_matches_jax(code, engine, rng):
    js, ts = _specs(code)
    T, B = 30, 3
    p = _kalman_params(js, B, rng)
    data = _panel(rng, js.N, T)
    windows = ((0, None), (2, T - 4))
    refs = _jax_losses(js, p, data, windows, engine)
    for (start, end), ref in zip(windows, refs):
        got = P.get_loss(ts, p, data, start, end, engine=engine, device=CPU)
        assert got.shape == (B,) and got.dtype == torch.float64
        assert np.isfinite(ref).all()
        np.testing.assert_allclose(got.numpy(), ref, rtol=1e-10)
    one = P.get_loss(ts, p[0], data, engine=engine, device=CPU)  # one vector
    assert one.shape == ()
    np.testing.assert_allclose(one.item(), refs[0][0], rtol=1e-10)


def test_invalid_draw_gives_neg_inf_and_neighbour_stays_finite(rng):
    js, ts = _specs("1C")
    p = _kalman_params(js, 2, rng)
    p[1] = np.nan
    data = _panel(rng, js.N, 20)
    for engine in ("univariate", "joint"):
        got = P.get_loss(ts, p, data, engine=engine, device=CPU).numpy()
        assert np.isfinite(got[0]) and got[1] == -np.inf


@pytest.mark.parametrize("code", ["1C", "AFNS5", "TVλ"])
def test_predict_matches_jax(code, rng):
    js, ts = _specs(code)
    p = _kalman_params(js, 1, rng)[0]
    data = _panel(rng, js.N, 24)
    data = np.concatenate([data, np.full((js.N, 4), np.nan)], axis=1)
    ref = jax.jit(lambda q, d: J.predict(js, q, d))(jnp.asarray(p), jnp.asarray(data))
    got = P.predict(ts, p, data, device=CPU)
    assert set(got) == set(ref)
    for key in ref:
        r = np.asarray(ref[key])
        assert got[key].shape == r.shape, key
        np.testing.assert_allclose(got[key].numpy(), r, rtol=1e-10, atol=1e-12,
                                   err_msg=key)


def test_batched_predict_matches_per_draw(rng):
    js, ts = _specs("AFNS5")
    p = _kalman_params(js, 3, rng)
    data = _panel(rng, js.N, 20)
    batched = P.predict(ts, p, data, device=CPU)
    for b in range(3):
        one = P.predict(ts, p[b], data, device=CPU)
        for key in one:
            np.testing.assert_allclose(batched[key][b].numpy(), one[key].numpy(),
                                       rtol=1e-12, atol=1e-12, err_msg=key)


# ---------------------------------------------------------------------------
# entry-point rules
# ---------------------------------------------------------------------------

def test_engine_and_family_errors(rng):
    _, ts = _specs("TVλ")
    data = _panel(rng, ts.N, 20)
    p = np.zeros(ts.n_params)
    with pytest.raises(ValueError, match="unknown kalman engine"):
        P.get_loss(ts, p, data, engine="nope", device=CPU)
    with pytest.raises(ValueError, match="not applicable"):
        P.get_loss(ts, p, data, engine="assoc", device=CPU)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        P.get_loss(ts, p, data, engine="slr", device=CPU)
    assert P.get_loss(ts, p, data, engine="sqrt", device=CPU).shape == ()
    # the static families run (tests/test_torch_static.py holds them against
    # JAX); an explicit engine is a caller error for them, as in JAX
    static, _ = P.create_model("NS", MATS, float_type="float64")
    assert P.get_loss(static, np.zeros(static.n_params), data, device=CPU).shape == ()
    with pytest.raises(ValueError, match="not applicable"):
        P.get_loss(static, np.zeros(static.n_params), data, engine="univariate", device=CPU)


def test_numpy_input_without_device_needs_cuda(rng):
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA card: device=None is valid here")
    _, ts = _specs("1C")
    p = _kalman_params(ts, 2, rng)
    data = _panel(rng, ts.N, 20)
    for call in (lambda: P.get_loss(ts, p, data),
                 lambda: P.predict(ts, p[0], data),
                 lambda: P.batched_loglik(ts, p, data),
                 lambda: P.params_from_jax(ts, p)):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            call()


def test_params_from_jax_keeps_the_flat_layout(rng):
    js, ts = _specs("AFNS5")
    p = _kalman_params(js, 4, rng)
    got = P.params_from_jax(ts, p, device=CPU)
    assert got.dtype == torch.float64 and got.shape == (4, js.n_params)
    np.testing.assert_array_equal(got.numpy(), p)
    assert P.params_from_jax(ts, p, device=CPU, dtype=torch.float32).dtype == torch.float32
    with pytest.raises(ValueError, match="takes 48 parameters"):
        P.params_from_jax(ts, p[:, :-1], device=CPU)


def _port_sources():
    pkg = os.path.join(ROOT, "yieldfactormodels_jl_tpu_torch")
    for dirpath, _, files in os.walk(pkg):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(dirpath, f)
    yield os.path.join(ROOT, "chip_smoke.py")


def test_port_imports_neither_jax_nor_the_jax_package():
    banned = ("jax", "jaxlib", "yieldfactormodels_jl_tpu")
    files = list(_port_sources())
    assert len(files) >= 15, files  # the walk found the package
    for path in files:
        tree = ast.parse(open(path, encoding="utf-8").read(), path)
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module or ""]
            else:
                continue
            for name in names:
                assert name.split(".")[0] not in banned, f"{path} imports {name}"

