"""The port's coded engines, ``taxonomy.diagnose`` and the retry path against
the JAX package, on the CPU, in float64 at N = 6 maturities, T = 40.

- For a Kalman ("1C" and TVλ), a score-driven ("SD-NS") and a static
  ("NS") spec: ``diagnose`` (the univariate engine's ``get_loss_coded`` for
  the Kalman families, ``score_driven.get_loss_coded``,
  ``static_model.get_loss_coded``) against JAX's, and for the Kalman specs
  also the joint form's ``kalman.get_loss_coded``: the loss at rtol 1e-10
  (or −Inf in both) and the code equal, on a healthy point and on
  non-finite parameters (TRANSFORM_OVERFLOW), an all-NaN window
  (MISSING_ALL_OBS) and a blown-up state (STATE_EXPLODED).  A coded loss
  equals its family's ``get_loss`` bit for bit.
- ``univariate_kf.filter_moments`` against JAX's at rtol 1e-10.
- ``run_single_window_task(sentinel_policy="retry")`` on a window whose fit
  returns a non-finite loss raises ``SentinelFailure`` with JAX's code.
"""

import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)  # tiny tensors; leave the cores to the other test workers

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import yieldfactormodels_jl_tpu as J  # noqa: E402
import yieldfactormodels_jl_tpu_torch as P  # noqa: E402
from tests import oracle  # noqa: E402
from yieldfactormodels_jl_tpu import forecasting as jfc  # noqa: E402
from yieldfactormodels_jl_tpu.models import kalman as jkalman  # noqa: E402
from yieldfactormodels_jl_tpu.ops import univariate_kf as juni  # noqa: E402
from yieldfactormodels_jl_tpu.orchestration.retry import SentinelFailure as JSentinel  # noqa: E402
from yieldfactormodels_jl_tpu.robustness import taxonomy as jtax  # noqa: E402
from yieldfactormodels_jl_tpu_torch import forecasting as tfc  # noqa: E402
from yieldfactormodels_jl_tpu_torch.models import kalman as tkalman  # noqa: E402
from yieldfactormodels_jl_tpu_torch.ops import univariate_kf as tuni  # noqa: E402
from yieldfactormodels_jl_tpu_torch.orchestration.retry import SentinelFailure  # noqa: E402
from yieldfactormodels_jl_tpu_torch.robustness import taxonomy as ttax  # noqa: E402

CPU = "cpu"
MATS = tuple(np.array([3.0, 12.0, 24.0, 60.0, 120.0, 360.0]) / 12.0)
T = 40
STABLE = {"1C": lambda s: oracle.stable_1c_params(s, np.float64),
          "TVλ": oracle.stable_tvl_params,
          "SD-NS": oracle.stable_msed_params,
          "NS": lambda s: oracle.stable_ns_params(s, np.float64)}


def _panel():
    rng = np.random.default_rng(4)
    return 4.0 + np.cumsum(0.05 * rng.standard_normal((len(MATS), T)), axis=1)


def _cases(spec):
    """name → (params, data, start, end, the bit the case must raise)."""
    p, d = STABLE[spec.model_string](spec), _panel()
    overflow = p.copy()
    overflow[spec.layout["delta"][0]] = np.inf
    gap = d.copy()
    gap[:, 10:20] = np.nan
    exploded = p.copy()
    lo, _ = spec.layout["delta"]
    exploded[lo] = 1e300           # the first factor's intercept overflows the state
    return {"healthy": (p, d, 0, T, 0),
            "non-finite parameters": (overflow, d, 0, T, ttax.TRANSFORM_OVERFLOW),
            "all-NaN window": (p, gap, 10, 20, ttax.MISSING_ALL_OBS),
            "blown-up state": (exploded, d, 0, T, ttax.STATE_EXPLODED)}


def _same_loss(got, want, what):
    if np.isfinite(want):
        np.testing.assert_allclose(got, want, rtol=1e-10, err_msg=what)
    else:
        assert got == want, what


@pytest.mark.parametrize("code", list(STABLE))
def test_coded_engines_and_diagnose_match_jax(code):
    js, _ = J.create_model(code, MATS, float_type="float64")
    ts, _ = P.create_model(code, MATS, float_type="float64")
    joint = jax.jit(lambda p, d, s, e: jkalman.get_loss_coded(js, p, d, s, e))
    for name, (p, d, s, e, flag) in _cases(ts).items():
        what = f"{code}, {name}"
        ll_j, code_j = jtax.diagnose(js, p, d, s, e)
        ll_t, code_t = ttax.diagnose(ts, p, d, s, e, device=CPU)
        assert isinstance(ll_t, float) and isinstance(code_t, int)
        assert code_t == code_j, f"{what}: {ttax.describe(code_t)} vs {jtax.describe(code_j)}"
        assert code_t & flag == flag and (flag or code_t == 0), what
        _same_loss(ll_t, ll_j, what)
        pt, dt = torch.as_tensor(p), torch.as_tensor(d)
        assert ll_t == float(P.get_loss(ts, pt, dt, s, e)), what  # the same value, bit for bit
        if ts.is_kalman:
            ll_k, code_k = tkalman.get_loss_coded(ts, pt, dt, s, e)
            ll_kj, code_kj = joint(jnp.asarray(p), jnp.asarray(d), s, e)
            assert int(code_k) == int(code_kj), f"{what}: joint form"
            _same_loss(float(ll_k), float(ll_kj), f"{what}: joint form")
            assert float(ll_k) == float(tkalman.get_loss(ts, pt, dt, s, e))
    # a draw batch carries one code a draw
    rows = [c[0] for c in _cases(ts).values()]
    d = _panel()
    ll_b, code_b = ttax.coded_loss_fn(ts)(ts, torch.as_tensor(np.stack(rows)),
                                          torch.as_tensor(d), 0, T)
    assert code_b.shape == (4,) and code_b.dtype == torch.int32
    for i, row in enumerate(rows):
        assert int(code_b[i]) == ttax.diagnose(ts, row, d, device=CPU)[1]


@pytest.mark.parametrize("code", ["1C", "TVλ"])
def test_filter_moments_match_jax(code):
    js, _ = J.create_model(code, MATS, float_type="float64")
    ts, _ = P.create_model(code, MATS, float_type="float64")
    p, d = STABLE[code](ts), _panel()
    d[:, 7] = np.nan
    _, want = jax.jit(lambda p, d: juni.filter_moments(js, p, d, 2, 35))(
        jnp.asarray(p), jnp.asarray(d))
    _, got = tuni.filter_moments(ts, torch.as_tensor(p), torch.as_tensor(d), 2, 35)
    for k in ("beta_pred", "P_pred", "beta_upd", "P_upd", "ll", "obs"):
        assert got[k].shape == want[k].shape, k
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), rtol=1e-10,
                                   atol=1e-12, err_msg=k)


def test_retry_raises_sentinel_failure_with_jaxs_code(tmp_path, monkeypatch):
    """The fit of the window returns a non-finite loss at a point whose
    intercept overflowed: both packages raise the sentinel with the code of
    one coded evaluation there."""
    loc = str(tmp_path) + os.sep
    js, _ = J.create_model("1C", MATS, float_type="float64", results_location=loc)
    ts, _ = P.create_model("1C", MATS, float_type="float64", results_location=loc)
    bad = _cases(ts)["non-finite parameters"][0]
    for mod in (jfc, tfc):
        monkeypatch.setattr(mod, "_estimate_for_window",
                            lambda *a, **k: (-np.inf, bad.copy()))
    args = ("1", 32, "expanding", 30, 1, 3, oracle.stable_1c_params(ts, np.float64))
    with pytest.raises(JSentinel) as want:
        jfc.run_single_window_task(js, _panel(), *args, sentinel_policy="retry")
    with pytest.raises(SentinelFailure) as got:
        tfc.run_single_window_task(ts, _panel(), *args, sentinel_policy="retry", device=CPU)
    assert got.value.seam == want.value.seam == "estimate"
    assert got.value.code == want.value.code
    assert got.value.code & ttax.TRANSFORM_OVERFLOW
    assert str(got.value) == str(want.value)
    assert not [f for _, _, files in os.walk(loc) for f in files]   # no shard written
