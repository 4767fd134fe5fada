"""The port's square-root engine "sqrt" (``ops/sqrt_kf``) against the JAX
package's, on the CPU, float64, rtol 1e-10.

Loss and taxonomy code of ``get_loss_coded`` on "1C", AFNS5 and TVλ, on a
panel with a NaN column and a partly NaN column, over the full sample, a
[start, end) window and a window with no contributing step
(MISSING_ALL_OBS), for a batch of three draws: a stable one, one with
σ² < 0 (−Inf, NONPSD_INNOVATION) and one with a NaN entry (−Inf,
TRANSFORM_OVERFLOW).  The QR's sign convention may differ between the
packages, so losses are compared, never factors.  Then the same through
``api.get_loss(engine="sqrt")``.
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
from tests.test_afns import _afns5_params  # noqa: E402
from tests.test_extensions import _dns_params  # noqa: E402
from yieldfactormodels_jl_tpu.ops import sqrt_kf as JSQ  # noqa: E402
from yieldfactormodels_jl_tpu_torch.ops import sqrt_kf as TSQ  # noqa: E402
from yieldfactormodels_jl_tpu_torch.robustness import taxonomy as tax  # noqa: E402

MATS = np.asarray(MATURITIES) / 12.0
T = 30
WINDOWS = [(0, T), (3, 27), (5, 7)]


def _panel():
    data = oracle.simulate_dns_panel(np.random.default_rng(0), MATS, T=80)[:, :T]
    data[:, 9] = np.nan
    data[4, 15] = np.nan
    return data


@functools.lru_cache(maxsize=None)
def _specs(code):
    js, _ = J.create_model(code, tuple(MATS), float_type="float64")
    ts, _ = P.create_model(code, tuple(MATS), float_type="float64")
    return js, ts


def _batch(code):
    js, _ = _specs(code)
    if code == "AFNS5":
        p, *_ = _afns5_params(js)
    elif code == "1C":
        p = _dns_params()
    else:
        p = np.asarray(oracle.stable_tvl_params(js), dtype=np.float64)
    b = np.tile(p, (3, 1))
    b[1, js.layout["obs_var"][0]] = -4e-4
    b[2, js.layout["delta"][0]] = np.nan
    return b


@functools.lru_cache(maxsize=None)
def _jax_coded(code):
    js, _ = _specs(code)
    return jax.jit(jax.vmap(lambda q, d, s, e: JSQ.get_loss_coded(js, q, d, s, e),
                            in_axes=(0, None, None, None)))


@pytest.mark.parametrize("window", WINDOWS, ids=["full", "window", "no-contribution"])
@pytest.mark.parametrize("code", ["1C", "AFNS5", "TVλ"])
def test_sqrt_engine_matches_jax(code, window):
    _, ts = _specs(code)
    batch, data = _batch(code), _panel()
    start, end = window
    want, want_code = _jax_coded(code)(jnp.asarray(batch), jnp.asarray(data), start, end)
    got, got_code = TSQ.get_loss_coded(ts, torch.as_tensor(batch), torch.as_tensor(data),
                                       start, end)
    want, want_code = np.asarray(want), np.asarray(want_code)
    np.testing.assert_array_equal(got_code.numpy(), want_code)
    np.testing.assert_array_equal(np.isfinite(got.numpy()), np.isfinite(want))
    fin = np.isfinite(want)
    np.testing.assert_allclose(got.numpy()[fin], want[fin], rtol=1e-10)
    if window == (5, 7):
        assert "MISSING_ALL_OBS" in tax.decode(int(got_code[0]))
    else:
        assert np.isfinite(want[0]) and int(got_code[0]) == 0
        assert want[1] == -np.inf and want[2] == -np.inf
        assert "NONPSD_INNOVATION" in tax.decode(int(got_code[1]))
    assert "TRANSFORM_OVERFLOW" in tax.describe(int(got_code[2])).split("|")


@pytest.mark.parametrize("code", ["1C", "AFNS5", "TVλ"])
def test_api_sqrt_engine_matches_jax(code):
    _, ts = _specs(code)
    batch, data = _batch(code), _panel()
    got = P.get_loss(ts, batch, data, 3, 27, engine="sqrt", device="cpu")
    want, _ = _jax_coded(code)(jnp.asarray(batch), jnp.asarray(data), 3, 27)
    np.testing.assert_array_equal(np.isfinite(got.numpy()), np.isfinite(np.asarray(want)))
    np.testing.assert_allclose(float(got[0]), float(want[0]), rtol=1e-10)


def test_psd_projected_recovery_mode_matches_jax():
    """``init_psd_floor``: P₀ and Ω_state PSD-projected (eigenvalues clipped)
    instead of the −Inf sentinel, on "1C" for a stable draw and one whose
    Φ₁₁ = 1.5 leaves P₀ indefinite.  Eigenvectors are unique up to sign and
    order, which the filter does not see (S Sᵀ is the same); rtol 1e-9 for
    the explosive draw, whose states grow as 1.5ᵗ."""
    js, ts = _specs("1C")
    batch, data = _batch("1C")[:2].copy(), _panel()
    batch[1] = batch[0]
    batch[1, js.layout["phi"][0]] = 1.5
    fn = jax.jit(jax.vmap(lambda q, d: JSQ.get_loss_coded(js, q, d, 0, None, 1e-8),
                          in_axes=(0, None)))
    want, want_code = (np.asarray(x) for x in fn(jnp.asarray(batch), jnp.asarray(data)))
    got, got_code = TSQ.get_loss_coded(ts, torch.as_tensor(batch), torch.as_tensor(data),
                                       init_psd_floor=1e-8)
    assert np.isfinite(want).all()
    np.testing.assert_array_equal(got_code.numpy(), want_code)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-9)
