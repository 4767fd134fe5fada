"""The port's SV particle filter (``ops/particle``) against the JAX package,
on the CPU.

- ``particle_filter_loglik(noise=...)`` against JAX's on the same numpy
  noise, float64, rtol 1e-9 (one algorithm, summation orders aside): AFNS5
  and "1C" at T = 40, P = 128 particles, D = 3 draws; ``ess_threshold`` 0
  (never resamples) and 1.5 (resamples every contributing step); a NaN
  column (a predict-only step); two invalid draws, Φ₁₁ > 1 and σ² < 0,
  −Inf in both packages with JAX's ``with_code`` codes; every resampling
  offset u = 0 (searchsorted-left clones particle 0).  The JAX side is one
  jitted function per spec, vmapped over draws, with the threshold traced.
- Against the independent NumPy oracle (tests/oracle.rbpf_loglik: the joint
  per-particle update) at rtol 1e-8.
- σ_h = 0 against the port's "sqrt" engine at rtol 1e-9: every particle
  then runs the exact filter.
- The generator mode: finite, and the same value from the same seed; the
  draw sweep ``estimation.sv.pf_draw_logliks`` on one noise pair; a JAX
  draw and its noise carried by ``params_from_jax``/``config.as_tensor``.
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
from yieldfactormodels_jl_tpu.ops import particle as JPF  # noqa: E402
from yieldfactormodels_jl_tpu_torch.ops import sqrt_kf as TSQ  # noqa: E402

MATS = np.asarray(MATURITIES) / 12.0
T, NP, D = 40, 128, 3


def _panel(seed=0):
    return oracle.simulate_dns_panel(np.random.default_rng(seed), MATS, T=80)[:, :T]


def _batch(code, rng):
    """(D, n_params) float64 draws: the JAX suite's stable point with its
    decay drivers and δ jittered (distinct trajectories per draw)."""
    if code == "AFNS5":
        spec, _ = J.create_model(code, tuple(MATS), float_type="float64")
        p, *_ = _afns5_params(spec)
        b = np.tile(p, (D, 1))
        b[:, 0:2] += 0.05 * rng.standard_normal((D, 2))
        b[:, 18:23] += 0.05 * rng.standard_normal((D, 5))
        return b
    b = np.tile(_dns_params(), (D, 1))
    b[:, 0] += 0.05 * rng.standard_normal(D)
    b[:, 8:11] += 0.05 * rng.standard_normal((D, 3))
    return b


@functools.lru_cache(maxsize=None)
def _specs(code):
    js, _ = J.create_model(code, tuple(MATS), float_type="float64")
    ts, _ = P.create_model(code, tuple(MATS), float_type="float64")
    return js, ts


@functools.lru_cache(maxsize=None)
def _jax_filter(code):
    """JAX's filter, vmapped over draws and their noise, jitted once per
    spec: (batch, data, normals, uniforms, ess_threshold) → (loss, code)."""
    js, _ = _specs(code)

    def one(q, data, nz, u, th):
        return JPF.particle_filter_loglik(js, q, data, n_particles=NP, noise=(nz, u),
                                          ess_threshold=th, with_code=True)

    return jax.jit(jax.vmap(one, in_axes=(0, None, 0, 0, None)))


def _both(code, batch, data, nz, u, th=0.5):
    want, want_code = _jax_filter(code)(jnp.asarray(batch), jnp.asarray(data),
                                        jnp.asarray(nz), jnp.asarray(u), th)
    _, ts = _specs(code)
    got, got_code = P.particle_filter_loglik(
        ts, torch.as_tensor(batch), torch.as_tensor(data), n_particles=NP,
        noise=(torch.as_tensor(nz), torch.as_tensor(u)), ess_threshold=th, with_code=True)
    return (np.asarray(want), np.asarray(want_code), got.numpy(), got_code.numpy())


def _noise(rng, zero_offsets=False):
    nz = rng.standard_normal((D, T - 1, NP))
    u = np.zeros((D, T - 1)) if zero_offsets else rng.uniform(size=(D, T - 1))
    return nz, u


CASES = ["ess 0.5", "ess 0", "ess 1.5", "NaN column", "invalid draws", "u = 0"]


@pytest.mark.parametrize("code", ["AFNS5", "1C"])
@pytest.mark.parametrize("case", CASES)
def test_filter_matches_jax_common_noise(code, case):
    rng = np.random.default_rng(11)
    batch = _batch(code, rng)
    nz, u = _noise(rng, zero_offsets=case == "u = 0")
    data = _panel()
    th = {"ess 0": 0.0, "ess 1.5": 1.5, "u = 0": 1.5}.get(case, 0.5)
    if case == "NaN column":
        data[:, 7] = np.nan
    if case == "invalid draws":
        js, _ = _specs(code)
        lo, _ = js.layout["phi"]
        batch[0, lo] = 1.5                          # Φ₁₁ > 1: the P₀ factorization fails
        batch[1, js.layout["obs_var"][0]] = -4e-4   # σ² < 0: f ≤ 0
    want, want_code, got, got_code = _both(code, batch, data, nz, u, th)
    if case == "invalid draws":
        assert want[0] == -np.inf and want[1] == -np.inf
        assert got[0] == -np.inf and got[1] == -np.inf
        assert want_code[0] != 0 and want_code[1] != 0
    else:
        assert np.isfinite(want).all()
    np.testing.assert_array_equal(got_code, want_code)
    np.testing.assert_array_equal(np.isfinite(got), np.isfinite(want))
    fin = np.isfinite(want)
    np.testing.assert_allclose(got[fin], want[fin], rtol=1e-9)


@pytest.mark.parametrize("zero_offsets", [False, True])
def test_filter_matches_numpy_oracle(zero_offsets):
    """The oracle's joint per-particle update, a different algebraic route,
    on "1C" with the JAX suite's point; u = 0 with resampling at every
    contributing step."""
    from tests.test_kalman import _dns_params as _dns_pieces

    _, ts = _specs("1C")
    p, Phi, delta, Omega, obs_var = _dns_pieces()
    data = _panel(3)[:, :30]
    rng = np.random.default_rng(7)
    nz = rng.standard_normal((29, NP))
    u = np.zeros(29) if zero_offsets else rng.uniform(size=29)
    ess = 1.5 if zero_offsets else 0.5
    want = oracle.rbpf_loglik(oracle.dns_loadings(p[0], MATS), Phi, delta, Omega, obs_var,
                              data, nz, u, sv_phi=0.95, sv_sigma=0.2, ess_frac=ess)
    got = P.particle_filter_loglik(ts, torch.as_tensor(p), torch.as_tensor(data),
                                   n_particles=NP, ess_threshold=ess,
                                   noise=(torch.as_tensor(nz), torch.as_tensor(u)))
    np.testing.assert_allclose(float(got), want, rtol=1e-8)


@pytest.mark.parametrize("code", ["AFNS5", "1C"])
def test_filter_collapses_to_the_sqrt_engine(code):
    """σ_h = 0: every particle runs the exact square-root filter."""
    _, ts = _specs(code)
    rng = np.random.default_rng(5)
    batch = torch.as_tensor(_batch(code, rng))
    data = torch.as_tensor(_panel())
    nz, u = _noise(rng)
    got = P.particle_filter_loglik(ts, batch, data, n_particles=NP, sv_sigma=0.0,
                                   noise=(torch.as_tensor(nz), torch.as_tensor(u)))
    want = TSQ.get_loss(ts, batch, data)
    assert torch.isfinite(want).all()
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-9)


def test_generator_mode_is_finite_and_reproducible():
    _, ts = _specs("1C")
    p = torch.as_tensor(_dns_params())
    data = torch.as_tensor(_panel())
    runs = [P.particle_filter_loglik(ts, p, data, torch.Generator().manual_seed(4),
                                     n_particles=64) for _ in range(2)]
    other = P.particle_filter_loglik(ts, p, data, torch.Generator().manual_seed(5),
                                     n_particles=64)
    assert torch.isfinite(runs[0]) and torch.isfinite(other)
    assert float(runs[0]) == float(runs[1])
    assert float(runs[0]) != float(other)


def test_draw_sweep_shares_one_noise_pair():
    """``estimation.sv.pf_draw_logliks``: every draw of a batch on the one
    noise pair ``draw_noise`` gives from the generator's seed."""
    from yieldfactormodels_jl_tpu_torch.estimation.sv import pf_draw_logliks
    from yieldfactormodels_jl_tpu_torch.ops.particle import draw_noise

    _, ts = _specs("1C")
    rng = np.random.default_rng(9)
    batch = torch.as_tensor(_batch("1C", rng))
    data = torch.as_tensor(_panel()[:, :20])
    got = pf_draw_logliks(ts, batch, data, torch.Generator().manual_seed(3), n_particles=64,
                          device="cpu")
    noise = draw_noise(20, 64, torch.Generator().manual_seed(3))
    want = torch.stack([P.particle_filter_loglik(ts, batch[d], data, n_particles=64,
                                                 noise=noise) for d in range(D)])
    assert torch.isfinite(want).all()
    # one draw at a time against the batch: sums over the batch's broadcast
    # axes may round differently in the last bit
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-12)


def test_carried_draw_and_noise_give_the_jax_loglik():
    """One AFNS5 draw from the JAX side and its noise, carried into the port
    by ``params_from_jax`` and ``config.as_tensor``, give JAX's loglik."""
    from yieldfactormodels_jl_tpu_torch import config as tconfig

    js, ts = _specs("AFNS5")
    rng = np.random.default_rng(21)
    batch = _batch("AFNS5", rng)[:1]
    nz, u = rng.standard_normal((1, T - 1, NP)), rng.uniform(size=(1, T - 1))
    data = _panel()
    want = np.asarray(_jax_filter("AFNS5")(jnp.asarray(batch), jnp.asarray(data),
                                           jnp.asarray(nz), jnp.asarray(u), 0.5)[0])
    p = P.params_from_jax(ts, np.asarray(jnp.asarray(batch[0])), device="cpu")
    noise = tuple(tconfig.as_tensor(x[0], "cpu") for x in (nz, u))
    got = P.particle_filter_loglik(ts, p, tconfig.as_tensor(data, "cpu"), n_particles=NP,
                                   noise=noise)
    assert p.dtype == torch.float64 and np.isfinite(want[0])
    np.testing.assert_allclose(float(got), want[0], rtol=1e-9)
