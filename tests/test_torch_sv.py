"""The port's ``estimate_sv`` (``estimation/sv``) against the JAX package's,
on the CPU, float64.

The lockstep search: the port on the CPU runs K5's plain version; JAX runs
its kernel-backed search (``YFM_PF_PALLAS=force``) with ``pf_loglik_batch``
pointed at its XLA filter vmapped over draws (the same numbers as the Pallas
kernel, which tests/test_pallas_pf.py pins at rtol 1e-9, without its
interpret-mode cost).  The same noise reaches both packages: JAX's own pair
from the search's key split, handed to the port through ``estimate_sv``'s
``noise`` argument.  "1C", T = 30, 128 particles, 2 starts, 10 iterations,
6 maturities, with (φ_h, σ_h) fixed and searched: the same best point and ll at rtol 1e-9,
the same per-start lls and iterations.  Then the loud failure when every
start sits on the penalty, the search with its noise drawn from a generator
(finite, reproducible, the pair ``draw_noise`` gives), and the refusal of a
family with a state-dependent measurement.
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
from tests.test_extensions import _dns_params  # noqa: E402
from yieldfactormodels_jl_tpu.estimation import sv as JSV  # noqa: E402
from yieldfactormodels_jl_tpu.models.params import untransform_params  # noqa: E402
from yieldfactormodels_jl_tpu.ops import pallas_pf  # noqa: E402
from yieldfactormodels_jl_tpu.ops.particle import particle_filter_loglik  # noqa: E402
from yieldfactormodels_jl_tpu_torch.ops.particle import draw_noise  # noqa: E402

MATS = tuple(np.array([3, 12, 36, 60, 120, 240]) / 12.0)
T, NP, SEED = 30, 128, 3
KW = dict(n_particles=NP, max_iters=10, sv_phi=0.9, sv_sigma=0.15)


def _xla_batch(spec, params_batch, data, normals, uniforms, n_particles=None, sv_phi=0.95,
               sv_sigma=0.2, ess_threshold=0.5, interpret=None):
    """JAX's XLA filter vmapped over draws, in place of the Pallas kernel."""
    n = normals.shape[-1] if n_particles is None else n_particles
    D = params_batch.shape[0]
    phis = jnp.broadcast_to(jnp.asarray(sv_phi, dtype=params_batch.dtype), (D,))
    sigs = jnp.broadcast_to(jnp.asarray(sv_sigma, dtype=params_batch.dtype), (D,))
    return jax.vmap(lambda q, nz, u, a, b: particle_filter_loglik(
        spec, q, data, n_particles=n, noise=(nz[:, :n], u), sv_phi=a, sv_sigma=b,
        ess_threshold=ess_threshold))(params_batch, normals, uniforms, phis, sigs)


@pytest.fixture
def jax_lockstep(monkeypatch):
    monkeypatch.setenv("YFM_PF_PALLAS", "force")
    monkeypatch.setattr(pallas_pf, "pf_loglik_batch", _xla_batch)
    JSV._jitted_sv_search_pallas.cache_clear()
    yield
    JSV._jitted_sv_search_pallas.cache_clear()


def _setup():
    js, _ = J.create_model("1C", MATS, float_type="float64")
    ts, _ = P.create_model("1C", MATS, float_type="float64")
    data = oracle.simulate_dns_panel(np.random.default_rng(0), np.asarray(MATS), T=80)[:, :T]
    raw = np.asarray(untransform_params(js, jnp.asarray(_dns_params())))
    return js, ts, data, np.stack([raw, raw + 1e-3])


def _jax_noise(dtype=jnp.float64):
    """The noise pair of JAX's lockstep search (estimation/sv.py's split)."""
    kz, ku = jax.random.split(jax.random.PRNGKey(SEED))
    return (np.asarray(jax.random.normal(kz, (T - 1, NP), dtype=dtype)),
            np.asarray(jax.random.uniform(ku, (T - 1,), dtype=dtype)))


@pytest.mark.parametrize("full", [False, True], ids=["fixed-sv", "estimate-sv"])
def test_lockstep_search_matches_jax(jax_lockstep, full):
    js, ts, data, starts = _setup()
    want = JSV.estimate_sv(js, jnp.asarray(data), starts, key=jax.random.PRNGKey(SEED),
                           estimate_sv_params=full, **KW)
    got = P.estimate_sv(ts, data, starts, noise=_jax_noise(), estimate_sv_params=full,
                        device="cpu", **KW)
    np.testing.assert_allclose(got[1], want[1], rtol=1e-9)
    np.testing.assert_allclose(got[0], np.asarray(want[0]), rtol=1e-9, atol=1e-12)
    np.testing.assert_allclose(got[2], np.asarray(want[2]), rtol=1e-9)
    np.testing.assert_array_equal(got[3], np.asarray(want[3]))
    assert np.isfinite(got[1]) and got[3].max() > 0
    if full:
        np.testing.assert_allclose(got[4], want[4], rtol=1e-9)
        assert -1.0 < got[4][0] < 1.0 and got[4][1] > 0.0


@pytest.mark.parametrize("full", [False, True], ids=["fixed-sv", "estimate-sv"])
def test_every_start_on_the_penalty_raises(full):
    _, ts, data, starts = _setup()
    starts[:, 0] = np.nan
    with pytest.raises(RuntimeError, match="non-finite at every point"):
        P.estimate_sv(ts, data[:, :8], starts, n_particles=32, max_iters=1,
                      estimate_sv_params=full, device="cpu")


def test_search_with_generator_noise_is_reproducible():
    """Noise from a generator: the pair ``draw_noise`` draws from it (128
    slots for 32 particles), so the same seed gives the same result."""
    _, ts, data, starts = _setup()
    data = data[:, :12]
    kw = dict(n_particles=32, max_iters=2, device="cpu")
    runs = [P.estimate_sv(ts, data, starts[:1], torch.Generator().manual_seed(1), **kw)
            for _ in range(2)]
    noise = draw_noise(12, 128, torch.Generator().manual_seed(1), torch.float64, "cpu")
    seam = P.estimate_sv(ts, data, starts[:1], noise=noise, **kw)
    assert np.isfinite(runs[0][1]) and runs[0][1] == runs[1][1] == seam[1]
    np.testing.assert_array_equal(runs[0][0], runs[1][0])
    np.testing.assert_array_equal(runs[0][0], seam[0])


def test_state_dependent_measurement_is_refused():
    tvl, _ = P.create_model("TVλ", MATS, float_type="float64")
    data = np.zeros((len(MATS), 12))
    with pytest.raises(ValueError, match="LINEAR state space"):
        P.estimate_sv(tvl, data, np.zeros(tvl.n_params), n_particles=32, device="cpu")
