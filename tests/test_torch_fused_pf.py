"""The plain version of the fused SV particle-filter kernel K5
(``ops/fused_pf.pf_loglik_batch`` on CPU tensors) against the JAX package,
on the CPU, float64.

- Once against the Pallas kernel itself in interpret mode (D = 2 draws,
  T = 16, P = 128 slots: its interpret-mode run is the costly part, and
  tests/test_pallas_pf.py already pins it to JAX's XLA filter), rtol 1e-9.
- Against JAX's XLA filter fed the same noise, rtol 1e-9: 96 live particles
  on 128 slots against the 96-particle filter on the first 96 normals, with
  shared and with per-draw (D,) ``sv_phi``/``sv_sigma`` (as
  ``estimate_sv``'s search gives them).
- More slots than the card's kernel runs (1,152 > 1,024) on the CPU,
  against the 1,152-particle filter: the limit is the kernel's alone.
- The entry point's three refusals, in JAX's words, and the launch's refusal
  of an unknown layout (before it looks for the card).
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
from yieldfactormodels_jl_tpu.ops import particle as JPF  # noqa: E402
from yieldfactormodels_jl_tpu.ops.pallas_pf import pf_loglik_batch as jax_pf_batch  # noqa: E402
from yieldfactormodels_jl_tpu_torch.ops import fused_pf  # noqa: E402

MATS = np.asarray(MATURITIES) / 12.0
NP = 128


@functools.lru_cache(maxsize=None)
def _specs():
    js, _ = J.create_model("AFNS5", tuple(MATS), float_type="float64")
    ts, _ = P.create_model("AFNS5", tuple(MATS), float_type="float64")
    return js, ts


def _setup(D, T, seed=0):
    js, _ = _specs()
    data = oracle.simulate_dns_panel(np.random.default_rng(seed), MATS, T=80)[:, :T]
    p, *_ = _afns5_params(js)
    rng = np.random.default_rng(seed + 1)
    batch = np.tile(p, (D, 1))
    batch[:, 0:2] += 0.05 * rng.standard_normal((D, 2))
    batch[:, 18:23] += 0.05 * rng.standard_normal((D, 5))
    return data, batch, rng.standard_normal((D, T - 1, NP)), rng.uniform(size=(D, T - 1))


def _port(batch, data, nz, u, **kw):
    _, ts = _specs()
    return fused_pf.pf_loglik_batch(ts, batch, data, nz, u, device="cpu", **kw).numpy()


def test_plain_version_matches_the_pallas_kernel_in_interpret_mode():
    js, _ = _specs()
    data, batch, nz, u = _setup(D=2, T=16)
    want = np.asarray(jax_pf_batch(js, jnp.asarray(batch), jnp.asarray(data),
                                   jnp.asarray(nz), jnp.asarray(u), interpret=True))
    got = _port(batch, data, nz, u)
    assert np.isfinite(want).all()
    np.testing.assert_allclose(got, want, rtol=1e-9)


@functools.lru_cache(maxsize=None)
def _xla(n_live):
    js, _ = _specs()

    def one(q, data, nz, u, phi, sig):
        return JPF.particle_filter_loglik(js, q, data, n_particles=n_live, noise=(nz, u),
                                          sv_phi=phi, sv_sigma=sig)

    return jax.jit(jax.vmap(one, in_axes=(0, None, 0, 0, 0, 0)))


def _want(batch, data, nz, u, n_live, phi, sig):
    D = batch.shape[0]
    return np.asarray(_xla(n_live)(
        jnp.asarray(batch), jnp.asarray(data), jnp.asarray(nz[:, :, :n_live]), jnp.asarray(u),
        jnp.asarray(np.broadcast_to(np.asarray(phi, dtype=np.float64), (D,))),
        jnp.asarray(np.broadcast_to(np.asarray(sig, dtype=np.float64), (D,)))))


def test_dead_slots_match_the_filter_with_fewer_particles():
    data, batch, nz, u = _setup(D=2, T=40)
    want = _want(batch, data, nz, u, 96, 0.95, 0.2)
    got = _port(batch, data, nz, u, n_particles=96)
    assert np.isfinite(want).all()
    np.testing.assert_allclose(got, want, rtol=1e-9)


def test_per_draw_volatility_dynamics():
    data, batch, nz, u = _setup(D=2, T=40, seed=2)
    phi, sig = np.array([0.9, 0.5]), np.array([0.3, 0.1])
    want = _want(batch, data, nz, u, 96, phi, sig)
    got = _port(batch, data, nz, u, n_particles=96, sv_phi=phi, sv_sigma=sig)
    assert np.isfinite(want).all()
    np.testing.assert_allclose(got, want, rtol=1e-9)


def test_more_slots_than_the_kernel_runs_on_the_cpu():
    data, batch, _, _ = _setup(D=1, T=8, seed=3)
    rng = np.random.default_rng(4)
    nz, u = rng.standard_normal((1, 7, 1152)), rng.uniform(size=(1, 7))
    want = _want(batch, data, nz, u, 1152, 0.95, 0.2)
    got = _port(batch, data, nz, u)
    assert np.isfinite(want).all()
    np.testing.assert_allclose(got, want, rtol=1e-9)


def test_shared_noise_view_gives_the_same_result():
    """An expanded (stride-0) draw axis, as estimate_sv passes it, reads the
    same numbers as its materialised copy."""
    data, batch, nz, u = _setup(D=2, T=20)
    nz1, u1 = torch.as_tensor(nz[0]), torch.as_tensor(u[0])
    view = _port(batch, data, nz1[None].expand(2, 19, NP), u1[None].expand(2, 19))
    copy = _port(batch, data, nz1[None].repeat(2, 1, 1), u1[None].repeat(2, 1))
    np.testing.assert_array_equal(view, copy)


def test_refusals_in_the_jax_words():
    _, ts = _specs()
    data, batch, nz, u = _setup(D=2, T=20)
    with pytest.raises(ValueError, match="multiple of 128"):
        _port(batch, data, nz[:, :, :100], u)
    with pytest.raises(ValueError, match="noise shapes"):
        _port(batch, data, nz[:, :-1], u)
    tvl, _ = P.create_model("TVλ", tuple(MATS), float_type="float64")
    with pytest.raises(ValueError, match="constant-measurement"):
        fused_pf.pf_loglik_batch(tvl, batch, data, nz, u, device="cpu")


def test_launch_refuses_an_unknown_layout():
    """``launch(inputs, layout=...)`` takes None, "block" or "cluster" and
    raises for any other name before it builds or launches anything."""
    _, ts = _specs()
    data, batch, nz, u = _setup(D=1, T=8)
    inputs = fused_pf.kernel_inputs(ts, torch.as_tensor(batch), torch.as_tensor(data),
                                    torch.as_tensor(nz), torch.as_tensor(u), NP, 0.95, 0.2, 0.5)
    with pytest.raises(ValueError, match="layout must be one of"):
        fused_pf.launch(inputs, layout="warp")
