"""The port's fused batched log-likelihood (K1) against the JAX Pallas kernel.

On the CPU the wrapper ``batched_loglik`` runs its plain version,
``batched_loglik_reference``; it is held against ``pallas_kf.batched_loglik``
in interpret mode at the tolerances of tests/test_pallas_kf.py (rtol 5e-4,
atol 1e-2: both compute in float32 and sum in another order), and against
the JAX univariate engine at rtol 1e-10 in float64.  The CUDA kernel itself
runs only on the card: tests/test_torch_cuda.py holds it against the plain
version there.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)  # tiny tensors; leave the cores to the other test workers

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import yieldfactormodels_jl_tpu as J  # noqa: E402
import yieldfactormodels_jl_tpu_torch as P  # noqa: E402
from yieldfactormodels_jl_tpu.ops import pallas_kf, univariate_kf  # noqa: E402
from yieldfactormodels_jl_tpu_torch.ops import fused_kf  # noqa: E402

MATS = tuple(np.array([3, 12, 36, 60, 120, 240]) / 12.0)   # N = 6
CPU = "cpu"


def _specs(code, exact=False):
    import dataclasses

    js, _ = J.create_model(code, MATS, float_type="float64")
    ts, _ = P.create_model(code, MATS, float_type="float64")
    if exact:
        js = dataclasses.replace(js, exact_jacobian=True)
        ts = dataclasses.replace(ts, exact_jacobian=True)
    return js, ts


def _params(spec, B, rng):
    """Stationary constrained draws (tests/test_pallas_kf.py's point)."""
    p = np.zeros((B, spec.n_params))
    if "gamma" in spec.layout:
        lo, hi = spec.layout["gamma"]
        p[:, lo:hi] = np.log(0.4) + 0.2 * rng.standard_normal((B, hi - lo))
    p[:, spec.layout["obs_var"][0]] = 0.01
    Ms = spec.state_dim
    k = spec.layout["chol"][0]
    for j in range(Ms):
        for i in range(j + 1):
            p[:, k] = 0.1 if i == j else 0.01
            k += 1
    lo, hi = spec.layout["delta"]
    p[:, lo:hi] = 0.2 * rng.standard_normal((B, Ms))
    lo, hi = spec.layout["phi"]
    p[:, lo:hi] = (0.9 * np.eye(Ms)).reshape(-1)
    return p


def _panel(rng, T):
    data = 0.5 * rng.standard_normal((len(MATS), T)) + 4
    data[:, -3:] = np.nan          # forecast tail → predict-only
    data[2, 10] = np.nan           # interior partial NaN → column missing
    return data


@pytest.mark.parametrize("code,windowed", [("1C", True), ("TVλ", False)])
def test_reference_matches_pallas_interpret(code, windowed, rng):
    """NaN columns, a shared window or one [start, end) per draw, and an
    invalid draw that must give −inf while its neighbours stay finite.
    (AFNS5 and the exact TVλ Jacobian are held against the JAX univariate
    engine below, which the Pallas kernel matches in tests/test_pallas_kf.py.)"""
    js, ts = _specs(code)
    B, T = 6, 36
    p = _params(js, B, rng)
    p[4, :] = np.nan
    data = _panel(rng, T)
    kw = {"start": 2, "end": T - 1}
    if windowed:
        kw = {"starts": np.array([0, 3, 5, 0, 2, 1]),
              "ends": np.array([36, 25, 28, 18, 30, 33])}
    ref = np.asarray(pallas_kf.batched_loglik(js, p, data, interpret=True, **kw))
    launches = fused_kf.batched_loglik.launches
    got = P.batched_loglik(ts, p, data, device=CPU, **kw)
    assert got.shape == (B,) and got.dtype == torch.float32
    assert fused_kf.batched_loglik.launches == launches   # the CPU runs no kernel
    assert ref[4] == -np.inf and got[4] == -np.inf
    assert np.isfinite(np.delete(got.numpy(), 4)).all()
    np.testing.assert_allclose(got.numpy(), ref, rtol=5e-4, atol=1e-2)


@pytest.mark.parametrize("code,exact", [("AFNS5", False), ("TVλ", True)])
def test_float64_reference_matches_jax_univariate(code, exact, rng):
    """The plain version at the kernel's float64 instantiation, held tightly
    against the JAX univariate engine, windows per draw included."""
    js, ts = _specs(code, exact)
    B, T = 4, 30
    p = _params(js, B, rng)
    data = _panel(rng, T)
    starts, ends = np.array([0, 2, 4, 1]), np.array([30, 26, 29, 20])
    fn = jax.jit(jax.vmap(lambda q, s, e: univariate_kf.get_loss(js, q, jnp.asarray(data), s, e)))
    ref = np.asarray(fn(jnp.asarray(p), jnp.asarray(starts), jnp.asarray(ends)))
    got = fused_kf._batched_loglik(ts, p, data, starts=starts, ends=ends,
                                   device=CPU, dtype=torch.float64)
    assert got.dtype == torch.float64
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-10)


def test_validation_errors(rng):
    _, ts = _specs("1C")
    data = np.zeros((len(MATS), 10))
    msed, _ = P.create_model("SD-NS", MATS)
    with pytest.raises(ValueError, match="kalman families"):
        P.batched_loglik(msed, np.zeros((2, msed.n_params)), data, device=CPU)
    with pytest.raises(ValueError, match="params_batch must be"):
        P.batched_loglik(ts, np.zeros(ts.n_params), data, device=CPU)
    with pytest.raises(ValueError, match="data must be"):
        P.batched_loglik(ts, np.zeros((2, ts.n_params)), data[:3], device=CPU)
    with pytest.raises(ValueError, match="together"):
        P.batched_loglik(ts, np.zeros((2, ts.n_params)), data, device=CPU,
                         starts=[0, 1])


@pytest.mark.parametrize("code", ["AFNS5", "TVλ"])
def test_kernel_inputs_lay_draws_minor(code, rng):
    """The buffers the kernel reads, built on the CPU: (D, B) draw-minor,
    row-major Φ per draw, the shared (T, N) panel and (T, 2) masks."""
    _, ts = _specs(code)
    B, T = 5, 12
    p = torch.as_tensor(_params(ts, B, rng))
    data = torch.as_tensor(_panel(rng, T))
    inp = fused_kf.kernel_inputs(ts, p, data, 1, T - 2)
    Z, d, phi, delta, om, ovar, b0, p0, panel, masks, win, mats = inp.buffers
    Ms, N = ts.state_dim, ts.N
    assert inp.ints == (1, Ms, int(code == "TVλ"), 0, B, N, T)
    kp = P.models.params.unpack_kalman(ts, p)
    for b in range(B):
        np.testing.assert_array_equal(phi[:, b].numpy(), kp.Phi[b].reshape(-1).numpy())
        np.testing.assert_array_equal(om[:, b].numpy(), kp.Omega_state[b].reshape(-1).numpy())
        np.testing.assert_array_equal(delta[:, b].numpy(), kp.delta[b].numpy())
        assert ovar[0, b] == kp.obs_var[b]
    assert b0.shape == (Ms, B) and p0.shape == (Ms * Ms, B)
    assert panel.shape == (T, N)
    torch.testing.assert_close(panel, data.T, rtol=0, atol=0, equal_nan=True)
    assert masks.dtype == torch.uint8 and masks.shape == (T, 2)
    assert masks[:, 0].tolist() == [0] + [1] * (T - 3) + [0, 0]   # 1 ≤ t < T−2
    assert masks[:, 1].tolist() == [0, 0] + [1] * (T - 5) + [0] * 3  # 2 ≤ t ≤ T−4
    assert win is None and inp.out.shape == (B,)
    if code == "TVλ":
        assert Z is None and d is None and mats.shape == (N,)
    else:
        assert Z.shape == (N * Ms, B) and d.shape == (N, B) and mats is None
    for x in inp.buffers:
        assert x is None or x.is_contiguous()



def test_launch_refuses_an_unknown_layout_before_any_build(monkeypatch, rng):
    """``launch(layout=)`` takes None (the kernel's pick), "thread", "warp"
    or "octet"; any other name raises ValueError before a library is built
    or loaded."""
    _, ts = _specs("1C")
    p = torch.as_tensor(_params(ts, 2, rng))
    inputs = fused_kf.kernel_inputs(ts, p, torch.as_tensor(_panel(rng, 12)), 0, 12)

    def no_build(name):
        raise AssertionError(f"built or loaded {name}")

    monkeypatch.setattr(fused_kf, "load", no_build)
    launches = fused_kf.batched_loglik.launches
    for bad in ("block", "Warp", 2):
        with pytest.raises(ValueError, match="layout must be one of"):
            fused_kf.launch(inputs, layout=bad)
    assert fused_kf.batched_loglik.launches == launches
