"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Marked ``cuda``: each test skips without a CUDA card.  This file imports
neither JAX nor the JAX package, so it also runs where only PyTorch is
installed:

    python -m pytest --noconftest tests/test_torch_cuda.py -m cuda

Tolerances: the float32 kernel against the plain float64 version at rtol
5e-4, atol 1e-2 (tests/test_pallas_kf.py's), the float64 instantiation at
rtol 1e-9 (the same arithmetic in another order).  The SV particle filter
(K5) in float32 is held elementwise only without volatility noise: with it,
a weight on a resampling boundary may fall either way in another summation
order.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import yieldfactormodels_jl_tpu_torch as P  # noqa: E402
from yieldfactormodels_jl_tpu_torch.ops import fused_kf  # noqa: E402

MATS = tuple(np.array([3, 12, 36, 60, 120, 240]) / 12.0)


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    return torch.device("cuda")


def _draws(spec, B, rng):
    p = np.zeros((B, spec.n_params))
    if "gamma" in spec.layout:
        lo, hi = spec.layout["gamma"]
        p[:, lo:hi] = np.log(0.4) + 0.2 * rng.standard_normal((B, hi - lo))
    p[:, spec.layout["obs_var"][0]] = 0.01
    a, _ = spec.layout["chol"]
    rows, cols = spec.chol_indices
    for k, (r, c) in enumerate(zip(rows, cols)):
        p[:, a + k] = 0.1 if r == c else 0.01
    Ms = spec.state_dim
    lo, hi = spec.layout["delta"]
    p[:, lo:hi] = 0.2 * rng.standard_normal((B, Ms))
    lo, hi = spec.layout["phi"]
    p[:, lo:hi] = (0.9 * np.eye(Ms)).reshape(-1)
    return p


@pytest.mark.cuda
@pytest.mark.parametrize("code", ["1C", "AFNS5", "TVλ"])
def test_fused_kf_matches_plain_version(card, code):
    rng = np.random.default_rng(0)
    spec, _ = P.create_model(code, MATS, float_type="float64")
    B, T = 300, 40
    p = _draws(spec, B, rng)
    p[7] = np.nan                                   # must give −inf
    data = 0.5 * rng.standard_normal((len(MATS), T)) + 4
    data[:, 20] = np.nan
    data[1, 25] = np.nan
    p, data = torch.as_tensor(p, device=card), torch.as_tensor(data, device=card)
    starts = torch.as_tensor(rng.integers(0, 10, B), device=card)
    ends = torch.as_tensor(rng.integers(25, T + 1, B), device=card)
    for kw in ({"start": 1, "end": T - 2}, {"starts": starts, "ends": ends}):
        launches = fused_kf.batched_loglik.launches
        got = P.batched_loglik(spec, p, data, **kw)
        got64 = fused_kf._batched_loglik(spec, p, data, dtype=torch.float64, **kw)
        torch.cuda.synchronize()
        assert fused_kf.batched_loglik.launches == launches + 2
        ref = fused_kf.batched_loglik_reference(spec, p, data, **kw).cpu().numpy()
        assert ref[7] == -np.inf and got[7].item() == -np.inf
        np.testing.assert_allclose(got.cpu().numpy(), ref, rtol=5e-4, atol=1e-2)
        np.testing.assert_allclose(got64.cpu().numpy(), ref, rtol=1e-9)


def _raw_value_and_grad(spec, p, data, dtype, **kw):
    pt = p.detach().to(dtype).requires_grad_(True)
    v = P.batched_loglik_diff(spec, pt, data.to(dtype), dtype=dtype, **kw)
    (g,) = torch.autograd.grad(v.sum(), pt)
    return v.detach(), g


@pytest.mark.cuda
@pytest.mark.parametrize("code", ["1C", "AFNS3", "AFNS5"])
def test_fused_kf_grad_matches_plain_versions(card, code):
    """K2f/K2b through autograd against the plain versions on the CPU, in
    float64 at value rtol 1e-9 and gradient rtol 1e-6 (relative to each
    draw's largest component), and in float32 by bench.py's direction and
    norm criterion (cosine > 0.999, norm within 5%)."""
    from yieldfactormodels_jl_tpu_torch.ops import fused_kf_grad

    rng = np.random.default_rng(1)
    spec, _ = P.create_model(code, MATS, float_type="float64")
    B, T = 200, 29
    p = _draws(spec, B, rng)
    p[3] = np.nan                                   # must give −inf
    data = 0.5 * rng.standard_normal((len(MATS), T)) + 4
    data[:, 11] = np.nan
    data[2, 17] = np.nan
    starts = rng.integers(0, 6, B)
    ends = rng.integers(18, T + 1, B)
    for kw in ({"start": 1, "end": T - 2},
               {"starts": torch.as_tensor(starts), "ends": torch.as_tensor(ends)}):
        ref_v, ref_g = _raw_value_and_grad(spec, torch.as_tensor(p), torch.as_tensor(data),
                                           torch.float64, device="cpu", **kw)
        fin = torch.isfinite(ref_v)
        assert not fin[3] and int(fin.sum()) == B - 1
        card_kw = {k: (v.to(card) if torch.is_tensor(v) else v) for k, v in kw.items()}
        p_card, d_card = torch.as_tensor(p, device=card), torch.as_tensor(data, device=card)
        launches = (fused_kf_grad.launch_forward.launches,
                    fused_kf_grad.launch_backward.launches)
        v64, g64 = _raw_value_and_grad(spec, p_card, d_card, torch.float64, **card_kw)
        v32, g32 = _raw_value_and_grad(spec, p_card, d_card, torch.float32, **card_kw)
        torch.cuda.synchronize()
        assert (fused_kf_grad.launch_forward.launches,
                fused_kf_grad.launch_backward.launches) == (launches[0] + 2, launches[1] + 2)
        v64, g64, v32, g32 = (x.cpu().double() for x in (v64, g64, v32, g32))
        assert torch.equal(torch.isfinite(v64), fin) and torch.equal(torch.isfinite(v32), fin)
        np.testing.assert_allclose(v64[fin].numpy(), ref_v[fin].numpy(), rtol=1e-9)
        scale = ref_g[fin].abs().amax(1, keepdim=True)
        assert ((g64[fin] - ref_g[fin]).abs() <= 1e-6 * (ref_g[fin].abs() + scale)).all()
        np.testing.assert_allclose(v32[fin].numpy(), ref_v[fin].numpy(), rtol=5e-4, atol=1e-2)
        na, nb = g32[fin].norm(dim=1), ref_g[fin].norm(dim=1)
        assert ((g32[fin] * ref_g[fin]).sum(1) / (na * nb)).min() > 0.999
        assert ((na / nb - 1).abs() < 0.05).all()


@pytest.mark.cuda
@pytest.mark.parametrize("code", ["1C", "AFNS3", "AFNS5"])
def test_fused_kf_grad_leaves_match_the_plain_adjoint(card, code):
    """K2b's eight raw float64 outputs (∂Z, ∂d, ∂Φ, ∂δ, ∂Ω, ∂σ², ∂β₀, ∂P₀)
    against adjoint_reference on the same inputs, K2f's checkpoints and a
    random cotangent, element by element: rtol 1e-6 with an atol of 1e-9
    times the leaf's largest entry in the draw, so that no leaf is judged
    by the scale of another (the same algebra in float64, summed in
    another order)."""
    from yieldfactormodels_jl_tpu_torch.ops import fused_kf_grad as G

    rng = np.random.default_rng(2)
    spec, _ = P.create_model(code, MATS, float_type="float64")
    B, T = 96, 29
    p = torch.as_tensor(_draws(spec, B, rng), device=card)
    p[3] = float("nan")                             # gated: zero rows
    data = torch.as_tensor(0.5 * rng.standard_normal((len(MATS), T)) + 4, device=card)
    data[:, 11] = float("nan")
    win = {"starts": torch.as_tensor(rng.integers(0, 6, B), device=card),
           "ends": torch.as_tensor(rng.integers(18, T + 1, B), device=card)}
    args = G.core_inputs(spec, p, data, 0, T, **win)
    ll, chk = G.launch_forward(G.lay_out(*args))
    g = torch.as_tensor(rng.uniform(0.5, 1.5, B), device=card)
    g = torch.where(torch.isfinite(ll), g, torch.zeros_like(g))
    got = G.launch_backward(G.lay_out(*args), chk, g)
    Ms = spec.state_dim
    ref = G.adjoint_reference(*args[:6], *args[8:], chk.T.reshape(B, -1, Ms + Ms * Ms), g)
    for k, r in zip(got, ref):
        r = r.reshape(B, -1)
        k = k.T.reshape(r.shape)
        scale = r.abs().amax(1, keepdim=True)
        assert ((k - r).abs() <= 1e-6 * r.abs() + 1e-9 * scale).all()
        assert (k[3] == 0).all()


@pytest.mark.cuda
def test_estimate_on_the_card_matches_the_cpu(card):
    """The fused MLE on the card (K1 probes, K2f/K2b gradients) against the
    same call on the CPU (the plain versions), float32 both: ll within
    rtol 1e-3, since Armijo decisions on float32 values rounded in another
    order may send the two L-BFGS paths a step apart."""
    from yieldfactormodels_jl_tpu_torch.ops import fused_kf_grad

    mats = tuple(np.array([3, 12, 36, 84, 180, 360]) / 12.0)
    spec, _ = P.create_model("1C", mats)
    rng = np.random.default_rng(0)
    data = 0.5 * rng.standard_normal((6, 60))
    base = np.zeros(spec.n_params)
    base[spec.layout["gamma"][0]] = np.log(0.49)
    base[spec.layout["obs_var"][0]] = 0.25
    base[2:8] = [0.3, 0.01, 0.3, 0.01, 0.01, 0.3]
    base[spec.layout["phi"][0]:] = (0.5 * np.eye(3)).reshape(-1)
    starts = np.stack([base * (1 + 0.05 * rng.standard_normal(spec.n_params))
                       for _ in range(3)], axis=1)
    launches = fused_kf_grad.launch_backward.launches
    _, ll_card, best_card, conv_card = P.estimate(spec, data, starts, max_iters=10)
    assert fused_kf_grad.launch_backward.launches > launches
    _, ll_cpu, best_cpu, conv_cpu = P.estimate(spec, data, starts, max_iters=10,
                                               device="cpu")
    assert conv_card.iterations > 0
    np.testing.assert_allclose(ll_card, ll_cpu, rtol=1e-3)


@pytest.mark.cuda
@pytest.mark.parametrize("exact", [False, True])
def test_fused_kf_tvl_grad_matches_plain_versions(card, exact):
    """K3f/K3b against the plain versions in float64, under both Jacobian
    settings, with interior NaN columns, per-draw windows and a NaN draw:
    through autograd, value rtol 1e-9 and gradient rtol 1e-6 of each draw's
    largest component; K3b's six raw outputs on the same inputs, K3f's
    checkpoints and a random cotangent, leaf by leaf (rtol 1e-6, atol 1e-9 ×
    the leaf's largest entry in the draw); K3f's value equal to K1's."""
    import dataclasses

    from yieldfactormodels_jl_tpu_torch.ops import fused_kf_grad as G

    rng = np.random.default_rng(3)
    spec, _ = P.create_model("TVλ", MATS, float_type="float64")
    spec = dataclasses.replace(spec, exact_jacobian=exact)
    B, T = 200, 29
    p = _draws(spec, B, rng)
    p[3] = np.nan                                   # gated: −inf, zero rows
    data = 0.5 * rng.standard_normal((len(MATS), T)) + 4
    data[:, 11] = np.nan
    data[2, 17] = np.nan
    win = {"starts": torch.as_tensor(rng.integers(0, 6, B)),
           "ends": torch.as_tensor(rng.integers(18, T + 1, B))}
    ref_v, ref_g = _raw_value_and_grad(spec, torch.as_tensor(p), torch.as_tensor(data),
                                       torch.float64, device="cpu", **win)
    fin = torch.isfinite(ref_v)
    assert not fin[3] and int(fin.sum()) == B - 1
    p_card, d_card = torch.as_tensor(p, device=card), torch.as_tensor(data, device=card)
    card_win = {k: v.to(card) for k, v in win.items()}
    launches = (G.launch_forward_tvl.launches, G.launch_backward_tvl.launches)
    v64, g64 = _raw_value_and_grad(spec, p_card, d_card, torch.float64, **card_win)
    torch.cuda.synchronize()
    assert (G.launch_forward_tvl.launches,
            G.launch_backward_tvl.launches) == (launches[0] + 1, launches[1] + 1)
    v64, g64 = v64.cpu(), g64.cpu()
    assert torch.equal(torch.isfinite(v64), fin)
    np.testing.assert_allclose(v64[fin].numpy(), ref_v[fin].numpy(), rtol=1e-9)
    scale = ref_g[fin].abs().amax(1, keepdim=True)
    assert ((g64[fin] - ref_g[fin]).abs() <= 1e-6 * (ref_g[fin].abs() + scale)).all()

    args = G.core_inputs(spec, p_card, d_card, 0, T, **card_win)
    bufs = G.lay_out_tvl(*args[:10])
    ll, chk = G.launch_forward_tvl(bufs, exact)
    k1 = fused_kf.launch(fused_kf.kernel_inputs(spec, p_card, d_card, 0, T, **card_win))
    assert torch.equal(ll, k1)
    g = torch.as_tensor(rng.uniform(0.5, 1.5, B), device=card)
    g = torch.where(torch.isfinite(ll), g, torch.zeros_like(g))
    got = G.launch_backward_tvl(bufs, exact, chk, g)
    ref = G.adjoint_reference_tvl(*args[:4], *args[6:], chk.T.reshape(B, -1, 20), g)
    for k, r in zip(got, ref):
        r = r.reshape(B, -1)
        k = k.T.reshape(r.shape)
        leaf_scale = r.abs().amax(1, keepdim=True)
        assert ((k - r).abs() <= 1e-6 * r.abs() + 1e-9 * leaf_scale).all()
        assert (k[3] == 0).all()


@pytest.mark.cuda
@pytest.mark.parametrize("code", ["1C", "TVλ"])
def test_estimate_windows_on_the_card_matches_the_cpu(card, code):
    """estimate_windows (W=2 windows × S=3 starts, N=6, T=60, float32) on the
    card against the same call on the CPU: every cell's ll within rtol
    1e-3, as the fused estimate's card test allows for Armijo decisions on
    float32 values rounded in another order."""
    from yieldfactormodels_jl_tpu_torch.ops import fused_kf_grad as G

    mats = tuple(np.array([3, 12, 36, 84, 180, 360]) / 12.0)
    spec, _ = P.create_model(code, mats)
    rng = np.random.default_rng(0)
    data = 0.5 * rng.standard_normal((6, 60))
    base = np.zeros(spec.n_params)
    base[spec.layout["obs_var"][0]] = 1.0
    a, _ = spec.layout["chol"]
    for k, (r, c) in enumerate(zip(*spec.chol_indices)):
        base[a + k] = 0.3 if r == c else 0.01
    lo, hi = spec.layout["phi"]
    base[lo:hi] = (0.5 * np.eye(spec.state_dim)).reshape(-1)
    if "gamma" in spec.layout:
        base[spec.layout["gamma"][0]] = np.log(0.49)
    else:
        base[spec.layout["delta"][0] + 3] = 0.5 * np.log(0.49)
    starts = np.stack([base * (1 + 0.05 * rng.standard_normal(spec.n_params))
                       for _ in range(3)])
    raw = P.untransform_params(spec, torch.as_tensor(starts)).numpy()
    counter = G.launch_backward_tvl if code == "TVλ" else G.launch_backward
    launches = counter.launches
    xs_card, ll_card = P.estimate_windows(spec, data, raw, [0, 10], [50, 60], max_iters=10)
    assert counter.launches > launches
    xs_cpu, ll_cpu = P.estimate_windows(spec, data, raw, [0, 10], [50, 60], max_iters=10,
                                        device="cpu")
    assert xs_card.shape == xs_cpu.shape == (2, 3, spec.n_params)
    np.testing.assert_allclose(ll_card, ll_cpu, rtol=1e-3)


def _ssd_draws(spec, B, rng):
    """(B, P) constrained score-driven draws around a stable point: small
    step sizes, persistence 0.97, Φ = diag(0.95, 0.9, 0.85)."""
    p = np.zeros((B, spec.n_params))
    neural = spec.family == "msed_neural"
    p[:, slice(*spec.layout["A"])] = (2e-4 if neural else 1e-3) * np.exp(
        0.2 * rng.standard_normal((B, 1)))
    if "B" in spec.layout:
        p[:, slice(*spec.layout["B"])] = 0.97
    lo, hi = spec.layout["omega"]
    p[:, lo:hi] = (rng.standard_normal((B, hi - lo)) / 10 if neural
                   else np.log(0.5) + 0.1 * rng.standard_normal((B, 1)))
    p[:, slice(*spec.layout["delta"])] = [0.3, -0.1, 0.05]
    p[:, slice(*spec.layout["phi"])] = np.diag([0.95, 0.9, 0.85]).T.reshape(-1)
    return p


@pytest.mark.cuda
@pytest.mark.parametrize("B", [1, 23, 64])
@pytest.mark.parametrize("code", ["1SSD-NNS", "1RWSD-NNS", "SRWSD-NS", "SSD-NS"])
def test_fused_ssd_matches_plain_version(card, code, B):
    """K4 against its plain version on the same inputs, at the batches
    ``estimate_steps`` gives it (one start, the 23-point simplex) and a
    block: the float64 kernel at rtol 1e-9 (the same arithmetic, sums over
    maturities in another order), the float32 kernel against the plain
    float64 version at rtol 2e-2 (bench.py's bar for the float32 kernel); an
    interior NaN column inside the window, an invalid draw and an exploding
    SSD-NS draw (step size 20, persistence 0.5: −inf in both types under
    nudges) give −inf.  The EWMA step of 1SSD-NNS divides each score
    component by its own running scale, which hides a score that is off by a
    constant factor, so a plain-step neural code (1RWSD-NNS) is held too."""
    from tests import oracle
    from yieldfactormodels_jl_tpu_torch.ops import fused_ssd

    rng = np.random.default_rng(0)
    s64, _ = P.create_model(code, MATS, float_type="float64")
    s32, _ = P.create_model(code, MATS)
    T = 60
    p = _ssd_draws(s64, 64, rng)[:B]
    minus_inf = []
    if B > 7:
        p[7] = np.nan
        minus_inf.append(7)
    if code == "SSD-NS" and B > 11:
        p[11, s64.layout["A"][0]] = 20.0
        p[11, s64.layout["B"][0]] = 0.5
        minus_inf.append(11)
    data = oracle.simulate_dns_panel(rng, np.asarray(MATS), T=T)
    data[:, 40] = np.nan
    p, data = torch.as_tensor(p, device=card), torch.as_tensor(data, device=card)
    for start, end in ((0, 35), (2, T)):
        launches = fused_ssd.batched_loss.launches
        got64 = P.batched_loss(s64, p, data, start, end)
        got32 = P.batched_loss(s32, p, data, start, end)
        torch.cuda.synchronize()
        assert fused_ssd.batched_loss.launches == launches + 2
        ref = fused_ssd.batched_loss_reference(s64, p, data, start, end).cpu().numpy()
        got64, got32 = got64.cpu().numpy(), got32.cpu().numpy()
        assert got32.dtype == np.float32
        for i in minus_inf:
            assert ref[i] == got64[i] == got32[i] == -np.inf
        np.testing.assert_array_equal(np.isfinite(got64), np.isfinite(ref))
        np.testing.assert_array_equal(np.isfinite(got32), np.isfinite(ref))
        fin = np.isfinite(ref)
        assert fin.sum() == (B - len(minus_inf) if end == 35 else 0)
        np.testing.assert_allclose(got64[fin], ref[fin], rtol=1e-9)
        np.testing.assert_allclose(got32.astype(np.float64)[fin], ref[fin], rtol=2e-2)


@pytest.mark.cuda
def test_estimate_steps_on_the_card_matches_the_cpu(card):
    """``estimate_steps`` (grid, Nelder–Mead on K4, closed-form (δ, Φ)) on
    the card against the same call on the CPU (K4's plain version), float64
    both, on the CPU suite's small case: ll within rtol 1e-6."""
    from tests import oracle
    from yieldfactormodels_jl_tpu_torch.ops import fused_ssd

    mats = tuple(np.array([3, 6, 9, 12, 15, 18, 21, 24, 30, 36, 48, 60, 72, 84, 96,
                           108, 120, 180, 240, 360]) / 12.0)
    spec, _ = P.create_model("1SSD-NNS", mats, float_type="float64")
    rng = np.random.default_rng(7)
    p = _ssd_draws(spec, 1, rng)[0]
    data = oracle.simulate_dns_panel(rng, np.asarray(mats), T=40)
    groups = P.get_param_groups(spec)
    budgets = {"1": ("neldermead", dict(max_iters=25)),
               "2": ("lbfgs", dict(max_iters=8, g_tol=1e-6, f_abstol=1e-6))}
    launches, calls = fused_ssd.batched_loss.launches, fused_ssd.batched_loss_reference.calls
    init_c, ll_card, best_card, _ = P.estimate_steps(spec, data, p[:, None], groups,
                                                     max_group_iters=1, optimizers=budgets)
    assert fused_ssd.batched_loss.launches > launches
    assert fused_ssd.batched_loss_reference.calls == calls
    init_h, ll_cpu, best_cpu, _ = P.estimate_steps(spec, data, p[:, None], groups,
                                                   max_group_iters=1, optimizers=budgets,
                                                   device="cpu")
    np.testing.assert_array_equal(init_c, init_h)
    np.testing.assert_allclose(ll_card, ll_cpu, rtol=1e-6)


def _afns5_batch(spec, D, rng):
    """(D, 48) AFNS5 draws around the JAX suite's stable point, decay
    drivers and δ jittered."""
    p = np.zeros(48)
    p[0], p[1], p[2] = np.log(0.5), np.log(0.15), 4e-4
    k = 3
    for j in range(5):
        for i in range(j + 1):
            p[k] = 0.05 + 0.01 * i if i == j else 0.002
            k += 1
    p[18:23] = [4.0, -1.0, 0.5, -0.3, 0.2]
    p[23:48] = np.diag([0.98, 0.94, 0.9, 0.92, 0.88]).reshape(-1)
    b = np.tile(p, (D, 1))
    b[:, 0:2] += 0.05 * rng.standard_normal((D, 2))
    b[:, 18:23] += 0.05 * rng.standard_normal((D, 5))
    return b


def _pf_case(card, D=6, T=40, P_slots=256, seed=0):
    from tests import oracle

    rng = np.random.default_rng(seed)
    mats = np.asarray(MATS)
    data = oracle.simulate_dns_panel(rng, mats, T=T)
    s64, _ = P.create_model("AFNS5", MATS, float_type="float64")
    batch = _afns5_batch(s64, D, rng)
    nz = rng.standard_normal((D, T - 1, P_slots))
    u = rng.uniform(size=(D, T - 1))
    return s64, *(torch.as_tensor(x, device=card) for x in (batch, data, nz, u))


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["sv 0.2", "NaN column", "invalid draws", "dead slots",
                                  "u = 0", "per-draw sv"])
def test_fused_pf_float64_matches_plain_version(card, case):
    """K5 in float64 against its plain version on the same inputs, rtol 1e-9
    (the same arithmetic, block sums in another order), equal −Inf sets."""
    from yieldfactormodels_jl_tpu_torch.ops import fused_pf

    s64, batch, data, nz, u = _pf_case(card)
    kw = {}
    if case == "NaN column":
        data[:, 9] = float("nan")
    if case == "invalid draws":
        batch[0, 23] = 1.5       # Φ₁₁ > 1
        batch[1, 2] = -4e-4      # σ² < 0
    if case == "dead slots":
        kw["n_particles"] = 200
    if case == "u = 0":
        u = torch.zeros_like(u)
        kw["ess_threshold"] = 1.5
    if case == "per-draw sv":
        kw["sv_phi"] = torch.linspace(0.5, 0.95, batch.shape[0], device=card, dtype=torch.float64)
        kw["sv_sigma"] = torch.linspace(0.05, 0.4, batch.shape[0], device=card,
                                        dtype=torch.float64)
    launches = fused_pf.pf_loglik_batch.launches
    got = fused_pf.pf_loglik_batch(s64, batch, data, nz, u, **kw)
    torch.cuda.synchronize()
    assert fused_pf.pf_loglik_batch.launches == launches + 1
    ref = fused_pf.pf_loglik_batch_reference(s64, batch, data, nz, u, **kw)
    got, ref = got.cpu().numpy(), ref.cpu().numpy()
    np.testing.assert_array_equal(np.isfinite(got), np.isfinite(ref))
    if case == "invalid draws":
        assert got[0] == -np.inf and got[1] == -np.inf
    fin = np.isfinite(ref)
    assert fin.sum() >= batch.shape[0] - 2
    np.testing.assert_allclose(got[fin], ref[fin], rtol=1e-9)


@pytest.mark.cuda
def test_fused_pf_float32_without_volatility_noise(card):
    """K5 in float32 at σ_h = 0 (every particle the exact filter, so
    resampling never changes a trajectory) against the plain float32
    version elementwise, rtol 5e-4, atol 1e-2."""
    from yieldfactormodels_jl_tpu_torch.ops import fused_pf

    s64, batch, data, nz, u = _pf_case(card, P_slots=1024)
    s32, _ = P.create_model("AFNS5", MATS)
    args = (batch.float(), data.float(), nz.float(), u.float())
    got = fused_pf.pf_loglik_batch(s32, *args, n_particles=1000, sv_sigma=0.0)
    ref = fused_pf.pf_loglik_batch_reference(s32, *args, n_particles=1000, sv_sigma=0.0)
    assert got.dtype == torch.float32 and bool(torch.isfinite(ref).all())
    np.testing.assert_allclose(got.cpu().numpy(), ref.cpu().numpy(), rtol=5e-4, atol=1e-2)


@pytest.mark.cuda
@pytest.mark.parametrize("slots", [1152, 2048])
def test_fused_pf_runs_more_slots_than_threads(card, slots):
    """Above 1,024 slots a thread runs several from the wrapper's scratch:
    K5 in float64 against its plain version at rtol 1e-9, equal −Inf sets,
    with a NaN column, dead slots and resampling at every step (ESS
    threshold 1.5)."""
    from yieldfactormodels_jl_tpu_torch.ops import fused_pf

    s64, batch, data, nz, u = _pf_case(card, D=3, T=24, P_slots=slots)
    data[:, 9] = float("nan")
    batch[2, 23] = 1.5  # Φ₁₁ > 1
    for kw in ({}, {"n_particles": slots - 100, "ess_threshold": 1.5}):
        launches = fused_pf.pf_loglik_batch.launches
        got = fused_pf.pf_loglik_batch(s64, batch, data, nz, u, **kw)
        torch.cuda.synchronize()
        assert fused_pf.pf_loglik_batch.launches == launches + 1
        ref = fused_pf.pf_loglik_batch_reference(s64, batch, data, nz, u, **kw)
        got, ref = got.cpu().numpy(), ref.cpu().numpy()
        np.testing.assert_array_equal(np.isfinite(got), np.isfinite(ref))
        assert got[2] == -np.inf and np.isfinite(ref[:2]).all()
        np.testing.assert_allclose(got[:2], ref[:2], rtol=1e-9)


@pytest.mark.cuda
def test_estimate_sv_on_the_card_matches_the_cpu(card):
    """The lockstep ``estimate_sv`` on the card (K5) against the same call
    on the CPU (K5's plain version), float64 both, on one noise pair: the
    same best start, ll at rtol 1e-8, the same iterations."""
    from tests import oracle
    from yieldfactormodels_jl_tpu_torch.ops import fused_pf

    spec, _ = P.create_model("1C", MATS, float_type="float64")
    rng = np.random.default_rng(3)
    data = oracle.simulate_dns_panel(rng, np.asarray(MATS), T=40)
    p = np.zeros(spec.n_params)
    p[0], p[1] = np.log(0.5), 4e-4
    p[2], p[4], p[7] = 0.1, 0.08, 0.12
    p[8:11] = [0.3, -0.1, 0.05]
    p[11:20] = np.diag([0.95, 0.9, 0.85]).reshape(-1)
    raw = P.untransform_params(spec, torch.as_tensor(p)).numpy()
    starts = np.stack([raw, raw + 1e-3])
    gen = torch.Generator().manual_seed(5)
    noise = (torch.randn(39, 128, generator=gen, dtype=torch.float64),
             torch.rand(39, generator=gen, dtype=torch.float64))
    kw = dict(n_particles=128, max_iters=15, noise=noise)
    launches = fused_pf.pf_loglik_batch.launches
    card_run = P.estimate_sv(spec, data, starts, **kw)
    assert fused_pf.pf_loglik_batch.launches > launches
    cpu_run = P.estimate_sv(spec, data, starts, device="cpu", **kw)
    assert int(np.argmax(card_run[2])) == int(np.argmax(cpu_run[2]))
    np.testing.assert_allclose(card_run[1], cpu_run[1], rtol=1e-8)
    np.testing.assert_allclose(card_run[2], cpu_run[2], rtol=1e-8)
    np.testing.assert_array_equal(card_run[3], cpu_run[3])
