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


_KF_CASES = ("AFNS5", "1C NaN columns, invalid draw", "TVλ exact", "TVλ reference",
             "AFNS5 per-draw windows")


def _kf_case(card, case, B, dtype):
    """K1's inputs for one case of the layout test: N=6, T=40."""
    import dataclasses

    rng = np.random.default_rng(len(case) + B)
    code = case.split()[0]
    spec, _ = P.create_model(code, MATS, float_type="float64")
    if code == "TVλ":
        spec = dataclasses.replace(spec, exact_jacobian=case.endswith("exact"))
    T = 40
    p = _draws(spec, B, rng)
    data = 0.5 * rng.standard_normal((len(MATS), T)) + 4
    starts = ends = None
    if code == "TVλ":
        lo, hi = spec.layout["delta"]
        p[:, lo:hi] = [0.4, -0.1, 0.05, 0.1 * np.log(0.49)]
        p[:, lo:hi] += 0.02 * rng.standard_normal((B, hi - lo))
    if "NaN" in case:
        data[:, 20] = np.nan
        data[1, 25] = np.nan
        p[B // 2] = np.nan
    if "windows" in case:
        starts = torch.as_tensor(rng.integers(0, 10, B), device=card)
        ends = torch.as_tensor(rng.integers(25, T + 1, B), device=card)
    params, data, starts, ends = fused_kf._prepare(
        spec, torch.as_tensor(p, device=card), torch.as_tensor(data, device=card), starts,
        ends, None, dtype)
    return fused_kf.kernel_inputs(spec, params, data, 1, T - 2, starts, ends)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("B", [1, 256, 1024])
@pytest.mark.parametrize("case", _KF_CASES)
@pytest.mark.parametrize("layout", ["warp", "octet"])
def test_fused_kf_layouts_equal(card, layout, case, B, dtype):
    """K1 with 32 or 8 lanes a draw against one thread a draw on the same
    inputs, bit for bit (torch.equal: the same −inf draws and every finite
    bit): NaN columns as predict-only steps, an invalid draw, both TVλ
    Jacobians, a shared window and one per draw."""
    inputs = _kf_case(card, case, B, dtype)
    thread = fused_kf.launch(inputs, layout="thread").clone()
    got = fused_kf.launch(inputs, layout=layout)
    torch.cuda.synchronize()
    assert got.dtype == dtype
    assert torch.equal(got, thread)
    if "NaN" in case:
        assert got[B // 2] == -np.inf
    if B > 1:
        assert bool(torch.isfinite(got).sum() >= B - 1)


@pytest.mark.cuda
def test_fused_kf_pick_and_a_forced_layouts_refusal(card):
    """The pick follows the batch (a group layout for the few draws of a
    line search, the thread layout at 16,384); a layout that cannot launch
    — 8 lanes a draw when four draws' rows of 1,200 maturities pass the
    block's shared memory — raises and launches nothing, while the pick
    (one draw's rows fit a warp's block) and the thread layout run the same
    inputs to the same bits."""
    small = _kf_case(card, "AFNS5", 1, torch.float32)
    assert fused_kf.layout_of(small) in ("warp", "octet")
    large = _kf_case(card, "AFNS5", 16384, torch.float32)
    assert fused_kf.layout_of(large) == "thread"
    mats = tuple(np.linspace(0.25, 30.0, 1200))
    spec, _ = P.create_model("1C", mats, float_type="float64")
    rng = np.random.default_rng(3)
    p = torch.as_tensor(_draws(spec, 2, rng), device=card)
    data = torch.as_tensor(0.5 * rng.standard_normal((len(mats), 4)) + 4, device=card)
    wide = fused_kf.kernel_inputs(spec, p, data, 0, 4)
    launches = fused_kf.batched_loglik.launches
    with pytest.raises(RuntimeError, match="cudaError"):
        fused_kf.launch(wide, layout="octet")
    assert fused_kf.batched_loglik.launches == launches
    assert fused_kf.layout_of(wide) == "warp"
    picked = fused_kf.launch(wide).clone()
    got = fused_kf.launch(wide, layout="thread")
    torch.cuda.synchronize()
    assert torch.equal(picked, got)
    ref = fused_kf.batched_loglik_reference(spec, p, data).cpu().numpy()
    np.testing.assert_allclose(got.cpu().numpy(), ref, rtol=1e-9)


@pytest.mark.cuda
@pytest.mark.parametrize("B, pick", [(256, "warp"), (1024, "thread")])
def test_fused_kf_pick_fits_many_maturities(card, B, pick):
    """360 monthly maturities in float64: a warp's block holds one AFNS5
    draw's rows and 256 such blocks fit the card at once, but four draws'
    rows pass a block's shared memory, so 1,024 draws take the thread
    layout where the batch alone would pick 8 lanes a draw.  The picked
    launch runs, equals the thread layout bit for bit and agrees with the
    plain version."""
    mats = tuple(np.arange(1, 361) / 12.0)
    spec, _ = P.create_model("AFNS5", mats, float_type="float64")
    rng = np.random.default_rng(B)
    p = torch.as_tensor(_draws(spec, B, rng), device=card)
    data = torch.as_tensor(0.5 * rng.standard_normal((len(mats), 12)) + 4, device=card)
    inputs = fused_kf.kernel_inputs(spec, p, data, 0, 12)
    assert fused_kf.layout_of(inputs) == pick
    got = fused_kf.launch(inputs).clone()
    thread = fused_kf.launch(inputs, layout="thread")
    torch.cuda.synchronize()
    assert torch.equal(got, thread)
    assert bool(torch.isfinite(got).all())
    ref = fused_kf.batched_loglik_reference(spec, p, data).cpu().numpy()
    np.testing.assert_allclose(got.cpu().numpy(), ref, rtol=1e-9)


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


_KFG_CASES = ("AFNS5", "1C NaN columns, invalid draw, windows", "Svensson Ms=4 windows",
              "TVλ exact windows", "TVλ reference windows")
_KFG_GROUPS = (("warp", "segment"), ("warp", "step"), ("warp", 3), ("octet", "segment"),
               ("octet", "step"), ("octet", 3))


def _svensson(B, data, rng):
    """The arguments of forward_reference for a four-state constant
    measurement (Svensson's loadings at λ₁ = 0.6, λ₂ = 0.15, MATS) and B
    stationary draws: the Ms = 4 instance of K2f/K2b, which no model of the
    port reaches yet."""
    tau = np.asarray(MATS)
    x1, x2 = 0.6 * tau, 0.15 * tau
    slope = (1 - np.exp(-x1)) / x1
    Z = np.stack([np.ones_like(tau), slope, slope - np.exp(-x1),
                  (1 - np.exp(-x2)) / x2 - np.exp(-x2)], -1)
    phi = 0.9 * np.eye(4) + 0.01 * rng.standard_normal((B, 4, 4))
    delta = 0.2 * rng.standard_normal((B, 4))
    om = np.tile(0.01 * np.eye(4), (B, 1, 1))
    P0 = np.tile(np.eye(4), (B, 1, 1))
    for _ in range(100):
        P0 = phi @ P0 @ phi.transpose(0, 2, 1) + om
    beta0 = np.linalg.solve(np.eye(4) - phi, delta[..., None])[..., 0]

    def t(x):
        return torch.as_tensor(x, device=data.device, dtype=data.dtype)

    return (t(np.tile(Z, (B, 1, 1))), t(np.zeros((B, len(MATS)))), t(phi), t(delta), t(om),
            t(np.full(B, 0.01)), t(beta0), t(P0))


def _kfg_case(card, case, B, dtype):
    """An adjoint launch's inputs for one case of the layout test, N=6, T=40:
    (buffers, checkpoints, cotangent, tvl, exact)."""
    import dataclasses

    from yieldfactormodels_jl_tpu_torch.ops import fused_kf_grad as G

    rng = np.random.default_rng(len(case) + B)
    code = case.split()[0]
    T = 40
    data = torch.as_tensor(0.5 * rng.standard_normal((len(MATS), T)) + 4, device=card,
                           dtype=dtype)
    if "NaN" in case:
        data[:, 20] = float("nan")
        data[1, 25] = float("nan")
    win = {}
    if "windows" in case:
        win = {"starts": torch.as_tensor(rng.integers(0, 10, B), device=card),
               "ends": torch.as_tensor(rng.integers(25, T + 1, B), device=card)}
    tvl, exact = code == "TVλ", case.startswith("TVλ exact")
    if code == "Svensson":
        masks = torch.ones(T, 2, dtype=torch.uint8, device=card)
        w = torch.stack([win["starts"], win["ends"]]).to(torch.int32)
        bufs = G.lay_out(*_svensson(B, data, rng), data, masks, w)
    else:
        spec, _ = P.create_model(code, MATS, float_type="float64")
        spec = dataclasses.replace(spec, exact_jacobian=exact)
        p = _draws(spec, B, rng)
        if tvl:
            lo, hi = spec.layout["delta"]
            p[:, lo:hi] = [0.4, -0.1, 0.05, 0.1 * np.log(0.49)]
            p[:, lo:hi] += 0.02 * rng.standard_normal((B, hi - lo))
        if "invalid" in case:
            p[B // 2] = np.nan
        args = G.core_inputs(spec, torch.as_tensor(p, device=card, dtype=dtype), data, 1, T - 1,
                             **win)
        bufs = G.lay_out_tvl(*args[:10]) if tvl else G.lay_out(*args)
    ll, chk = G.launch_forward_tvl(bufs, exact) if tvl else G.launch_forward(bufs)
    g = torch.as_tensor(rng.uniform(0.5, 1.5, B), device=card, dtype=dtype)
    g = torch.where(torch.isfinite(ll), g, torch.zeros_like(g))
    return bufs, chk, g, tvl, exact


def _kfg(bufs, chk, g, tvl, exact, **kw):
    from yieldfactormodels_jl_tpu_torch.ops import fused_kf_grad as G

    if tvl:
        return G.launch_backward_tvl(bufs, exact, chk, g, **kw)
    return G.launch_backward(bufs, chk, g, **kw)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("B", [3, 300])
@pytest.mark.parametrize("case", _KFG_CASES)
@pytest.mark.parametrize("layout, store", _KFG_GROUPS)
def test_fused_kf_grad_layouts_equal(card, layout, store, case, B, dtype):
    """K2b/K3b with 32 or 8 lanes a draw, keeping the pre-update states of a
    whole segment, of one step or of 3 of its 7 steps in shared memory (the
    segment's earlier steps then run forward twice), against one thread a draw on the
    same inputs, checkpoints and cotangent, bit for bit on every leaf
    (torch.equal): NaN columns as predict-only steps, an invalid draw (zero
    gradients), a four-state constant measurement, both TVλ Jacobians,
    shared and per-draw windows."""
    bufs, chk, g, tvl, exact = _kfg_case(card, case, B, dtype)
    thread = [x.clone() for x in _kfg(bufs, chk, g, tvl, exact, layout="thread")]
    got = _kfg(bufs, chk, g, tvl, exact, layout=layout, store=store)
    torch.cuda.synchronize()
    for a, r in zip(got, thread):
        assert a.dtype == dtype
        assert torch.equal(a, r)
    if "invalid" in case:
        assert all(bool((a[:, B // 2] == 0).all()) for a in got)


def _fwd(bufs, tvl, exact, **kw):
    from yieldfactormodels_jl_tpu_torch.ops import fused_kf_grad as G

    return G.launch_forward_tvl(bufs, exact, **kw) if tvl else G.launch_forward(bufs, **kw)


def _same_bits(a, b):
    """Bit for bit, NaN words too (an invalid draw's checkpoints are NaN)."""
    as_int = torch.int64 if a.dtype == torch.float64 else torch.int32
    return a.dtype == b.dtype and a.shape == b.shape and torch.equal(a.view(as_int),
                                                                     b.view(as_int))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("B", [3, 300])
@pytest.mark.parametrize("case", _KFG_CASES)
@pytest.mark.parametrize("layout", ["warp", "octet"])
def test_fused_kf_grad_forward_layouts_equal(card, layout, case, B, dtype):
    """K2f/K3f with 32 or 8 lanes a draw against one thread a draw on the
    same inputs: the value equal (torch.equal: the same −inf draws and every
    finite bit) and every checkpoint word the same bits (NaN words too: an
    invalid draw's state is NaN), on NaN columns, an invalid draw, a
    four-state constant measurement, both TVλ Jacobians, shared and per-draw
    windows."""
    bufs, _, _, tvl, exact = _kfg_case(card, case, B, dtype)
    ll_t, chk_t = (x.clone() for x in _fwd(bufs, tvl, exact, layout="thread"))
    ll, chk = _fwd(bufs, tvl, exact, layout=layout)
    torch.cuda.synchronize()
    assert ll.dtype == dtype and torch.equal(ll, ll_t)
    assert _same_bits(chk, chk_t)
    if "invalid" in case:
        assert ll[B // 2] == -np.inf


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("exact", [False, True])
@pytest.mark.parametrize("layout", [None, "thread", "warp", "octet"])
def test_fused_kf_tvl_grad_forward_equals_k1_in_each_layout(card, layout, exact, dtype):
    """K3f's value is K1-TVλ's bit for bit in each layout (one kernel in
    kf_common.cuh, K3f's launch only adds the checkpoints), and the pick
    (layout None) is K1's pick for the same shapes."""
    from yieldfactormodels_jl_tpu_torch.ops import fused_kf_grad as G

    case = "TVλ exact windows" if exact else "TVλ reference windows"
    bufs, _, _, tvl, _ = _kfg_case(card, case, 300, dtype)
    code, B, N, T, _, _ = G._sizes_tvl(bufs)
    k1 = fused_kf.KernelInputs((code, 4, 1, int(exact), B, N, T), (None, None, *bufs),
                               torch.empty(B, dtype=dtype, device=card))
    assert G.forward_layout_of(bufs, tvl=True) == fused_kf.layout_of(k1)
    ll_k1 = fused_kf.launch(k1, layout=layout).clone()
    ll, _ = G.launch_forward_tvl(bufs, exact, layout=layout)
    torch.cuda.synchronize()
    assert torch.equal(ll, ll_k1)
    assert bool(torch.isfinite(ll).all())


@pytest.mark.cuda
@pytest.mark.parametrize("B, pick", [(256, "warp"), (1024, "thread")])
def test_fused_kf_grad_forward_pick_and_a_forced_layouts_refusal(card, B, pick):
    """The forward's pick follows the batch (a warp a draw for a line
    search's few draws, a thread a draw at 16,384) and, as K1's, takes a
    group layout only while its blocks fit the card at once: 360 monthly
    maturities in float64 give 256 draws the warp and 1,024 the thread
    layout, and a forced octet layout (four draws' rows pass a block's
    shared memory) raises and launches nothing.  The pick equals the thread
    layout bit for bit, checkpoints too, and agrees with the plain version."""
    from yieldfactormodels_jl_tpu_torch.ops import fused_kf_grad as G

    assert G.forward_layout_of(_kfg_case(card, "AFNS5", 3, torch.float32)[0]) == "warp"
    large = _kfg_case(card, "TVλ exact windows", 16384, torch.float32)[0]
    assert G.forward_layout_of(large, tvl=True) == "thread"
    mats = tuple(np.arange(1, 361) / 12.0)
    spec, _ = P.create_model("AFNS5", mats, float_type="float64")
    rng = np.random.default_rng(B)
    p = torch.as_tensor(_draws(spec, B, rng), device=card)
    data = torch.as_tensor(0.5 * rng.standard_normal((len(mats), 12)) + 4, device=card)
    args = G.core_inputs(spec, p, data, 0, 12)
    bufs = G.lay_out(*args)
    assert G.forward_layout_of(bufs) == pick
    launches = G.launch_forward.launches
    with pytest.raises(RuntimeError, match="cudaError"):
        G.launch_forward(bufs, layout="octet")
    assert G.launch_forward.launches == launches
    ll, chk = (x.clone() for x in G.launch_forward(bufs))
    ll_t, chk_t = G.launch_forward(bufs, layout="thread")
    torch.cuda.synchronize()
    assert torch.equal(ll, ll_t) and _same_bits(chk, chk_t)
    assert bool(torch.isfinite(ll).all())
    ref, chk_ref = G.forward_reference(*args)
    np.testing.assert_allclose(ll.cpu().numpy(), ref.cpu().numpy(), rtol=1e-9)
    np.testing.assert_allclose(chk.T.reshape(chk_ref.shape).cpu().numpy(),
                               chk_ref.cpu().numpy(), rtol=1e-9, atol=1e-12)


@pytest.mark.cuda
def test_fused_kf_grad_pick_and_a_forced_layouts_refusal(card):
    """The adjoint's pick follows the batch: a warp a draw keeping the
    segment for a line search's few draws, a thread a draw at 16,384; with
    360 maturities in float64 a warp's block holds a few of a draw's steps but not
    its segment, so 64 draws take the warp keeping a few steps and 256
    (which would not fit the card at once) the thread layout, while a
    forced octet layout or a forced segment store raises and launches
    nothing.  The pick equals the thread layout bit for bit and the plain
    adjoint at 1e-6."""
    from yieldfactormodels_jl_tpu_torch.ops import fused_kf_grad as G

    small = _kfg_case(card, "AFNS5", 3, torch.float32)
    assert G.backward_plan(small[0]) == ("warp", "segment")
    large = _kfg_case(card, "TVλ exact windows", 16384, torch.float32)
    assert G.backward_plan(large[0], tvl=True) == ("thread", None)
    mats = tuple(np.arange(1, 361) / 12.0)
    spec, _ = P.create_model("AFNS5", mats, float_type="float64")
    for B, pick in ((64, "warp"), (256, "thread")):
        rng = np.random.default_rng(B)
        p = torch.as_tensor(_draws(spec, B, rng), device=card)
        data = torch.as_tensor(0.5 * rng.standard_normal((len(mats), 12)) + 4, device=card)
        args = G.core_inputs(spec, p, data, 0, 12)
        bufs = G.lay_out(*args)
        ll, chk = G.launch_forward(bufs)
        g = torch.where(torch.isfinite(ll), torch.ones_like(ll), torch.zeros_like(ll))
        layout, store = G.backward_plan(bufs)
        assert layout == pick and store != "segment"
        launches = G.launch_backward.launches
        for kw in ({"layout": "octet"}, {"layout": "warp", "store": "segment"}):
            with pytest.raises(RuntimeError, match="cudaError"):
                G.launch_backward(bufs, chk, g, **kw)
        assert G.launch_backward.launches == launches
        picked = [x.clone() for x in G.launch_backward(bufs, chk, g)]
        thread = G.launch_backward(bufs, chk, g, layout="thread")
        torch.cuda.synchronize()
        assert all(torch.equal(a, r) for a, r in zip(picked, thread))
        ref = G.adjoint_reference(*args[:6], *args[8:], chk.T.reshape(B, -1, 30), g)
        for k, r in zip(picked, ref):
            r = r.reshape(B, -1)
            k = k.T.reshape(r.shape)
            scale = r.abs().amax(1, keepdim=True)
            assert ((k - r).abs() <= 1e-6 * r.abs() + 1e-9 * scale).all()


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


@pytest.mark.cuda
@pytest.mark.parametrize("code", ["1C", "TVλ"])
def test_loglik_graph_replays_k1_bit_for_bit(card, code):
    """K1 and its set-up captured as a CUDA graph return the eager launch's
    bits on every replay, and each replay counts one launch."""
    rng = np.random.default_rng(3)
    spec, _ = P.create_model(code, MATS)
    p = torch.as_tensor(_draws(spec, 4, rng), device=card, dtype=torch.float32)
    data = torch.as_tensor(4.0 + 0.1 * rng.standard_normal((len(MATS), 40)), device=card,
                           dtype=torch.float32)
    raw = P.untransform_params(spec, p)

    def fn(X):
        return fused_kf.batched_loglik(spec, P.transform_params(spec, X), data, 2, 38)

    n = fused_kf.batched_loglik.launches
    graph = fused_kf.LoglikGraph(fn, raw[:1])
    assert fused_kf.batched_loglik.launches == n + 1      # the warm-up, not the capture
    for row in raw:
        assert torch.equal(graph(row[None]), fn(row[None]))
    assert fused_kf.batched_loglik.launches == n + 1 + 2 * len(raw)


@pytest.mark.cuda
def test_kalman_estimate_steps_on_the_card(card, monkeypatch):
    """``estimate_steps`` on "1C" in float64: on the card (its iterations
    replayed from a CUDA graph) against the same call on the CPU at rtol
    1e-6, and bit for bit against the card with every evaluation eager."""
    from tests import oracle

    spec, _ = P.create_model("1C", MATS, float_type="float64")
    data = oracle.simulate_dns_panel(np.random.default_rng(0), np.asarray(MATS), T=40)
    p = oracle.stable_1c_params(spec, np.float64)[:, None]
    groups = P.get_param_groups(spec)
    budgets = {"1": ("neldermead", dict(max_iters=25))}
    launches = fused_kf.batched_loglik.launches
    calls = fused_kf.batched_loglik_reference.calls
    _, ll_card, best_card, conv_card = P.estimate_steps(spec, data, p, groups, max_group_iters=1,
                                                        optimizers=budgets)
    assert fused_kf.batched_loglik.launches > launches
    assert fused_kf.batched_loglik_reference.calls == calls
    _, ll_cpu, _, conv_cpu = P.estimate_steps(spec, data, p, groups, max_group_iters=1,
                                              optimizers=budgets, device="cpu")
    np.testing.assert_allclose(ll_card, ll_cpu, rtol=1e-6)
    assert tuple(conv_card) == tuple(conv_cpu)
    monkeypatch.setattr(fused_kf, "LoglikGraph", lambda fn, example: fn)
    _, ll_eager, best_eager, _ = P.estimate_steps(spec, data, p, groups, max_group_iters=1,
                                                  optimizers=budgets)
    assert ll_eager == ll_card
    np.testing.assert_array_equal(best_eager, best_card)


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
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("D", [1, 8, 392])
def test_fused_pf_cluster_launch_equals_block_launch(card, D, dtype):
    """K5 with one draw over a thread-block cluster (8 CTAs at P = 256, each
    a chain warp and a helper warp) against one draw a block on the same
    inputs, bit for bit
    (torch.equal): 200 live of 256 slots, one noise pair shared by every
    draw (as estimate_sv passes it), a NaN column, and a draw whose loglik
    is −Inf in the kernel (σ² < 0)."""
    from yieldfactormodels_jl_tpu_torch.ops import fused_pf

    s64, batch, data, nz, u = _pf_case(card, D=1, T=40, P_slots=256)
    rng = np.random.default_rng(7)
    batch = torch.as_tensor(_afns5_batch(s64, D, rng), device=card)
    batch[0, 2] = -4e-4  # σ² < 0: every update's f ≤ 0
    data[:, 9] = float("nan")
    spec = s64 if dtype == torch.float64 else P.create_model("AFNS5", MATS)[0]
    inputs = fused_pf.kernel_inputs(spec, batch.to(dtype), data.to(dtype),
                                    nz.to(dtype).expand(D, -1, -1), u.to(dtype).expand(D, -1),
                                    200, 0.95, 0.2, 0.5)
    block = fused_pf.launch(inputs, layout="block")
    cluster = fused_pf.launch(inputs, layout="cluster")
    torch.cuda.synchronize()
    assert cluster.dtype == dtype and cluster[0] == -np.inf
    assert D == 1 or bool(torch.isfinite(cluster[1:]).all())
    assert torch.equal(block, cluster)
    if D == 8:
        assert fused_pf.layout_of(inputs) == "cluster"


@pytest.mark.cuda
def test_fused_pf_cluster_launch_at_128_slots_and_its_refusal_above_256(card):
    """The cluster launch at 4 CTAs (128 slots) against the
    block launch bit for bit and the plain version at rtol 1e-9, float64,
    resampling at every step (ESS threshold 1.5) with dead slots and an
    invalid draw; forced above 256 slots (more than 8 CTAs) it raises and
    launches nothing."""
    from yieldfactormodels_jl_tpu_torch.ops import fused_pf

    s64, batch, data, nz, u = _pf_case(card, D=3, T=24, P_slots=128)
    batch[2, 23] = 1.5  # Φ₁₁ > 1
    inputs = fused_pf.kernel_inputs(s64, batch, data, nz, u, 100, 0.95, 0.2, 1.5)
    block = fused_pf.launch(inputs, layout="block")
    cluster = fused_pf.launch(inputs, layout="cluster")
    torch.cuda.synchronize()
    assert torch.equal(block, cluster)
    ref = fused_pf.reference(inputs).cpu().numpy()
    got = cluster.cpu().numpy()
    assert got[2] == -np.inf and np.isfinite(ref[:2]).all()
    np.testing.assert_allclose(got[:2], ref[:2], rtol=1e-9)
    s64, batch, data, nz, u = _pf_case(card, D=2, T=8, P_slots=384)
    wide = fused_pf.kernel_inputs(s64, batch, data, nz, u, 384, 0.95, 0.2, 0.5)
    launches = fused_pf.pf_loglik_batch.launches
    with pytest.raises(RuntimeError, match="cudaError"):
        fused_pf.launch(wide, layout="cluster")
    assert fused_pf.pf_loglik_batch.launches == launches
    assert fused_pf.layout_of(wide) == "block"


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


def _static_draws(spec, B, rng):
    """(B, P) static draws: λ = 0.5 (or small neural weights) jittered, δ
    near a DNS curve, Φ near 0.9 I."""
    p = np.zeros((B, spec.n_params))
    L = spec.L
    p[:, :L] = (np.log(0.5) if L == 1 else 0.0) + 0.2 * rng.standard_normal((B, L))
    p[:, L:L + 3] = [0.3, -0.1, 0.05] + 0.05 * rng.standard_normal((B, 3))
    p[:, L + 3:] = (0.9 * np.eye(3)).T.reshape(-1) + 0.01 * rng.standard_normal((B, 9))
    return p


@pytest.mark.cuda
@pytest.mark.parametrize("code", ["NS", "NNS"])
def test_static_loss_on_the_card_matches_the_cpu(card, code):
    """The batched static loss, loss array and predict on the card against
    the CPU in float64 (rtol 1e-9), with a NaN column at the window's first
    step, a partially NaN column after it and a NaN forecast tail; and the
    float32 loss against the float64 CPU at rtol 5e-4."""
    from tests import oracle

    rng = np.random.default_rng(1)
    spec, _ = P.create_model(code, MATS, float_type="float64")
    spec32, _ = P.create_model(code, MATS)
    data = oracle.simulate_dns_panel(rng, np.asarray(MATS), T=60)
    data[:, 5] = np.nan
    data[2, 50] = np.nan
    data = np.concatenate([data, np.full((len(MATS), 6), np.nan)], axis=1)
    p = _static_draws(spec, 64, rng)
    got = P.get_loss(spec, p, data, 5, 45)
    assert got.is_cuda
    want = P.get_loss(spec, p, data, 5, 45, device="cpu").numpy()
    np.testing.assert_allclose(got.cpu().numpy(), want, rtol=1e-9)
    assert P.get_loss(spec, p, data, 5, 55).isinf().all()      # the partial column
    np.testing.assert_allclose(P.get_loss_array(spec, p, data, 5, 45).cpu().numpy(),
                               P.get_loss_array(spec, p, data, 5, 45, device="cpu").numpy(),
                               rtol=1e-9, atol=1e-12)
    res, ref = P.predict(spec, p[:4], data[:, :60]), P.predict(spec, p[:4], data[:, :60],
                                                               device="cpu")
    for k in ref:
        np.testing.assert_allclose(res[k].cpu().numpy(), ref[k].numpy(), rtol=1e-9,
                                   atol=1e-12, err_msg=k)
    np.testing.assert_allclose(P.get_loss(spec32, p, data, 5, 45).cpu().numpy(), want,
                               rtol=5e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("code", ["1C", "SD-NS", "NS"])
def test_diagnose_on_the_card_gives_the_cpus_code(card, code):
    """``taxonomy.diagnose`` on the card against the CPU in float64: the
    same code, the loss at rtol 1e-9, on a healthy point, non-finite
    parameters, an all-NaN window and a blown-up state."""
    from tests import oracle
    from yieldfactormodels_jl_tpu_torch.robustness import taxonomy

    spec, _ = P.create_model(code, MATS, float_type="float64")
    p = {"1C": lambda s: oracle.stable_1c_params(s, np.float64),
         "SD-NS": oracle.stable_msed_params,
         "NS": lambda s: oracle.stable_ns_params(s, np.float64)}[code](spec)
    data = oracle.simulate_dns_panel(np.random.default_rng(2), np.asarray(MATS), T=40)
    lo, _ = spec.layout["delta"]
    overflow, exploded, gap = p.copy(), p.copy(), data.copy()
    overflow[lo] = np.inf
    exploded[lo] = 1e300
    gap[:, 10:20] = np.nan
    cases = {"healthy": (p, data, 0, 40, 0),
             "non-finite parameters": (overflow, data, 0, 40, taxonomy.TRANSFORM_OVERFLOW),
             "all-NaN window": (p, gap, 10, 20, taxonomy.MISSING_ALL_OBS),
             "blown-up state": (exploded, data, 0, 40, taxonomy.STATE_EXPLODED)}
    for name, (q, d, s, e, flag) in cases.items():
        ll_g, code_g = taxonomy.diagnose(spec, q, d, s, e)
        ll_c, code_c = taxonomy.diagnose(spec, q, d, s, e, device="cpu")
        assert code_g == code_c and code_g & flag == flag, name
        if np.isfinite(ll_c):
            np.testing.assert_allclose(ll_g, ll_c, rtol=1e-9, err_msg=name)
        else:
            assert ll_g == ll_c, name
