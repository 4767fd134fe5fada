"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Marked ``cuda``: each test skips without a CUDA card.  This file imports
neither JAX nor the JAX package, so it also runs where only PyTorch is
installed:

    python -m pytest --noconftest tests/test_torch_cuda.py -m cuda

Tolerances: the float32 kernel against the plain float64 version at rtol
5e-4, atol 1e-2 (tests/test_pallas_kf.py's), the float64 instantiation at
rtol 1e-9 (the same arithmetic in another order).
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
