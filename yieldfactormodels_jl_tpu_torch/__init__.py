"""PyTorch/CUDA port of ``yieldfactormodels_jl_tpu``.

The JAX package stays the reference; this package mirrors its module paths
(``models/``, ``ops/``, ``estimation/``, ``persistence/``, ``utils/``) in
PyTorch, with hand-written CUDA kernels for Hopper under ``csrc/``.  Ported
so far: model specs and the zoo registry, parameter transforms and
unpacking, DNS/AFNS loadings, the Kalman log-likelihood (univariate and
joint engines), ``predict`` and ``get_loss_array``, the fused batched
log-likelihood kernel, its differentiable twin (forward and adjoint
kernels, for DNS/AFNS and the TVλ EKF), the multi-start MLE
``estimate`` and its rolling-window form ``estimate_windows`` (fused for
the Kalman families, and per start on the plain engines for every family:
optax's L-BFGS and Adam, the starts in lockstep); for the
score-driven families the scan filter, the fused value kernel and the
``try_initializations`` grid; the static families (OLS cross-sections and
the random walk) and their initial proposals; the block-coordinate
``estimate_steps`` for the Kalman, score-driven and static families, with
their Nelder–Mead, closed-form, L-BFGS and Adam groups; the
coded engines and the failure taxonomy's ``diagnose``; the square-root
engine "sqrt"; under
stochastic-volatility measurement errors the particle filter, its fused
kernel over a draw batch and the simulated MLE ``estimate_sv``; and the
reference's driver: ``run`` (CSV panel → in-sample fit and CSVs → rolling
forecasts, and the warm-start cascade from a static model into a
score-driven one) with ``run_rolling_forecasts``, the SQLite forecast
shards, their merge and the legacy CSV export.
"""

from .carry import params_from_jax
from .estimation.optimize import (Convergence, estimate, estimate_steps,
                                  estimate_windows, last_multistart_report,
                                  try_initializations)
from .estimation.sv import estimate_sv
from .forecasting import run_rolling_forecasts
from .models.api import get_loss, get_loss_array, get_param_groups, predict
from .models.params import transform_params, untransform_params
from .models.registry import create_model
from .ops.fused_kf import batched_loglik
from .ops.fused_kf_grad import batched_loglik_diff
from .ops.fused_pf import pf_loglik_batch
from .ops.fused_ssd import batched_loss
from .ops.particle import particle_filter_loglik
from .run import run

__all__ = ["create_model", "transform_params", "untransform_params",
           "get_loss", "get_loss_array", "get_param_groups", "predict",
           "batched_loglik", "batched_loglik_diff", "batched_loss",
           "estimate", "estimate_windows", "estimate_steps", "try_initializations",
           "last_multistart_report", "Convergence", "params_from_jax",
           "particle_filter_loglik", "pf_loglik_batch", "estimate_sv",
           "run", "run_rolling_forecasts"]
