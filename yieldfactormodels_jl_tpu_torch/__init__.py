"""PyTorch/CUDA port of ``yieldfactormodels_jl_tpu``.

The JAX package stays the reference; this package mirrors its module paths
(``models/``, ``ops/``, ``utils/``) in PyTorch, with hand-written CUDA
kernels for Hopper under ``csrc/``.  Ported so far: model specs and the zoo
registry, parameter transforms and unpacking, DNS/AFNS loadings, the Kalman
log-likelihood (univariate and joint engines), ``predict``, the fused
batched log-likelihood kernel, its differentiable twin (forward and adjoint
kernels) and the fused multi-start MLE ``estimate``.
"""

from .carry import params_from_jax
from .estimation.optimize import Convergence, estimate, last_multistart_report
from .models.api import get_loss, predict
from .models.params import transform_params, untransform_params
from .models.registry import create_model
from .ops.fused_kf import batched_loglik
from .ops.fused_kf_grad import batched_loglik_diff

__all__ = ["create_model", "transform_params", "untransform_params",
           "get_loss", "predict", "batched_loglik", "batched_loglik_diff",
           "estimate", "last_multistart_report", "Convergence",
           "params_from_jax"]
