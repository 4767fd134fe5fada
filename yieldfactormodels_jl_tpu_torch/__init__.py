"""PyTorch/CUDA port of ``yieldfactormodels_jl_tpu``.

The JAX package stays the reference; this package mirrors its module paths
(``models/``, ``ops/``, ``utils/``) in PyTorch, with hand-written CUDA
kernels for Hopper under ``csrc/``.  Ported so far: model specs and the zoo
registry, parameter transforms and unpacking, DNS/AFNS loadings, the Kalman
log-likelihood (univariate and joint engines), ``predict``, and the fused
batched log-likelihood kernel.
"""

from .carry import params_from_jax
from .models.api import get_loss, predict
from .models.params import transform_params, untransform_params
from .models.registry import create_model
from .ops.fused_kf import batched_loglik

__all__ = ["create_model", "transform_params", "untransform_params",
           "get_loss", "predict", "batched_loglik", "params_from_jax"]
