"""Immutable model specifications.

Counterpart of ``yieldfactormodels_jl_tpu/models/specs.py``: a model is a
hashable, frozen :class:`ModelSpec` plus a flat parameter tensor whose
layout is byte-for-byte the JAX package's (and so the reference's), so flat
parameter arrays move between the two packages unchanged
(``carry.params_from_jax``):

- kalman_dns   [γ_λ | σ²_obs | chol(Ω_state) | δ | vec_rowmajor(Φ)]   (20 for M=3)
- kalman_afns  [γ (n_lambdas) | σ²_obs | chol(Ω_state) | δ | vec_rowmajor(Φ)]
- kalman_tvl   [σ²_obs | chol(Ω_state) | δ | vec_rowmajor(Φ)]          (31, Ms=M+1)
- msed_*       [uniq A | uniq B (unless RW) | ω | δ | vec_colmajor(Φ)]
- static_* / random_walk  [γ | δ | vec_colmajor(Φ)]
"""

from __future__ import annotations

import dataclasses
from functools import cached_property
from typing import Optional, Tuple

import numpy as np
import torch

from .. import config
from ..utils import transformations as tr

KALMAN_FAMILIES = ("kalman_dns", "kalman_tvl", "kalman_afns")
MSED_FAMILIES = ("msed_lambda", "msed_neural")
STATIC_FAMILIES = ("static_lambda", "static_neural", "random_walk")
ALL_FAMILIES = KALMAN_FAMILIES + MSED_FAMILIES + STATIC_FAMILIES

_TORCH_DTYPES = {"float32": torch.float32, "float64": torch.float64}


@dataclasses.dataclass(frozen=True)
class ModelSpec:
    """Static description of a yield-factor model (hashable)."""

    family: str
    model_code: str
    maturities: Tuple[float, ...]
    M: int = 3
    L: int = 1
    dtype_name: str = "float32"

    # score-driven family options
    random_walk: bool = False
    scale_grad: bool = False
    forget_factor: float = 0.9
    dynamics: Optional[str] = None  # 'scalar' | 'block_diag' | 'diag'
    duplicator: Tuple[int, ...] = ()  # 0-based unique-parameter index per state

    # neural loading option: False = "-Anchored" codes
    transform_bool: bool = True

    # EKF Jacobian: False reproduces the reference's dZ₂/dλ formula
    # (models/kalman.tvl_dz2_dlam), True the exact derivative.
    exact_jacobian: bool = False

    # score-driven inner score detaches β (reference behaviour) when True
    detach_inner_beta: bool = True

    # persistence context
    model_string: str = ""
    results_location: str = "results/"

    def __post_init__(self):
        if self.family not in ALL_FAMILIES:
            raise ValueError(f"unknown family {self.family!r}")
        if self.dtype_name not in _TORCH_DTYPES:
            raise ValueError(f"dtype_name must be one of {tuple(_TORCH_DTYPES)}")
        if not self.model_string:
            object.__setattr__(self, "model_string", self.model_code)

    # ---- basic derived facts -------------------------------------------------

    @property
    def N(self) -> int:
        return len(self.maturities)

    @property
    def dtype(self) -> torch.dtype:
        return _TORCH_DTYPES[self.dtype_name]

    @property
    def state_dim(self) -> int:
        """Kalman state dimension (M+1 for TVλ: λ's driver is the 4th state)."""
        return self.M + 1 if self.family == "kalman_tvl" else self.M

    @property
    def n_lambdas(self) -> int:
        """Number of λ decay drivers (AFNS5/AFGNS has two)."""
        return (self.M - 1) // 2 if self.family == "kalman_afns" else 1

    @property
    def n_unique(self) -> int:
        return (max(self.duplicator) + 1) if self.duplicator else self.L

    def maturities_array(self, device=None, dtype=None) -> torch.Tensor:
        """The maturities on ``device`` (read only: made once per device and
        type)."""
        return config.device_constant(self.maturities, device, dtype or self.dtype)

    @property
    def is_kalman(self) -> bool:
        return self.family in KALMAN_FAMILIES

    @property
    def has_constant_measurement(self) -> bool:
        """Constant-Z Kalman family (TVλ's Jacobian rows depend on the state)."""
        return self.family in ("kalman_dns", "kalman_afns")

    @property
    def is_msed(self) -> bool:
        return self.family in MSED_FAMILIES

    @property
    def supports_score_tree(self) -> bool:
        """Score-driven spec whose recursion is the plain gradient update."""
        return self.is_msed and not self.scale_grad

    @property
    def is_static(self) -> bool:
        return self.family in STATIC_FAMILIES

    # ---- flat parameter layout ----------------------------------------------

    @cached_property
    def layout(self) -> dict:
        """name -> (start, stop) slices into the flat parameter vector."""
        M, L, u = self.M, self.L, self.n_unique
        pos = 0
        lay = {}

        def put(name, size):
            nonlocal pos
            lay[name] = (pos, pos + size)
            pos += size

        if self.is_kalman:
            Ms = self.state_dim
            if self.family == "kalman_dns":
                put("gamma", 1)
            elif self.family == "kalman_afns":
                put("gamma", self.n_lambdas)
            put("obs_var", 1)
            put("chol", Ms * (Ms + 1) // 2)
            put("delta", Ms)
            put("phi", Ms * Ms)
        elif self.is_msed:
            put("A", u)
            if not self.random_walk:
                put("B", u)
            put("omega", L)
            put("delta", M)
            put("phi", M * M)
        else:
            put("gamma", L)
            put("delta", M)
            put("phi", M * M)
        lay["__total__"] = (0, pos)
        return lay

    @property
    def n_params(self) -> int:
        return self.layout["__total__"][1]

    def slice(self, params, name):
        a, b = self.layout[name]
        return params[..., a:b]

    # ---- transform codes -----------------------------------------------------

    @cached_property
    def transform_codes(self) -> Tuple[int, ...]:
        """Per-parameter bijection codes, ordered like the flat layout."""
        codes: list[int] = []
        M = self.M
        if self.is_kalman:
            Ms = self.state_dim
            if self.family == "kalman_dns":
                codes.append(tr.IDENTITY)  # λ driver γ
            elif self.family == "kalman_afns":
                codes.extend([tr.IDENTITY] * self.n_lambdas)
            codes.append(tr.R_TO_POS)  # observation variance
            for j in range(Ms):  # chol, column-by-column; diag positive
                for i in range(j + 1):
                    codes.append(tr.R_TO_POS if i == j else tr.IDENTITY)
            codes.extend([tr.IDENTITY] * Ms)  # delta
            for i in range(Ms):  # Phi row-major, diag in (-1,1)
                for j in range(Ms):
                    codes.append(tr.R_TO_11 if i == j else tr.IDENTITY)
        elif self.is_msed:
            u = self.n_unique
            codes.extend([tr.R_TO_POS] * u)  # step sizes A > 0
            if not self.random_walk:
                codes.extend([tr.R_TO_01] * u)  # persistence B in (0,1)
            codes.extend([tr.IDENTITY] * self.L)  # omega
            codes.extend([tr.IDENTITY] * M)  # delta
            for k in range(M * M):  # Phi col-major, diag in (-1,1)
                codes.append(tr.R_TO_11 if k % (M + 1) == 0 else tr.IDENTITY)
        else:
            codes.extend([tr.IDENTITY] * self.L)  # gamma
            codes.extend([tr.IDENTITY] * M)  # delta
            for k in range(M * M):
                codes.append(tr.R_TO_11 if k % (M + 1) == 0 else tr.IDENTITY)
        if len(codes) != self.n_params:
            raise AssertionError("transform codes do not cover the layout")
        return tuple(codes)

    def transform_codes_array(self, device=None) -> torch.Tensor:
        return torch.tensor(self.transform_codes, dtype=torch.int64,
                            device=device)

    # ---- default parameter groups (block-coordinate estimation) -------------

    def default_param_groups(self) -> Tuple[str, ...]:
        """kalman: all "1"; msed/static: head "1", (δ, Φ) block "2"."""
        n = self.n_params
        if self.is_kalman:
            return tuple(["1"] * n)
        tail = self.M * (self.M + 1)
        return tuple(["1"] * (n - tail) + ["2"] * tail)

    # ---- initialization grids ------------------------------------------------

    @property
    def A_guesses(self) -> Tuple[float, ...]:
        if self.family == "msed_lambda":
            return (1e-6, 1e-5, 1e-4, 1e-3, 1e-2, 1e-1)
        if self.family == "msed_neural":
            return (1e-6, 1e-5, 1e-4, 1e-3)
        return ()

    @property
    def B_guesses(self) -> Tuple[float, ...]:
        if self.random_walk:
            return ()
        if self.family == "msed_lambda":
            return (0.9, 0.95, 0.98, 0.99, 0.999)
        if self.family == "msed_neural":
            return (0.97, 0.98, 0.99, 0.999)
        return ()

    # ---- chol index helpers --------------------------------------------------

    @cached_property
    def chol_indices(self) -> Tuple[np.ndarray, np.ndarray]:
        """(rows, cols) positions of the upper-triangular factor C in flat
        fill order: column by column."""
        Ms = self.state_dim
        rows, cols = [], []
        for j in range(Ms):
            for i in range(j + 1):
                rows.append(i)
                cols.append(j)
        return np.asarray(rows), np.asarray(cols)


def make_duplicator(dynamics: str, L: int, net_size: int = 3) -> Tuple[int, ...]:
    """Parameter-sharing index (0-based) per γ-state."""
    if dynamics == "scalar":
        half = L // 2
        return tuple([0] * half + [1] * half)
    if dynamics == "block_diag":
        return tuple(i // net_size for i in range(L))
    if dynamics == "diag":
        return tuple(range(L))
    raise ValueError("dynamics must be 'scalar', 'block_diag' or 'diag'")
