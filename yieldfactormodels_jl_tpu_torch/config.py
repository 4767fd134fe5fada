"""Engine names and the device rule of the PyTorch port.

Counterpart of the engine registries of ``yieldfactormodels_jl_tpu/config.py``.
The engine names are the JAX package's, so a caller can name any of them;
the port runs "univariate" (the default), "joint" and "sqrt" for the
Kalman families and "scan" for the score-driven ones so far, and
``models.api.get_loss`` says which ROADMAP item brings the others.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

#: Kalman loglik engines (the JAX package's names):
#:   "univariate"  sequential-observation scalar updates (the default)
#:   "sqrt"        Potter square-root form
#:   "joint"       textbook joint update with per-step Cholesky
#:   "assoc"       parallel-in-time associative scan (constant-Z families)
#:   "slr"         iterated SLR on the combine tree (every Kalman family)
KALMAN_ENGINES = ("univariate", "sqrt", "joint", "assoc", "slr")
_KALMAN_ENGINE = "univariate"

#: loss engines of the score-driven (MSED) families:
#:   "scan"        the sequential recursion (the default)
#:   "score_tree"  the parallel-in-time engine, where the spec's state is
#:                 the plain gradient recursion (``spec.supports_score_tree``)
MSED_ENGINES = ("scan", "score_tree")


def engines_for(spec) -> tuple:
    """The loss-engine names valid for one family: for a Kalman family all
    of ``KALMAN_ENGINES`` where the measurement is constant, all but "assoc"
    for TVλ; for a score-driven family ``MSED_ENGINES``, without
    "score_tree" for the EWMA-scaled specs; none for the static families,
    which have no recursion to choose an engine for."""
    if spec.is_kalman:
        if spec.has_constant_measurement:
            return KALMAN_ENGINES
        return tuple(e for e in KALMAN_ENGINES if e != "assoc")
    if spec.is_msed:
        if spec.supports_score_tree:
            return MSED_ENGINES
        return tuple(e for e in MSED_ENGINES if e != "score_tree")
    return ()


def kalman_engine() -> str:
    """The engine ``api.get_loss`` runs when the caller names none."""
    return _KALMAN_ENGINE


def resolve_device(device=None) -> torch.device:
    """The device an entry point puts numpy input on: ``None`` means CUDA.
    Without a card, only an explicit CPU request is honoured — the port
    never moves to the CPU on its own."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' to run the plain "
            "PyTorch path on the CPU")
    return dev


@functools.lru_cache(maxsize=1024)
def device_constant(values: tuple, device=None, dtype=None) -> torch.Tensor:
    """``torch.tensor(values, dtype=dtype, device=device)``, made once per
    (values, device, dtype).  A copy from pageable host memory waits for
    every kernel queued before it, so index and maturity vectors copied on
    each call would hold the host to the card's pace; these are made once.
    Callers must not write to the result."""
    return torch.tensor(values, dtype=dtype, device=device)


def as_tensor(x, device=None, dtype=None) -> torch.Tensor:
    """A tensor stays where it is unless ``device`` names another place;
    anything else (numpy, lists) goes to :func:`resolve_device`'s device."""
    if isinstance(x, torch.Tensor):
        dev = x.device if device is None else resolve_device(device)
        return x.to(device=dev, dtype=dtype or x.dtype)
    return torch.as_tensor(np.asarray(x), dtype=dtype,
                           device=resolve_device(device))
