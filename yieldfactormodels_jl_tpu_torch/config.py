"""Engine names and the device rule of the PyTorch port.

Counterpart of the Kalman part of ``yieldfactormodels_jl_tpu/config.py``.  The
engine names are the JAX package's, so a caller can name any of them; the
port runs "univariate" (the default) and "joint" so far, and
``models.api.get_loss`` says which ROADMAP item brings the others.
"""

from __future__ import annotations

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


def engines_for(spec) -> tuple:
    """The loss-engine names valid for a Kalman family: all of them where
    the measurement is constant, all but "assoc" for TVλ."""
    if not spec.is_kalman:
        raise NotImplementedError(
            "engines_for covers the Kalman families; the score-driven and "
            "static families are not ported yet (ROADMAP Queue 1 item 6)")
    if spec.has_constant_measurement:
        return KALMAN_ENGINES
    return tuple(e for e in KALMAN_ENGINES if e != "assoc")


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


def as_tensor(x, device=None, dtype=None) -> torch.Tensor:
    """A tensor stays where it is unless ``device`` names another place;
    anything else (numpy, lists) goes to :func:`resolve_device`'s device."""
    if isinstance(x, torch.Tensor):
        dev = x.device if device is None else resolve_device(device)
        return x.to(device=dev, dtype=dtype or x.dtype)
    return torch.as_tensor(np.asarray(x), dtype=dtype,
                           device=resolve_device(device))
