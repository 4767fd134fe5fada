"""String-code → ModelSpec registry.

Counterpart of ``yieldfactormodels_jl_tpu/models/registry.py``: every zoo
code and numeric alias, including the "-Anchored" variants
(transform_bool=False), the ``pC``/``vanillaNN`` placeholders (return None),
the random-walk benchmark and the AFNS3/AFNS5 extensions.  The declarative
model programs (``prog-dns``, ``svensson4``) belong to the ``program/``
layer, which the port does not have yet: their codes raise a ValueError
that says so.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np

from .specs import ModelSpec, make_duplicator

_NET_SIZE = 3
_NEURAL_L = 3 * _NET_SIZE * 2  # 18

#: codes the JAX package's program/ layer registers (program/library.py)
PROGRAM_CODES = ("prog-dns", "svensson4")


def _msed_lambda(rw: bool, sg: bool):
    return dict(
        family="msed_lambda", L=1, duplicator=(0,), random_walk=rw,
        scale_grad=sg, forget_factor=0.98,
    )


def _msed_neural(dynamics: str, rw: bool, sg: bool, anchored: bool):
    return dict(
        family="msed_neural", L=_NEURAL_L,
        duplicator=make_duplicator(dynamics, _NEURAL_L, _NET_SIZE),
        dynamics=dynamics, random_walk=rw, scale_grad=sg,
        forget_factor=0.9,
        transform_bool=not anchored,
    )


def _build_table():
    t = {}

    def add(code, alias, **kw):
        t[code] = (code, kw)
        t[alias] = (code, kw)

    add("1C", "0", family="kalman_dns", L=1)
    add("TVλ", "1", family="kalman_tvl", L=1)
    add("NS", "2", family="static_lambda", L=1)
    add("NNS", "3", family="static_neural", L=_NEURAL_L)

    add("SD-NS", "4", **_msed_lambda(False, False))
    add("RWSD-NS", "5", **_msed_lambda(True, False))
    add("SSD-NS", "6", **_msed_lambda(False, True))
    add("SRWSD-NS", "7", **_msed_lambda(True, True))

    dyn = {"1": "scalar", "2": "block_diag", "3": "diag"}
    num = 8
    for sg in (False, True):
        for d in ("1", "2", "3"):
            for rw in (False, True):
                code = f"{d}{'S' if sg else ''}{'RW' if rw else ''}SD-NNS"
                add(code, str(num), **_msed_neural(dyn[d], rw, sg, anchored=False))
                num += 1

    add("NNS-Anchored", "20", family="static_neural", L=_NEURAL_L, transform_bool=False)
    num = 21
    for sg in (False, True):
        for d in ("1", "2", "3"):
            for rw in (False, True):
                code = f"{d}{'S' if sg else ''}{'RW' if rw else ''}SD-NNS-Anchored"
                add(code, str(num), **_msed_neural(dyn[d], rw, sg, anchored=True))
                num += 1

    t["pC"] = ("pC", None)
    t["1100"] = ("pC", None)
    t["vanillaNN"] = ("vanillaNN", None)
    t["a"] = ("vanillaNN", None)
    add("RW", "-1", family="random_walk", L=1)

    # arbitrage-free NS with yield-adjustment term; AFNS5 = AFGNS (two decays)
    add("AFNS3", "af3", family="kalman_afns", L=1, M_override=3)
    add("AFNS5", "af5", family="kalman_afns", L=2, M_override=5)
    return t


_TABLE = _build_table()
MODEL_CODES = sorted({canon for canon, _ in _TABLE.values()})


def valid_codes() -> Tuple[str, ...]:
    """Every code :func:`create_model` accepts: the zoo's canonical codes."""
    return tuple(MODEL_CODES)


def create_model(
    model_type: str,
    maturities,
    N: Optional[int] = None,
    M: int = 3,
    float_type="float32",
    results_location: str = "results/",
) -> Tuple[Optional[ModelSpec], str]:
    """Returns (spec | None, canonical code), as the JAX ``create_model``."""
    if model_type not in _TABLE:
        if model_type in PROGRAM_CODES:
            raise ValueError(
                f"model code {model_type!r} is a declarative model program; "
                f"the program/ layer is not ported to PyTorch yet")
        raise ValueError(
            f"Invalid model type: {model_type!r}; valid codes (aliases "
            f"omitted): {valid_codes()}")
    canon, kw = _TABLE[model_type]
    if kw is None:  # pC / vanillaNN placeholders
        return None, canon
    mats = tuple(float(m) for m in maturities)
    if N is not None and N != len(mats):
        raise ValueError(f"N={N} does not match len(maturities)={len(mats)}")
    kw = dict(kw)
    M = kw.pop("M_override", M)
    spec = ModelSpec(
        model_code=canon,
        maturities=mats,
        M=M,
        dtype_name=np.dtype(float_type).name,
        model_string=model_type,
        results_location=results_location,
        **kw,
    )
    return spec, canon
