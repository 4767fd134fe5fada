"""CSV data loading (the reference's utils/data_management.jl).

Counterpart of ``yieldfactormodels_jl_tpu/utils/data_management.py``:
``load_data(folder, thread_id)`` reads ``thread_id__<id>__data.csv`` (the
N×T panel of yields) and ``thread_id__<id>__maturities.csv``.
"""

from __future__ import annotations

import os

import numpy as np


def load_data(data_folder: str, thread_id: str):
    data = np.loadtxt(os.path.join(data_folder, f"thread_id__{thread_id}__data.csv"),
                      delimiter=",")
    maturities = np.loadtxt(
        os.path.join(data_folder, f"thread_id__{thread_id}__maturities.csv"), delimiter=","
    ).reshape(-1)
    return data, maturities


def extend_data(data, extension_horizon: int):
    """NaN-pad ``extension_horizon`` columns on the right."""
    data = np.asarray(data)
    pad = np.full((data.shape[0], extension_horizon), np.nan, dtype=data.dtype)
    return np.concatenate([data, pad], axis=1)
