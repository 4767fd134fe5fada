"""In-sample result CSVs, in the reference's layout (its io.jl).

Counterpart of ``yieldfactormodels_jl_tpu/persistence/io.py``; the arrays
of ``predict`` may be tensors on any device and are written as float64.
"""

from __future__ import annotations

import os
import threading

import numpy as np
import torch


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu().numpy()
    return np.asarray(x, dtype=np.float64)


def savetxt_atomic(path: str, rows, **kwargs) -> str:
    """``np.savetxt`` through a writer-unique tmp + ``os.replace`` publish,
    so a reader never observes a torn CSV.  The suffix carries the thread
    id as well as the pid: in-process workers share a pid."""
    tmp = f"{path}.tmp-{os.getpid()}-{threading.get_ident()}"
    np.savetxt(tmp, rows, **kwargs)
    os.replace(tmp, path)
    return path


def save_results(spec, results: dict, loss: float, params, thread_id: str,
                 data_type: str) -> None:
    """Write filtered factors/states, fitted ŷ, loading columns, loss, params."""
    folder = spec.results_location
    os.makedirs(folder, exist_ok=True)
    ms = spec.model_string

    def path(suffix):
        return os.path.join(folder, f"{ms}__thread_id__{thread_id}__{suffix}.csv")

    savetxt_atomic(path(f"factors_filtered_{data_type}"),
                   np.concatenate([_np(results["factors"]), _np(results["states"])],
                                  axis=0).T, delimiter=",")
    savetxt_atomic(path(f"fit_filtered_{data_type}"), _np(results["preds"]).T,
                   delimiter=",")
    savetxt_atomic(path(f"factor_loadings_1_filtered_{data_type}"),
                   _np(results["factor_loadings_1"]).T, delimiter=",")
    savetxt_atomic(path(f"factor_loadings_2_filtered_{data_type}"),
                   _np(results["factor_loadings_2"]).T, delimiter=",")
    savetxt_atomic(path("loss"), np.asarray([loss], dtype=np.float64), delimiter=",")
    savetxt_atomic(path("out_params"), _np(params), delimiter=",")
