"""Top-level experiment driver.

Counterpart of ``yieldfactormodels_jl_tpu/run.py`` (the reference's
``run(...)``): path setup, CSV data loading, model creation from a string
code, initial parameter loading (with a random fallback written to disk),
the static warm-start cascade, estimation (block-coordinate by default:
``get_param_groups`` always gives a non-empty grouping, so
``estimate_steps`` is the live path), the in-sample save and out-of-sample
loss prints, and rolling forecasts.  ``simulation=True`` forces no-window
forecasting and disables optimization and saving.  M = 3 factors, seed 43
and float32 by default, as the reference hard-codes.

``run`` takes ``device=`` (``None`` means CUDA; ``config.resolve_device``):
every estimation, filter and forecast runs there; without a card only
``device="cpu"`` runs, on the kernels' plain versions.  The Kalman,
score-driven and static families run, the random walk and the groups off
the closed form included, so the reference's warm-start cascade does:
``run("NS")`` writes the in-sample parameters and the merged window
databases that ``run("SD-NS")`` starts from.  What is not ported raises,
naming its ROADMAP item: the leased-queue driver (``orchestrated=True``)
and the Newton polish (``second_order``).
"""

from __future__ import annotations

import os
from typing import Sequence

import numpy as np
import torch

from . import config
from .estimation import optimize as opt
from .forecasting import run_rolling_forecasts
from .models import api
from .models.params import initialize_with_static_params
from .models.registry import create_model
from .persistence.io import save_results
from .utils.data_management import load_data


def setup_data_paths(model_type: str, simulation: bool, scratch_dir: str,
                     thread_id: str):
    """(data folder, results folder) under ``scratch_dir``."""
    data_sub, results_sub = (("data_simulation", "results_simulation") if simulation
                             else ("data", "results"))
    data_folder = os.path.join(scratch_dir, "YieldFactorModels.jl", data_sub) + os.sep
    results = os.path.join(scratch_dir, "YieldFactorModels.jl", results_sub,
                           f"thread_id__{thread_id}") + os.sep
    return data_folder, results


def _init_folder(model_string: str) -> str:
    # relative to the working directory, as the reference keeps it
    return os.path.join("YieldFactorModels.jl", "initializations", model_string) + os.sep


def load_initial_parameters(spec, model_type: str, float_type, simulation: bool = False):
    """(P, S) initial parameters from ``init_params_<code>[_simulation].csv``
    in the working directory's initialization folder; without one, random
    U(0, 1) parameters, which are written there for reuse."""
    folder = _init_folder(spec.model_string)
    candidates = []
    if simulation:
        candidates.append(os.path.join(folder, f"init_params_{model_type}_simulation.csv"))
    candidates.append(os.path.join(folder, f"init_params_{model_type}.csv"))
    for path in candidates:
        if os.path.isfile(path):
            arr = np.loadtxt(path, delimiter=",")
            if arr.ndim == 1:
                arr = arr[:, None]
            return arr
    num_params = spec.n_params
    print(f"Initial parameters for {model_type} not found in {folder}. "
          f"Writing file with random initial parameters... ({num_params} params)")
    arr = np.random.default_rng().uniform(size=(num_params, 1))
    os.makedirs(folder, exist_ok=True)
    np.savetxt(os.path.join(folder, f"init_params_{model_type}.csv"), arr, delimiter=",")
    return arr


def load_static_parameters(spec, model_type: str, results_location: str,
                           thread_id: str, params: np.ndarray) -> np.ndarray:
    """Warm start from the simpler model's saved parameters, where it has
    some."""
    static_name = api.get_static_model_type(spec)
    if not static_name:
        return params
    path = os.path.join(results_location, static_name,
                        f"{static_name}__thread_id__{thread_id}__out_params.csv")
    if not os.path.isfile(path):
        print(f"Static parameters for {model_type} not found, using default initialization.")
        return params
    static_params = np.loadtxt(path, delimiter=",").reshape(-1, 1)
    return initialize_with_static_params(spec, params, static_params)


def run_estimation(spec, data, in_sample_end: int, all_params, param_groups,
                   max_group_iters: int, group_tol: float, printing: bool = True,
                   second_order=None, device=None):
    """Grouped (block-coordinate) estimation, or the plain multi-start MLE
    without a grouping."""
    if param_groups:
        if np.asarray(all_params).shape[0] != len(param_groups):
            raise ValueError(f"{len(param_groups)} parameter groups for "
                             f"{np.asarray(all_params).shape[0]} parameters")
        return opt.estimate_steps(
            spec, data, all_params, list(param_groups),
            max_group_iters=max_group_iters, tol=group_tol,
            start=0, end=in_sample_end, printing=printing,
            second_order=second_order, device=device)
    return opt.estimate(spec, data, all_params, start=0, end=in_sample_end,
                        printing=printing, second_order=second_order,
                        device=device)


def run(
    thread_id: str = "1",
    in_sample_end: int = 100,
    forecast_horizon: int = 12,
    run_rolling: bool = True,
    model_type: str = "1C",
    float_type="float32",
    *,
    window_type: str = "both",
    in_sample_start: int = 1,
    param_groups: Sequence[str] = (),
    max_group_iters: int = 10,
    group_tol: float = 1e-8,
    run_optimization: bool = True,
    save_results_bool: bool = True,
    simulation: bool = False,
    reestimate: bool = True,
    scratch_dir: str = "",
    seed: int = 43,
    batched_windows: bool = False,
    orchestrated: bool = False,
    n_workers: int = 2,
    second_order=None,
    device=None,
):
    """The reference's driver; returns (spec, fitted parameters), or None
    for the placeholder codes ("pC", "vanillaNN")."""
    dev = config.resolve_device(device)
    if orchestrated:
        raise opt._not_ported(f"run(orchestrated=True) with {n_workers} workers",
                              "orchestrated")
    opt._check_unported_knobs(second_order, False)
    if simulation:
        window_type = "simulation"
        run_optimization = False
        run_rolling = True
        save_results_bool = False

    np.random.seed(seed)

    data_folder, results_location = setup_data_paths(model_type, simulation,
                                                     scratch_dir, thread_id)
    data, maturities = load_data(data_folder, thread_id)
    data = np.asarray(data, dtype=float_type)
    maturities = np.asarray(maturities, dtype=float_type)

    N = len(maturities)
    M = 3  # hard-coded in the reference
    spec, model_type = create_model(
        model_type, tuple(maturities), N, M, float_type,
        results_location=os.path.join(results_location, model_type) + os.sep)
    if spec is None:  # pC / vanillaNN placeholders
        return None

    param_groups = list(api.get_param_groups(spec, list(param_groups) or None))
    all_params = load_initial_parameters(spec, model_type, float_type,
                                         simulation=simulation)
    all_params = all_params.astype(np.float64)
    all_params[:, 0] = np.asarray(
        load_static_parameters(spec, model_type, results_location, thread_id,
                               all_params[:, 0])).reshape(-1)

    if run_optimization:
        print("The param groups are:", param_groups)
        _, loss, params, _ = run_estimation(
            spec, data, in_sample_end, all_params, param_groups,
            max_group_iters, group_tol, printing=True,
            second_order=second_order, device=dev)
    else:
        params = all_params[:, 0]
        loss = 0.0

    params_t = torch.as_tensor(np.asarray(params, dtype=np.float64), dtype=spec.dtype,
                               device=dev)
    data_t = torch.as_tensor(data, dtype=spec.dtype, device=dev)

    if save_results_bool:
        results = api.predict(spec, params_t, data_t[:, :in_sample_end])
        save_results(spec, results, loss, params, thread_id, "insample")
        loss = float(api.get_loss(spec, params_t, data_t[:, :in_sample_end]))
        print(f"In-sample loss: {loss}")

        results = api.predict(spec, params_t, data_t)
        save_results(spec, results, loss, params, thread_id, "outofsample")

        loss_array = api.get_loss_array(spec, params_t, data_t, K=1).cpu().numpy()
        oos = loss_array[in_sample_end:]
        for frac in (0.1, 0.25, 0.5, 0.75, 1.0):
            k = max(1, int(np.floor(frac * len(oos))))
            print(f"Out-of-sample loss array (first {int(frac * 100)}%): {np.mean(oos[:k])}")

    if run_rolling:
        print("Forecasting...")
        run_rolling_forecasts(
            spec, data, thread_id, in_sample_end, in_sample_start,
            forecast_horizon, all_params,
            window_type=window_type, param_groups=param_groups,
            max_group_iters=max_group_iters, group_tol=group_tol,
            reestimate=reestimate, batched=batched_windows,
            second_order=second_order, device=dev)

    return spec, params
