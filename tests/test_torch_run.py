"""The port's ``run()`` against the JAX package's, end to end on the CPU.

Both packages run the reference's driver on tests/test_run.py's CSV panel
(N = 6, T = 36, float64), each in its own directory under a temporary root
with the working directory set there (``load_initial_parameters`` reads and
writes relative to it), from the same ``init_params_<code>.csv``:

- "1C" with estimation: in_sample_end 35, horizon 3, both window types (2
  origins each), one group iteration, the Nelder–Mead budget set to 25 in
  both packages' ``DEFAULT_OPTIMIZERS``.  The in-sample CSVs agree at rtol
  1e-6; the window forecast, parameter, factor, state and loading CSVs and
  the merged databases' rows to the 3 decimals the reference rounds to;
  the merged databases have the same schema.
- ``batched_windows=True`` on "1C" without in-sample optimization, the
  port alone: each origin's shard against the per-origin task's from the
  same parameters.
- "1SSD-NNS" without optimization or re-estimation (the score-driven
  dispatch), the port alone, against its own score-driven filter.
- "RW" with estimation (its (δ, Φ) group by the per-start L-BFGS),
  in_sample_end 34, horizon 3, expanding windows, and "SD-NS" in-sample
  under ``YFM_MSED_CLOSED=0`` (group "2" by L-BFGS on K4's plain version),
  one group iteration and small budgets: both complete with finite
  artifacts, the in-sample loss JAX's at the written parameters
  (tests/test_torch_per_start.py holds those groups against JAX's).
- The refusals (item 11, item 9) and the random initial parameters written
  to disk.
"""

import contextlib
import os
import sqlite3

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)  # tiny tensors; leave the cores to the other test workers

import yieldfactormodels_jl_tpu as J  # noqa: E402
import yieldfactormodels_jl_tpu_torch as P  # noqa: E402
from tests import oracle  # noqa: E402
from tests.test_run import MATS_MONTHS, _write_data  # noqa: E402
from tests.test_score_driven import _neural_params  # noqa: E402
from yieldfactormodels_jl_tpu.estimation import optimize as jopt  # noqa: E402
from yieldfactormodels_jl_tpu.run import run as jrun  # noqa: E402
from yieldfactormodels_jl_tpu_torch.estimation import optimize as topt  # noqa: E402
from yieldfactormodels_jl_tpu_torch.ops import fused_kf, fused_kf_grad, fused_ssd  # noqa: E402

CPU = "cpu"
MATS = tuple(MATS_MONTHS / 12.0)
RESULTS = os.path.join("YieldFactorModels.jl", "results", "thread_id__1")
INSAMPLE = ("factors_filtered_insample", "fit_filtered_insample",
            "factor_loadings_1_filtered_insample", "factor_loadings_2_filtered_insample",
            "factors_filtered_outofsample", "fit_filtered_outofsample",
            "factor_loadings_1_filtered_outofsample",
            "factor_loadings_2_filtered_outofsample", "loss", "out_params")
WINDOW_KINDS = ("forecasts", "fitted_params", "factors", "states", "fl1", "fl2")


@contextlib.contextmanager
def _cwd(path):
    old = os.getcwd()
    os.chdir(path)
    try:
        yield
    finally:
        os.chdir(old)


def _start_point(code):
    spec, _ = J.create_model(code, MATS, float_type="float64")
    if code == "1C":
        return oracle.stable_1c_params(spec, np.float64)
    if code == "RW":
        return np.full(spec.n_params, 0.3)
    return _neural_params(spec, np.random.default_rng(7))[0]


def _run_in(d, fn, code, in_sample_end, forecast_horizon, **kw):
    """``fn("1", in_sample_end, forecast_horizon, True, code, "float64",
    **kw)`` in directory ``d`` (its working directory and scratch) with the
    data (T = 36) and the initial parameters; returns the results folder."""
    os.makedirs(d)
    with _cwd(d):
        scratch = d + os.sep
        _write_data(scratch, T=36)
        init = os.path.join("YieldFactorModels.jl", "initializations", code)
        os.makedirs(init)
        np.savetxt(os.path.join(init, f"init_params_{code}.csv"), _start_point(code),
                   delimiter=",")
        fn("1", in_sample_end, forecast_horizon, True, code, "float64",
           scratch_dir=scratch, **kw)
    return os.path.join(d, RESULTS, code)


def _run_both(root, code, in_sample_end, forecast_horizon, **kw):
    """Both packages' ``run`` in root/<package>; returns the two results
    folders."""
    return {"jax": _run_in(os.path.join(str(root), "jax"), jrun, code, in_sample_end,
                           forecast_horizon, **kw),
            "torch": _run_in(os.path.join(str(root), "torch"), P.run, code, in_sample_end,
                             forecast_horizon, device=CPU, **kw)}


def _csv(folder, code, suffix):
    return np.loadtxt(os.path.join(folder, f"{code}__thread_id__1__{suffix}.csv"),
                      delimiter=",")


def _assert_3_decimals(got, want, what):
    """Values the reference rounds to 3 decimals: equal but for one step of
    the last decimal, where two last-bit-different values round apart."""
    assert got.shape == want.shape, what
    np.testing.assert_allclose(got, want, rtol=0, atol=1.5e-3, err_msg=what)


def _rows_of(path):
    conn = sqlite3.connect(path)
    try:
        return conn.execute("SELECT * FROM forecasts").fetchall()
    finally:
        conn.close()


def _merged_rows(folder, window):
    conn = sqlite3.connect(os.path.join(folder, "db", f"forecasts_{window}_merged.sqlite3"))
    try:
        return (conn.execute("SELECT * FROM forecasts ORDER BY task_id").fetchall(),
                conn.execute("SELECT sql FROM sqlite_master ORDER BY name").fetchall())
    finally:
        conn.close()


@pytest.fixture(scope="module")
def run_1c(tmp_path_factory):
    """Both packages' ``run`` on "1C" with estimation, once per module."""
    with pytest.MonkeyPatch.context() as mp:
        for table in (jopt.DEFAULT_OPTIMIZERS, topt.DEFAULT_OPTIMIZERS):
            mp.setitem(table, "1", ("neldermead", dict(max_iters=25)))
        calls = fused_kf.batched_loglik_reference.calls
        folders = _run_both(tmp_path_factory.mktemp("run_1c"), "1C", 35, 3,
                            window_type="both", max_group_iters=1)
        folders["k1_plain_calls"] = fused_kf.batched_loglik_reference.calls - calls
    return folders


def test_run_matches_jax(run_1c):
    """The in-sample CSVs at rtol 1e-6; every window CSV and both merged
    databases' rows to 3 decimals, their schema, the files left in ``db/``;
    and the fits ran on K1's plain version."""
    from yieldfactormodels_jl_tpu_torch.persistence.database import deser

    for suffix in INSAMPLE:
        want = _csv(run_1c["jax"], "1C", suffix)
        got = _csv(run_1c["torch"], "1C", suffix)
        assert got.shape == want.shape and np.isfinite(got).all(), suffix
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-12, err_msg=suffix)
    for window in ("expanding", "moving"):
        for kind in WINDOW_KINDS:
            want = _csv(run_1c["jax"], "1C", f"{window}_window_{kind}")
            got = _csv(run_1c["torch"], "1C", f"{window}_window_{kind}")
            assert got.shape[0] == (2 * 3 if kind != "fitted_params" else 2)
            assert list(got[:, 0]) == list(want[:, 0])   # the origins
            _assert_3_decimals(got, want, f"{window} {kind}")
        rows_t, schema_t = _merged_rows(run_1c["torch"], window)
        rows_j, schema_j = _merged_rows(run_1c["jax"], window)
        assert schema_t == schema_j
        assert [r[:4] for r in rows_t] == [r[:4] for r in rows_j] == \
            [("1C", "1", window, 35), ("1C", "1", window, 36)]
        for rt, rj in zip(rows_t, rows_j):
            np.testing.assert_allclose(rt[4], rj[4], rtol=1e-6)   # the window's ll
            for bt, bj in zip(rt[5:], rj[5:]):
                _assert_3_decimals(deser(bt), deser(bj), f"{window} blob")
    assert sorted(os.listdir(os.path.join(run_1c["torch"], "db"))) == \
        sorted(os.listdir(os.path.join(run_1c["jax"], "db")))   # shards gone, locks kept
    # 5 fits (in-sample, 2 origins × 2 windows), each at least its simplex,
    # 25 iterations of one or two candidate batches and the final ll
    assert run_1c["k1_plain_calls"] >= 5 * 27


def test_run_batched_windows_match_the_per_origin_path(tmp_path):
    """``run(batched_windows=True)`` re-estimates the origins in one
    ``estimate_windows`` batch (K2f/K2b's plain versions here) and forecasts
    each on one NaN-masked panel; each origin's shard holds what the
    per-origin task writes from the same parameters on the truncated panel,
    to the reference's 3 decimals.  (JAX's ``estimate_windows`` off the TPU
    runs its per-start optimizer; the port's fit is held against JAX's fused
    L-BFGS in tests/test_torch_estimation.py.)"""
    from yieldfactormodels_jl_tpu_torch import forecasting as tfc
    from yieldfactormodels_jl_tpu_torch.persistence import database as tdb
    from yieldfactormodels_jl_tpu_torch.utils.data_management import load_data

    calls = fused_kf_grad.forward_reference.calls
    folder = _run_in(str(tmp_path / "batched"), P.run, "1C", 33, 3, window_type="both",
                     run_optimization=False, batched_windows=True, device=CPU)
    assert fused_kf_grad.forward_reference.calls > calls
    data, mats = load_data(str(tmp_path / "batched" / "YieldFactorModels.jl" / "data"), "1")
    spec, _ = P.create_model("1C", tuple(mats), float_type="float64",
                             results_location=str(tmp_path / "per_origin") + os.sep)
    for window in ("expanding", "moving"):
        rows = _merged_rows(folder, window)[0]
        assert [r[3] for r in rows] == [33, 34, 35, 36]
        for row in rows:
            params = tdb.deser(row[5])
            np.testing.assert_array_equal(params, _csv(folder, "1C", f"{window}_window_"
                                                       "fitted_params")[row[3] - 33, 1:])
            shard = tfc.run_single_window_task(spec, data, "1", row[3], window, 33, 1, 3,
                                               params[:, None], reestimate=False,
                                               device=CPU)
            (mine,) = _rows_of(shard)
            for got, want in zip(mine[6:], row[6:]):
                _assert_3_decimals(tdb.deser(got), tdb.deser(want), f"{window} {row[3]}")
        fc = _csv(folder, "1C", f"{window}_window_forecasts")
        assert fc.shape == (4 * 3, 2 + len(MATS)) and np.isfinite(fc).all()


def test_run_score_driven_dispatch(tmp_path):
    """``run`` on "1SSD-NNS" (no estimation, no re-estimation) writes the
    score-driven filter's artifacts: the in-sample fit and loss are
    ``score_driven.predict``'s and ``get_loss``'s (held against JAX in
    tests/test_torch_score_driven.py), the windows finite."""
    folder = _run_in(str(tmp_path / "ssd"), P.run, "1SSD-NNS", 33, 3,
                     window_type="expanding", run_optimization=False, reestimate=False,
                     device=CPU)
    spec, _ = P.create_model("1SSD-NNS", MATS, float_type="float64")
    assert spec.is_msed
    data = np.loadtxt(tmp_path / "ssd" / "YieldFactorModels.jl" / "data" /
                      "thread_id__1__data.csv", delimiter=",")
    p = _start_point("1SSD-NNS")
    fit = P.predict(spec, p, data[:, :33], device=CPU)
    np.testing.assert_allclose(_csv(folder, "1SSD-NNS", "fit_filtered_insample"),
                               fit["preds"].numpy().T, rtol=1e-12, atol=1e-12)
    np.testing.assert_allclose(_csv(folder, "1SSD-NNS", "loss"),
                               float(P.get_loss(spec, p, data[:, :33], device=CPU)), rtol=1e-12)
    for kind in WINDOW_KINDS:
        got = _csv(folder, "1SSD-NNS", f"expanding_window_{kind}")
        assert np.isfinite(got).all() and got.shape[0] == (4 * 3 if kind != "fitted_params"
                                                           else 4)


def test_run_refusals_and_random_initial_parameters(tmp_path, monkeypatch):
    """What the port refuses, naming the ROADMAP item that brings it; and
    without an initial-parameter file ``run`` draws U(0, 1) parameters
    and writes them, relative to the working directory, for the next run."""
    monkeypatch.chdir(tmp_path)
    scratch = str(tmp_path) + os.sep
    _write_data(scratch, T=36)
    kw = dict(scratch_dir=scratch, device=CPU)
    with pytest.raises(NotImplementedError, match="item 11"):
        P.run("1", 30, 3, True, "1C", "float64", orchestrated=True, **kw)
    with pytest.raises(NotImplementedError, match="item 9"):
        P.run("1", 30, 3, True, "1C", "float64", second_order="fisher", **kw)
    budgets = {"1": ("neldermead", dict(max_iters=10)),
               "2": ("lbfgs", dict(max_iters=3, g_tol=1e-6, f_abstol=1e-6))}
    data = np.loadtxt(os.path.join(scratch, "YieldFactorModels.jl", "data",
                                   "thread_id__1__data.csv"), delimiter=",")
    with monkeypatch.context() as mp:
        for g, entry in budgets.items():
            mp.setitem(topt.DEFAULT_OPTIMIZERS, g, entry)
        # the random walk's fits: its (δ, Φ) group by the per-start L-BFGS
        init = os.path.join("YieldFactorModels.jl", "initializations", "RW")
        os.makedirs(init)
        np.savetxt(os.path.join(init, "init_params_RW.csv"), _start_point("RW"), delimiter=",")
        spec, params = P.run("1", 34, 3, True, "RW", "float64", window_type="expanding",
                             max_group_iters=1, **kw)
        folder = spec.results_location
        for kind in WINDOW_KINDS:
            got = _csv(folder, "RW", f"expanding_window_{kind}")
            assert np.isfinite(got).all() and got.shape[0] == (3 * 3 if kind != "fitted_params"
                                                               else 3), kind
        # a score-driven (δ, Φ) group off the closed form: L-BFGS on K4
        mp.setenv("YFM_MSED_CLOSED", "0")
        init = os.path.join("YieldFactorModels.jl", "initializations", "SD-NS")
        os.makedirs(init)
        sd, _ = P.create_model("SD-NS", MATS, float_type="float64")
        np.savetxt(os.path.join(init, "init_params_SD-NS.csv"), oracle.stable_msed_params(sd),
                   delimiter=",")
        calls = fused_ssd.batched_loss_reference.calls
        spec_sd, params_sd = P.run("1", 34, 3, False, "SD-NS", "float64", max_group_iters=1,
                                   **kw)
        assert fused_ssd.batched_loss_reference.calls > calls
    for code, sp, p_fit in (("RW", spec, params), ("SD-NS", spec_sd, params_sd)):
        for suffix in INSAMPLE:
            assert np.isfinite(_csv(sp.results_location, code, suffix)).all(), (code, suffix)
        js, _ = J.create_model(code, MATS, float_type="float64")
        np.testing.assert_allclose(_csv(sp.results_location, code, "loss"),
                                   float(J.get_loss(js, p_fit, data[:, :34])), rtol=1e-10)
    assert P.run("1", 30, 3, True, "pC", "float64", **kw) is None
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            P.run("1", 30, 3, True, "1C", "float64", scratch_dir=scratch)

    spec, params = P.run("1", 30, 3, False, "1C", "float64", run_optimization=False, **kw)
    path = tmp_path / "YieldFactorModels.jl" / "initializations" / "1C" / "init_params_1C.csv"
    written = np.loadtxt(path, delimiter=",")
    assert written.shape == (spec.n_params,) and ((written >= 0) & (written < 1)).all()
    np.testing.assert_array_equal(params, written)
    for suffix in INSAMPLE:
        assert os.path.isfile(os.path.join(spec.results_location,
                                           f"1C__thread_id__1__{suffix}.csv")), suffix
