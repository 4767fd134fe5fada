"""The static families' ``estimate_steps`` and the reference's warm-start
cascade ``run("NS")`` → ``run("SD-NS")`` against the JAX package, on the
CPU, in float64.

- ``estimate_steps`` for "NS" and "NNS" (N = 6, T = 40): group "1" (λ, or
  NNS's 18 net weights) by the lockstep Nelder–Mead on the batched static
  loss with 10 iterations, group "2" by the closed form, one group
  iteration, against JAX's (its per-start Nelder–Mead): ll at rtol 1e-6,
  the parameters at rtol 1e-5 / atol 1e-9, an equal ``Convergence``.
- The cascade on tests/test_run.py's CSV panel (N = 6, T = 36): both
  packages' ``run("NS")`` then ``run("SD-NS")`` in one scratch root each,
  expanding windows, in-sample end 35, horizon 3 (2 origins), one group
  iteration with 10 Nelder–Mead iterations.  NS's in-sample CSVs at rtol
  1e-10; its window CSVs and merged-database rows bit for bit where the
  reference rounds to 3 decimals (forecasts, factors, states, loadings),
  the fitted parameters and the windows' losses at rtol 1e-10.  SD-NS's
  first start, in-sample and at every origin: its [ω; δ; Φ] tail equal to
  NS's out-params (in-sample) or to NS's merged-database row for the task
  (per origin), bit for bit, and to JAX's first start at rtol 1e-10 (NS's
  fits agree to that); SD-NS's in-sample ll at rtol 1e-6.

These tests hold a whole fit or two runs each (the heavy kind of
ROADMAP.md's rule: at most 4 in a file).
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
from tests.test_torch_static import _panel as static_panel  # noqa: E402
from tests.test_torch_static import static_params  # noqa: E402
from yieldfactormodels_jl_tpu.estimation import optimize as jopt  # noqa: E402
from yieldfactormodels_jl_tpu.run import run as jrun  # noqa: E402
from yieldfactormodels_jl_tpu_torch.estimation import optimize as topt  # noqa: E402
from yieldfactormodels_jl_tpu_torch.persistence import database as tdb  # noqa: E402

CPU = "cpu"
BUDGETS = {"1": ("neldermead", dict(max_iters=10)),
           "2": ("lbfgs", dict(max_iters=8, g_tol=1e-6, f_abstol=1e-6))}
T_IN, H = 35, 3
N_ORIGINS = 36 + 1 - T_IN
RESULTS = os.path.join("YieldFactorModels.jl", "results", "thread_id__1")
INSAMPLE = ("factors_filtered_insample", "fit_filtered_insample",
            "factor_loadings_1_filtered_insample", "factor_loadings_2_filtered_insample",
            "factors_filtered_outofsample", "fit_filtered_outofsample", "loss",
            "out_params")
WINDOW_KINDS = ("forecasts", "fitted_params", "factors", "states", "fl1", "fl2")


@pytest.mark.parametrize("code", ["NS", "NNS"])
def test_static_estimate_steps_matches_jax(code):
    mats = tuple(np.array([3.0, 12.0, 24.0, 60.0, 120.0, 360.0]) / 12.0)
    js, _ = J.create_model(code, mats, float_type="float64")
    ts, _ = P.create_model(code, mats, float_type="float64")
    p, data = static_params(js), static_panel()
    p[js.L:] *= 0.9                                   # start away from the DGP's (δ, Φ)
    groups = list(J.models.api.get_param_groups(js, None))
    assert jopt._msed_closed_applicable(js, tuple(range(js.L, js.n_params)), data, 0, 40)
    init_j, ll_j, best_j, conv_j = jopt.estimate_steps(js, data, p[:, None], groups,
                                                      max_group_iters=1, optimizers=BUDGETS)
    init_t, ll_t, best_t, conv_t = P.estimate_steps(ts, data, p[:, None], groups,
                                                    max_group_iters=1, optimizers=BUDGETS,
                                                    device=CPU)
    np.testing.assert_allclose(init_t, np.asarray(init_j), rtol=1e-12)  # the start, transformed back
    np.testing.assert_allclose(ll_t, ll_j, rtol=1e-6)
    np.testing.assert_allclose(best_t, np.asarray(best_j), rtol=1e-5, atol=1e-9)
    assert tuple(conv_t) == tuple(conv_j)
    assert ll_t > float(P.get_loss(ts, p, data, device=CPU))   # the fit moved up
    assert P.last_multistart_report()["iters"] == [1]


@contextlib.contextmanager
def _cwd(path):
    old = os.getcwd()
    os.chdir(path)
    try:
        yield
    finally:
        os.chdir(old)


def _cascade(root, run, opt, **kw):
    """``run("NS")`` then ``run("SD-NS")`` in ``root`` (its working directory
    and scratch); returns the SD-NS fits' (window end, first start), the
    in-sample fit first."""
    os.makedirs(root)
    starts = []
    steps = opt.estimate_steps

    def recorded(spec, data, all_params, *a, **k):
        if spec.is_msed:
            starts.append((int(k["end"]),
                           np.asarray(all_params, dtype=np.float64)[:, 0].copy()))
        return steps(spec, data, all_params, *a, **k)

    with _cwd(root), pytest.MonkeyPatch.context() as mp:
        mp.setattr(opt, "estimate_steps", recorded)
        mp.setitem(opt.DEFAULT_OPTIMIZERS, "1", BUDGETS["1"])
        _write_data(root + os.sep, T=36)
        mats = tuple(MATS_MONTHS / 12.0)
        for code, point in (("NS", oracle.stable_ns_params), ("SD-NS", oracle.stable_msed_params)):
            spec, _ = J.create_model(code, mats, float_type="float64")
            init = os.path.join("YieldFactorModels.jl", "initializations", code)
            os.makedirs(init)
            np.savetxt(os.path.join(init, f"init_params_{code}.csv"),
                       np.asarray(point(spec), dtype=np.float64), delimiter=",")
            run("1", T_IN, H, True, code, "float64", window_type="expanding",
                max_group_iters=1, scratch_dir=root + os.sep, **kw)
    return starts


@pytest.fixture(scope="module")
def cascades(tmp_path_factory):
    root = tmp_path_factory.mktemp("cascade")
    return {"jax": (os.path.join(root, "jax"), _cascade(os.path.join(root, "jax"), jrun, jopt)),
            "torch": (os.path.join(root, "torch"),
                      _cascade(os.path.join(root, "torch"), P.run, topt, device=CPU))}


def _csv(root, code, suffix):
    return np.loadtxt(os.path.join(root, RESULTS, code, f"{code}__thread_id__1__{suffix}.csv"),
                      delimiter=",")


def _merged(root, code):
    path = os.path.join(root, RESULTS, code, "db", "forecasts_expanding_merged.sqlite3")
    conn = sqlite3.connect(path)
    try:
        return conn.execute("SELECT * FROM forecasts ORDER BY task_id").fetchall(), path
    finally:
        conn.close()


def test_cascade_matches_jax(cascades):
    (root_j, starts_j), (root_t, starts_t) = cascades["jax"], cascades["torch"]
    for suffix in INSAMPLE:
        np.testing.assert_allclose(_csv(root_t, "NS", suffix), _csv(root_j, "NS", suffix),
                                   rtol=1e-10, atol=1e-12, err_msg=suffix)
    for kind in WINDOW_KINDS:
        got = _csv(root_t, "NS", f"expanding_window_{kind}")
        want = _csv(root_j, "NS", f"expanding_window_{kind}")
        if kind == "fitted_params":   # stored unrounded
            assert got.shape[0] == N_ORIGINS and list(got[:, 0]) == list(want[:, 0])
            np.testing.assert_allclose(got, want, rtol=1e-10, atol=1e-12)
        else:
            assert got.shape[0] == N_ORIGINS * H
            np.testing.assert_array_equal(got, want, err_msg=kind)
    (rows_t, db_t), (rows_j, _) = _merged(root_t, "NS"), _merged(root_j, "NS")
    assert [r[:4] for r in rows_t] == [r[:4] for r in rows_j] == \
        [("NS", "1", "expanding", t) for t in range(T_IN, T_IN + N_ORIGINS)]
    for rt, rj in zip(rows_t, rows_j):
        np.testing.assert_allclose(rt[4], rj[4], rtol=1e-10)        # the window's loss
        np.testing.assert_allclose(tdb.deser(rt[5]), tdb.deser(rj[5]), rtol=1e-10)
        for bt, bj in zip(rt[6:], rj[6:]):   # the rounded preds, loadings, factors, states
            np.testing.assert_array_equal(tdb.deser(bt), tdb.deser(bj))

    # SD-NS: one in-sample fit, then the origins in a shuffled order, each
    # warm-started from NS
    assert starts_t[0][0] == starts_j[0][0] == T_IN
    origins_t, origins_j = dict(starts_t[1:]), dict(starts_j[1:])
    assert sorted(origins_t) == sorted(origins_j) == list(range(T_IN, T_IN + N_ORIGINS))
    np.testing.assert_allclose(starts_t[0][1], starts_j[0][1], rtol=1e-10)
    spec, _ = P.create_model("SD-NS", tuple(MATS_MONTHS / 12.0), float_type="float64")
    tail = spec.n_params - _csv(root_t, "NS", "out_params").size
    np.testing.assert_array_equal(starts_t[0][1][tail:], _csv(root_t, "NS", "out_params"))
    for end in origins_t:
        np.testing.assert_allclose(origins_t[end], origins_j[end], rtol=1e-10,
                                   err_msg=f"end {end}")
        np.testing.assert_array_equal(origins_t[end][tail:], tdb.read_task_params(db_t, end))
    np.testing.assert_allclose(_csv(root_t, "SD-NS", "loss"), _csv(root_j, "SD-NS", "loss"),
                               rtol=1e-6)
    rows_sd, _ = _merged(root_t, "SD-NS")
    assert [r[3] for r in rows_sd] == list(range(T_IN, T_IN + N_ORIGINS))
    assert all(np.isfinite(r[4]) for r in rows_sd)
