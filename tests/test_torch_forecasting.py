"""The port's persistence and forecast-driver layers against the JAX package,
on the CPU, in ``tmp_path``.

- Shards: the same results written through both packages'
  ``save_oos_forecast_sharded`` give the same rows (the blobs' bytes and
  their ``deser`` arrays equal); ``merge_forecast_shards`` and
  ``export_all_csv`` give byte-identical merged rows and legacy CSVs, with a
  NULL loss; the SQLite schema is the JAX package's.
- The crash-only protocol, after tests/test_forecasting.py: atomic locks, a
  stale lock broken by TTL, a corrupt shard skipped with its summary and kept
  for repair, an at-most-once merge publish, the ``merge`` chaos seam.
- ``load_data``/``extend_data``, ``StageTimer``'s summary and the window
  checkpoint's round trip; ``sentinel_policy="retry"`` raising the
  sentinel for a non-finite fit; the refusals (a ``checkpoint_root``
  reaches ``estimate_steps``' item 11, no card without ``device="cpu"``).

The forecast loops' numbers against JAX's are in tests/test_torch_run.py.
"""

import os
import sqlite3

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)  # tiny tensors; leave the cores to the other test workers

import yieldfactormodels_jl_tpu as J  # noqa: E402
import yieldfactormodels_jl_tpu_torch as P  # noqa: E402
from tests import oracle  # noqa: E402
from yieldfactormodels_jl_tpu.persistence import database as jdb  # noqa: E402
from yieldfactormodels_jl_tpu.utils import data_management as jdm  # noqa: E402
from yieldfactormodels_jl_tpu.utils.profiling import StageTimer as JStageTimer  # noqa: E402
from yieldfactormodels_jl_tpu_torch import forecasting as tfc  # noqa: E402
from yieldfactormodels_jl_tpu_torch.orchestration import chaos  # noqa: E402
from yieldfactormodels_jl_tpu_torch.orchestration.checkpoint import WindowCheckpoint  # noqa: E402
from yieldfactormodels_jl_tpu_torch.orchestration.retry import SentinelFailure  # noqa: E402
from yieldfactormodels_jl_tpu_torch.persistence import database as tdb  # noqa: E402
from yieldfactormodels_jl_tpu_torch.persistence import locks as tlocks  # noqa: E402
from yieldfactormodels_jl_tpu_torch.robustness import taxonomy  # noqa: E402
from yieldfactormodels_jl_tpu_torch.utils import data_management as tdm  # noqa: E402
from yieldfactormodels_jl_tpu_torch.utils.profiling import StageTimer  # noqa: E402

CPU = "cpu"
MATS = tuple(np.array([3.0, 12.0, 24.0, 60.0, 120.0, 360.0]) / 12.0)


def _specs(root, code="1C"):
    loc = str(root) + os.sep
    js, _ = J.create_model(code, MATS, float_type="float64", results_location=loc)
    ts, _ = P.create_model(code, MATS, float_type="float64", results_location=loc)
    return js, ts


def _results(seed, T=10):
    """A ``predict``-shaped artifact dict with values that round to 3
    decimals in both directions."""
    rng = np.random.default_rng(seed)
    shapes = {"preds": (6, T), "factors": (3, T), "states": (1, T),
              "factor_loadings_1": (6, T), "factor_loadings_2": (6, T)}
    return {k: rng.standard_normal(s) * 10 for k, s in shapes.items()}


def _panel(T=36):
    rng = np.random.default_rng(5)
    return np.cumsum(rng.standard_normal((len(MATS), T)) * 0.1, axis=1) + 5.0


def _rows(path):
    conn = sqlite3.connect(path)
    try:
        return conn.execute("SELECT * FROM forecasts ORDER BY task_id").fetchall()
    finally:
        conn.close()


def _schema(path):
    conn = sqlite3.connect(path)
    try:
        return conn.execute("SELECT sql FROM sqlite_master ORDER BY name").fetchall()
    finally:
        conn.close()


def _write_shards(db, spec, base, tasks=(30, 31, 32)):
    for i, task in enumerate(tasks):
        loss = np.nan if i == 1 else -0.5 - i   # a NaN loss is stored as NULL
        res = _results(task)
        params = np.random.default_rng(100 + task).standard_normal(spec.n_params)
        if db is tdb:  # the port's arrays come from the filter as tensors
            res = {k: torch.as_tensor(v) for k, v in res.items()}
        db.save_oos_forecast_sharded(base, spec.model_string, "1", "expanding", task,
                                     res, loss, params, forecast_horizon=3)


def test_shard_rows_match_jax(tmp_path):
    js, ts = _specs(tmp_path)
    bases = {}
    for name, db, spec in (("jax", jdb, js), ("torch", tdb, ts)):
        bases[name] = os.path.join(str(tmp_path), name, "forecasts_expanding.sqlite3")
        _write_shards(db, spec, bases[name])
    for task in (30, 31, 32):
        rj = _rows(jdb.forecast_path(bases["jax"], task))
        rt = _rows(tdb.forecast_path(bases["torch"], task))
        assert len(rj) == len(rt) == 1
        assert rt[0][:5] == rj[0][:5]     # model, thread, window, task_id, loss
        for a, b in zip(rt[0][5:], rj[0][5:]):
            assert a == b                # the .npy bytes
            np.testing.assert_array_equal(tdb.deser(a), jdb.deser(b))
    assert _rows(tdb.forecast_path(bases["torch"], 31))[0][4] is None
    assert _schema(tdb.forecast_path(bases["torch"], 30)) == \
        _schema(jdb.forecast_path(bases["jax"], 30))


def test_merge_and_export_match_jax(tmp_path):
    out = {}
    for name, db in (("jax", jdb), ("torch", tdb)):
        js, ts = _specs(tmp_path / name)
        spec = js if db is jdb else ts
        base = os.path.join(spec.results_location, "db", "forecasts_expanding.sqlite3")
        _write_shards(db, spec, base)
        merged = db.merge_forecast_shards(base, task_ids=[30, 31, 32], delete_shards=True)
        assert sorted(merged.merged) == [30, 31, 32] and merged.skipped == []
        out[name] = (merged, db.export_all_csv(spec, "1", [30, 31, 32]))
    assert _rows(out["torch"][0]) == _rows(out["jax"][0])
    assert _schema(out["torch"][0]) == _schema(out["jax"][0])
    assert set(out["torch"][1]) == set(out["jax"][1])
    for kind, path in out["jax"][1].items():
        with open(path, "rb") as fj, open(out["torch"][1][kind], "rb") as ft:
            assert ft.read() == fj.read(), kind
    fc = np.loadtxt(out["torch"][1]["forecasts"], delimiter=",")
    assert fc.shape == (9, 2 + len(MATS)) and (fc[:, 1] > fc[:, 0]).all()
    assert tdb.read_all_task_params(out["torch"][0]).keys() == {30, 31, 32}


def test_locks_are_atomic_and_stale_ones_break(tmp_path):
    root = str(tmp_path / "locks")
    held = tlocks.acquire_task_lock(root, "expanding", 7)
    assert held is not None and tlocks.acquire_task_lock(root, "expanding", 7) is None
    assert not tlocks.break_stale_lock(held, ttl_seconds=3600.0)  # fresh: trusted
    old = os.path.getmtime(held) - 7200
    os.utime(held, (old, old))
    assert tlocks.break_stale_lock(held, ttl_seconds=3600.0)
    again = tlocks.acquire_task_lock(root, "expanding", 7)
    assert again == held
    tlocks.release_task_lock(again)
    assert not os.path.isdir(held)


def test_crash_recovery_breaks_a_stale_lock(tmp_path):
    """A killed worker's lock dir skips its task until the TTL sweep breaks
    it; the rerun completes and merges every origin."""
    _, ts = _specs(tmp_path)
    data = _panel(T=34)
    init = oracle.stable_1c_params(ts, np.float64)
    stale = os.path.join(ts.results_location, "db", "locks", "expanding", "task_31.lock")
    os.makedirs(stale)
    old = os.path.getmtime(stale) - 7200
    os.utime(stale, (old, old))
    kw = dict(param_groups=[], reestimate=False, printing=False, device=CPU)
    tfc.run_forecast_window_database(ts, data, "1", 30, 1, 3, "expanding", init, **kw)
    merged = os.path.join(ts.results_location, "db", "forecasts_expanding_merged.sqlite3")
    base = os.path.join(ts.results_location, "db", "forecasts_expanding.sqlite3")
    assert not os.path.isfile(merged) and not os.path.isfile(tdb.forecast_path(base, 31))
    assert os.path.isfile(tdb.forecast_path(base, 30))
    tfc.run_forecast_window_database(ts, data, "1", 30, 1, 3, "expanding", init,
                                     stale_lock_ttl=3600.0, **kw)
    assert [r[3] for r in _rows(merged)] == [30, 31, 32, 33, 34]
    fc = np.loadtxt(os.path.join(ts.results_location,
                                 "1C__thread_id__1__expanding_window_forecasts.csv"),
                    delimiter=",")
    assert fc.shape == (5 * 3, 2 + len(MATS)) and np.isfinite(fc).all()


def test_merge_skips_a_corrupt_shard_and_publishes_once(tmp_path):
    _, ts = _specs(tmp_path)
    base = os.path.join(str(tmp_path), "db", "forecasts_expanding.sqlite3")
    _write_shards(tdb, ts, base)
    with open(tdb.forecast_path(base, 31), "r+b") as fh:
        fh.truncate(100)             # a worker killed mid-write
    out = tdb.merge_forecast_shards(base, task_ids=[30, 31, 32], delete_shards=True)
    assert sorted(out.merged) == [30, 32] and [t for t, _ in out.skipped] == [31]
    assert "corrupt" in out.skipped[0][1]
    assert [r[3] for r in _rows(out)] == [30, 32]
    assert os.path.isfile(tdb.forecast_path(base, 31))      # kept for repair
    assert not os.path.isfile(tdb.forecast_path(base, 32))  # healthy: deleted
    again = tdb.merge_forecast_shards(base, task_ids=[30, 31, 32], delete_shards=True)
    assert str(again) == str(out) and again.merged == []     # the first publish stands
    assert [r[3] for r in _rows(out)] == [30, 32]


def test_merge_chaos_seam_then_rerun(tmp_path):
    _, ts = _specs(tmp_path)
    base = os.path.join(ts.results_location, "db", "forecasts_expanding.sqlite3")
    _write_shards(tdb, ts, base)
    chaos.configure("merge:@1")
    try:
        with pytest.raises(chaos.ChaosInjected, match="merge"):
            tfc.merge_and_export(ts, "1", [30, 31, 32], "expanding")
        assert os.path.isfile(tdb.forecast_path(base, 30))   # nothing was lost
        tfc.merge_and_export(ts, "1", [30, 31, 32], "expanding")
        assert chaos.hits("merge") == 2 and chaos.fired("merge") == 1
    finally:
        chaos.reset()
    with pytest.raises(ValueError, match="unknown seam"):
        chaos.configure("merj:@1")
    chaos.reset()


def test_data_timer_and_checkpoint_match_jax(tmp_path):
    data = _panel(T=8)
    np.savetxt(tmp_path / "thread_id__7__data.csv", data, delimiter=",")
    np.savetxt(tmp_path / "thread_id__7__maturities.csv", np.asarray(MATS), delimiter=",")
    for a, b in zip(tdm.load_data(str(tmp_path), "7"), jdm.load_data(str(tmp_path), "7")):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(tdm.extend_data(data, 3), jdm.extend_data(data, 3))
    timers = StageTimer(max_samples=4), JStageTimer(max_samples=4)
    for k, dt in enumerate((0.3, 0.1, 0.7, 0.2, 0.5)):
        for timer in timers:
            timer.record("estimation" if k % 2 else "merge", dt)
    assert timers[0].summary() == timers[1].summary()
    assert timers[0].to_json(run="x") == timers[1].to_json(run="x")
    assert timers[0].report() == timers[1].report()
    ck = WindowCheckpoint(str(tmp_path / "ck"), "expanding", 31)
    sig = {"model": "1C", "T": 36}
    ck.save(sig, {"X": np.arange(3.0, dtype=np.float32), "next_it": 2})
    state = ck.load(sig)
    assert state["X"].dtype == np.float32 and ck.resumed_iters == 2
    assert ck.load({"model": "1C", "T": 37}) is None   # a foreign signature
    ck.clear()
    assert ck.load(sig) is None


def test_forecast_refusals(tmp_path, monkeypatch):
    _, ts = _specs(tmp_path)
    data = _panel(T=34)
    init = oracle.stable_1c_params(ts, np.float64)
    args = (ts, data, "1", 32, "expanding", 30, 1, 3, init)
    # a fit that returns a non-finite loss surfaces as the retriable sentinel,
    # its code one coded evaluation at the returned point (held against JAX
    # in tests/test_torch_coded.py)
    bad = init.copy()
    bad[ts.layout["delta"][0]] = np.inf
    with monkeypatch.context() as mp:
        mp.setattr(tfc, "_estimate_for_window", lambda *a, **k: (-np.inf, bad))
        with pytest.raises(SentinelFailure, match="non-finite loss") as err:
            tfc.run_single_window_task(*args, sentinel_policy="retry", device=CPU)
    assert err.value.seam == "estimate"
    assert err.value.code == taxonomy.diagnose(ts, bad, data, 0, 32, device=CPU)[1] != 0
    with pytest.raises(ValueError, match="sentinel_policy"):
        tfc.run_single_window_task(*args, sentinel_policy="drop", device=CPU)
    with pytest.raises(NotImplementedError, match="item 11"):
        tfc.run_single_window_task(*args, param_groups=P.get_param_groups(ts),
                                   checkpoint_root=str(tmp_path / "ck"), device=CPU)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            tfc.run_rolling_forecasts(ts, data, "1", 30, 1, 3, init,
                                      window_type="expanding", reestimate=False)
