"""The port's drivers (``s3shuffle_tpu_torch/examples/``) against the JAX
package's ``examples/``, on the CPU (``--device cpu``), at small sizes:

- ``sql_queries``: ``gen_tables`` (uniform and Zipf-skewed) gives the JAX
  example's arrays; each of the six queries through the port with zlib
  equals the JAX example's result and its plain-Python reference, with the
  JAX stage counts, and so does ``chip_smoke.py``'s numpy recomputation;
  ``run_query`` verifies through the driver; the narrow-pack retry and the
  re-raise of non-range errors behave as in ``tests/test_sql_queries.py``;
- ``terasort``: its input equals the JAX example's, and at 2 MiB under zlib
  it writes objects byte-equal to the JAX example's and TeraValidates;
- ``query_shuffles``: each profile's line equals the JAX one's but for the
  timing keys;
- ``multihost_terasort`` with two CPU worker processes and ``ici_to_store``
  on two repeated CPU lanes report valid;
- every driver refuses to run without a card unless given ``--device
  cpu``, and refuses the JAX ``tpu-hostpath`` label (the host fallback).
"""

import hashlib
import json
import os
import sys

import numpy as np
import pytest
import torch

import chip_smoke
from s3shuffle_tpu.config import ShuffleConfig as JaxConfig
from s3shuffle_tpu.shuffle import ShuffleContext as JaxContext
from s3shuffle_tpu.storage.dispatcher import Dispatcher as JaxDispatcher
from s3shuffle_tpu_torch import ShuffleConfig, ShuffleContext
from s3shuffle_tpu_torch.examples import (
    ici_to_store,
    multihost_terasort,
    query_shuffles,
    sql_queries,
    terasort,
)
from s3shuffle_tpu_torch.storage.dispatcher import Dispatcher
from torch_port_dispatcher import port_dispatcher_reset  # noqa: F401  (resets the port's process dispatcher)

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "examples"))

import query_shuffles as jax_query_shuffles  # noqa: E402
import sql_queries as jax_sql_queries  # noqa: E402
import terasort as jax_terasort  # noqa: E402

QUERIES = ["q5", "q49", "q75", "q67", "q64", "q95"]
STAGES = {"q5": 1, "q49": 3, "q75": 3, "q67": 2, "q64": 4, "q95": 3}
DRIVERS = {
    "sql_queries": (sql_queries, ["--query", "q5", "--sf", "0.01"]),
    "terasort": (terasort, ["--size", "1m"]),
    "query_shuffles": (query_shuffles, ["--query", "q49", "--scale", "1000000"]),
    "multihost_terasort": (multihost_terasort, ["--local-workers", "1", "--size", "1m"]),
    "ici_to_store": (ici_to_store, ["--devices", "2", "--size", "1m"]),
}


def _last_json(text: str) -> dict:
    return json.loads([line for line in text.splitlines() if line.startswith("{")][-1])


# ---------------------------------------------------------------------------
# sql_queries
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("skew", [0.0, 1.2])
def test_gen_tables_equal_jax(skew):
    sales, returns = sql_queries.gen_tables(0.02, skew=skew)
    jax_sales, jax_returns = jax_sql_queries.gen_tables(0.02, skew=skew)
    for got, want in ((sales, jax_sales), (returns, jax_returns)):
        assert sorted(got) == sorted(want)
        for col in got:
            assert got[col].dtype == want[col].dtype and np.array_equal(got[col], want[col]), col


@pytest.mark.parametrize("skew", [0.0, 1.2])
@pytest.mark.parametrize("name", QUERIES)
def test_query_equals_jax_reference_and_numpy(tmp_path, name, skew):
    sales, returns = sql_queries.gen_tables(0.02, skew=skew)
    with ShuffleContext(config=ShuffleConfig(root_dir=f"file://{tmp_path}/port", codec="zlib"),
                        num_workers=2, device="cpu") as ctx:
        st = sql_queries.ColumnarStages(ctx)
        result, reference = sql_queries.QUERIES[name](st, sales, returns)
    JaxDispatcher.reset()
    with JaxContext(config=JaxConfig(root_dir=f"file://{tmp_path}/jax", codec="zlib"),
                    num_workers=2) as jax_ctx:
        jax_st = jax_sql_queries.ColumnarStages(jax_ctx)
        jax_result, _jax_reference = jax_sql_queries.QUERIES[name](jax_st, sales, returns)
    assert result == jax_result == reference()
    assert chip_smoke.NUMPY_QUERIES[name](sales, returns) == result
    assert st.stages == jax_st.stages == STAGES[name]
    assert st.narrow_fallbacks == jax_st.narrow_fallbacks == 0


@pytest.mark.parametrize("name", QUERIES)
def test_run_query_verifies_through_the_driver(tmp_path, name):
    out = sql_queries.run_query(name, sf=0.02, codec="zlib", workers=2, verify=True,
                                root=str(tmp_path), device="cpu")
    assert out["verified"] and out["rows_out"] > 0
    assert out["shuffle_stages"] == STAGES[name]
    assert out["shuffle_stage_wall_s"] <= out["wall_s"] + 1e-9
    assert (out["name"], out["power_limit"]) == (None, None)  # no card: no card fields
    assert "narrow_fallbacks" not in out and "skew" not in out


def test_query_through_the_tpu_codec(tmp_path):
    out = sql_queries.run_query("q49", sf=0.01, codec="tpu", workers=2, verify=True,
                                root=str(tmp_path), device="cpu")
    assert out["verified"] and out["codec"] == "tpu"


def test_main_prints_one_verified_line_per_query(capsys):
    assert sql_queries.main(["--query", "q95", "--sf", "0.01", "--codec", "zlib",
                             "--skew", "1.2", "--device", "cpu"]) == 0
    out = _last_json(capsys.readouterr().out)
    assert out["query"] == "q95" and out["verified"] and out["skew"] == 1.2


def test_agg_typed_falls_back_to_wide_rows(tmp_path):
    """A value over its declared narrow wire dtype does not abort the stage:
    ``agg_typed`` retries with wide int64 rows (and i64 keys) and counts
    the fallback, as the JAX example does."""
    from s3shuffle_tpu_torch.structured import KeyCodec

    with ShuffleContext(config=ShuffleConfig(root_dir=f"file://{tmp_path}/agg", app_id="fb"),
                        num_workers=2, device="cpu") as ctx:
        st = sql_queries.ColumnarStages(ctx)
        keys = np.array([1, 1, 2, 2], dtype=np.int64)
        vals = np.array([1000, 1000, 5, 5], dtype=np.int64)  # 1000 >> i1
        (k,), v = st.agg_typed(KeyCodec("i32"), (keys,), (vals,), ("sum",), val_dtypes=("i1",))
    order = np.argsort(k)
    assert k[order].tolist() == [1, 2]
    assert v[order, 0].tolist() == [2000, 10]
    assert st.narrow_fallbacks == 1
    assert st.stages == 1


def test_agg_typed_reraises_non_range_errors(tmp_path):
    """Only a range overflow is healed by widening: a float column or a
    dtype-count mismatch is a caller's bug and propagates."""
    from s3shuffle_tpu_torch.structured import KeyCodec

    with ShuffleContext(config=ShuffleConfig(root_dir=f"file://{tmp_path}/agg2", app_id="fb2"),
                        num_workers=1, device="cpu") as ctx:
        st = sql_queries.ColumnarStages(ctx)
        with pytest.raises(ValueError, match="integer dtype"):
            st.agg_typed(KeyCodec("i32"), (np.array([1.5, 2.5]),),
                         (np.array([1, 2], dtype=np.int64),), ("sum",), val_dtypes=("i1",))
        with pytest.raises(ValueError, match="expected"):
            st.agg_typed(KeyCodec("i32"), (np.array([1, 2], dtype=np.int64),),
                         (np.array([1, 2], dtype=np.int64),), ("sum",), val_dtypes=("i1", "i1"))
    assert st.narrow_fallbacks == 0


# ---------------------------------------------------------------------------
# terasort
# ---------------------------------------------------------------------------


def test_terasort_input_equals_jax():
    parts = terasort.generate(1 << 20, 4)
    jax_parts = jax_terasort.generate(1 << 20, 4)
    assert [p.to_records() for p in parts] == [p.to_records() for p in jax_parts]


def test_teravalidate_refuses_disorder_and_a_short_count():
    parts = terasort.generate(1 << 16, 2)
    with pytest.raises(AssertionError, match="order violated"):
        terasort.teravalidate([[parts[0]]], parts[0].n)
    with pytest.raises(AssertionError, match="record count"):
        terasort.teravalidate([[]], 1)


def _digests(root: str) -> dict:
    out = {}
    for d, _dirs, files in os.walk(root):
        for f in files:
            path = os.path.join(d, f)
            with open(path, "rb") as fh:
                out[os.path.relpath(path, root)] = hashlib.sha256(fh.read()).hexdigest()
    return out


def test_terasort_writes_the_jax_examples_objects(tmp_path, monkeypatch, capsys):
    """Both drivers at 2 MiB under zlib: the objects under each root, taken
    just before each sort removes its shuffle, are byte-equal; both
    TeraValidate."""
    from s3shuffle_tpu import manager as jax_manager
    from s3shuffle_tpu_torch import manager

    seen = {}
    for label, mod in (("port", manager), ("jax", jax_manager)):
        real = mod.ShuffleManager.unregister_shuffle

        def unregister(mgr, shuffle_id, _real=real, _label=label):
            seen[_label] = _digests(str(tmp_path / _label))
            return _real(mgr, shuffle_id)

        monkeypatch.setattr(mod.ShuffleManager, "unregister_shuffle", unregister)
    args = ["--size", "2m", "--codec", "zlib", "--workers", "2"]
    assert terasort.main([*args, "--root", f"file://{tmp_path}/port", "--device", "cpu"]) == 0
    port_line = _last_json(capsys.readouterr().out)
    monkeypatch.setattr(sys, "argv", ["terasort.py", *args, "--root", f"file://{tmp_path}/jax"])
    assert jax_terasort.main() == 0
    jax_line = _last_json(capsys.readouterr().out)
    assert seen["port"] and seen["port"] == seen["jax"]
    assert port_line["runs"][0]["records"] == jax_line["runs"][0]["records"] == 20968
    jax_keys = set(jax_line) - {"calib_memcpy_mb_s", "calib_zlib1_mb_s"}
    assert set(port_line) - {"name", "power_limit"} == jax_keys


# ---------------------------------------------------------------------------
# query_shuffles
# ---------------------------------------------------------------------------

TIMING_KEYS = {"wall_s", "mb_per_s"}


@pytest.mark.parametrize("name", list(query_shuffles.PROFILES))
def test_query_profile_equals_jax_but_for_timings(tmp_path, name):
    got = query_shuffles.run_query(name, 200_000.0, "zlib", 2, 4, 4,
                                   f"file://{tmp_path}/port", device="cpu")
    JaxDispatcher.reset()
    want = jax_query_shuffles.run_query(name, 200_000.0, "zlib", 2, 4, 4,
                                        f"file://{tmp_path}/jax")
    assert set(got) == set(want)
    assert {k: v for k, v in got.items() if k not in TIMING_KEYS} == \
        {k: v for k, v in want.items() if k not in TIMING_KEYS}


# ---------------------------------------------------------------------------
# multihost_terasort and ici_to_store
# ---------------------------------------------------------------------------


def test_multihost_terasort_with_two_cpu_workers_is_valid(tmp_path, capsys):
    launch_dir = tmp_path / "launches"
    launch_dir.mkdir()
    os.environ["S3SHUFFLE_LAUNCHES_DIR"] = str(launch_dir)
    try:
        assert multihost_terasort.main(["--local-workers", "2", "--size", "1m", "--codec",
                                        "zlib", "--root", f"file://{tmp_path}/store",
                                        "--device", "cpu"]) == 0
    finally:
        del os.environ["S3SHUFFLE_LAUNCHES_DIR"]
    out = _last_json(capsys.readouterr().out)
    assert out["valid"] is True and out["workers"] == 2 and out["records"] == 10480
    # each agent wrote its launches as it left: the CPU's plain versions
    # launch no kernel
    reports = sorted(os.listdir(launch_dir))
    assert reports == ["local-0.json", "local-1.json"]
    for name in reports:
        info = json.loads((launch_dir / name).read_text())
        assert set(info["launches"].values()) == {0}


def test_ici_to_store_on_two_cpu_lanes_is_valid(tmp_path, capsys):
    assert ici_to_store.main(["--devices", "2", "--size", "1m", "--partitions", "4", "--codec",
                              "zlib", "--root", str(tmp_path), "--device", "cpu"]) == 0
    out = _last_json(capsys.readouterr().out)
    assert out["valid"] is True and out["devices"] == 2 and out["records"] == 10484


def test_ici_to_store_never_shrinks_the_mesh(monkeypatch):
    from s3shuffle_tpu_torch.parallel import dispatch

    monkeypatch.setattr(dispatch, "local_devices", lambda device_type="cuda": [])
    with pytest.raises(RuntimeError, match="--devices 2 asks for 2 cuda devices; 0"):
        ici_to_store.mesh_devices(torch.device("cuda"), 2)
    assert ici_to_store.mesh_devices(torch.device("cpu"), 3) == [torch.device("cpu")] * 3


# ---------------------------------------------------------------------------
# refusals
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("driver", list(DRIVERS))
def test_each_driver_refuses_to_run_without_a_card(driver, monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    module, argv = DRIVERS[driver]
    with pytest.raises(RuntimeError, match="no CUDA device"):
        module.main([*argv, "--root", f"file://{tmp_path}"] if driver != "ici_to_store"
                    else [*argv, "--root", str(tmp_path)])
    assert not any(files for _d, _s, files in os.walk(tmp_path))


@pytest.mark.parametrize("driver", list(DRIVERS))
def test_each_driver_refuses_the_host_fallback_label(driver, tmp_path):
    module, argv = DRIVERS[driver]
    root = str(tmp_path) if driver == "ici_to_store" else f"file://{tmp_path}"
    with pytest.raises(ValueError, match="host fallback"):
        module.main([*argv, "--codec", "tpu-hostpath", "--device", "cpu", "--root", root])
