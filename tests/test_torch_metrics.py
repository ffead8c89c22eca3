"""The port's metrics registry, cost digest and skew/speculation knobs
against the JAX package, on the CPU, exactly:

- bucket math (``exponential_buckets``, ``quantile_from_buckets``) and
  histogram snapshots give the JAX package's numbers;
- the same seeded observations into a registry of each package give equal
  ``snapshot()`` / ``snapshot(compact=True)`` dumps and equal Prometheus
  text, before and after ``reset_values``;
- the registry is off by default, ``S3SHUFFLE_METRICS`` turns it on, and
  while it is off no instrument records;
- the names table is the JAX package's, and every instrument the port
  registers is in it with its kind and labels;
- ``parse_rate_card`` and ``cost_digest`` equal the JAX package's;
- the five knobs of ``config.py`` take the JAX defaults and validation,
  through ``from_dict``, ``from_env`` and ``log_values``.

Every test that turns a registry on turns it off and zeroes it in its
fixture's teardown (the suite runs many files per worker).
"""

import logging
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from s3shuffle_tpu import costs as jax_costs
from s3shuffle_tpu.config import ShuffleConfig as JaxConfig
from s3shuffle_tpu.metrics import names as jax_names
from s3shuffle_tpu.metrics import registry as jax_reg
from s3shuffle_tpu_torch import ShuffleConfig, costs
from s3shuffle_tpu_torch import metrics as port_metrics
from s3shuffle_tpu_torch.metrics import names
from s3shuffle_tpu_torch.metrics import registry as reg

REPO = Path(__file__).resolve().parent.parent


@pytest.fixture
def both_on():
    """Both packages' registries on, zeroed before and after."""
    for r in (reg, jax_reg):
        r.REGISTRY.reset_values()
        r.enable()
    yield
    for r in (reg, jax_reg):
        r.disable()
        r.REGISTRY.reset_values()


# --- bucket math ---

@pytest.mark.parametrize("args", [(1e-4, 2.0, 20), (256.0, 4.0, 12), (1.0, 1.5, 1), (3.0, 10.0, 7)])
def test_exponential_buckets_equal_jax(args):
    assert reg.exponential_buckets(*args) == jax_reg.exponential_buckets(*args)


@pytest.mark.parametrize("args", [(0.0, 2.0, 3), (1.0, 1.0, 3), (1.0, 2.0, 0)])
def test_exponential_buckets_refuse_what_jax_refuses(args):
    with pytest.raises(ValueError):
        reg.exponential_buckets(*args)
    with pytest.raises(ValueError):
        jax_reg.exponential_buckets(*args)


@pytest.mark.parametrize("seed", range(6))
def test_quantile_from_buckets_equals_jax(seed):
    rng = np.random.default_rng(seed)
    bounds = reg.DEFAULT_TIME_BUCKETS
    counts = [int(c) for c in rng.integers(0, 5, len(bounds) + 1)]
    if seed == 0:
        counts = [0] * (len(bounds) + 1)
    if seed == 1:
        counts = [0] * len(bounds) + [7]  # everything in the overflow bin
    for q in (0.0, 0.1, 0.5, 0.9, 0.99, 1.0):
        assert reg.quantile_from_buckets(bounds, counts, q) == \
            jax_reg.quantile_from_buckets(bounds, counts, q)
    assert reg.DEFAULT_TIME_BUCKETS == jax_reg.DEFAULT_TIME_BUCKETS
    assert reg.DEFAULT_BYTES_BUCKETS == jax_reg.DEFAULT_BYTES_BUCKETS


# --- one seeded workload through a fresh registry of each package ---

def _feed(mod, registry, seed):
    rng = np.random.default_rng(seed)
    c = registry.counter("t_ops_total", "ops", labelnames=("op",))
    plain = registry.counter("t_plain_total")
    g = registry.gauge("t_level", "a level")
    h = registry.histogram("t_fill_seconds", "fills", labelnames=("size_class",))
    hb = registry.histogram("t_bytes", buckets=mod.DEFAULT_BYTES_BUCKETS)
    registry.counter("t_never_total", "never recorded")
    for _ in range(200):
        c.labels(op=str(rng.choice(["read", "open", "create"]))).inc(float(rng.integers(1, 4)))
        plain.inc()
        g.set(float(rng.normal()))
        g.inc(0.5)
        g.dec(0.25)
        h.labels(size_class=str(rng.choice(["le1m", "le8m"]))).observe(float(rng.exponential(0.01)))
        hb.observe(float(rng.integers(0, 1 << 31)))
    return h


@pytest.mark.parametrize("seed", range(3))
def test_snapshots_and_prometheus_text_equal_jax(both_on, seed):
    mine, theirs = reg.MetricRegistry(), jax_reg.MetricRegistry()
    h_mine = _feed(reg, mine, seed)
    h_theirs = _feed(jax_reg, theirs, seed)
    assert mine.snapshot() == theirs.snapshot()
    assert mine.snapshot(compact=True) == theirs.snapshot(compact=True)
    assert "t_never_total" not in mine.snapshot(compact=True)
    extra = {"worker": 'w"1\n'}
    assert reg.render_prometheus(mine, extra_labels=extra) == \
        jax_reg.render_prometheus(theirs, extra_labels=extra)
    a, b = h_mine.read(), h_theirs.read()
    assert (a.bounds, a.counts, a.sum, a.count) == (b.bounds, b.counts, b.sum, b.count)
    for q in (0.5, 0.9, 0.99):
        assert h_mine.percentile(q) == h_theirs.percentile(q)
        assert h_mine.labels(size_class="le1m").read().percentile(q) == \
            h_theirs.labels(size_class="le1m").read().percentile(q)
    assert reg.read_counter_total("t_ops_total", mine) == \
        jax_reg.read_counter_total("t_ops_total", theirs)
    d_mine = reg.read_histogram("t_fill_seconds", mine).delta(a)
    d_theirs = jax_reg.read_histogram("t_fill_seconds", theirs).delta(b)
    assert (d_mine.count, d_mine.mean) == (d_theirs.count, d_theirs.mean) == (0, 0.0)
    mine.reset_values()
    theirs.reset_values()
    assert mine.snapshot() == theirs.snapshot()
    assert reg.render_prometheus(mine) == jax_reg.render_prometheus(theirs) == ""


def test_instruments_refuse_what_jax_refuses(both_on):
    for mod in (reg, jax_reg):
        r = mod.MetricRegistry()
        c = r.counter("x_total", labelnames=("a",))
        with pytest.raises(ValueError):
            c.labels(b="1")
        with pytest.raises(ValueError):
            r.gauge("x_total")
        with pytest.raises(ValueError):
            r.counter("x_total", labelnames=("b",))
        with pytest.raises(ValueError):
            r.histogram("h", buckets=(1.0, 1.0))
        assert r.get("missing") is None
        assert mod.read_histogram("x_total", r).count == 0
        assert mod.read_counter_total("missing", r) == 0.0


def test_nothing_records_while_the_registry_is_off():
    assert not reg.enabled()
    r = reg.MetricRegistry()
    r.counter("off_total").inc()
    r.gauge("off_level").set(3.0)
    r.histogram("off_seconds").observe(1.0)
    assert r.snapshot(compact=True) == {}
    assert reg.render_prometheus(r) == ""


@pytest.mark.parametrize("value,on", [("", False), ("1", True), ("yes", True)])
def test_s3shuffle_metrics_switch(value, on):
    """A fresh interpreter: the port's registry is on exactly when
    ``S3SHUFFLE_METRICS`` is non-empty, as the JAX package's is."""
    env = {k: v for k, v in os.environ.items() if k not in ("PYTHONPATH", "S3SHUFFLE_METRICS")}
    if value:
        env["S3SHUFFLE_METRICS"] = value
    code = ("import sys; from s3shuffle_tpu_torch.metrics import registry as r; "
            "print(r.enabled()); sys.exit('jax' in sys.modules)")
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip() == str(on)


def test_package_exports_the_jax_packages_registry_names():
    """The port's ``metrics`` package exports the JAX one's registry names
    (its stats reports are not ported), each the registry module's own."""
    import s3shuffle_tpu.metrics as jax_metrics

    stats_names = {"COLLECTOR", "ShuffleStats", "ShuffleStatsCollector", "TaskStats"}
    assert set(port_metrics.__all__) == set(jax_metrics.__all__) - stats_names
    for name in port_metrics.__all__:
        assert getattr(port_metrics, name) is getattr(reg, name)


# --- the names table ---

def test_names_table_is_the_jax_one():
    assert names.KNOWN_METRICS == jax_names.KNOWN_METRICS


def test_every_port_instrument_is_a_known_name():
    """The dynamic form of the JAX package's MET01 lint: each instrument the
    port registers (its modules imported) is declared, kind and labels."""
    import s3shuffle_tpu_torch.coding.degraded  # noqa: F401
    import s3shuffle_tpu_torch.read.scan_plan  # noqa: F401
    import s3shuffle_tpu_torch.write.spill_writer  # noqa: F401

    registered = {m.name: (m.kind, m.labelnames) for m in reg.REGISTRY.metrics()}
    for name in ("read_prefetch_fill_seconds", "read_prefetch_fill_class_seconds",
                 "read_prefetch_fill_per_mib_seconds", "shuffle_parity_speculative_reads_total",
                 "shuffle_map_combine_rows_total", "shuffle_partition_splits_total",
                 "shuffle_hot_fanout_reads_total", "cost_dollars_total"):
        assert name in registered, name
    for name, spec in registered.items():
        assert names.KNOWN_METRICS[name] == spec, name


# --- costs ---

CARDS = ["", "get=4e-7,put=5e-6", " get = 1e-6 , , gb_read=0.09", "delete=0,list=1e-5,gb_written=0.02"]
BAD_CARDS = ["get", "bogus=1", "put=-1", "get=abc"]


@pytest.mark.parametrize("spec", CARDS)
def test_parse_rate_card_equals_jax(spec):
    assert costs.parse_rate_card(spec) == jax_costs.parse_rate_card(spec)


@pytest.mark.parametrize("spec", BAD_CARDS)
def test_parse_rate_card_refuses_what_jax_refuses(spec):
    with pytest.raises(ValueError):
        costs.parse_rate_card(spec)
    with pytest.raises(ValueError):
        jax_costs.parse_rate_card(spec)


def _synthetic_snapshot(seed):
    rng = np.random.default_rng(seed)
    ops = ["read", "open", "status", "create", "write_close", "rename", "list", "delete", "write"]
    return {
        "storage_op_seconds": {"kind": "histogram", "series": [
            {"labels": {"scheme": "s3", "op": op}, "count": int(rng.integers(0, 10_000))}
            for op in ops]},
        "storage_read_bytes_total": {"kind": "counter", "series": [
            {"labels": {"scheme": "s3"}, "value": float(rng.integers(0, 1 << 40))}]},
        "storage_write_bytes_total": {"kind": "counter", "series": [
            {"labels": {"scheme": "s3"}, "value": float(rng.integers(0, 1 << 38))}]},
    }


@pytest.mark.parametrize("spec", CARDS)
@pytest.mark.parametrize("shuffles", [0, 1, 7])
def test_cost_digest_equals_jax(both_on, spec, shuffles):
    snap = _synthetic_snapshot(len(spec) + shuffles)
    mine = costs.cost_digest(snap, costs.parse_rate_card(spec), shuffles=shuffles)
    theirs = jax_costs.cost_digest(snap, jax_costs.parse_rate_card(spec), shuffles=shuffles)
    assert mine == theirs
    assert costs.cost_digest(snap) == jax_costs.cost_digest(snap)
    costs.record_cost_metrics(mine)
    jax_costs.record_cost_metrics(theirs)
    assert reg.REGISTRY.snapshot(compact=True)["cost_dollars_total"] == \
        jax_reg.REGISTRY.snapshot(compact=True)["cost_dollars_total"]


# --- the knobs ---

KNOBS = ("speculative_read_quantile", "combine_threshold_bytes", "split_threshold_bytes",
         "hot_read_fanout", "cost_rate_card")


def test_knob_defaults_equal_jax():
    port, jax = ShuffleConfig(), JaxConfig()
    assert {k: getattr(port, k) for k in KNOBS} == {k: getattr(jax, k) for k in KNOBS}
    assert port.speculative_read_quantile == 0.99 and port.cost_rate_card == ""


BAD_KNOBS = [
    {"speculative_read_quantile": 1.0},
    {"speculative_read_quantile": -0.1},
    {"combine_threshold_bytes": -1},
    {"split_threshold_bytes": -1},
    {"hot_read_fanout": -1},
    {"cost_rate_card": "bogus=1"},
    {"cost_rate_card": "get=-1"},
]


@pytest.mark.parametrize("bad", BAD_KNOBS, ids=lambda d: "-".join(f"{k}={v}" for k, v in d.items()))
def test_knob_validation_equals_jax(bad):
    with pytest.raises(ValueError):
        ShuffleConfig(**bad)
    with pytest.raises(ValueError):
        JaxConfig(**bad)


def test_knobs_through_from_dict_from_env_and_log_values(caplog):
    d = {"speculative_read_quantile": "0.9", "combine_threshold_bytes": "4m",
         "split_threshold_bytes": "8m", "hot_read_fanout": "6", "cost_rate_card": "get=1e-6"}
    port = ShuffleConfig.from_dict(d)
    jax = JaxConfig.from_dict(d)
    assert {k: getattr(port, k) for k in KNOBS} == {k: getattr(jax, k) for k in KNOBS}
    assert port.combine_threshold_bytes == 4 << 20 and port.hot_read_fanout == 6
    env = {"S3SHUFFLE_" + k.upper(): v for k, v in d.items()}
    from_env = ShuffleConfig.from_env(env)
    assert {k: getattr(from_env, k) for k in KNOBS} == {k: getattr(port, k) for k in KNOBS}
    with caplog.at_level(logging.INFO, logger="s3shuffle_tpu_torch.config"):
        port.log_values()
    logged = caplog.text
    for k in KNOBS:
        assert f"config: {k}=" in logged, k
