"""TPC-DS q67 through the port's ranked rollup, on the CPU at small sizes,
against the plain reference ``portbench/reference/tpcds_q67.py`` (numpy on
dictionary codes: no ``KeyCodec``, ``structured`` or ``colagg``):

- ``structured.rollup_shuffle`` through ``ShuffleContext`` for 1, 16 and
  200 reducers and 1 and 4 maps: every group of every grouping set and its
  sum equal the reference's;
- a handmade table: a data NULL beside a rollup NULL, ties at the rank
  limit (rank, not row number), and the final order's NULLS FIRST;
- ``structured.rank`` against a loop version of SQL's rank() (descending);
- the rollup takes the sort-shuffle handle (``base``), the window exchange
  the bypass handle;
- the cell through ``portbench.harness.run_cell(..., device="cpu")``:
  correct, with its end-to-end and per-layer metrics; the control reads
  wrong;
- the generator at the configuration's full dimension sizes;
- the ``record.expand``, ``record.combine`` and ``record.rank`` stages and
  the combine's row counts add their own keys to the codec's timings, and
  a TeraSort job's keys stay as they were.
"""

import tempfile
import time

import numpy as np
import pytest

from portbench import control, harness
from portbench.generators import tpcds_q67 as gen
from portbench.reference import tpcds_q67 as reference
from portbench.tests.small import SMALL_KNOBS
from s3shuffle_tpu_torch import ShuffleConfig, ShuffleContext
from s3shuffle_tpu_torch.batch import RecordBatch, iter_record_batches
from s3shuffle_tpu_torch.serializer import ColumnarKVSerializer
from s3shuffle_tpu_torch.structured import rank, rank_shuffle, rollup_shuffle, values_matrix
from s3shuffle_tpu_torch.utils import trace
from torch_port_dispatcher import port_dispatcher_reset  # noqa: F401  (resets the port's process dispatcher)

SEED = 2**31 + 977
SMALL = {"maps": 2, "rows_per_map": 256, "reducers": 8, "item_rows": 400, "store_rows": 12,
         "knobs": SMALL_KNOBS}
NEW_KEYS = ("expand_host_s", "combine_host_s", "combine_rows_in", "combine_rows_out",
            "rank_host_s")


def _config(**over):
    spec = harness.load_cell("tpcds-q67")
    return dict(spec["config"], **dict(SMALL, **over))


def _context(tmp_path, codec="zlib", **kw):
    cfg = ShuffleConfig(root_dir=f"file://{tmp_path / 'store'}", codec=codec,
                        checksum_algorithm="CRC32C", autotune=False, codec_block_size=2048,
                        codec_batch_blocks=4, **kw)
    return ShuffleContext(cfg, num_workers=2, device="cpu")


def _table(rows, seed=SEED, **over):
    config = _config(rows_per_map=rows, maps=1, **over)
    return gen.make_joined(config, np.random.default_rng(seed))


def _port_groups(rollup, out):
    """{(gid, row of the eight columns, None for NULL): sum} of the
    rollup's output partitions."""
    groups = {}
    for partition in out:
        for b in partition:
            if not b.n:
                continue
            cols, nulls, gid = rollup.decode(b)
            sums = values_matrix(b, 1)[:, 0]
            for i in range(b.n):
                row = tuple(None if nulls[c][i] else bytes(cols[c][i])
                            if isinstance(cols[c][i], bytes) else int(cols[c][i])
                            for c in range(8))
                key = (int(gid[i]), row)
                assert key not in groups, "a group twice in the output"
                groups[key] = int(sums[i])
    return groups


def _reference_groups(table):
    codes, gids, sums, tables = reference.rollup_groups(table)
    return {(int(g), reference._row(c, g, s, 0, tables)[:8]): int(s)
            for c, g, s in zip(codes, gids, sums)}


# --- the rollup aggregate ---

@pytest.mark.parametrize("maps", [1, 4])
@pytest.mark.parametrize("reducers", [1, 16, 200])
def test_the_rollup_aggregate_equals_the_reference(tmp_path, reducers, maps):
    table = _table(600, seed=SEED + reducers + maps)
    ctx = _context(tmp_path)
    try:
        rollup, out = rollup_shuffle(ctx, gen.CODEC, gen.map_batches(table, maps), ("sum",),
                                     reducers)
    finally:
        ctx.stop()
    assert len(out) == reducers
    got, want = _port_groups(rollup, out), _reference_groups(table)
    assert got == want
    assert {g for g, _r in got} == {(1 << (8 - kept)) - 1 for kept in range(9)}
    # each partition's rows come key-sorted from the reduce-side merge
    for partition in out:
        for b in partition:
            keys = np.ascontiguousarray(b.keys).view(f"S{rollup.out_codec.width}")
            assert (keys[1:] > keys[:-1]).all()


HANDMADE = [
    # category, class, brand, product, year, qoy, moy, store, sales; None = data NULL
    ("Books", "arts", "b1", "p1", 2000, 1, 1, "S1", 500),
    ("Books", None, "b1", "p2", 2000, 1, 2, "S1", 300),
    ("Books", None, "b2", "p3", 2000, 2, 4, "S2", 300),
    ("Books", "arts", "b2", "p4", 2000, 2, 5, "S2", 200),
    ("Music", "jazz", "b3", "p5", 2000, 3, 7, "S1", 700),
    ("Music", "jazz", "b3", "p6", 2000, 3, 7, "S1", 700),
    ("Music", "rock", "b4", "p7", 2000, 4, 10, "S2", 100),
    (None, "pop", "b5", "p8", 2000, 4, 11, "S3", 50),
]


def _handmade_table():
    cols = list(zip(*HANDMADE))
    table = {}
    for j, name in enumerate(reference.COLUMNS):
        vals = cols[j]
        if j in (4, 5, 6):
            table[name] = np.array(vals, dtype=np.int64)
            continue
        width = gen.STORE_ID if name == "s_store_id" else gen.CHAR50
        table[name] = np.array([(v or "").encode().ljust(width) for v in vals],
                               dtype=f"S{width}")
        table[name + "_null"] = np.array([v is None for v in vals])
    table["s_store_id_null"] = np.zeros(len(HANDMADE), dtype=bool)
    table["sales"] = np.array(cols[8], dtype=np.int64)
    return table


def _q67(tmp_path, table, maps, k, limit, reducers=16):
    ctx = _context(tmp_path)
    try:
        rollup, out = rollup_shuffle(ctx, gen.CODEC, gen.map_batches(table, maps), ("sum",),
                                     reducers)
        bounds = [reducers * m // maps for m in range(maps + 1)]
        ranked = rank_shuffle(ctx, [[b for p in out[lo:hi] for b in p]
                                    for lo, hi in zip(bounds[:-1], bounds[1:])],
                              gen.CHAR50, k, reducers)
    finally:
        ctx.stop()
    rows = gen.answer_rows(rollup, ranked)
    return {"rows": rows, "top": rows[:limit], "sets": gen.grouping_sets(out)}


def test_a_data_null_stays_apart_from_a_rollup_null(tmp_path):
    table = _handmade_table()
    got = _q67(tmp_path, table, 2, 100, 100)
    want = reference.q67(table, 100, 100)
    assert reference.judge_unit(got, want) == 0 and got == want
    books = b"Books".ljust(50)
    # (Books, NULL class) as data, grouped on its own, and (Books) with
    # every other column rolled up: both NULL in i_class, told apart by gid
    data_null = [r for r in got["rows"] if r[:2] == (books, None) and r[10] == 63]
    rollup_null = [r for r in got["rows"] if r[:2] == (books, None) and r[10] == 127]
    assert [r[8] for r in data_null] == [600] and [r[8] for r in rollup_null] == [1300]
    # the data NULL category shares the grand total's window partition
    null_cat = sorted((r[10], r[8], r[9]) for r in got["rows"] if r[0] is None)
    assert null_cat[-1] == (255, 2850, 1)
    assert all(rk > 1 for gid, _s, rk in null_cat if gid != 255)


def test_ties_at_the_rank_limit_are_kept_by_rank_not_row_number(tmp_path):
    table = _handmade_table()
    got = _q67(tmp_path, table, 1, 2, 100)
    want = reference.q67(table, 2, 100)
    assert reference.judge_unit(got, want) == 0 and got == want
    music = b"Music".ljust(50)
    # Music's total 1500 ranks 1; (Music, jazz) and (Music, jazz, b3), both
    # 1400, tie at rank 2 and are both kept: three rows under a limit of 2
    assert sorted((r[9], r[8]) for r in got["rows"] if r[0] == music) == \
        [(1, 1500), (2, 1400), (2, 1400)]


def test_the_final_order_puts_nulls_first(tmp_path):
    table = _handmade_table()
    got = _q67(tmp_path, table, 2, 100, 5)
    want = reference.q67(table, 100, 5)
    assert got["top"] == want["top"] and len(got["top"]) == 5
    assert [r[0] for r in got["top"]] == [None] * 5
    # the data NULL category with every other column rolled up, and the
    # grand total: NULL in all eight columns, so ordered by sumsales
    assert got["top"][0][:10] == (None,) * 8 + (50, 2)
    assert got["top"][1][8:] == (2850, 1, 255)
    assert got["top"][2][1] == b"pop".ljust(50)


# --- rank() ---

def _rank_loop(group, order):
    return [1 + sum(1 for g2, v2 in zip(group, order) if g2 == g and v2 > v)
            for g, v in zip(group, order)]


@pytest.mark.parametrize("case", [
    ([0, 0, 0, 0], [5, 5, 3, 9]),
    ([1, 0, 1, 0, 2], [7, 7, 7, 1, 0]),
    ([0] * 6, [4, 4, 4, 4, 4, 4]),
    ([3, 1, 3, 1, 3, 1], [-2, 8, -2, 9, 5, 8]),
    (list(np.random.default_rng(5).integers(0, 4, 200)),
     list(np.random.default_rng(6).integers(-3, 3, 200))),
])
def test_rank_is_sql_rank(case):
    group, order = case
    got = rank(np.array(group), np.array(order, dtype=np.int64))
    assert got.tolist() == _rank_loop(group, order)


# --- the handles, the stages, the map task's lazy input ---

def test_the_rollup_takes_the_sort_shuffle_handle_and_the_window_the_bypass(tmp_path):
    table = _table(300)
    ctx = _context(tmp_path)
    kinds = []
    register = ctx.manager.register_shuffle

    def recording(shuffle_id, dep):
        handle = register(shuffle_id, dep)
        kinds.append((handle.kind, dep.map_side_combine, dep.num_partitions))
        return handle

    ctx.manager.register_shuffle = recording
    try:
        rollup, out = rollup_shuffle(ctx, gen.CODEC, gen.map_batches(table, 2), ("sum",), 200)
        rank_shuffle(ctx, [[b for p in out for b in p]], gen.CHAR50, 100, 200)
    finally:
        ctx.stop()
    assert kinds == [("base", True, 200), ("bypass-merge", False, 200)]


def test_the_q67_stages_add_their_own_keys_to_the_codec_timings(tmp_path):
    table = _table(400)
    ctx = _context(tmp_path, codec="tpu")
    try:
        ctx.manager.codec.timings = t = {}
        _rollup, out = rollup_shuffle(ctx, gen.CODEC, gen.map_batches(table, 2), ("sum",), 8)
        rank_shuffle(ctx, [[b for p in out for b in p]], gen.CHAR50, 100, 8)
    finally:
        ctx.stop()
    assert all(t.get(k, 0) > 0 for k in NEW_KEYS), {k: t.get(k) for k in NEW_KEYS}
    expanded = 9 * len(table["sales"])
    assert t["combine_rows_in"] == expanded
    groups = sum(b.n for p in out for b in p)
    # two maps' partials: at least every group once, fewer than the rows in
    assert groups <= t["combine_rows_out"] < expanded
    assert t["record_host_s"] > 0


def test_a_terasort_job_keeps_its_record_keys_and_gains_none(tmp_path):
    rng = np.random.default_rng(3)
    parts = [RecordBatch(np.full(500, 10, np.int32), np.full(500, 90, np.int32),
                         rng.integers(0, 256, 5000, dtype=np.uint8),
                         rng.integers(0, 256, 45000, dtype=np.uint8)) for _ in range(2)]
    ctx = _context(tmp_path, codec="tpu")
    try:
        ctx.manager.codec.timings = t = {}
        ctx.sort_by_key(parts, 4, serializer=ColumnarKVSerializer(), materialize="batches")
    finally:
        ctx.stop()
    assert t["record_host_s"] > 0
    assert not set(NEW_KEYS) & set(t)


def test_a_map_task_pulls_an_iterator_of_batches_batch_by_batch():
    made = []

    def batches():
        for i in range(3):
            made.append(i)
            yield RecordBatch.from_records([(bytes([i, j]), b"v") for j in range(5)])

    chunks = iter_record_batches(batches(), chunk_records=2)
    assert made == []
    first = next(chunks)
    assert made == [0] and first.n == 2
    rest = list(chunks)
    assert made == [0, 1, 2] and [c.n for c in [first] + rest] == [2, 2, 1] * 3
    # an iterator of (k, v) records is chunked as before
    recs = iter([(b"a", b"1"), (b"b", b"2"), (b"c", b"3")])
    assert [c.n for c in iter_record_batches(recs, chunk_records=2)] == [2, 1]
    assert list(iter_record_batches(iter([]))) == []


# --- the cell ---

def _run(trace_on):
    store = tempfile.mkdtemp(prefix="q67-test-store-")
    return harness.run_cell("tpcds-q67", SEED, 0.2, trace_on, time.perf_counter(), device="cpu",
                            overrides=SMALL, store=store, log=lambda *a, **k: None)


@pytest.mark.parametrize("trace_on", [False, True])
def test_a_small_run_of_the_cell_is_correct_and_reports_its_metrics(trace_on):
    spec = harness.load_cell("tpcds-q67")
    try:
        result = _run(trace_on)
    finally:
        trace.disable()
        trace.reset()
    assert result["correct"] is True, result["checks"]
    assert all(c["value"] == 0 for c in result["checks"].values())
    want = {m["name"] for m in (spec["per_layer"] if trace_on else spec["end_to_end"])}
    assert set(result["metrics"]) == want
    if trace_on:
        assert want == {"expand_host_s_per_gib.q67", "combine_host_s_per_gib.q67",
                        "combine_rows_ratio.q67"}
        assert 0 < result["metrics"]["combine_rows_ratio.q67"]["value"] < 1
    else:
        assert "shuffle_mib_s" in want
    assert all(m["value"] > 0 for m in result["metrics"].values())


@pytest.mark.parametrize("seed", [11, 12, 13])
def test_the_control_reads_wrong(seed):
    assert control.control_reading("tpcds-q67", seed, overrides=SMALL) > 0


# --- the generator at the configuration's sizes ---

def test_the_generator_holds_the_dimensions_at_sf1000():
    config = harness.load_cell("tpcds-q67")["config"]
    assert (config["item_rows"], config["store_rows"]) == (300_000, 1_002)
    item = gen.make_item(config["item_rows"], config["classes_per_category"],
                         config["brands_per_class"], config["item_null_rate"],
                         np.random.default_rng(SEED))
    assert all(len(item[c]) == 300_000 and item[c].dtype == np.dtype("S50")
               for c in reference.COLUMNS[:4])
    assert {bytes(c).rstrip() for c in np.unique(item["i_category"])} == \
        {c.encode() for c in gen.CATEGORIES} and len(gen.CATEGORIES) == 10
    assert len(np.unique(item["i_product_name"])) == 300_000
    assert len(np.unique(item["i_class"])) == config["classes_per_category"]
    for c in reference.COLUMNS[:4]:
        share = item[c + "_null"].mean()
        assert 0.005 < share < 0.015
    stores = gen.store_ids(config["store_rows"])
    assert len(stores) == 1_002 and stores.dtype == np.dtype("S16")
    assert all(len(bytes(s)) == 16 for s in stores)
    assert bytes(stores[0]) == b"AAAAAAAABAAAAAAA" and stores[0] == stores[1]


def test_the_joined_rows_are_year_2000_at_the_schema_widths():
    config = harness.load_cell("tpcds-q67")["config"]
    dates = gen.make_date_dim()
    jan_2000 = np.flatnonzero(dates["d_month_seq"] == 1200)
    assert (dates["d_year"][jan_2000] == 2000).all() and (dates["d_moy"][jan_2000] == 1).all()
    assert dates["d_date_sk"][jan_2000[0]] == 2451545  # 2000-01-01, TPC-DS's d_date_sk
    table = gen.make_joined(dict(config, rows_per_map=512), np.random.default_rng(SEED))
    assert len(table["sales"]) == config["maps"] * 512
    assert (table["d_year"] == 2000).all() and set(np.unique(table["d_qoy"])) <= {1, 2, 3, 4}
    assert (table["sales"] >= 0).all() and (table["sales"] == 0).any()
    assert gen.unit_work(config, None, {"table": table})["user_bytes"] == len(table["sales"]) * 236
    for batch in gen.map_batches(table, config["maps"]):
        assert (batch.klens == 228).all() and (batch.vlens == 8).all()
