"""TPC-DS-shaped query pipelines over the port's typed record paths
(the JAX package's ``examples/sql_queries.py``, run over
``s3shuffle_tpu_torch``).

Each query is a real multi-stage pipeline (joins, aggregations, rank) over
synthetic tables with TPC-DS-like schemas. Every shuffle stage runs through
the full write and read planes (partitioned object writes, index and
checksum sidecars, prefetching reads, the configured codec; with
``--codec tpu`` the TLZ codec on kernels K1-K3), and the **shuffle-stage
wall-clock** is measured per query as the summed wall time of its shuffle
stages. The pipelines are columnar: numpy tables, typed order-preserving
key packing, the columnar aggregator's segmented reductions, vectorized
operators.

Semantics are verified: with verify on (the default) each query is
recomputed single-process in plain Python dict/loop form over the same
tables and the results must be equal.

Queries (simplified schemas, faithful shapes):
  q5   channel profit rollup: union sales+returns, aggregate per store — 1 stage
  q49  worst return ratios: join returns to sales on (item, order),
       per-item ratio aggregate, rank by ratio         — 3 shuffle stages
  q75  year-over-year decline: left-join returns, net by (year, item),
       cross-year cogroup, emit declines               — 3 shuffle stages
  q67  top items per category: sumsales by (category, item, store,
       month), one grouping set and not TPC-DS's rollup (that is
       portbench/generators/tpcds_q67.py), rank top K
       within category                                 — 2 shuffle stages
  q64  cross-channel repeat purchases: per-(item,year) and per-item
       aggregates, cogroup join, year self-join, growth sort
       (join-heavy profile)                            — 4 shuffle stages
  q95  returned-order analysis: order-level semi-join, per-store
       aggregate, total rollup (semi-join profile)     — 3 shuffle stages

``--codec`` takes a codec name (``tpu``, ``native``, ``zlib``, ...). The JAX
driver's ``tpu-hostpath`` label selects its codec's host fallback, which the
port does not have, and is refused. The rest of the config comes from
``S3SHUFFLE_*`` variables (e.g. ``S3SHUFFLE_CHECKSUM_ALGORITHM=CRC32C``).

Usage:
    python -m s3shuffle_tpu_torch.examples.sql_queries --query all --sf 0.1 --codec tpu
    python -m s3shuffle_tpu_torch.examples.sql_queries --query q49 --sf 0.1 --device cpu

Prints one JSON line per query:
    {"query": "q49", "codec": "tpu", "wall_s": ..,
     "shuffle_stage_wall_s": .., "shuffle_stages": 3, "rows_out": .., ...,
     "name": <card>, "power_limit": <card's limit>}
"""

from __future__ import annotations

import argparse
import json
import shutil
import sys
import tempfile
import time
from collections import defaultdict

import numpy as np

from s3shuffle_tpu_torch.examples import card_fields, config_codec
from s3shuffle_tpu_torch.structured import (
    KeyCodec,
    agg_shuffle,
    make_batch,
    sort_shuffle_batches,
    split_batch,
    window_group_limit,
)

N_MAPS = 4
N_REDUCERS = 6
TOP_K = 10

_I64 = np.int64


def _zeros(n):
    return np.zeros(n, dtype=_I64)


def _ones(n):
    return np.ones(n, dtype=_I64)


# ---------------------------------------------------------------------------
# Instrumented stages: every shuffle stage's wall time is accumulated, so the
# shuffle-stage wall-clock is a measured quantity.
# ---------------------------------------------------------------------------


class ColumnarStages:
    def __init__(self, ctx):
        self.ctx = ctx
        self.stage_seconds = 0.0
        self.stages = 0
        self.narrow_fallbacks = 0

    def agg_typed(self, codec, key_cols, val_cols, ops,
                  num_partitions=N_REDUCERS, map_side_combine=True,
                  val_dtypes=None):
        """Pack + aggregate with the declared narrow wire dtypes. The typed
        pack paths range-check (and dtype-check) every column and raise
        ``ValueError`` rather than silently wrap/truncate — correct, but a
        single out-of-range value at an unusual --sf/--skew must not abort a
        whole benchmark sweep: on pack failure the STAGE retries with wide
        int64 rows (and i64 keys), which cannot overflow, and the fallback is
        counted so the emitted row shows the narrow plane was bypassed."""
        try:
            batch = make_batch(codec, key_cols, val_cols, val_dtypes=val_dtypes)
        except ValueError as e:
            # Only RANGE overflow is recoverable by widening; dtype/arity
            # errors are caller bugs (and a float column would truncate just
            # as silently through the wide i64 path) — re-raise those.
            if "range" not in str(e):
                raise
            wide = KeyCodec(*("i64" if f == "i32" else f for f in codec.fields))
            print(f"narrow typed pack failed ({e}); retrying stage with wide "
                  "int64 rows", file=sys.stderr)
            self.narrow_fallbacks += 1
            batch = make_batch(wide, key_cols, val_cols)
            codec, val_dtypes = wide, None
        return self.agg(codec, batch, ops, num_partitions=num_partitions,
                        map_side_combine=map_side_combine,
                        val_dtypes=val_dtypes)

    def agg(self, codec, batch, ops, num_partitions=N_REDUCERS,
            map_side_combine=True, val_dtypes=None):
        t0 = time.perf_counter()
        out = agg_shuffle(
            self.ctx, codec, split_batch(batch, N_MAPS), ops,
            num_partitions=num_partitions, map_side_combine=map_side_combine,
            val_dtypes=val_dtypes,
        )
        self.stage_seconds += time.perf_counter() - t0
        self.stages += 1
        return out

    def sort(self, codec, batch, val_ncols, num_partitions=N_REDUCERS):
        t0 = time.perf_counter()
        out = list(sort_shuffle_batches(
            self.ctx, codec, split_batch(batch, N_MAPS), val_ncols,
            num_partitions=num_partitions,
        ))
        self.stage_seconds += time.perf_counter() - t0
        self.stages += 1
        return out


# ---------------------------------------------------------------------------
# Table generators (seeded, TPC-DS-ish distributions) — columnar numpy tables
# ---------------------------------------------------------------------------


def gen_tables(sf: float, seed: int = 17, skew: float = 0.0):
    """Synthetic star-schema slice as int64 column arrays. ``sf`` scales row
    counts linearly (sf=1 ≈ 200k sales rows). Prices are integer cents so
    sums stay exact and the shuffled pipelines agree with the single-process
    reference regardless of summation order.

    ``skew`` > 1 draws item/store ids from a Zipf(``skew``) law instead of
    uniform — the hot-key shape real TPC-DS data has (a few items dominate
    sales). The shuffled pipelines see heavy partition imbalance and long
    equal-key runs; semantics are unchanged (the ``--verify`` reference
    recomputes over the same skewed tables)."""
    rng = np.random.default_rng(seed)
    n_sales = int(200_000 * sf)
    n_items = max(50, int(2_000 * sf))
    n_stores = max(4, int(40 * sf))

    def _ids(n, domain):
        if skew > 1.0:
            # zipf is unbounded: fold the tail back into the domain (keeps
            # the head hot, preserves the domain size)
            return (rng.zipf(skew, n).astype(_I64) - 1) % domain
        return rng.integers(0, domain, n, dtype=_I64)

    order = np.arange(n_sales, dtype=_I64)
    sales = {
        "item": _ids(n_sales, n_items),
        "store": _ids(n_sales, n_stores),
        "order": order,
        "year": 2001 + (order & 1),
        "month": 1 + rng.integers(0, 12, n_sales, dtype=_I64),
        "qty": 1 + rng.integers(0, 10, n_sales, dtype=_I64),
        "price": rng.integers(100, 10_000, n_sales, dtype=_I64),
    }
    # ~8% of orders have a return of part of the quantity
    mask = rng.random(n_sales) < 0.08
    rq = 1 + np.floor(rng.random(int(mask.sum())) * sales["qty"][mask]).astype(_I64)
    returns = {
        "item": sales["item"][mask],
        "order": sales["order"][mask],
        "rq": rq,
        "ramt": rq * sales["price"][mask] * 9 // 10,
    }
    return sales, returns


# ---------------------------------------------------------------------------
# The queries — each returns (result, reference_fn). References are plain
# Python dict/loop recomputations over the same tables.
# ---------------------------------------------------------------------------

_K1 = KeyCodec("i64")
_K2 = KeyCodec("i64", "i64")
# Narrow typed-plane codecs: item/order/store/year/month all fit i32 at
# every benchmarked SF (pack range-checks and raises rather than wrap), and
# per-row value columns declare i1/i2/i4 wire widths — the reduce side widens
# to i64 before reducing, so only row inputs must fit. q75's stage-1 shuffle
# drops from 40 to 12 bytes/row.
_K1_32 = KeyCodec("i32")
_K2_32 = KeyCodec("i32", "i32")


def q5(st, sales, returns):
    """Channel profit rollup: sales minus returns per store, rolled up.
    One aggregate stage over the unioned fact stream."""
    s_amt = sales["qty"] * sales["price"]
    r_store = sales["store"][returns["order"]]  # returns join their sale's store
    nr = len(r_store)
    (store,), vals = st.agg_typed(
        _K1_32,
        (np.concatenate([sales["store"], r_store]),),
        (np.concatenate([s_amt, _zeros(nr)]),
         np.concatenate([_zeros(len(s_amt)), returns["ramt"]])),
        ("sum", "sum"),
        val_dtypes=("i4", "i4"),  # per-row amounts ≤ 100 000
    )
    order = np.argsort(store, kind="stable")
    result = [
        (int(s), int(a), int(r), int(a - r))
        for s, a, r in zip(store[order], vals[order, 0], vals[order, 1])
    ]

    def reference():
        acc = defaultdict(lambda: [0, 0])
        for s, a in zip(sales["store"].tolist(), s_amt.tolist()):
            acc[s][0] += a
        for s, r in zip(r_store.tolist(), returns["ramt"].tolist()):
            acc[s][1] += r
        return sorted((s, a, r, a - r) for s, (a, r) in acc.items())

    return result, reference


def q49(st, sales, returns):
    """Worst return ratios: join returns to sales on (item, order), per-item
    return ratio, rank worst TOP_K. Three stages: cogroup join (as a
    two-column sum over the tagged union), per-item aggregate, rank sort."""
    ns, nr = len(sales["item"]), len(returns["item"])
    # (item, order) groups have ≤ 2 rows (order is unique per sale) — the
    # cogroup join key is ~unique, so map-side combine is skipped
    (item1, _order1), v1 = st.agg_typed(
        _K2_32,
        (np.concatenate([sales["item"], returns["item"]]),
         np.concatenate([sales["order"], returns["order"]])),
        (np.concatenate([sales["qty"], _zeros(nr)]),      # sold
         np.concatenate([_zeros(ns), returns["rq"]])),    # returned
        ("sum", "sum"),
        map_side_combine=False,
        val_dtypes=("i1", "i1"),  # per-row qty/rq ≤ 10
    )
    hit = v1[:, 1] > 0  # inner join: only orders with a return
    (item2,), v2 = st.agg_typed(
        _K1_32, (item1[hit],), (v1[hit, 1], v1[hit, 0]), ("sum", "sum"),
        val_dtypes=("i2", "i2"),  # per-(item,order) sums ≤ 20
    )
    ratio = np.round(v2[:, 0] / v2[:, 1], 6)
    # ORDER BY ratio LIMIT TOP_K → TakeOrderedAndProject-style prune:
    # only rows that can reach the worst-TOP_K tail survive the rank sort
    keep = window_group_limit(_zeros(len(ratio)), ratio, TOP_K)
    ratio, item2 = ratio[keep], item2[keep]
    rank_codec = KeyCodec("f64", "i64")
    ranked = st.sort(rank_codec, make_batch(rank_codec, (ratio, item2), ()), 0)
    flat_ratio = np.concatenate([kc[0] for kc, _ in ranked]) if ranked else np.empty(0)
    flat_item = np.concatenate([kc[1] for kc, _ in ranked]) if ranked else np.empty(0)
    result = [
        (int(i), float(r))
        for r, i in zip(flat_ratio[-TOP_K:], flat_item[-TOP_K:])
    ][::-1]  # worst first

    def reference():
        sold_by = defaultdict(int)
        ret_by = defaultdict(int)
        sold_of_order = {}
        for i, o, q in zip(sales["item"].tolist(), sales["order"].tolist(),
                           sales["qty"].tolist()):
            sold_of_order[(i, o)] = q
        for i, o, rq in zip(returns["item"].tolist(), returns["order"].tolist(),
                            returns["rq"].tolist()):
            ret_by[i] += rq
            sold_by[i] += sold_of_order[(i, o)]
        ratios = sorted(
            (float(np.round(r / sold_by[i], 6)), i) for i, r in ret_by.items()
        )
        return [(i, ratio) for ratio, i in ratios[-TOP_K:]][::-1]

    return result, reference


def q75(st, sales, returns):
    """Year-over-year decline: net quantity per (year, item) after a left
    join with returns, then a cross-year cogroup reporting items whose net
    quantity declined. Three stages."""
    ns, nr = len(sales["item"]), len(returns["item"])
    # ~unique (item, order) join key → no map-side combine (see q49)
    (item1, _o), v1 = st.agg_typed(
        _K2_32,
        (np.concatenate([sales["item"], returns["item"]]),
         np.concatenate([sales["order"], returns["order"]])),
        (np.concatenate([sales["year"], _zeros(nr)]),   # year (max: sale's year)
         np.concatenate([sales["qty"], _zeros(nr)]),    # sold
         np.concatenate([_zeros(ns), returns["rq"]])),  # returned
        ("max", "sum", "sum"),
        map_side_combine=False,
        val_dtypes=("i2", "i1", "i1"),  # year ≤ 2002; per-row qty/rq ≤ 10
    )
    net = v1[:, 1] - v1[:, 2]
    (year2, item2), v2 = st.agg_typed(
        _K2_32, (v1[:, 0], item1), (net,), ("sum",),
        val_dtypes=("i2",),  # |net| ≤ 20 per (item,order)
    )
    is1 = (year2 == 2001).astype(_I64)
    is2 = (year2 == 2002).astype(_I64)
    (item3,), v3 = st.agg_typed(
        _K1_32, (item2,), (v2[:, 0] * is1, v2[:, 0] * is2, is1, is2),
        ("sum", "sum", "sum", "sum"),
        val_dtypes=("i4", "i4", "i1", "i1"),
    )
    hit = (v3[:, 2] > 0) & (v3[:, 3] > 0) & (v3[:, 1] < v3[:, 0])
    item_f, q1, q2 = item3[hit], v3[hit, 0], v3[hit, 1]
    order = np.argsort(item_f, kind="stable")  # items unique → total order
    result = [
        (int(i), int(a), int(b)) for i, a, b in zip(item_f[order], q1[order], q2[order])
    ]

    def reference():
        net_ref = defaultdict(int)
        ret_of = defaultdict(int)
        for i, o, rq in zip(returns["item"].tolist(), returns["order"].tolist(),
                            returns["rq"].tolist()):
            ret_of[(i, o)] += rq
        for i, o, y, q in zip(sales["item"].tolist(), sales["order"].tolist(),
                              sales["year"].tolist(), sales["qty"].tolist()):
            net_ref[(y, i)] += q - ret_of[(i, o)]
        out = []
        for i in {i for _y, i in net_ref}:
            a, b = net_ref.get((2001, i)), net_ref.get((2002, i))
            if a is not None and b is not None and b < a:
                out.append((i, a, b))
        return sorted(out)

    return result, reference


def q67(st, sales, returns):
    """Top items per category: sumsales by (category, item, store, month),
    one grouping set (TPC-DS q67's rollup is
    ``portbench/generators/tpcds_q67.py``) — the item→category dimension is
    a broadcast map-side join (cat = item % 10) — then rank within
    category, keep TOP_K. Two stages
    (aggregate + sort) with a vectorized streaming rank scan.

    Plan optimizations (semantics unchanged — ``--verify`` still checks
    exact equality against the plain-Python reference):
    - the category column is derivable (item % 10), so the rollup shuffles a
      3-column key and re-derives cat post-aggregation (-20% key bytes);
    - rollup groups are ~unique at scale (items × stores × months ≫ rows),
      so map-side combine is skipped — an argsort per map task that merges
      almost nothing (the planner-knows-cardinality call Spark makes when it
      picks obj-hash aggregation over sort-agg);
    - rank pushdown via :func:`window_group_limit` (Spark 3.5's
      WindowGroupLimitExec): only rows that can reach rank ≤ TOP_K within
      their category survive to the rank sort, collapsing the second shuffle
      from every rolled-up group to ~TOP_K·n_categories rows."""
    codec3 = KeyCodec("i32", "i32", "i32")
    (item1, store1, month1), v1 = st.agg_typed(
        codec3,
        (sales["item"], sales["store"], sales["month"]),
        (sales["qty"] * sales["price"],),
        ("sum",), map_side_combine=False,
        val_dtypes=("i4",),  # per-row amt = qty·price ≤ 100 000
    )
    cat1 = item1 % 10
    keep = window_group_limit(cat1, v1[:, 0], TOP_K)
    cat1, item1, store1, month1 = (
        cat1[keep], item1[keep], store1[keep], month1[keep],
    )
    v1 = v1[keep]
    codec5 = KeyCodec("i64", "i64", "i64", "i64", "i64")
    sort_in = make_batch(codec5, (cat1, -v1[:, 0], item1, store1, month1), ())
    batches = st.sort(codec5, sort_in, 0)
    # streaming vectorized rank-within-category over globally sorted batches
    result = []
    last_cat = None
    carry = 0
    for (bc, bneg, bitem, bstore, bmonth), _v in batches:
        n = len(bc)
        newrun = np.empty(n, dtype=bool)
        newrun[0] = last_cat is None or bc[0] != last_cat
        np.not_equal(bc[1:], bc[:-1], out=newrun[1:])
        run_start = np.zeros(n, dtype=_I64)
        idx = np.flatnonzero(newrun)
        run_start[idx] = idx
        np.maximum.accumulate(run_start, out=run_start)
        pos = np.arange(n, dtype=_I64) - run_start
        if not newrun[0]:
            # rows before the first boundary continue the previous batch's cat
            first_run_len = int(idx[0]) if len(idx) else n
            pos[:first_run_len] += carry
        keep = np.flatnonzero(pos < TOP_K)
        for i in keep.tolist():
            result.append((
                f"cat-{int(bc[i])}", int(bitem[i]), int(bstore[i]),
                int(bmonth[i]), int(-bneg[i]), int(pos[i]) + 1,
            ))
        last_cat = int(bc[-1])
        carry = int(pos[-1]) + 1

    def reference():
        acc = defaultdict(int)
        for i, s, m, q, p in zip(sales["item"].tolist(), sales["store"].tolist(),
                                 sales["month"].tolist(), sales["qty"].tolist(),
                                 sales["price"].tolist()):
            acc[(f"cat-{i % 10}", i, s, m)] += q * p
        rows = sorted(
            (c, -amt, i, s, m) for (c, i, s, m), amt in acc.items()
        )
        out = []
        r, last = 0, None
        for c, neg_amt, i, s, m in rows:
            r = r + 1 if c == last else 1
            last = c
            if r <= TOP_K:
                out.append((c, i, s, m, -neg_amt, r))
        return out

    return result, reference


def q64(st, sales, returns):
    """Cross-channel repeat purchases (q64's join-heavy profile): per
    (item, year) sales stats, per-item return stats, a cogroup join of the
    two, then a cross-year self-join emitting items whose 2002 amount grew.
    Four stages — the widest join pipeline in the suite."""
    (item1, year1), v1 = st.agg_typed(
        _K2_32, (sales["item"], sales["year"]),
        (sales["qty"], sales["qty"] * sales["price"]),
        ("sum", "sum"),
        val_dtypes=("i1", "i4"),  # per-row qty ≤ 10, amt ≤ 100 000
    )
    (item_r,), v_r = st.agg_typed(
        _K1_32, (returns["item"],), (returns["rq"],), ("sum",),
        val_dtypes=("i1",),
    )
    is1 = (year1 == 2001).astype(_I64)
    is2 = (year1 == 2002).astype(_I64)
    nj, nr = len(item1), len(item_r)
    cogroup = make_batch(
        _K1_32,
        (np.concatenate([item1, item_r]),),
        (np.concatenate([v1[:, 0] * is1, _zeros(nr)]),   # qty 2001
         np.concatenate([v1[:, 1] * is1, _zeros(nr)]),   # amt 2001
         np.concatenate([v1[:, 0] * is2, _zeros(nr)]),   # qty 2002
         np.concatenate([v1[:, 1] * is2, _zeros(nr)]),   # amt 2002
         np.concatenate([_zeros(nj), v_r[:, 0]]),        # returned qty
         np.concatenate([is1, _zeros(nr)]),              # has 2001
         np.concatenate([is2, _zeros(nr)])),             # has 2002
    )
    (item3,), m = st.agg(_K1_32, cogroup, ("sum",) * 7)
    hit = (m[:, 5] > 0) & (m[:, 6] > 0) & (m[:, 3] > m[:, 1])
    growth = m[hit, 3] - m[hit, 1]
    sort_in = make_batch(
        _K2, (growth, item3[hit]),
        (m[hit, 0], m[hit, 1], m[hit, 2], m[hit, 3], m[hit, 4]),
    )
    batches = st.sort(_K2, sort_in, 5)
    result = [
        (int(i), (int(r[0]), int(r[1])), (int(r[2]), int(r[3])), int(r[4]))
        for (_g, items), vals in batches
        for i, r in zip(items, vals)
    ]

    def reference():
        acc = defaultdict(lambda: [0, 0])
        for i, y, q, p in zip(sales["item"].tolist(), sales["year"].tolist(),
                              sales["qty"].tolist(), sales["price"].tolist()):
            acc[(i, y)][0] += q
            acc[(i, y)][1] += q * p
        rets = defaultdict(int)
        for i, rq in zip(returns["item"].tolist(), returns["rq"].tolist()):
            rets[i] += rq
        rows = []
        for i in {i for i, _y in acc}:
            y1 = acc.get((i, 2001))
            y2 = acc.get((i, 2002))
            if y1 and y2 and y2[1] > y1[1]:
                rows.append((y2[1] - y1[1], i, tuple(y1), tuple(y2), rets[i]))
        rows.sort()
        return [(i, y1, y2, ret) for _g, i, y1, y2, ret in rows]

    return result, reference


def q95(st, sales, returns):
    """Returned-order analysis (q95's semi-join profile): orders with a
    matching return (semi-join on order), aggregated per store — distinct
    order count, total quantity, total returned amount — plus a total rollup
    row. Three stages (cogroup semi-join, per-store aggregate, rollup)."""
    ns, nr = len(sales["order"]), len(returns["order"])
    # ~unique order semi-join key → no map-side combine (see q49)
    (_order1,), v1 = st.agg_typed(
        _K1_32,
        (np.concatenate([sales["order"], returns["order"]]),),
        (np.concatenate([_zeros(ns), returns["ramt"]]),   # returned amount
         np.concatenate([sales["store"], _zeros(nr)]),    # store (max: sale's)
         np.concatenate([sales["qty"], _zeros(nr)])),     # qty
        ("sum", "max", "sum"),
        map_side_combine=False,
        val_dtypes=("i4", "i4", "i1"),  # ramt ≤ 90 000; qty ≤ 10
    )
    hit = v1[:, 0] > 0  # semi-join: orders with at least one return
    (store2,), v2 = st.agg_typed(
        _K1_32, (v1[hit, 1],),
        (_ones(int(hit.sum())), v1[hit, 2], v1[hit, 0]),
        ("sum", "sum", "sum"),
        val_dtypes=("i1", "i2", "i4"),  # per-order count/qty/ramt
    )
    order2 = np.argsort(store2, kind="stable")
    agg_rows = [
        (int(s), (int(c), int(q), int(a)))
        for s, c, q, a in zip(store2[order2], v2[order2, 0], v2[order2, 1],
                              v2[order2, 2])
    ]
    rollup = make_batch(
        _K1_32, (_zeros(len(store2)),), (v2[:, 0], v2[:, 1], v2[:, 2])
    )
    (_z,), vt = st.agg(_K1_32, rollup, ("sum", "sum", "sum"), num_partitions=1)
    total_rows = (
        [("ALL", (int(vt[0, 0]), int(vt[0, 1]), int(vt[0, 2])))] if len(vt) else []
    )
    result = (agg_rows, total_rows)

    def reference():
        ret_amt_of = defaultdict(int)
        for o, a in zip(returns["order"].tolist(), returns["ramt"].tolist()):
            ret_amt_of[o] += a
        acc = defaultdict(lambda: [0, 0, 0])
        for o, s, q in zip(sales["order"].tolist(), sales["store"].tolist(),
                           sales["qty"].tolist()):
            ra = ret_amt_of.get(o)
            if ra:
                acc[s][0] += 1
                acc[s][1] += q
                acc[s][2] += ra
        agg_ref = sorted((s, tuple(v)) for s, v in acc.items())
        t = [0, 0, 0]
        for _s, (c, q, a) in agg_ref:
            t[0] += c
            t[1] += q
            t[2] += a
        return (agg_ref, [("ALL", tuple(t))] if agg_ref else [])

    return result, reference


QUERIES = {"q5": q5, "q49": q49, "q75": q75, "q67": q67, "q64": q64, "q95": q95}


def run_query(name: str, sf: float, codec: str, workers: int, verify: bool,
              root: str | None = None, root_uri: str | None = None,
              skew: float = 0.0, device=None) -> dict:
    """``root`` is a caller-owned local directory (tests); ``root_uri`` a
    storage root URI (file://, memory://, s3://, ...) so the pipelines can
    run against a real object store. ``device``: the CUDA device by
    default, ``"cpu"`` for the plain versions."""
    import uuid as _uuid

    from s3shuffle_tpu_torch.config import ShuffleConfig
    from s3shuffle_tpu_torch.device import resolve_device
    from s3shuffle_tpu_torch.shuffle import ShuffleContext
    from s3shuffle_tpu_torch.storage.dispatcher import Dispatcher

    dev = resolve_device(device)
    cfg_codec = config_codec(codec)
    tmp = None
    if root_uri:
        root_dir = f"{root_uri.rstrip('/')}/sql-{name}-{_uuid.uuid4().hex[:8]}"
    else:
        tmp = root or tempfile.mkdtemp(prefix=f"s3shuffle-sql-{name}-")
        root_dir = f"file://{tmp}"
    Dispatcher.reset()
    # S3SHUFFLE_* variables first (a deployment's checksum, store options),
    # the arguments over them
    cfg = ShuffleConfig.from_env(root_dir=root_dir, app_id=f"sql-{name}", codec=cfg_codec)
    sales, returns = gen_tables(sf, skew=skew)
    try:
        with ShuffleContext(config=cfg, num_workers=workers, device=dev) as ctx:
            st = ColumnarStages(ctx)
            t0 = time.perf_counter()
            result, reference = QUERIES[name](st, sales, returns)
            wall = time.perf_counter() - t0
        if verify:
            expected = reference()
            assert result == expected, (
                f"{name} result mismatch: {len(result)} rows vs "
                f"{len(expected)} expected"
            )
        return {
            "query": name,
            "codec": codec,
            "sf": sf,
            "rows_in": len(sales["order"]) + len(returns["order"]),
            "rows_out": len(result),
            "wall_s": round(wall, 3),
            "shuffle_stage_wall_s": round(st.stage_seconds, 3),
            "shuffle_stages": st.stages,
            "verified": bool(verify),
            **({"narrow_fallbacks": st.narrow_fallbacks}
               if st.narrow_fallbacks else {}),
            **({"skew": skew} if skew else {}),
            **card_fields(dev),
        }
    finally:
        if root is None and tmp is not None:
            shutil.rmtree(tmp, ignore_errors=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--query", default="all", choices=["all", *QUERIES])
    ap.add_argument("--sf", type=float, default=0.1,
                    help="scale factor (1 ≈ 200k sales rows)")
    ap.add_argument("--codec", default="auto",
                    help="codec name (tpu, native, lz4, zlib, zstd, none, auto)")
    ap.add_argument("--workers", type=int, default=4)
    ap.add_argument("--no-verify", action="store_true",
                    help="skip the single-process reference check "
                         "(use at large --sf)")

    def _skew(v):
        v = float(v)
        if 0.0 < v <= 1.0:
            raise argparse.ArgumentTypeError(
                "skew must be 0 (uniform) or > 1 (Zipf exponent)")
        return v

    ap.add_argument("--skew", type=_skew, default=0.0,
                    help="item/store id distribution: 0 = uniform, >1 = "
                         "Zipf(skew) hot-key law")
    ap.add_argument("--root", default=None,
                    help="storage root URI (file://, s3://, ...; "
                         "default: local temp dir)")
    ap.add_argument("--device", default=None,
                    help="torch device of the kernels (default: the CUDA device; "
                         "'cpu' runs their plain versions)")
    args = ap.parse_args(argv)
    names = list(QUERIES) if args.query == "all" else [args.query]
    for name in names:
        out = run_query(
            name, args.sf, args.codec, args.workers,
            verify=not args.no_verify, root_uri=args.root, skew=args.skew,
            device=args.device,
        )
        print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
