"""TPC-DS q67 units through the port's ranked rollup: one query at a time
(a closed loop) over joined rows made once from the seed.

Set-up (:func:`make_inputs`) draws the tables q67 reads at TPC-DS's widths
(every text column a CHAR, space padded to its width, as Spark 3.4 and
later read CHAR): ``item`` (``i_item_sk`` and four CHAR(50) columns),
``store`` (``s_store_sk``, ``s_store_id`` CHAR(16)), ``date_dim`` over
store_sales' sold dates (1998-01-02 to 2003-01-02; ``d_date_sk`` is the
Julian day number, ``d_month_seq`` 1200 is January 2000) and store_sales
rows (``ss_sold_date_sk``, ``ss_item_sk``, ``ss_store_sk``, ``ss_quantity``
1-100, ``ss_sales_price`` decimal(7,2) in cents, either NULL at a small
rate). It then applies the date filter and the three broadcast joins,
which are Spark's scan side and not the shuffle's, until it holds
``maps * rows_per_map`` joined rows, cut into ``maps`` map inputs.

A unit (:func:`run_unit`) is one q67:

1. the rollup aggregate (``structured.rollup_shuffle``): each map task
   expands its rows into the 9 grouping sets into the map-side combine,
   hash partitioned into ``reducers`` partitions (the sort-shuffle handle);
2. the window exchange (``structured.rank_shuffle``): the aggregate's
   partitions in ``maps`` map tasks, each pruned to the rows that can rank
   within ``k`` in their category, hashed on ``i_category`` into
   ``reducers`` partitions (the bypass handle), and ranked per partition;
3. in the calling thread, the ``order by`` over the ten output columns and the
   ``limit``.

The value distributions dsdgen would draw are the configuration's
``assumed`` ones; the reference is ``portbench/reference/tpcds_q67.py``.
"""

from __future__ import annotations

import datetime

import numpy as np

from portbench.reference import tpcds_q67 as reference
from s3shuffle_tpu_torch.batch import RecordBatch
from s3shuffle_tpu_torch.structured import (  # noqa: F401  (a parent without them fails here)
    KeyCodec,
    Rollup,
    make_batch,
    rank_shuffle,
    rollup_shuffle,
    values_matrix,
)

CHAR50, STORE_ID = 50, 16
#: the schema's widths of one joined row: four CHAR(50), three ints, the
#: CHAR(16) store id, and the 8-byte sum
USER_ROW_BYTES = 4 * CHAR50 + 3 * 4 + STORE_ID + 8
CODEC = KeyCodec(("bytes", CHAR50), ("bytes", CHAR50), ("bytes", CHAR50), ("bytes", CHAR50),
                 "i32", "i32", "i32", ("bytes", STORE_ID))

#: TPC-DS's ten ``i_category`` values
CATEGORIES = ("Books", "Children", "Electronics", "Home", "Jewelry", "Men", "Music", "Shoes",
              "Sports", "Women")
CLASS_WORDS = ("accessories", "athletic", "classical", "computers", "dresses", "fiction",
               "fragrances", "infants", "kids", "mens", "pants", "rings", "shirts", "swimwear",
               "televisions", "womens")
BRAND_WORDS = ("amalg", "edu pack", "export", "import", "scholar", "univ", "brand", "corp",
               "maxi", "nameless")
#: dsdgen's syllables of ``i_product_name``, one per decimal digit of the item
SYLLABLES = ("bar", "ought", "able", "pri", "ese", "anti", "cally", "ation", "eing", "n st")
FIRST_SOLD = datetime.date(1998, 1, 2)
LAST_SOLD = datetime.date(2003, 1, 2)
JULIAN_1970 = 2440588  # the Julian day number of 1970-01-01


def _char(texts, width: int) -> np.ndarray:
    return np.array([t.encode().ljust(width) for t in texts], dtype=f"S{width}")


def make_item(n: int, classes: int, brands: int, null_rate: float, rng) -> dict:
    """``item`` by ``i_item_sk - 1``: each item's class lies in its category
    and its brand in its class; the product name spells the item's number
    in dsdgen's syllables; each text column is NULL at ``null_rate``."""
    cat = rng.integers(0, len(CATEGORIES), n)
    cls = cat * classes + rng.integers(0, classes, n)
    brand = cls * brands + rng.integers(0, brands, n)
    words = len(CLASS_WORDS)
    class_names = _char([CLASS_WORDS[j % words] + (f" {j // words}" if j >= words else "")
                         for _c in CATEGORIES for j in range(classes)], CHAR50)
    brand_names = _char([f"{BRAND_WORDS[b // 100 % 10]}{BRAND_WORDS[b // 10 % 10]} #{b % 10 + 1}"
                         + (f" {b // 1000}" if b >= 1000 else "")
                         for b in range(len(CATEGORIES) * classes * brands)], CHAR50)
    products = _char(["".join(SYLLABLES[int(d)] for d in str(sk)) for sk in range(1, n + 1)],
                     CHAR50)
    table = {"i_category": _char(CATEGORIES, CHAR50)[cat], "i_class": class_names[cls],
             "i_brand": brand_names[brand], "i_product_name": products}
    for name in list(table):
        table[name + "_null"] = rng.random(n) < null_rate
    return table


def store_ids(n: int) -> np.ndarray:
    """``s_store_id`` by ``s_store_sk - 1``: dsdgen's business keys (eight
    ``A``, then the key's eight hex digits, lowest first, as ``A``-``P``),
    each shared by two store rows (a store's two revisions)."""
    keys = (np.arange(n) + 2) // 2
    digits = (keys[:, None] >> (4 * np.arange(8))) & 0xF
    chars = np.full((n, STORE_ID), ord("A"), dtype=np.uint8)
    chars[:, 8:] = ord("A") + digits
    return chars.view(f"S{STORE_ID}").ravel()


def make_date_dim() -> dict:
    """``date_dim`` over the sold dates, by ``d_date_sk - first``."""
    days = np.arange(np.datetime64(FIRST_SOLD), np.datetime64(LAST_SOLD) + 1)
    months = days.astype("datetime64[M]").astype(np.int64)  # months since 1970-01
    year = months // 12 + 1970
    moy = months % 12 + 1
    return {"d_date_sk": days.astype(np.int64) + JULIAN_1970,
            "d_month_seq": (year - 1900) * 12 + moy - 1, "d_year": year,
            "d_qoy": (moy - 1) // 3 + 1, "d_moy": moy}


def make_joined(config: dict, rng) -> dict:
    """The joined, filtered rows of one unit: ``maps * rows_per_map`` of
    them, in the reference's table layout."""
    want = config["maps"] * config["rows_per_map"]
    item = make_item(config["item_rows"], config["classes_per_category"],
                     config["brands_per_class"], config["item_null_rate"], rng)
    stores = store_ids(config["store_rows"])
    dates = make_date_dim()
    first_sk = int(dates["d_date_sk"][0])
    parts = []
    held = 0
    while held < want:
        n = 2 * want
        sold = rng.integers(0, len(dates["d_date_sk"]), n)
        seq = dates["d_month_seq"][sold]
        keep = (seq >= config["month_seq_first"]) & (seq <= config["month_seq_first"] + 11)
        sold = sold[keep]
        m = len(sold)
        qty = rng.integers(1, 101, m)
        # decimal(7,2) in cents: wholesale 1.00-100.00, list 1-3x that,
        # sold at 0-100 % of list
        wholesale = rng.integers(100, 10001, m)
        price = (wholesale * rng.uniform(1.0, 3.0, m) * rng.random(m)).astype(np.int64)
        null = rng.random(m) < config["sales_null_rate"]
        null |= rng.random(m) < config["sales_null_rate"]
        parts.append({"date": sold + first_sk, "item": rng.integers(1, config["item_rows"] + 1, m),
                      "store": rng.integers(1, config["store_rows"] + 1, m),
                      "sales": np.where(null, 0, price * qty)})
        held += m
    fact = {k: np.concatenate([p[k] for p in parts])[:want] for k in parts[0]}
    d, i, s = fact["date"] - first_sk, fact["item"] - 1, fact["store"] - 1
    table = {name: item[name][i] for name in item}
    table.update(d_year=dates["d_year"][d], d_qoy=dates["d_qoy"][d], d_moy=dates["d_moy"][d],
                 s_store_id=stores[s], sales=fact["sales"].astype(np.int64))
    return table


def map_batches(table: dict, maps: int) -> list:
    """The port's map inputs: one batch of ``CODEC`` keys (a data NULL as
    the empty string) and the sales value per map."""
    text = {name: np.where(table[name + "_null"], b"", table[name])
            for name in reference.COLUMNS[:4]}
    cols = [text[n] for n in reference.COLUMNS[:4]] + \
        [table[n] for n in reference.COLUMNS[4:]]
    n = len(table["sales"])
    bounds = [n * m // maps for m in range(maps + 1)]
    return [make_batch(CODEC, [c[lo:hi] for c in cols], [table["sales"][lo:hi]])
            for lo, hi in zip(bounds[:-1], bounds[1:])]


def make_inputs(config, traffic, seed):
    table = make_joined(config, np.random.default_rng(seed))
    return {"table": table, "parts": map_batches(table, config["maps"])}


def unit_work(config, traffic, inputs):
    return {"user_bytes": len(inputs["table"]["sales"]) * USER_ROW_BYTES}


def answer_rows(rollup: Rollup, ranked) -> list:
    """The ranked rows as the reference's tuples, in the final order: the
    eight columns' key bytes (NULL first), sumsales, rk, then gid."""
    batches = [(b, r) for b, r in ranked if b.n]
    if not batches:
        return []
    keys = np.concatenate([np.asarray(b.keys).reshape(b.n, -1) for b, _r in batches])
    sums = np.concatenate([values_matrix(b, 1)[:, 0] for b, _r in batches])
    ranks = np.concatenate([r for _b, r in batches])
    width = CODEC.width
    prefix = np.ascontiguousarray(keys[:, :width]).view(f"S{width}").ravel()
    gid_bytes = np.ascontiguousarray(keys[:, width:]).view(">u4").ravel()
    order = np.lexsort((gid_bytes, ranks, sums, prefix))
    keys = np.ascontiguousarray(keys[order])
    cols, nulls, gid = rollup.decode(RecordBatch.from_fixed(len(order), width + 4, 0,
                                                            keys.ravel(), np.empty(0, np.uint8)))
    rows = []
    for i, j in enumerate(order.tolist()):
        row = tuple(None if nulls[c][i] else (bytes(cols[c][i]) if c in (0, 1, 2, 3, 7)
                                              else int(cols[c][i])) for c in range(len(cols)))
        rows.append(row + (int(sums[j]), int(ranks[j]), int(gid[i])))
    return rows


def grouping_sets(rollup_out) -> dict:
    """gid -> (groups, sum of sumsales) over the rollup's output."""
    width = CODEC.width
    batches = [b for partition in rollup_out for b in partition if b.n]
    if not batches:
        return {}
    gid = np.concatenate([np.ascontiguousarray(np.asarray(b.keys).reshape(b.n, -1)[:, width:])
                          .view(">u4").ravel() for b in batches]).astype(np.int64) - (1 << 31)
    sums = np.concatenate([values_matrix(b, 1)[:, 0] for b in batches])
    gids, which = np.unique(gid, return_inverse=True)
    totals = np.zeros(len(gids), dtype=np.int64)
    np.add.at(totals, which.ravel(), sums)
    counts = np.bincount(which.ravel(), minlength=len(gids))
    return {int(g): (int(c), int(t)) for g, c, t in zip(gids, counts, totals)}


def run_unit(ctx, config, traffic, inputs):
    reducers, maps, k = config["reducers"], config["maps"], config["rank_limit"]
    rollup, out = rollup_shuffle(ctx, CODEC, inputs["parts"], ("sum",), reducers)
    # the window exchange's map tasks: the aggregate's partitions in ``maps``
    # contiguous runs (AQE's coalescing)
    bounds = [reducers * m // maps for m in range(maps + 1)]
    window_inputs = [[b for p in out[lo:hi] for b in p] for lo, hi in zip(bounds[:-1],
                                                                          bounds[1:])]
    ranked = rank_shuffle(ctx, window_inputs, CHAR50, k, reducers)
    rows = answer_rows(rollup, ranked)
    return {"rows": rows, "top": rows[:config["limit"]], "sets": grouping_sets(out)}


def judge(config, traffic, inputs, answers):
    expected = reference.q67(inputs["table"], config["rank_limit"], config["limit"])
    return sum(reference.judge_unit(answer, expected) for answer in answers)


def control(config, traffic, inputs):
    return reference.q67(reference.control_table(inputs["table"], config["rows_per_map"]),
                         config["rank_limit"], config["limit"])
