"""TPC-DS q67's plain reference: the query over the joined rows, computed
with numpy on dictionary codes, and the judge of the port's answers.

The query (TPC-DS v2 query 67, qualification substitution DMS = 1200), from
the joined rows on:

    select * from (
      select i_category, i_class, i_brand, i_product_name, d_year, d_qoy,
             d_moy, s_store_id, sumsales,
             rank() over (partition by i_category order by sumsales desc) rk
      from (select ..., sum(coalesce(ss_sales_price * ss_quantity, 0)) sumsales
            from store_sales, date_dim, store, item
            where ... and d_month_seq between 1200 and 1211
            group by rollup(i_category, i_class, i_brand, i_product_name,
                            d_year, d_qoy, d_moy, s_store_id)) dw1) dw2
    where rk <= 100
    order by i_category, i_class, i_brand, i_product_name, d_year, d_qoy,
             d_moy, s_store_id, sumsales, rk
    limit 100

A joined table is a dict of the eight group-by columns (``bytes`` columns
as numpy ``S`` arrays at their CHAR widths, space padded; ints as int64)
with a ``<column>_null`` mask where a column has data NULLs, and
``sales``: ``coalesce(ss_sales_price * ss_quantity, 0)`` in cents (int64).

Each column becomes integer codes in value order with NULL as -1, so every
grouping set is a ``np.unique`` over the code rows (as one mixed-radix
number each); rolled-up columns are NULL
(-1), data NULLs too, and the grouping id (Spark's ``spark_grouping_id``:
bit 7 - j set when column j is rolled up) keeps the two apart. The window
partitions by ``i_category``'s value, so a data NULL category and the
grand total share a window partition, as in SQL. Ascending order puts NULL
first (Spark's default). Rows equal in all ten output columns (only a data
NULL beside a rollup NULL can make them so) are ordered by grouping id, a
tie SQL leaves open.

An answer row is ``(i_category, i_class, i_brand, i_product_name, d_year,
d_qoy, d_moy, s_store_id, sumsales, rk, gid)``, None for NULL.
"""

from __future__ import annotations

import collections

import numpy as np

COLUMNS = ("i_category", "i_class", "i_brand", "i_product_name", "d_year", "d_qoy", "d_moy",
           "s_store_id")


def _codes(table: dict, name: str):
    """(codes with NULL as -1, the values in code order) of one column."""
    col = table[name]
    values, codes = np.unique(col, return_inverse=True)
    codes = codes.ravel().astype(np.int64)
    nulls = table.get(name + "_null")
    if nulls is not None:
        codes[nulls] = -1
    return codes, values


def rollup_groups(table: dict):
    """Every group of the rollup: ``(codes (g, 8) with -1 for NULL, gid (g,),
    sumsales (g,))`` and the per-column value tables. A grouping set's rows
    are told apart by one mixed-radix number of their eight codes."""
    coded = [_codes(table, name) for name in COLUMNS]
    codes = np.stack([c for c, _v in coded], axis=1)
    radix = [len(v) + 1 for _c, v in coded]  # a code, or NULL
    if np.prod(radix, dtype=object) >= 2**63:
        raise ValueError("the eight columns' codes do not fit one int64")
    sales = np.asarray(table["sales"], dtype=np.int64)
    n_cols = len(COLUMNS)
    all_codes, all_gids, all_sums = [], [], []
    for kept in range(n_cols, -1, -1):
        gid = (1 << (n_cols - kept)) - 1
        rows = np.full((len(sales), n_cols), -1, dtype=np.int64)
        rows[:, :kept] = codes[:, :kept]
        number = np.zeros(len(sales), dtype=np.int64)
        for j in range(n_cols):
            number = number * radix[j] + rows[:, j] + 1
        _u, first, inverse = np.unique(number, return_index=True, return_inverse=True)
        # exact int64 sums (bincount's weights would be float64)
        sums = np.zeros(len(first), dtype=np.int64)
        np.add.at(sums, inverse.ravel(), sales)
        all_codes.append(rows[first])
        all_gids.append(np.full(len(first), gid, dtype=np.int64))
        all_sums.append(sums)
    return (np.concatenate(all_codes), np.concatenate(all_gids), np.concatenate(all_sums),
            [v for _c, v in coded])


def sql_rank(group: np.ndarray, order: np.ndarray) -> np.ndarray:
    """rank() over (partition by group order by order desc), one group at a
    time: 1 + the rows of the group with a larger value."""
    ranks = np.empty(len(group), dtype=np.int64)
    for g in np.unique(group):
        rows = np.flatnonzero(group == g)
        vals = order[rows]
        ordered = np.sort(vals)
        # rows strictly larger = len - (index of the first value > v)
        ranks[rows] = len(vals) - np.searchsorted(ordered, vals, side="right") + 1
    return ranks


def _row(codes, gid, sumsales, rk, tables):
    return tuple(None if c < 0 else (tables[j][c].item() if j in (4, 5, 6) else
                                     bytes(tables[j][c]))
                 for j, c in enumerate(codes.tolist())) + (int(sumsales), int(rk), int(gid))


def q67(table: dict, k: int = 100, limit: int = 100) -> dict:
    """The query's answer: ``rows`` (every category's rows with rk <= k, in
    the final order), ``top`` (the first ``limit`` of them) and ``sets``
    (gid -> (groups, sum of sumsales) of the rollup)."""
    codes, gids, sums, tables = rollup_groups(table)
    ranks = sql_rank(codes[:, 0], sums)
    keep = np.flatnonzero(ranks <= k)
    c, g, s, r = codes[keep], gids[keep], sums[keep], ranks[keep]
    # order by the eight columns (NULL = -1 first), sumsales, rk; then gid
    order = np.lexsort((g, r, s) + tuple(c[:, j] for j in range(c.shape[1] - 1, -1, -1)))
    rows = [_row(c[i], g[i], s[i], r[i], tables) for i in order.tolist()]
    sets = {int(x): (int(np.count_nonzero(gids == x)), int(sums[gids == x].sum()))
            for x in np.unique(gids)}
    return {"rows": rows, "top": rows[:limit], "sets": sets}


def judge_unit(answer: dict, expected: dict) -> int:
    """Rows and numbers wrong in one answer: the rows with rk <= k as a
    multiset (missing plus extra), the ordered first rows position by
    position (plus any difference in their count), and the grouping sets'
    (groups, sum) pairs that differ; 0 for a correct answer."""
    got = collections.Counter(answer["rows"])
    want = collections.Counter(expected["rows"])
    wrong = sum(((got - want) + (want - got)).values())
    top, want_top = answer["top"], expected["top"]
    wrong += abs(len(top) - len(want_top))
    wrong += sum(a != b for a, b in zip(top, want_top))
    sets, want_sets = answer["sets"], expected["sets"]
    wrong += sum(sets.get(gid) != pair for gid, pair in want_sets.items())
    wrong += len(set(sets) - set(want_sets))
    return wrong


def control_table(table: dict, rows_per_map: int) -> dict:
    """The control's input: the joined rows with the first map's counted
    twice (a map output read twice, or a retried map task committed
    twice)."""
    head = np.arange(min(rows_per_map, len(table["sales"])))
    return {name: np.concatenate([col, col[head]]) for name, col in table.items()}
