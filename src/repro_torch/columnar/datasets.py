"""Benchmark-style dataset suites (TPC-H-shaped lineitem columns).

The paper's production evaluation ran on real warehouse tables; this module
reconstructs the CLASSIC column shapes those tables exhibit — with exact
ground truth — so EXPERIMENTS can report per-column-kind accuracy the way a
warehouse user would encounter it:

  l_orderkey       clustered ascending int (4 rows per order)   ~sorted
  l_partkey        uniform FK int                               well-spread
  l_suppkey        uniform FK int, small domain                 well-spread
  l_quantity       1..50                                        low NDV
  l_extendedprice  ~continuous float -> near-unique             plain fallback
  l_discount       11 distinct decimals                         low NDV
  l_returnflag     3 single-char flags                          Eq 15 bound
  l_shipdate       dates over ~7 years, order-correlated        pseudo-sorted
  l_comment        random strings                               near-unique
"""
from __future__ import annotations

from typing import Dict, Tuple

import numpy as np

Column = Tuple[np.ndarray, int]


def lineitem(rows: int = 1 << 17, seed: int = 0) -> Dict[str, Column]:
    rng = np.random.default_rng(seed)
    orders = rows // 4
    orderkey = np.repeat(np.arange(1, orders + 1, dtype=np.int64) * 4, 4)[:rows]

    partkey = rng.integers(1, 20000, rows).astype(np.int64)
    suppkey = rng.integers(1, 1000, rows).astype(np.int64)
    quantity = rng.integers(1, 51, rows).astype(np.int64)
    price = np.round(rng.uniform(900.0, 104949.5, rows), 2)
    discount = np.round(rng.integers(0, 11, rows) / 100.0, 2)
    returnflag = rng.choice(np.array(["A", "N", "R"]), rows)
    base = np.datetime64("1992-01-01").astype(np.int64)
    ship_offset = (orderkey / orderkey.max() * 2400).astype(np.int64)
    shipdate = (base + ship_offset + rng.integers(0, 90, rows)).astype(np.int64)

    alphabet = np.array(list("abcdefghijklmnopqrstuvwxyz "))
    comments = np.array([
        "".join(rng.choice(alphabet, size=rng.integers(12, 30)))
        for _ in range(rows // 16)
    ])
    comment = comments[rng.integers(0, len(comments), rows)]

    def truth(v) -> int:
        return int(np.unique(v).size)

    cols = {
        "l_orderkey": orderkey, "l_partkey": partkey, "l_suppkey": suppkey,
        "l_quantity": quantity, "l_extendedprice": price,
        "l_discount": discount, "l_returnflag": returnflag,
        "l_shipdate": shipdate, "l_comment": comment,
    }
    return {k: (v, truth(v)) for k, v in cols.items()}
