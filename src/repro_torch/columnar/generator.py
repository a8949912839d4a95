"""Synthetic column generators with KNOWN ground-truth NDV.

The paper's original evaluation data was lost; its claims are regime-level
(Table 1, "<10% error on well-spread", sorted-underestimation repair). These
generators produce every regime controllably, so EXPERIMENTS.md can validate
each claim against exact ground truth.

Each generator returns (values, true_ndv). Layout regimes:

  uniform       — i.i.d. uniform over ndv values -> well-spread
  zipf          — skewed frequencies, shuffled -> well-spread w/ heavy skew
                  (tests Eq 1's indifference to within-group frequency)
  sorted        — globally sorted -> sorted
  partitioned   — values clustered into contiguous key ranges per partition,
                  partition order shuffled -> pseudo-sorted / mixed
  clustered     — runs of repeated values (time-series-ish) -> mixed
  low_ndv       — tiny dictionaries (status codes / flags)
  unique        — all-distinct (IDs) -> triggers plain fallback at scale
"""
from __future__ import annotations

import dataclasses
import string
from typing import Callable, Dict, Optional, Tuple

import numpy as np

Column = Tuple[np.ndarray, int]  # (values, true_ndv)


def _rng(seed: int) -> np.random.Generator:
    return np.random.default_rng(seed)


# ---------------------------------------------------------------------------
# Value domains
# ---------------------------------------------------------------------------


def int_domain(ndv: int, spread: int = 10, seed: int = 0) -> np.ndarray:
    """ndv distinct int64 values, sparsely spread to avoid range-bound
    trivially pinning the estimate (Eq 14 should help, not answer)."""
    rng = _rng(seed)
    vals = rng.choice(ndv * spread, size=ndv, replace=False).astype(np.int64)
    return np.sort(vals)


def string_domain(
    ndv: int, mean_len: int = 12, seed: int = 0, dist: str = "geometric"
) -> np.ndarray:
    """ndv distinct strings.

    dist="geometric": heavy-tailed lengths (stresses Eq 4 — row-group
    extrema lengths are then unrepresentative and the paper's len estimate
    biases low; characterized in benchmarks/accuracy.py).
    dist="uniform": lengths in [mean_len-4, mean_len+4] (representative
    extrema — the regime the paper's <10% claim assumes).
    """
    rng = _rng(seed)
    alphabet = np.array(list(string.ascii_lowercase + string.digits))
    out = set()
    while len(out) < ndv:
        if dist == "uniform":
            length = int(rng.integers(max(mean_len - 4, 2), mean_len + 5))
        else:
            length = max(int(rng.geometric(1.0 / mean_len)), 2)
        out.add("".join(rng.choice(alphabet, size=length)))
    return np.sort(np.array(list(out)))


def float_domain(ndv: int, seed: int = 0) -> np.ndarray:
    rng = _rng(seed)
    return np.sort(rng.standard_normal(ndv) * 1e3).astype(np.float64)


# ---------------------------------------------------------------------------
# Frequency / layout generators (domain-agnostic)
# ---------------------------------------------------------------------------


def uniform_column(domain: np.ndarray, rows: int, seed: int = 0) -> Column:
    rng = _rng(seed)
    idx = rng.integers(0, domain.size, size=rows)
    # Guarantee every domain value appears at least once when rows >> ndv
    # (true NDV == domain size); otherwise true ndv is whatever was drawn.
    vals = domain[idx]
    return vals, int(np.unique(idx).size)


def zipf_column(
    domain: np.ndarray, rows: int, s: float = 1.2, seed: int = 0
) -> Column:
    rng = _rng(seed)
    ranks = np.arange(1, domain.size + 1, dtype=np.float64)
    p = ranks ** (-s)
    p /= p.sum()
    idx = rng.choice(domain.size, size=rows, p=p)
    return domain[idx], int(np.unique(idx).size)


def sorted_column(domain: np.ndarray, rows: int, seed: int = 0) -> Column:
    vals, ndv = uniform_column(domain, rows, seed)
    return np.sort(vals), ndv


def partitioned_column(
    domain: np.ndarray,
    rows: int,
    partitions: int = 16,
    shuffle_partitions: bool = True,
    seed: int = 0,
) -> Column:
    """Contiguous key ranges per partition (hive-style), partition order
    optionally shuffled. Within a partition values are i.i.d. uniform."""
    rng = _rng(seed)
    dom_parts = np.array_split(np.arange(domain.size), partitions)
    row_parts = np.array_split(np.arange(rows), partitions)
    order = np.arange(partitions)
    if shuffle_partitions:
        rng.shuffle(order)
    chunks = []
    seen = set()
    for p in order:
        d = dom_parts[p]
        r = row_parts[p].size
        if d.size == 0 or r == 0:
            continue
        idx = d[rng.integers(0, d.size, size=r)]
        seen.update(np.unique(idx).tolist())
        chunks.append(domain[idx])
    return np.concatenate(chunks), len(seen)


def clustered_column(
    domain: np.ndarray, rows: int, mean_run: int = 64, seed: int = 0
) -> Column:
    """Runs of repeated values — sensor/time-series-like locality."""
    rng = _rng(seed)
    out = np.empty(rows, dtype=domain.dtype)
    pos = 0
    seen = set()
    while pos < rows:
        v = int(rng.integers(0, domain.size))
        run = min(max(int(rng.exponential(mean_run)), 1), rows - pos)
        out[pos : pos + run] = domain[v]
        seen.add(v)
        pos += run
    return out, len(seen)


def unique_column(rows: int, seed: int = 0) -> Column:
    rng = _rng(seed)
    vals = rng.permutation(rows).astype(np.int64) * 7 + 13
    return vals, rows


# ---------------------------------------------------------------------------
# Regime suite used by tests/benchmarks
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class ColumnSpec:
    """A generated column with its expected layout regime."""

    name: str
    regime: str            # uniform|zipf|sorted|partitioned|clustered|low|unique
    dtype: str             # int|str|float
    ndv: int
    rows: int
    seed: int = 0
    extra: Optional[dict] = None

    def generate(self) -> Column:
        if self.regime == "unique":
            return unique_column(self.rows, self.seed)
        if self.dtype == "int":
            dom = int_domain(self.ndv, seed=self.seed)
        elif self.dtype == "str":
            mean_len = (self.extra or {}).get("mean_len", 12)
            dom = string_domain(self.ndv, mean_len=mean_len, seed=self.seed)
        else:
            dom = float_domain(self.ndv, seed=self.seed)
        x = dict(self.extra or {})
        x.pop("mean_len", None)
        gen: Dict[str, Callable[..., Column]] = {
            "uniform": uniform_column,
            "zipf": zipf_column,
            "sorted": sorted_column,
            "partitioned": partitioned_column,
            "clustered": clustered_column,
            "low": uniform_column,
        }
        return gen[self.regime](dom, self.rows, seed=self.seed, **x)


def standard_suite(rows: int = 1 << 18, seed: int = 0) -> list[ColumnSpec]:
    """The benchmark suite: every regime x dtype x cardinality band."""
    specs = []
    bands = {"small": 100, "medium": 5_000, "large": 100_000}
    for regime in ("uniform", "zipf", "sorted", "partitioned", "clustered"):
        for dtype in ("int", "str"):
            for band, ndv in bands.items():
                specs.append(
                    ColumnSpec(
                        name=f"{regime}_{dtype}_{band}",
                        regime=regime,
                        dtype=dtype,
                        ndv=ndv,
                        rows=rows,
                        seed=seed + hash((regime, dtype, band)) % 1000,
                    )
                )
    specs.append(ColumnSpec("low_int_flags", "low", "int", 8, rows, seed))
    specs.append(ColumnSpec("unique_ids", "unique", "int", rows, rows, seed))
    return specs
