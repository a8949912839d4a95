"""Core datatypes for zero-cost NDV estimation.

The estimator consumes *only* file metadata: per-column-chunk uncompressed
sizes, row counts, null counts, and per-row-group min/max statistics. These
types mirror what a columnar footer (Parquet / ORC / PQLite) exposes, in a
batched struct-of-arrays layout so that thousands of columns (millions of
chunks) can be estimated in one vectorized pass.

Granularity note: Eq 1's ``total_uncompressed_size`` is a PER-COLUMN-CHUNK
field (one chunk per row group per column). Dictionary inversion therefore
runs per chunk and the column-level estimate aggregates chunk estimates by
max — tight when distinct values are well-spread across row groups, an
underestimate for sorted layouts (paper Table 1).
"""
from __future__ import annotations

import dataclasses
import enum
from typing import Dict, Mapping, Optional, Sequence

import numpy as np
import torch


class Layout(enum.IntEnum):
    """Data-layout classes produced by the distribution detector (paper §6.2)."""

    WELL_SPREAD = 0
    SORTED = 1
    PSEUDO_SORTED = 2
    MIXED = 3


class PhysicalType(enum.IntEnum):
    """Physical column types, as a columnar format would record them."""

    INT32 = 0
    INT64 = 1
    FLOAT32 = 2
    FLOAT64 = 3
    BYTE_ARRAY = 4  # variable-length (strings / binary)
    FIXED_LEN_BYTE_ARRAY = 5
    DATE32 = 6
    TIMESTAMP64 = 7
    BOOL = 8

    @property
    def fixed_width(self) -> Optional[int]:
        return {
            PhysicalType.INT32: 4,
            PhysicalType.INT64: 8,
            PhysicalType.FLOAT32: 4,
            PhysicalType.FLOAT64: 8,
            PhysicalType.DATE32: 4,
            PhysicalType.TIMESTAMP64: 8,
            PhysicalType.BOOL: 1,
        }.get(self)

    @property
    def is_integer_like(self) -> bool:
        """Types for which the range bound ndv <= max-min+1 applies (Eq 14)."""
        return self in (
            PhysicalType.INT32,
            PhysicalType.INT64,
            PhysicalType.DATE32,
            PhysicalType.BOOL,
        )


@dataclasses.dataclass(frozen=True)
class ColumnMetadata:
    """Everything the estimator may read for ONE column of ONE file.

    All fields come from footer metadata; none require touching data pages.
    Per-row-group arrays have shape (n,) with n = num_row_groups.

    Attributes:
      chunk_sizes: per-chunk ``total_uncompressed_size`` (dictionary page +
        data pages before compression) — Eq 1's S, per chunk.
      chunk_rows / chunk_nulls: per-chunk value and null counts.
      chunk_dict_encoded: per-chunk bit — False where the writer recorded a
        plain-encoding fallback for that chunk.
      mins / maxs: per-row-group min/max statistics as float64 *keys*
        (numeric value for numeric types; order-preserving 8-byte prefix for
        byte arrays).
      min_lengths / max_lengths: byte lengths of the min/max values.
      distinct_min_count / distinct_max_count: m_min, m_max — number of
        distinct min (max) values across row groups (computed exactly for
        small n, via HLL sketch at fleet scale).
      min_reprs / max_reprs: optional per-row-group human-readable stat
        values. Not consumed by the estimator; carried so that cross-file
        merging (repro.catalog.merge) can dedup BYTE_ARRAY statistics that
        collide in the truncated 8-byte key space.
      physical_type: the column's physical type.
    """

    chunk_sizes: np.ndarray
    chunk_rows: np.ndarray
    chunk_nulls: np.ndarray
    chunk_dict_encoded: np.ndarray
    mins: np.ndarray
    maxs: np.ndarray
    min_lengths: np.ndarray
    max_lengths: np.ndarray
    distinct_min_count: float
    distinct_max_count: float
    physical_type: PhysicalType
    column_name: str = ""
    min_reprs: Optional[np.ndarray] = None
    max_reprs: Optional[np.ndarray] = None

    @property
    def num_row_groups(self) -> int:
        return int(np.asarray(self.chunk_sizes).size)

    @property
    def total_uncompressed_size(self) -> float:
        return float(np.sum(self.chunk_sizes))

    @property
    def num_values(self) -> float:
        return float(np.sum(self.chunk_rows))

    @property
    def null_count(self) -> float:
        return float(np.sum(self.chunk_nulls))

    @property
    def non_null(self) -> float:
        return self.num_values - self.null_count


@dataclasses.dataclass(frozen=True)
class NDVEstimate:
    """Result of hybrid estimation for one column (paper §7)."""

    ndv: float                  # final hybrid estimate (Eq 13 + bounds)
    ndv_dict: float             # dictionary-inversion estimate (§4)
    ndv_minmax: float           # coupon-collector estimate (§5)
    layout: Layout              # detector classification (§6.2)
    is_lower_bound: bool        # plain-encoding fallback / saturation
    mean_len: float             # len used for inversion (Eq 4 or schema width)
    len_sample_size: int        # |V|, reliability indicator for len
    overlap_ratio: float        # detector metric (Eq 11)
    monotonicity: float         # detector metric (Eq 12)
    confidence: float           # heuristic 0-1 quality score
    column_name: str = ""

    @property
    def relative_error(self) -> Optional[float]:
        return None


@dataclasses.dataclass
class ColumnBatch:
    """Struct-of-arrays metadata for B columns with up to R row groups each.

    The layout the estimator modules and the CUDA kernels consume: a plain
    dataclass of 17 torch tensors, all on one device. Ragged row-group counts
    are padded to R with ``valid`` masks.
    """

    chunk_S: torch.Tensor            # (B, R) float32 — per-chunk size (Eq 1 S)
    chunk_rows: torch.Tensor         # (B, R) float32
    chunk_nulls: torch.Tensor        # (B, R) float32
    chunk_dict_encoded: torch.Tensor  # (B, R) bool
    N: torch.Tensor                  # (B,) float32 — total row count
    nulls: torch.Tensor              # (B,) float32
    n_groups: torch.Tensor           # (B,) int32 — row groups per column
    mins: torch.Tensor               # (B, R) float32 key space
    maxs: torch.Tensor               # (B, R) float32
    valid: torch.Tensor              # (B, R) bool — row-group mask
    m_min: torch.Tensor              # (B,) float32 — distinct min count
    m_max: torch.Tensor              # (B,) float32 — distinct max count
    mean_len: torch.Tensor           # (B,) float32 — Eq 4 (or schema width)
    len_sample: torch.Tensor         # (B,) int32 — |V|
    fixed_width: torch.Tensor        # (B,) bool
    int_like: torch.Tensor           # (B,) bool — Eq 14 applies
    single_byte: torch.Tensor        # (B,) bool — Eq 15 applies

    @property
    def batch(self) -> int:
        return int(self.chunk_S.shape[0])

    @property
    def max_groups(self) -> int:
        return int(self.chunk_S.shape[1])

    @property
    def device(self) -> torch.device:
        return self.chunk_S.device

    def fields(self) -> Dict[str, torch.Tensor]:
        return {f.name: getattr(self, f.name) for f in dataclasses.fields(self)}

    def to(self, device) -> "ColumnBatch":
        """The same batch with every tensor on `device` (one copy each)."""
        return ColumnBatch(**{k: v.to(device) for k, v in self.fields().items()})

    def slice(self, start: int, stop: int) -> "ColumnBatch":
        """Lanes [start, stop) of the B axis, as views."""
        return ColumnBatch(**{k: v[start:stop] for k, v in self.fields().items()})

    @classmethod
    def from_columns(cls, cols: Sequence[ColumnMetadata]) -> "ColumnBatch":
        """Pack per-column metadata into padded struct-of-arrays.

        Delegates to ``repro_torch.catalog.packer.BatchPacker`` with shape
        bucketing disabled: (B, R) == (len(cols), max row groups).
        """
        from repro_torch.catalog.packer import BatchPacker  # local: avoid cycle

        return BatchPacker(bucket_rows=False, bucket_cols=False).pack(cols)


def batch_from_numpy(fields: Mapping[str, np.ndarray], device="cpu") -> ColumnBatch:
    """Build a `ColumnBatch` from its 17 fields given as numpy arrays.

    The fields keep their dtypes (float32 planes and scalars, int32 counts,
    bool masks), so a batch packed elsewhere crosses over unchanged.
    """
    names = [f.name for f in dataclasses.fields(ColumnBatch)]
    missing = set(names) - set(fields)
    if missing:
        raise KeyError(f"batch_from_numpy: missing fields {sorted(missing)}")
    return ColumnBatch(
        **{k: torch.from_numpy(np.array(fields[k], copy=True)).to(device) for k in names}
    )


def metadata_from_numpy(fields: Mapping[str, object]) -> ColumnMetadata:
    """Build a `ColumnMetadata` from a mapping of its fields.

    Arrays are copied into numpy; `physical_type` may be an int or an enum.
    """
    kw = dict(fields)
    for k in ("chunk_sizes", "chunk_rows", "chunk_nulls", "chunk_dict_encoded",
              "mins", "maxs", "min_lengths", "max_lengths"):
        kw[k] = np.array(kw[k], copy=True)
    for k in ("min_reprs", "max_reprs"):
        if kw.get(k) is not None:
            kw[k] = np.array(kw[k], copy=True)
    kw["physical_type"] = PhysicalType(int(kw["physical_type"]))
    kw["distinct_min_count"] = float(kw["distinct_min_count"])
    kw["distinct_max_count"] = float(kw["distinct_max_count"])
    return ColumnMetadata(**kw)


# Printable-ASCII cardinality bound for single-byte strings (Eq 15).
SINGLE_BYTE_BOUND = 128.0
