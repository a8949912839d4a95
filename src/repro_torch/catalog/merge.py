"""Cross-file metadata merging: N per-file column views -> one logical view.

Chunk-granular fields (sizes, rows, nulls, encodings, min/max stats) simply
concatenate — the estimator is already chunk-oriented and does not care
which file a chunk came from. The subtle part is §5's m_min/m_max: the
number of *distinct* row-group min (max) statistics must be deduped across
the whole file set, not summed per file.

For numeric types the float64 order key IS the value, so uniqueness over
the concatenated key arrays is exact. For BYTE_ARRAY the key is only an
order-preserving 8-byte prefix: two distinct strings can share a key. We
disambiguate by (key, byte length, repr) when reprs are carried (the PQLite
reader always carries them) and by (key, byte length) otherwise — the same
resolution `column_metadata_from_footer` applies within a single file, so
single-file merges are exact fixed points: merge([m]) keeps m's counts.

`merge_column_metadata` is associative in the fields the estimator reads:
merging an already-merged view with newly-arrived per-file views gives the
same result as merging everything from scratch, which is what makes
`StatsCatalog.update()` incremental.
"""
from __future__ import annotations

from typing import Optional, Sequence

import numpy as np

from repro_torch.core.ndv.types import ColumnMetadata, PhysicalType

_BYTES_LIKE = (PhysicalType.BYTE_ARRAY, PhysicalType.FIXED_LEN_BYTE_ARRAY)


def _concat_reprs(parts: Sequence[ColumnMetadata], field: str) -> Optional[np.ndarray]:
    arrs = [getattr(p, field) for p in parts]
    if any(a is None for a in arrs):
        return None
    return np.concatenate([np.asarray(a, object) for a in arrs])


def distinct_stat_count(
    keys: np.ndarray,
    lengths: np.ndarray,
    reprs: Optional[np.ndarray],
    ptype: PhysicalType,
) -> float:
    """Count distinct min (or max) statistics across row groups.

    Numeric keys are exact; byte-array keys are truncated prefixes and are
    refined by length and, when available, the stat repr.
    """
    keys = np.asarray(keys, np.float64)
    if ptype not in _BYTES_LIKE:
        return float(np.unique(keys).size)
    lengths = np.asarray(lengths)
    if reprs is not None and len(reprs) == len(keys):
        ident = {
            (float(k), int(l), str(r))
            for k, l, r in zip(keys, lengths, reprs)
        }
    else:
        ident = {(float(k), int(l)) for k, l in zip(keys, lengths)}
    return float(len(ident))


def merge_column_metadata(parts: Sequence[ColumnMetadata]) -> ColumnMetadata:
    """Merge per-file views of ONE column into a single logical view."""
    if not parts:
        raise ValueError("merge_column_metadata: empty input")
    first = parts[0]
    for p in parts[1:]:
        if p.physical_type != first.physical_type:
            raise ValueError(
                f"column {first.column_name!r}: physical type mismatch "
                f"{first.physical_type.name} vs {p.physical_type.name}"
            )
        if p.column_name != first.column_name:
            raise ValueError(
                f"cannot merge columns {first.column_name!r} and {p.column_name!r}"
            )
    if len(parts) == 1:
        return first

    cat = lambda f, dt: np.concatenate(  # noqa: E731
        [np.asarray(getattr(p, f), dt) for p in parts]
    )
    mins = cat("mins", np.float64)
    maxs = cat("maxs", np.float64)
    min_lengths = cat("min_lengths", np.float64)
    max_lengths = cat("max_lengths", np.float64)
    min_reprs = _concat_reprs(parts, "min_reprs")
    max_reprs = _concat_reprs(parts, "max_reprs")
    return ColumnMetadata(
        chunk_sizes=cat("chunk_sizes", np.float64),
        chunk_rows=cat("chunk_rows", np.float64),
        chunk_nulls=cat("chunk_nulls", np.float64),
        chunk_dict_encoded=cat("chunk_dict_encoded", bool),
        mins=mins,
        maxs=maxs,
        min_lengths=min_lengths,
        max_lengths=max_lengths,
        distinct_min_count=distinct_stat_count(
            mins, min_lengths, min_reprs, first.physical_type
        ),
        distinct_max_count=distinct_stat_count(
            maxs, max_lengths, max_reprs, first.physical_type
        ),
        physical_type=first.physical_type,
        column_name=first.column_name,
        min_reprs=min_reprs,
        max_reprs=max_reprs,
    )
