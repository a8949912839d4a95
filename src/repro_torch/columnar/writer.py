"""PQLite writer: dictionary encoding with plain fallback, per-chunk stats.

Size accounting follows the dictionary storage equation the paper inverts
(Eq 1), per column chunk:

    dict_page_size = sum(byte_length(v) for v in chunk-distinct values)
                     (+ length_prefix_bytes per entry for BYTE_ARRAY, to
                      model Parquet's 4-byte length prefixes when desired)
    data_page_size = ceil(non_null_rows * ceil(log2(local_ndv)) / 8)
    total_uncompressed_size = dict_page_size + data_page_size

Fallback: when dict_page_size would exceed ``dictionary_page_limit``
(Parquet's ~1 MiB default), the chunk is written PLAIN:

    data_page_size = non_null_rows * byte lengths (+ prefixes)
    total_uncompressed_size = data_page_size

This is exactly the writer behaviour Eq 5 detects from the outside.
"""
from __future__ import annotations

import dataclasses
import math
import os
import tempfile
from typing import Dict, Optional, Sequence

import numpy as np

from repro_torch.columnar import format as fmt
from repro_torch.core.ndv.types import PhysicalType

DEFAULT_ROW_GROUP_SIZE = 65536
DEFAULT_DICT_PAGE_LIMIT = 1 << 20  # 1 MiB, parquet-mr default


@dataclasses.dataclass
class WriterOptions:
    row_group_size: int = DEFAULT_ROW_GROUP_SIZE
    dictionary_page_limit: int = DEFAULT_DICT_PAGE_LIMIT
    # 0 = the paper's idealized model (S = ndv*len + rows*bits/8).
    # 4 = Parquet-realistic BYTE_ARRAY length prefixes (model-mismatch study).
    length_prefix_bytes: int = 0
    # Minimum bits per dictionary index (Parquet RLE/bit-pack needs >= 1).
    min_index_bits: int = 1


def _ceil_log2(n: int, min_bits: int = 1) -> int:
    if n <= 1:
        return min_bits
    return max(int(math.ceil(math.log2(n))), min_bits)


def _chunk_sizes(
    values: np.ndarray,
    nulls: np.ndarray,
    ptype: PhysicalType,
    opts: WriterOptions,
) -> tuple[int, int, int, bool, int]:
    """Compute (dict_page, data_page, total, dictionary_encoded, local_ndv)."""
    non_null = values[~nulls]
    n_rows = int(non_null.size)
    if ptype == PhysicalType.BYTE_ARRAY:
        distinct = np.unique(non_null.astype(str))
        lens = np.char.str_len(np.char.encode(distinct.astype(str)))
        per_value = lens + opts.length_prefix_bytes
        dict_page = int(per_value.sum())
        plain_lens = np.char.str_len(np.char.encode(non_null.astype(str)))
        plain_page = int((plain_lens + opts.length_prefix_bytes).sum())
    else:
        distinct = np.unique(non_null)
        width = ptype.fixed_width or non_null.dtype.itemsize
        dict_page = int(distinct.size * width)
        plain_page = int(n_rows * width)
    local_ndv = int(distinct.size)
    if dict_page > opts.dictionary_page_limit or local_ndv == 0:
        return 0, plain_page, plain_page, False, local_ndv
    bits = _ceil_log2(local_ndv, opts.min_index_bits)
    data_page = int(math.ceil(n_rows * bits / 8.0))
    return dict_page, data_page, dict_page + data_page, True, local_ndv


def _stats(
    values: np.ndarray, nulls: np.ndarray, ptype: PhysicalType
) -> tuple[float, float, int, int, str, str]:
    non_null = values[~nulls]
    if non_null.size == 0:
        return 0.0, 0.0, 0, 0, "", ""
    if ptype == PhysicalType.BYTE_ARRAY:
        s = non_null.astype(str).tolist()
        mn, mx = min(s), max(s)
        return (
            fmt.stat_key(mn, ptype),
            fmt.stat_key(mx, ptype),
            len(mn.encode()),
            len(mx.encode()),
            mn[:64],
            mx[:64],
        )
    mn, mx = non_null.min(), non_null.max()
    w = ptype.fixed_width or non_null.dtype.itemsize
    return float(mn), float(mx), w, w, repr(mn), repr(mx)


def write_file(
    file_dir: str,
    columns: Dict[str, np.ndarray],
    *,
    null_masks: Optional[Dict[str, np.ndarray]] = None,
    options: Optional[WriterOptions] = None,
    key_value_metadata: Optional[Dict[str, str]] = None,
) -> fmt.FileFooter:
    """Write a PQLite file (directory with footer.json + data.npz).

    Args:
      file_dir: output directory (created if missing).
      columns: column name -> 1-D numpy array (all equal length).
      null_masks: optional name -> bool mask (True = null).
      options: writer options.

    Returns:
      The FileFooter that was written.
    """
    opts = options or WriterOptions()
    names = list(columns.keys())
    if not names:
        raise ValueError("no columns")
    n_rows = len(columns[names[0]])
    for k, v in columns.items():
        if len(v) != n_rows:
            raise ValueError(f"column {k} length {len(v)} != {n_rows}")
    null_masks = null_masks or {}

    schema = {k: int(fmt.infer_physical_type(np.asarray(v))) for k, v in columns.items()}
    row_groups = []
    rg = opts.row_group_size
    for start in range(0, n_rows, rg):
        stop = min(start + rg, n_rows)
        cols_meta: Dict[str, fmt.ColumnChunkMeta] = {}
        for name in names:
            arr = np.asarray(columns[name])[start:stop]
            ptype = PhysicalType(schema[name])
            nulls = null_masks.get(name)
            nulls = (
                np.asarray(nulls[start:stop], bool)
                if nulls is not None
                else np.zeros(arr.shape[0], bool)
            )
            dict_page, data_page, total, dict_enc, _ = _chunk_sizes(
                arr, nulls, ptype, opts
            )
            mn_k, mx_k, mn_l, mx_l, mn_r, mx_r = _stats(arr, nulls, ptype)
            cols_meta[name] = fmt.ColumnChunkMeta(
                name=name,
                physical_type=int(ptype),
                num_values=int(arr.shape[0]),
                null_count=int(nulls.sum()),
                total_uncompressed_size=total,
                dict_page_size=dict_page,
                data_page_size=data_page,
                encodings=["DICTIONARY"] if dict_enc else ["PLAIN"],
                min_key=mn_k,
                max_key=mx_k,
                min_len=mn_l,
                max_len=mx_l,
                min_repr=mn_r,
                max_repr=mx_r,
            )
        row_groups.append(fmt.RowGroupMeta(num_rows=stop - start, columns=cols_meta))

    footer = fmt.FileFooter(
        num_rows=n_rows,
        schema=schema,
        row_groups=row_groups,
        key_value_metadata=key_value_metadata or {},
    )

    os.makedirs(file_dir, exist_ok=True)
    # Atomic-ish write: temp files then rename (crash consistency for the
    # data pipeline's shard discovery).
    data = {}
    for name in names:
        arr = np.asarray(columns[name])
        if arr.dtype.kind in ("U", "S", "O"):
            arr = arr.astype(str)
        data[name] = arr
        mask = null_masks.get(name)
        if mask is not None:
            data[f"__nulls__{name}"] = np.asarray(mask, bool)
    fd, tmp = tempfile.mkstemp(dir=file_dir, suffix=".npz.tmp")
    os.close(fd)
    with open(tmp, "wb") as f:
        np.savez_compressed(f, **data)
    os.replace(tmp, fmt.data_path(file_dir))
    fd, tmp = tempfile.mkstemp(dir=file_dir, suffix=".json.tmp")
    os.close(fd)
    with open(tmp, "w") as f:
        f.write(footer.to_json())
    os.replace(tmp, fmt.footer_path(file_dir))
    return footer


def write_dataset(
    root: str,
    shards: Sequence[Dict[str, np.ndarray]],
    *,
    options: Optional[WriterOptions] = None,
) -> list[fmt.FileFooter]:
    """Write a multi-file dataset (one PQLite file per shard)."""
    footers = []
    for i, cols in enumerate(shards):
        footers.append(
            write_file(os.path.join(root, f"shard_{i:05d}"), cols, options=options)
        )
    return footers
