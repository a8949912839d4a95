"""PQLite — a minimal, faithful columnar file format for this framework.

Parquet-shaped on the metadata plane (the only plane the paper reads):

  file
   ├── row group 0..n-1
   │     └── column chunk per column:
   │           total_uncompressed_size  (dict page + data pages, Eq 1's S)
   │           num_values, null_count
   │           encodings  ("DICTIONARY" | "PLAIN")
   │           statistics: min / max (+ byte lengths for BYTE_ARRAY)
   └── footer: schema + row-group metadata (JSON)

Data pages are stored as npz arrays — real enough for the data-access
baselines (HLL/CVM/sampling/exact) and the training data pipeline, while the
footer is bit-for-bit sufficient for the paper's zero-cost estimators.

Why not real Parquet: no pyarrow in this container; PQLite keeps exactly the
fields the paper consumes (`total_uncompressed_size`, min/max stats, null
counts, encodings) with a writer whose size accounting follows the same
dictionary-encoding storage equation the paper inverts.
"""
from __future__ import annotations

import dataclasses
import json
import os
import struct
from typing import Dict, List, Optional, Sequence

import numpy as np

from repro_torch.core.ndv.types import PhysicalType

FORMAT_VERSION = "pqlite-1.0"
FOOTER_NAME = "footer.json"
DATA_NAME = "data.npz"


# ---------------------------------------------------------------------------
# Order-preserving float keys for statistics
# ---------------------------------------------------------------------------


def stat_key(value, ptype: PhysicalType) -> float:
    """Map a statistics value to an order-preserving float64 key.

    Numeric types use the value itself. Byte arrays use the big-endian
    integer of the first 8 bytes (zero-padded), which preserves
    lexicographic order of the prefixes — the same trick engines use for
    truncated Parquet statistics.
    """
    if ptype == PhysicalType.BYTE_ARRAY or ptype == PhysicalType.FIXED_LEN_BYTE_ARRAY:
        b = value.encode() if isinstance(value, str) else bytes(value)
        b = (b[:8] + b"\x00" * 8)[:8]
        return float(struct.unpack(">Q", b)[0])
    return float(value)


# ---------------------------------------------------------------------------
# Footer dataclasses
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class ColumnChunkMeta:
    """Per-row-group, per-column metadata (the paper's entire input)."""

    name: str
    physical_type: int                 # PhysicalType value
    num_values: int
    null_count: int
    total_uncompressed_size: int       # dict page + data pages, bytes
    dict_page_size: int
    data_page_size: int
    encodings: List[str]               # ["DICTIONARY"] or ["PLAIN"]
    min_key: float                     # order-preserving stat keys
    max_key: float
    min_len: int                       # byte length of the min value
    max_len: int
    min_repr: str = ""                 # human-readable stat (debug only)
    max_repr: str = ""

    @property
    def dictionary_encoded(self) -> bool:
        return "DICTIONARY" in self.encodings

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)

    @classmethod
    def from_dict(cls, d: dict) -> "ColumnChunkMeta":
        return cls(**d)


@dataclasses.dataclass
class RowGroupMeta:
    num_rows: int
    columns: Dict[str, ColumnChunkMeta]

    def to_dict(self) -> dict:
        return {
            "num_rows": self.num_rows,
            "columns": {k: v.to_dict() for k, v in self.columns.items()},
        }

    @classmethod
    def from_dict(cls, d: dict) -> "RowGroupMeta":
        return cls(
            num_rows=d["num_rows"],
            columns={
                k: ColumnChunkMeta.from_dict(v) for k, v in d["columns"].items()
            },
        )


@dataclasses.dataclass
class FileFooter:
    num_rows: int
    schema: Dict[str, int]             # column -> PhysicalType value
    row_groups: List[RowGroupMeta]
    created_by: str = FORMAT_VERSION
    key_value_metadata: Dict[str, str] = dataclasses.field(default_factory=dict)

    @property
    def column_names(self) -> List[str]:
        return list(self.schema.keys())

    @property
    def num_row_groups(self) -> int:
        return len(self.row_groups)

    def column_type(self, name: str) -> PhysicalType:
        return PhysicalType(self.schema[name])

    def chunks(self, name: str) -> List[ColumnChunkMeta]:
        return [rg.columns[name] for rg in self.row_groups]

    def to_json(self) -> str:
        return json.dumps(
            {
                "num_rows": self.num_rows,
                "schema": self.schema,
                "created_by": self.created_by,
                "key_value_metadata": self.key_value_metadata,
                "row_groups": [rg.to_dict() for rg in self.row_groups],
            }
        )

    @classmethod
    def from_json(cls, s: str) -> "FileFooter":
        d = json.loads(s)
        return cls(
            num_rows=d["num_rows"],
            schema=d["schema"],
            created_by=d.get("created_by", FORMAT_VERSION),
            key_value_metadata=d.get("key_value_metadata", {}),
            row_groups=[RowGroupMeta.from_dict(r) for r in d["row_groups"]],
        )


# ---------------------------------------------------------------------------
# On-disk layout helpers
# ---------------------------------------------------------------------------


def footer_path(file_dir: str) -> str:
    return os.path.join(file_dir, FOOTER_NAME)


def data_path(file_dir: str) -> str:
    return os.path.join(file_dir, DATA_NAME)


def infer_physical_type(arr: np.ndarray) -> PhysicalType:
    k = arr.dtype.kind
    if k in ("U", "S", "O"):
        return PhysicalType.BYTE_ARRAY
    if k == "b":
        return PhysicalType.BOOL
    if k in ("i", "u"):
        return PhysicalType.INT32 if arr.dtype.itemsize <= 4 else PhysicalType.INT64
    if k == "f":
        return (
            PhysicalType.FLOAT32 if arr.dtype.itemsize <= 4 else PhysicalType.FLOAT64
        )
    if k == "M":  # datetime64
        return PhysicalType.TIMESTAMP64
    raise TypeError(f"unsupported dtype {arr.dtype}")


def value_byte_length(value, ptype: PhysicalType) -> int:
    w = ptype.fixed_width
    if w is not None:
        return w
    if isinstance(value, str):
        return len(value.encode())
    return len(bytes(value))
