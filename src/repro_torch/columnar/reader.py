"""PQLite readers.

Two access paths, mirroring the paper's cost model:

  * ``read_footer`` / ``column_metadata_from_footer`` — METADATA-ONLY. This
    is the zero-cost path: O(footer bytes), never touches data.npz.
  * ``read_column`` / ``read_row_group`` — DATA access, used only by the
    baselines (exact/HLL/CVM/sampling) and the training pipeline.
"""
from __future__ import annotations

import glob
import os
from typing import Dict, Iterator, List, Optional

import numpy as np

from repro_torch.columnar import format as fmt
from repro_torch.core.ndv.types import ColumnMetadata, PhysicalType


def read_footer(file_dir: str) -> fmt.FileFooter:
    """Read ONLY the footer (zero-cost path)."""
    with open(fmt.footer_path(file_dir)) as f:
        return fmt.FileFooter.from_json(f.read())


def list_files(root: str) -> List[str]:
    """Discover PQLite files under a dataset root."""
    out = []
    for p in sorted(glob.glob(os.path.join(root, "**", fmt.FOOTER_NAME), recursive=True)):
        out.append(os.path.dirname(p))
    return out


def column_metadata_from_footer(
    footer: fmt.FileFooter, name: str
) -> ColumnMetadata:
    """Assemble the estimator's ColumnMetadata view for one column.

    Distinct min/max counts are computed from the footer's statistics values
    (the ``*_repr``-level exact values via their order keys plus lengths —
    for byte arrays we distinguish values that share an 8-byte prefix by the
    (key, len) pair, matching what an engine comparing truncated stats sees).
    """
    chunks = footer.chunks(name)
    ptype = footer.column_type(name)
    n = len(chunks)
    chunk_sizes = np.array([c.total_uncompressed_size for c in chunks], np.float64)
    chunk_rows = np.array([c.num_values for c in chunks], np.float64)
    chunk_nulls = np.array([c.null_count for c in chunks], np.float64)
    chunk_dict = np.array([c.dictionary_encoded for c in chunks], bool)
    mins = np.array([c.min_key for c in chunks], np.float64)
    maxs = np.array([c.max_key for c in chunks], np.float64)
    min_lens = np.array([c.min_len for c in chunks], np.float64)
    max_lens = np.array([c.max_len for c in chunks], np.float64)
    if ptype == PhysicalType.BYTE_ARRAY:
        # (key, len, repr) — same identity repro_torch.catalog.merge uses, so the
        # single-file counts are exact fixed points of cross-file merging.
        m_min = len({(c.min_key, c.min_len, c.min_repr) for c in chunks})
        m_max = len({(c.max_key, c.max_len, c.max_repr) for c in chunks})
    else:
        m_min = int(np.unique(mins).size)
        m_max = int(np.unique(maxs).size)
    return ColumnMetadata(
        chunk_sizes=chunk_sizes,
        chunk_rows=chunk_rows,
        chunk_nulls=chunk_nulls,
        chunk_dict_encoded=chunk_dict,
        mins=mins,
        maxs=maxs,
        min_lengths=min_lens,
        max_lengths=max_lens,
        distinct_min_count=float(m_min),
        distinct_max_count=float(m_max),
        physical_type=ptype,
        column_name=name,
        min_reprs=np.array([c.min_repr for c in chunks], object),
        max_reprs=np.array([c.max_repr for c in chunks], object),
    )


def dataset_column_metadata(root: str, name: str) -> List[ColumnMetadata]:
    """Metadata views for one column across every file of a dataset."""
    return [
        column_metadata_from_footer(read_footer(d), name) for d in list_files(root)
    ]


def scan_dataset(root: str) -> List[tuple]:
    """Footer scan of a whole dataset: [(file_dir, FileFooter), ...].

    Still the zero-cost path — one footer read per file, no data pages.
    Convenience for whole-dataset consumers (profiling, ad-hoc analysis)
    that want every footer eagerly; `repro_torch.catalog.StatsCatalog` instead
    reads footers selectively via fingerprints.
    """
    return [(d, read_footer(d)) for d in list_files(root)]


# ---------------------------------------------------------------------------
# Data access (baselines + pipeline only)
# ---------------------------------------------------------------------------


class DataReader:
    """Lazily-opened npz-backed data reader for one file."""

    def __init__(self, file_dir: str):
        self.file_dir = file_dir
        self.footer = read_footer(file_dir)
        self._npz = None

    @property
    def npz(self):
        if self._npz is None:
            self._npz = np.load(fmt.data_path(self.file_dir), allow_pickle=False)
        return self._npz

    def read_column(self, name: str) -> np.ndarray:
        return self.npz[name]

    def null_mask(self, name: str) -> Optional[np.ndarray]:
        key = f"__nulls__{name}"
        return self.npz[key] if key in self.npz.files else None

    def read_row_group(self, name: str, index: int) -> np.ndarray:
        start = sum(rg.num_rows for rg in self.footer.row_groups[:index])
        stop = start + self.footer.row_groups[index].num_rows
        return self.npz[name][start:stop]

    def iter_row_groups(self, name: str) -> Iterator[np.ndarray]:
        for i in range(self.footer.num_row_groups):
            yield self.read_row_group(name, i)

    def non_null_values(self, name: str) -> np.ndarray:
        col = self.read_column(name)
        mask = self.null_mask(name)
        return col[~mask] if mask is not None else col
