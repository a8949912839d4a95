"""Metadata ingestion sources for the stats catalog.

A `MetadataSource` is the catalog's only view of storage: it can list file
ids, fingerprint a file cheaply, and read a file's footer. Everything else
(merging, packing, caching) is format-agnostic, so supporting a real
Parquet or ORC footer reader later means writing one adapter class — the
footer just has to expose the `FileFooter` surface (`column_names`,
`chunks(name)`, `column_type(name)`).

Fingerprints are the cache/invalidation currency: `StatsCatalog.update()`
re-reads a footer only when its fingerprint changed, and estimate caches
are keyed by the set of fingerprints, so any file addition, removal, or
rewrite invalidates exactly the affected dataset-level entries.
"""
from __future__ import annotations

import abc
import hashlib
import os
from typing import Dict, List

from repro_torch.columnar import format as fmt
from repro_torch.columnar import reader as rd
from repro_torch.core.ndv.types import ColumnMetadata


class MetadataSource(abc.ABC):
    """Abstract footer provider for one dataset."""

    @abc.abstractmethod
    def list_files(self) -> List[str]:
        """Stable ids (paths) of the dataset's files, sorted."""

    @abc.abstractmethod
    def fingerprint(self, file_id: str) -> str:
        """Cheap change token for one file's footer.

        Must change whenever the footer content may have changed; must NOT
        require parsing the footer (that is what it exists to avoid).
        """

    @abc.abstractmethod
    def read_footer(self, file_id: str) -> fmt.FileFooter:
        """Parse one file's footer (the only non-free ingestion step)."""

    def column_metadata(self, footer: fmt.FileFooter, name: str) -> ColumnMetadata:
        """Estimator view of one column; override for non-PQLite footers."""
        return rd.column_metadata_from_footer(footer, name)


class PQLiteMetadataSource(MetadataSource):
    """Footer scanning over a PQLite dataset root directory."""

    def __init__(self, root: str):
        self.root = root

    def list_files(self) -> List[str]:
        return rd.list_files(self.root)

    def fingerprint(self, file_id: str) -> str:
        # stat-only: (size, mtime_ns) — no footer bytes are read, keeping
        # the re-scan path O(files) stat calls, not O(footer bytes).
        st = os.stat(fmt.footer_path(file_id))
        return f"{st.st_size}:{st.st_mtime_ns}"

    def read_footer(self, file_id: str) -> fmt.FileFooter:
        return rd.read_footer(file_id)


class InMemoryMetadataSource(MetadataSource):
    """Footers held in memory — tests, synthetic fleets, RPC ingestion stubs."""

    def __init__(self, footers: Dict[str, fmt.FileFooter]):
        self._footers = dict(footers)

    def list_files(self) -> List[str]:
        return sorted(self._footers)

    def fingerprint(self, file_id: str) -> str:
        payload = self._footers[file_id].to_json().encode()
        return hashlib.sha1(payload).hexdigest()

    def read_footer(self, file_id: str) -> fmt.FileFooter:
        return self._footers[file_id]

    # mutation helpers for incremental-ingestion tests
    def add(self, file_id: str, footer: fmt.FileFooter) -> None:
        self._footers[file_id] = footer

    def remove(self, file_id: str) -> None:
        del self._footers[file_id]
