"""Stats catalog: cached, incremental dataset-level NDV estimation.

The path from "directory of columnar files" to cached dataset-level NDV
estimates:

  ingestion   `MetadataSource` — footer scanning (PQLite) with per-file
              fingerprints so re-scans skip unchanged footers.
  merging     `merge_column_metadata` — one logical `ColumnMetadata` per
              column across files; the distinct-min/max counts (§5's
              m_min/m_max) are re-deduped across files, including
              BYTE_ARRAY stats that collide in the truncated 8-byte key
              space (disambiguated by length + repr).
  packing     `BatchPacker` — vectorized numpy packing into a (B, R)
              `ColumnBatch` of torch tensors, with power-of-two shape
              bucketing; padding lanes are masked and never affect
              estimates.
  caching     `StatsCatalog` — packed batches cached per fingerprint set
              and made resident on the engine's device once per
              generation; estimates cached per (fingerprint set, mode,
              schema bounds, engine numerics); `save_cache()`/
              `load_cache()` spill estimates next to the dataset.
  execution   estimation runs through an injected
              `repro_torch.engine.EstimationEngine` (local / chunked on one
              device) — the catalog never calls `estimate_batch` directly.
"""
from repro_torch.catalog.catalog import (  # noqa: F401
    CACHE_FILE_NAME,
    CatalogStats,
    FileEntry,
    StatsCatalog,
    UpdateSummary,
    estimate_from_json,
    estimate_to_json,
)
from repro_torch.catalog.merge import merge_column_metadata  # noqa: F401
from repro_torch.catalog.packer import (  # noqa: F401
    BatchPacker,
    bucket_size,
    concat_batches,
)
from repro_torch.catalog.source import (  # noqa: F401
    InMemoryMetadataSource,
    MetadataSource,
    PQLiteMetadataSource,
)
