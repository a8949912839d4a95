"""Paper core: zero-cost NDV estimation from columnar file metadata."""
from repro_torch.core.ndv.estimator import (  # noqa: F401
    BatchEstimates,
    estimate_batch,
)
from repro_torch.core.ndv.types import (  # noqa: F401
    ColumnBatch,
    ColumnMetadata,
    Layout,
    NDVEstimate,
    PhysicalType,
)
