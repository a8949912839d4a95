from repro_torch.columnar.format import FileFooter, ColumnChunkMeta, RowGroupMeta  # noqa: F401
from repro_torch.columnar.reader import (  # noqa: F401
    DataReader,
    column_metadata_from_footer,
    dataset_column_metadata,
    list_files,
    read_footer,
    scan_dataset,
)
from repro_torch.columnar.writer import WriterOptions, write_dataset, write_file  # noqa: F401
