"""PyTorch port: packing and merging, against the JAX package.

For the same columns, every one of the 17 `ColumnBatch` fields of the port's
`BatchPacker` equals the JAX packer's output element for element, with the
same dtype and the same bucketed shape (both pack with numpy). Merging and
`concat_batches` agree the same way.
"""
import dataclasses

import numpy as np
import pytest

from repro.catalog import merge as jmerge
from repro.catalog import packer as jpacker
from repro.core.ndv.types import ColumnBatch as JaxBatch
from repro.core.ndv.types import ColumnMetadata as JaxMeta
from repro.core.ndv.types import PhysicalType as JaxType
from repro_torch.catalog import merge as tmerge
from repro_torch.catalog import packer as tpacker
from repro_torch.core.ndv import types as ttypes

FIELDS = [f.name for f in dataclasses.fields(JaxBatch)]
META_FIELDS = [f.name for f in dataclasses.fields(JaxMeta)]


def _columns(seed: int, n: int, max_groups: int):
    """Seeded JAX-side ColumnMetadata with ragged row-group counts."""
    rng = np.random.default_rng(seed)
    types = [JaxType.INT64, JaxType.BYTE_ARRAY, JaxType.FLOAT64, JaxType.INT32,
             JaxType.DATE32, JaxType.BOOL]
    cols = []
    for i in range(n):
        r = int(rng.integers(1, max_groups + 1))
        rows = rng.integers(100, 5000, r).astype(np.float64)
        mins = np.sort(rng.normal(size=r) * 100)
        maxs = mins + np.abs(rng.normal(size=r)) * 50
        ptype = types[i % len(types)]
        lens = rng.integers(1, 30, (2, r)).astype(np.float64)
        if ptype == JaxType.BYTE_ARRAY and i % 4 == 1:
            lens[:] = 1.0
        cols.append(JaxMeta(
            chunk_sizes=rows * rng.uniform(0.5, 8, r),
            chunk_rows=rows,
            chunk_nulls=np.floor(rows * rng.uniform(0, 0.2, r)),
            chunk_dict_encoded=rng.uniform(size=r) < 0.8,
            mins=mins, maxs=maxs, min_lengths=lens[0], max_lengths=lens[1],
            distinct_min_count=float(np.unique(mins).size),
            distinct_max_count=float(np.unique(maxs).size),
            physical_type=ptype, column_name=f"c{i}",
        ))
    return cols


def _to_port(cols):
    return [ttypes.metadata_from_numpy({f: getattr(c, f) for f in META_FIELDS})
            for c in cols]


def _assert_batches_equal(tb, jb):
    for f in FIELDS:
        want = np.asarray(getattr(jb, f))
        got = getattr(tb, f).numpy()
        assert got.shape == want.shape, f
        assert got.dtype == want.dtype, f
        assert np.array_equal(got, want), f


@pytest.mark.parametrize(
    "opts",
    [
        {},
        {"bucket_rows": False, "bucket_cols": False},
        {"row_floor": 16, "col_floor": 8},
        {"col_multiple": 3},
        {"col_multiple": 2, "col_chunk": 4},
    ],
    ids=["default", "exact", "floors", "multiple", "chunk"],
)
@pytest.mark.parametrize("n,max_groups", [(1, 1), (7, 9), (29, 40)])
def test_pack_matches_jax_packer(opts, n, max_groups):
    cols = _columns(n * 100 + max_groups, n, max_groups)
    jb = jpacker.BatchPacker(**opts).pack(cols)
    tb = tpacker.BatchPacker(**opts).pack(_to_port(cols))
    assert isinstance(tb, ttypes.ColumnBatch)
    assert (tb.batch, tb.max_groups) == (jb.batch, jb.max_groups)
    _assert_batches_equal(tb, jb)


def test_from_columns_exact_shape():
    cols = _columns(5, 5, 11)
    _assert_batches_equal(
        ttypes.ColumnBatch.from_columns(_to_port(cols)), JaxBatch.from_columns(cols)
    )


@pytest.mark.parametrize("n,floor", [(0, 1), (1, 1), (5, 1), (8, 8), (9, 8), (1000, 1)])
def test_bucket_size_matches(n, floor):
    assert tpacker.bucket_size(n, floor) == jpacker.bucket_size(n, floor)


def test_concat_batches_matches():
    a, b = _columns(1, 5, 6), _columns(2, 3, 20)
    jcat = jpacker.concat_batches(
        [jpacker.BatchPacker().pack(a), jpacker.BatchPacker().pack(b)], pad_to=16
    )
    tcat = tpacker.concat_batches(
        [tpacker.BatchPacker().pack(_to_port(a)), tpacker.BatchPacker().pack(_to_port(b))],
        pad_to=16,
    )
    _assert_batches_equal(tcat, jcat)


def test_merge_matches_jax_merge():
    parts = _columns(9, 4, 7)
    # Share some statistics across parts so the cross-file dedup matters.
    parts = [dataclasses.replace(p, physical_type=JaxType.INT64, column_name="c",
                                 mins=np.round(p.mins), maxs=np.round(p.maxs))
             for p in parts]
    want = jmerge.merge_column_metadata(parts)
    got = tmerge.merge_column_metadata(_to_port(parts))
    for f in META_FIELDS:
        x, y = getattr(got, f), getattr(want, f)
        if isinstance(y, np.ndarray):
            assert np.array_equal(np.asarray(x), y), f
        else:
            assert x == y, f
