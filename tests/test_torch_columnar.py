"""PyTorch port: columnar I/O, types and the package boundary, against JAX.

* The port's reader gives `np.array_equal` ColumnMetadata for the same PQLite
  files as the JAX package's reader.
* Files written by the port's writer read back, through the JAX reader, to
  the same ColumnMetadata as files the JAX writer wrote from the same data
  (what is read is compared, not bytes: the data file is an .npz whose zip
  headers carry a timestamp).
* `batch_from_numpy` / `metadata_from_numpy` carry the JAX package's state
  across unchanged.
* The port imports neither JAX nor the JAX package.
"""
import dataclasses
import os
import subprocess
import sys

import numpy as np
import pytest

from repro.catalog.packer import BatchPacker as JaxPacker
from repro.columnar import reader as jreader
from repro.columnar import writer as jwriter
from repro.core.ndv.types import ColumnMetadata as JaxMeta
from repro_torch.columnar import datasets, generator
from repro_torch.columnar import reader as treader
from repro_torch.columnar import writer as twriter
from repro_torch.core.ndv import types as ttypes

SRC = os.path.join(os.path.dirname(__file__), "..", "src")
META_FIELDS = [f.name for f in dataclasses.fields(JaxMeta)]


# Of the five columns drawn from a domain of 100k strings one is enough here:
# they take one route through writer and reader, and drawing each domain costs
# about 3.5 s on a CPU (twice in test_generators_are_copies). The catalog test
# (tests/test_torch_catalog.py) holds all five against the reference.
LARGE_STRINGS = ("uniform_str_large",)


def _in_table(spec) -> bool:
    return spec.dtype == "int" or spec.ndv <= 5000 or spec.name in LARGE_STRINGS


def _table(seed: int, rows: int = 2048):
    rng = np.random.default_rng(seed)
    cols = {
        s.name: s.generate()[0]
        for s in generator.standard_suite(rows=rows, seed=seed)
        if _in_table(s)
    }
    cols.update({k: v for k, (v, _) in datasets.lineitem(rows, seed=seed).items()})
    cols["nullable"] = rng.integers(0, 50, rows).astype(np.int64)
    mask = rng.uniform(size=rows) < 0.1
    return cols, {"nullable": mask}


def _assert_meta_equal(a, b):
    for f in META_FIELDS:
        x, y = getattr(a, f), getattr(b, f)
        if isinstance(x, np.ndarray) or isinstance(y, np.ndarray):
            assert np.array_equal(np.asarray(x), np.asarray(y)), f
            assert np.asarray(x).dtype == np.asarray(y).dtype, f
        else:
            assert x == y, f


def _all_meta(read_mod, file_dir):
    footer = read_mod.read_footer(file_dir)
    return {n: read_mod.column_metadata_from_footer(footer, n) for n in footer.column_names}


@pytest.fixture(scope="module")
def table():
    return _table(3)


def test_port_reader_matches_jax_reader(tmp_path, table):
    cols, masks = table
    d = str(tmp_path / "f")
    jwriter.write_file(d, cols, null_masks=masks,
                       options=jwriter.WriterOptions(row_group_size=256))
    want, got = _all_meta(jreader, d), _all_meta(treader, d)
    assert want.keys() == got.keys()
    for name in want:
        _assert_meta_equal(got[name], want[name])


@pytest.mark.parametrize("row_group_size", [100, 512])
def test_port_writer_reads_back_like_jax_writer(tmp_path, table, row_group_size):
    cols, masks = table
    dj, dt = str(tmp_path / "jax"), str(tmp_path / "torch")
    jwriter.write_file(dj, cols, null_masks=masks,
                       options=jwriter.WriterOptions(row_group_size=row_group_size))
    twriter.write_file(dt, cols, null_masks=masks,
                       options=twriter.WriterOptions(row_group_size=row_group_size))
    want, got = _all_meta(jreader, dj), _all_meta(jreader, dt)
    for name in want:
        _assert_meta_equal(got[name], want[name])
    assert treader.read_footer(dt).to_json() == jreader.read_footer(dj).to_json()
    for name in ("l_quantity", "nullable"):
        assert np.array_equal(treader.DataReader(dt).read_column(name),
                              jreader.DataReader(dj).read_column(name))


def test_generators_are_copies(table):
    cols, _ = table
    from repro.columnar import datasets as jdatasets
    from repro.columnar import generator as jgen

    for s in jgen.standard_suite(rows=2048, seed=3):
        if _in_table(s):
            assert np.array_equal(s.generate()[0], cols[s.name]), s.name
    for k, (v, truth) in jdatasets.lineitem(2048, seed=3).items():
        assert np.array_equal(v, cols[k]) and truth == len(np.unique(cols[k])), k


def test_metadata_and_batch_from_numpy(tmp_path, table):
    cols, masks = table
    d = str(tmp_path / "f")
    jwriter.write_file(d, cols, null_masks=masks,
                       options=jwriter.WriterOptions(row_group_size=300))
    jax_cols = list(_all_meta(jreader, d).values())
    ported = [
        ttypes.metadata_from_numpy({f: getattr(c, f) for f in META_FIELDS})
        for c in jax_cols
    ]
    for a, b in zip(ported, jax_cols):
        _assert_meta_equal(a, b)
    assert isinstance(ported[0].physical_type, ttypes.PhysicalType)

    jb = JaxPacker().pack(jax_cols)
    fields = {f: np.asarray(getattr(jb, f)) for f in ttypes.ColumnBatch.__dataclass_fields__}
    tb = ttypes.batch_from_numpy(fields, "cpu")
    assert len(fields) == 17
    for f, v in fields.items():
        got = getattr(tb, f).numpy()
        assert got.dtype == v.dtype and np.array_equal(got, v), f
    with pytest.raises(KeyError):
        ttypes.batch_from_numpy({k: v for k, v in fields.items() if k != "valid"})


def test_port_imports_neither_jax_nor_repro():
    script = r"""
import importlib, pathlib, sys
import repro_torch
root = pathlib.Path(repro_torch.__file__).parent
names = sorted(
    ".".join(("repro_torch",) + p.relative_to(root).with_suffix("").parts).replace(".__init__", "")
    for p in root.rglob("*.py")
)
for n in names:
    importlib.import_module(n)
assert len(names) >= 25, names
bad = sorted(m for m in sys.modules
             if m == "jax" or m.startswith("jax.") or m == "repro" or m.startswith("repro."))
assert not bad, bad
print(len(names))
"""
    env = dict(os.environ, PYTHONPATH=os.path.abspath(SRC))
    out = subprocess.run([sys.executable, "-c", script], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
