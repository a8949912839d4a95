"""PyTorch port: engine and catalog, against the JAX package and themselves.

* `StatsCatalog.estimate` on one PQLite dataset equals the JAX catalog in
  both modes: the reference configuration at rtol=1e-5, the kernel-path
  configuration (JAX Pallas in interpret mode, `fuse="off"`) at rtol=1e-3;
  layout and lower-bound flags exactly.
* `chunked` equals `local` bit for bit.
* The port's cache identity is its own: `cache_token` is never a `k.*`
  token, and the estimate spill has its own file name.
* The default device is the card: without one, engine and catalog raise.
* A warm estimate copies the batch to the device once per generation.
"""
import os

import numpy as np
import pytest
import torch

from repro_torch.catalog import CACHE_FILE_NAME, StatsCatalog
from repro_torch.columnar import datasets, generator, writer
from repro_torch.engine import EngineConfig, EstimationEngine, default_engine
from repro_torch.kernels import build

try:  # the reference: absent where only the `cuda` tests run
    from repro.catalog import StatsCatalog as JaxCatalog
    from repro.catalog.catalog import CACHE_FILE_NAME as JAX_CACHE_FILE
    from repro.engine import EngineConfig as JaxConfig
    from repro.engine import EstimationEngine as JaxEngine
except ImportError:
    JaxCatalog = JAX_CACHE_FILE = JaxConfig = JaxEngine = None

FLOATS = ("ndv", "ndv_dict", "ndv_minmax", "confidence", "overlap_ratio",
          "monotonicity", "mean_len")


def _cpu(**kw) -> EstimationEngine:
    return EstimationEngine(EngineConfig(device="cpu", **kw))


@pytest.fixture()
def jax_ref():
    if JaxCatalog is None:
        pytest.skip("needs the JAX package, the reference")


@pytest.fixture(scope="module")
def dataset(tmp_path_factory):
    """lineitem plus every column of the standard suite, one table split over
    3 files in row groups of 512. The five `*_str_large` columns (a domain of
    100k strings, nearly every row distinct) hold the saturated coupon lanes
    and the high-cardinality dictionaries against the reference; drawing
    their domains is most of this fixture's cost (about 17 s on a CPU)."""
    root = tmp_path_factory.mktemp("ds")
    rows = 3 * 2048
    cols = {s.name: s.generate()[0] for s in generator.standard_suite(rows=rows, seed=1)}
    cols.update({k: v for k, (v, _) in datasets.lineitem(rows, seed=1).items()})
    shards = [{k: v[i * 2048:(i + 1) * 2048] for k, v in cols.items()} for i in range(3)]
    writer.write_dataset(str(root), shards, options=writer.WriterOptions(row_group_size=512))
    return str(root)


def _assert_same(got, want, rtol):
    assert got.keys() == want.keys()
    for name, w in want.items():
        g = got[name]
        assert (g.layout, g.is_lower_bound, g.len_sample_size) == (
            int(w.layout), w.is_lower_bound, w.len_sample_size), name
        for f in FLOATS:
            np.testing.assert_allclose(getattr(g, f), getattr(w, f), rtol=rtol,
                                       err_msg=f"{name}.{f}")


@pytest.mark.parametrize("mode", ["paper", "improved"])
@pytest.mark.parametrize(
    "port_backend,jax_backend,rtol", [("ref", "ref", 1e-5), ("auto", "pallas", 1e-3)],
    ids=["ref", "kernel_path"],
)
def test_catalog_matches_jax_catalog(dataset, mode, port_backend, jax_backend, rtol, jax_ref):
    want = JaxCatalog(dataset, engine=JaxEngine(JaxConfig(backend=jax_backend, fuse="off")))
    got = StatsCatalog(dataset, engine=_cpu(backend=port_backend))
    assert got.column_names == want.column_names
    _assert_same(got.estimate(mode=mode), want.estimate(mode=mode), rtol)
    pj, pt = want.provenance(mode=mode), got.provenance(mode=mode)
    for name in pj:
        assert (pt[name].route, pt[name].clamp_flags, pt[name].dict_iterations,
                pt[name].coupon_iterations) == (pj[name].route, pj[name].clamp_flags,
                                                pj[name].dict_iterations,
                                                pj[name].coupon_iterations), name


@pytest.mark.parametrize("mode", ["paper", "improved"])
def test_chunked_equals_local_bit_for_bit(dataset, mode):
    cat = StatsCatalog(dataset, engine=_cpu())
    batch = cat.packed_batch()
    local = _cpu(strategy="local")
    chunked = _cpu(strategy="auto", max_batch=4)
    assert chunked.resolve_strategy(batch.batch) == "chunked"
    assert local.resolve_strategy(batch.batch) == "local"
    sb = torch.full((batch.batch,), float("inf"))
    sb[::3] = 50.0
    for bound in (None, sb):
        a = local.estimate(batch, bound, mode=mode)
        b = chunked.estimate(batch, bound, mode=mode)
        for f, x, y in zip(a._fields, a, b):
            assert torch.equal(x, y), f
    # a budget that does not divide B pads and trims
    odd = chunked.estimate(batch.slice(0, 7), None, mode=mode)
    whole = local.estimate(batch.slice(0, 7), None, mode=mode)
    for x, y in zip(odd, whole):
        assert torch.equal(x, y)


def test_warm_estimate_copies_the_batch_once(dataset):
    cat = StatsCatalog(dataset, engine=_cpu())
    first = cat.estimate(mode="paper")
    assert cat.estimate(mode="paper") == first
    cat.estimate(mode="improved")
    assert cat.stats.device_puts == 1
    assert cat.stats.packs == 1
    assert cat.stats.estimate_cache_hits == 1
    assert cat.num_resident_batches == 1


def test_cache_identity_is_the_ports_own(dataset, tmp_path, jax_ref):
    for backend, token in (("auto", "t.cpu"), ("cuda", "t.cpu"), ("ref", "t.ref.cpu")):
        eng = _cpu(backend=backend)
        assert eng.cache_token == token and not eng.cache_token.startswith("k.")
        assert eng.cache_key == (token,)
    assert JaxEngine(JaxConfig()).cache_token.startswith("k.")
    assert CACHE_FILE_NAME != JAX_CACHE_FILE
    # Spills of the two packages land in different files and never mix.
    cat = StatsCatalog(dataset, engine=_cpu())
    est = cat.estimate(mode="paper")
    path = cat.save_cache()
    assert os.path.basename(path) == CACHE_FILE_NAME
    assert JaxCatalog(dataset).load_cache() == 0
    warm = StatsCatalog(dataset, engine=_cpu())
    assert warm.load_cache() == 1
    assert warm.estimate(mode="paper") == est
    assert warm.stats.packs == 0
    assert StatsCatalog(dataset, engine=_cpu(backend="ref")).load_cache() == 1
    os.remove(path)


def test_cpu_spill_is_not_served_to_a_cuda_engine(dataset, tmp_path):
    """The CPU's plain versions and the CUDA kernels may differ in the last
    ulp, so an estimate spilled by a CPU engine is never a CUDA engine's."""
    cat = StatsCatalog(dataset, engine=_cpu())
    cat.estimate(mode="paper")
    path = cat.save_cache(str(tmp_path / CACHE_FILE_NAME))
    warm = StatsCatalog(dataset, engine=_cpu())
    assert warm.load_cache(path) == 1
    on_card = _cpu()
    on_card.device = torch.device("cuda", 0)  # its identity only; nothing runs
    assert on_card.cache_token == "t.cuda"
    assert warm.estimate_cache_peek(warm.estimate_key(mode="paper", engine=on_card)) is None
    assert warm.estimate_cache_peek(warm.estimate_key(mode="paper")) is not None


@pytest.mark.cuda
def test_cuda_catalog_recomputes_over_a_cpu_spill(dataset, tmp_path):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    cat = StatsCatalog(dataset, engine=_cpu())
    cat.estimate(mode="improved")
    path = cat.save_cache(str(tmp_path / CACHE_FILE_NAME))
    on_card = StatsCatalog(dataset)
    assert on_card.load_cache(path) == 1
    on_card.estimate(mode="improved")
    assert on_card.stats.estimate_cache_hits == 0 and on_card.stats.packs == 1


def test_default_device_is_the_card_and_never_falls_back(dataset, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert EngineConfig().device == "cuda"
    with pytest.raises(RuntimeError, match="cuda"):
        EstimationEngine(EngineConfig())
    with pytest.raises(RuntimeError, match="cuda"):
        StatsCatalog(dataset)
    with pytest.raises(RuntimeError, match="cuda"):
        default_engine()
    with pytest.raises(ValueError):
        EngineConfig(device="tpu")
    with pytest.raises(ValueError):
        EngineConfig(backend="pallas")


@pytest.mark.parametrize("strategy", ["sharded", "composed"])
def test_multi_device_strategies_are_not_ported_yet(dataset, strategy):
    cat = StatsCatalog(dataset, engine=_cpu(strategy=strategy))
    with pytest.raises(NotImplementedError, match="Queue A item 11"):
        cat.estimate()


def test_schema_bounds_and_columns_api(dataset):
    cat = StatsCatalog(dataset, engine=_cpu())
    names = cat.column_names
    bounded = cat.estimate(mode="paper", schema_bounds={names[0]: 3.0})
    assert bounded[names[0]].ndv <= 3.0
    merged = cat.merged_metadata()
    eng = _cpu()
    direct = eng.estimate_columns([merged[n] for n in names], mode="paper")
    assert {e.column_name: e for e in direct} == cat.estimate(mode="paper")
    bounds = [2.0] + [float("inf")] * (len(names) - 1)
    capped = eng.estimate_columns([merged[n] for n in names], bounds, mode="paper")
    assert capped[0].ndv <= 2.0 and capped[1:] == direct[1:]


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["paper", "improved"])
def test_catalog_on_cuda_launches_every_kernel_and_matches_cpu(dataset, mode):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    gpu = StatsCatalog(dataset)
    build.reset_launch_counts()
    got = gpu.estimate(mode=mode)
    assert all(v > 0 for v in build.launch_counts().values())
    want = StatsCatalog(dataset, engine=_cpu()).estimate(mode=mode)
    _assert_same(got, want, 1e-3)
    assert gpu.stats.device_puts == 1


def test_incremental_update_matches_a_fresh_scan(tmp_path):
    rng = np.random.default_rng(4)

    def shard(i):
        return {"k": rng.integers(0, 300, 1024).astype(np.int64),
                "s": rng.choice(np.array(["a", "bb", "ccc"]), 1024)}

    opts = writer.WriterOptions(row_group_size=256)
    for i in range(2):
        writer.write_file(str(tmp_path / f"shard_{i}"), shard(i), options=opts)
    cat = StatsCatalog(str(tmp_path), engine=_cpu())
    before = cat.estimate(mode="improved")
    assert cat.num_resident_batches == 1
    writer.write_file(str(tmp_path / "shard_2"), shard(2), options=opts)
    summary = cat.update()
    assert (summary.added, summary.updated, summary.removed, summary.total) == (1, 0, 0, 3)
    assert cat.num_resident_batches == 0
    after = cat.estimate(mode="improved")
    assert after == StatsCatalog(str(tmp_path), engine=_cpu()).estimate(mode="improved")
    assert after != before and cat.stats.device_puts == 2
    assert cat.estimate_column("k", mode="improved") == after["k"]
