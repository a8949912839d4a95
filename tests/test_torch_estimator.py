"""PyTorch port: the whole estimator (`estimate_batch`) against the JAX package.

The same packed batch (packed by the JAX packer, carried across with
`batch_from_numpy`) goes through both packages on the CPU, in both modes:

* the reference configuration — port `backend="ref"` against JAX
  `estimate_batch(backend="ref", fuse="off")`: floats rtol=1e-5;
* the kernel-path configuration — port `backend="auto"` (the kernels' plain
  versions on the CPU) against JAX `estimate_batch(backend="pallas",
  fuse="off")` (Pallas in interpret mode): floats rtol=1e-3, bounded by
  coupon_newton's tolerance.

Discrete fields (layout, route, clamp_flags, is_lower_bound, both iteration
counts) must match exactly. route_margin, detector_margin and dict_residual
are differences of O(1) quantities, so they are held at atol = rtol as well.
"""
import numpy as np
import pytest
import torch

from repro_torch.catalog.packer import BatchPacker
from repro_torch.core.ndv import estimator as port_est
from repro_torch.core.ndv.types import (
    ColumnBatch,
    ColumnMetadata,
    PhysicalType,
    batch_from_numpy,
)
from repro_torch.kernels import ops as tops

try:  # the reference: absent where only the `cuda` tests run
    import jax.numpy as jnp
    from repro.catalog.packer import BatchPacker as JaxPacker
    from repro.core.ndv import estimator as jest
    from repro.core.ndv.types import ColumnMetadata as JaxMeta
except ImportError:
    jnp = JaxPacker = jest = JaxMeta = None

DISCRETE = ("layout", "is_lower_bound", "dict_iterations", "route",
            "coupon_iterations", "clamp_flags")
MARGINS = ("route_margin", "detector_margin", "dict_residual")
FIELDS = [f for f in ColumnBatch.__dataclass_fields__]


@pytest.fixture()
def jax_ref():
    if jest is None:
        pytest.skip("needs the JAX package, the reference")


def _columns(seed: int, B: int, R: int):
    """Fields of B seeded columns across the layouts the detector tells
    apart, as dicts that either package's ColumnMetadata takes."""
    rng = np.random.default_rng(seed)
    kinds = ("uniform", "sorted", "partitioned", "clustered", "low", "plain",
             "single", "flags")
    cols = []
    for b in range(B):
        kind = kinds[b % len(kinds)]
        n = 1 if kind == "single" else int(rng.integers(max(2, R // 2), R + 1))
        rows = np.full(n, float(rng.integers(2000, 20000)))
        nulls = np.floor(rows * (rng.uniform(0, 0.1) if b % 3 == 0 else 0.0))
        nn = rows - nulls
        D = float(rng.integers(2, 60)) if kind in ("low", "flags") else float(
            int(10 ** rng.uniform(2, 6)))
        if kind in ("sorted", "partitioned"):
            local = np.full(n, max(1.0, D / n))
        elif kind == "clustered":
            local = (D / 8) * -np.expm1(-nn / (D / 8))
        else:
            local = D * -np.expm1(-nn / D)
        local = np.clip(np.round(local), 1, nn)
        mean_len = 1.0 if kind == "flags" else float(rng.uniform(4, 16))
        bits = np.maximum(np.ceil(np.log2(local)), 1)
        dict_enc = (local / nn < 0.6) & (kind != "plain")
        sizes = np.where(dict_enc, local * mean_len + nn * bits / 8, nn * mean_len)
        if kind in ("sorted", "partitioned"):
            edges = np.linspace(0, D, n + 1)
            mins, maxs = np.floor(edges[:-1]), np.ceil(edges[1:]) - 1
            maxs = np.maximum(mins, maxs)
            if kind == "partitioned":
                perm = rng.permutation(n)
                mins, maxs = mins[perm], maxs[perm]
        elif kind == "clustered":
            c = rng.uniform(0, D, n)
            mins = np.floor(np.clip(c - D / 6, 0, D - 1))
            maxs = np.floor(np.clip(c + D / 6, 0, D - 1))
        else:
            mins = rng.integers(0, 3, n).astype(np.float64)
            maxs = (D - 1) - rng.integers(0, 3, n)
        ptype = PhysicalType.BYTE_ARRAY if kind == "flags" or b % 5 == 4 else PhysicalType.INT64
        lens = np.full(n, 1.0 if kind == "flags" else 8.0)
        cols.append(dict(
            chunk_sizes=sizes, chunk_rows=rows, chunk_nulls=nulls,
            chunk_dict_encoded=dict_enc, mins=mins, maxs=maxs,
            min_lengths=lens, max_lengths=lens,
            distinct_min_count=float(np.unique(mins).size),
            distinct_max_count=float(np.unique(maxs).size),
            physical_type=int(ptype), column_name=f"c{b}_{kind}",
        ))
    return cols


def _port_batch(seed, B, R):
    return BatchPacker().pack([ColumnMetadata(**{**c, "physical_type": PhysicalType(c["physical_type"])})
                               for c in _columns(seed, B, R)])


def _both(seed, B, R, bounds=False):
    jb = JaxPacker().pack([JaxMeta(**c) for c in _columns(seed, B, R)])
    tb = batch_from_numpy({f: np.asarray(getattr(jb, f)) for f in FIELDS}, "cpu")
    sb = None
    if bounds:
        rng = np.random.default_rng(seed + 1)
        sb = np.where(rng.uniform(size=jb.batch) < 0.5,
                      rng.uniform(1, 500, jb.batch), np.inf).astype(np.float32)
    return jb, tb, sb


def assert_estimates_close(got, want, rtol):
    assert got._fields == tuple(want._fields)
    for f in want._fields:
        a, w = getattr(got, f).numpy(), np.asarray(getattr(want, f))
        assert a.shape == w.shape, f
        if f in DISCRETE:
            bad = np.nonzero(a != w)[0]
            assert bad.size == 0, (f, bad[:5], a[bad[:5]], w[bad[:5]])
        else:
            atol = rtol if f in MARGINS else 0.0
            np.testing.assert_allclose(a, w, rtol=rtol, atol=atol, err_msg=f)


@pytest.mark.parametrize("mode", ["paper", "improved"])
@pytest.mark.parametrize("B,R,bounds", [(8, 9, False), (32, 64, True)])
def test_reference_config_matches_jax(mode, B, R, bounds, jax_ref):
    jb, tb, sb = _both(B * R, B, R, bounds)
    want = jest.estimate_batch(jb, None if sb is None else jnp.asarray(sb),
                               mode=mode, backend="ref", fuse="off")
    got = port_est.estimate_batch(tb, None if sb is None else torch.from_numpy(sb),
                               mode=mode, backend="ref", fuse="off")
    assert_estimates_close(got, want, rtol=1e-5)


@pytest.mark.parametrize("mode", ["paper", "improved"])
@pytest.mark.parametrize("B,R,bounds", [(8, 9, True), (32, 64, False)])
def test_kernel_path_config_matches_jax(mode, B, R, bounds, jax_ref):
    jb, tb, sb = _both(B * R + 1, B, R, bounds)
    want = jest.estimate_batch(jb, None if sb is None else jnp.asarray(sb),
                               mode=mode, backend="pallas", fuse="off")
    got = port_est.estimate_batch(tb, None if sb is None else torch.from_numpy(sb),
                               mode=mode, backend="auto", fuse="off")
    assert_estimates_close(got, want, rtol=1e-3)
    assert (got.dict_iterations[tb.n_groups > 0] == 16).all()
    assert (got.coupon_iterations == 40).all()


def test_materialised_estimates_and_provenance_match_jax(jax_ref):
    jb, tb, _ = _both(5, 16, 12)
    names = [f"c{i}" for i in range(12)]
    want = jest.estimate_batch(jb, mode="improved", backend="ref", fuse="off")
    got = port_est.estimate_batch(tb, mode="improved", backend="ref", fuse="off")
    for a, w in zip(port_est.estimates_from_batch(got, tb, names, offset=2),
                    jest.estimates_from_batch(want, jb, names, offset=2)):
        assert a.column_name == w.column_name and a.layout == w.layout
        assert a.is_lower_bound == w.is_lower_bound and a.len_sample_size == w.len_sample_size
        np.testing.assert_allclose(a.ndv, w.ndv, rtol=1e-5)
    for a, w in zip(port_est.provenance_from_batch(got, tb, names),
                    jest.provenance_from_batch(want, jb, names)):
        for f in ("route", "layout", "dict_iterations", "coupon_iterations",
                  "clamp_flags", "clamps", "schema_bound_hit", "is_lower_bound"):
            assert getattr(a, f) == getattr(w, f), f
    for flags in range(16):
        assert port_est.clamp_names(flags) == jest.clamp_names(flags)


@pytest.mark.parametrize("mode", ["paper", "improved"])
def test_fuse_knob_on_the_cpu(mode):
    tb = _port_batch(11, 12, 20)
    off = port_est.estimate_batch(tb, mode=mode, fuse="off")
    auto = port_est.estimate_batch(tb, mode=mode, fuse="auto")
    for a, b in zip(off, auto):
        assert torch.equal(a, b)
    on = port_est.estimate_batch(tb, mode=mode, fuse="on")
    core = port_est.estimate_batch_core(
        tb, torch.full((tb.batch,), float("inf")), mode=mode, backend="ref"
    )
    for a, b in zip(on, core):
        assert torch.equal(a, b)
    on_ref = port_est.estimate_batch(tb, mode=mode, backend="ref", fuse="on")
    for a, b in zip(on_ref, core):
        assert torch.equal(a, b)
    with pytest.raises(RuntimeError, match="cuda"):
        port_est.estimate_batch(tb, mode=mode, backend="cuda", fuse="on")
    with pytest.raises(ValueError):
        port_est.estimate_batch(tb, mode=mode, fuse="always")


def test_cache_tokens_are_the_ports_own():
    assert tops.cache_token("auto", "cuda") == tops.cache_token("cuda", "cuda") == "t.cuda"
    assert tops.cache_token("auto", "cpu") == "t.cpu"
    assert tops.cache_token("ref", "cuda") == "t.ref.cuda"
    assert tops.cache_token("ref", "cpu") == "t.ref.cpu"


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["paper", "improved"])
def test_cuda_pipeline_matches_cpu_and_refuses_fuse_on(mode):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    tb = _port_batch(13, 32, 64)
    cpu = port_est.estimate_batch(tb, mode=mode)
    dev = tb.to("cuda")
    got = port_est.estimate_batch(dev, mode=mode, backend="cuda")
    assert_estimates_close(
        type(got)(*[x.cpu() for x in got]), type(cpu)(*[x.numpy() for x in cpu]), rtol=1e-3
    )
    with pytest.raises(NotImplementedError, match="Queue B item 1"):
        port_est.estimate_batch(dev, mode=mode, fuse="on")
