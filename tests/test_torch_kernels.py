"""PyTorch port: the three kernels' plain versions against the JAX kernels.

On the CPU each wrapper runs its kernel's plain PyTorch version, and the JAX
side runs its Pallas kernel in interpret mode through `repro.kernels.ops`
(as `tests/test_kernels.py` does). Tolerances are the JAX package's own for
these kernels: dict_newton rtol=1e-4, coupon_newton rtol=1e-3 (near-saturated
lanes are ill-conditioned), minmax_scan rtol=atol=1e-5 on the float sum and
exact on the integer-valued fields.

The tests marked `cuda` hold each CUDA kernel against its plain version on
the card; they skip where no card is visible, and need no JAX, so they also
run on a machine that has a card and no JAX.
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels import build, minmax_scan, newton_ndv
from repro_torch.kernels import ops as tops

try:  # the reference: absent where only the `cuda` tests run
    import jax.numpy as jnp
    from repro.kernels import ops as jops
except ImportError:
    jnp = jops = None

EXACT_FIELDS = ("gmin", "gmax", "sign_changes", "n_valid", "shared_bounds")


@pytest.fixture()
def jax_ref():
    if jops is None:
        pytest.skip("needs the JAX package, the reference")


@pytest.fixture()
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _dict_inputs(m, len_scale, seed, powers_of_two=False):
    """The sweep of tests/test_kernels.py. With `powers_of_two`, a quarter of
    the lanes have an exact power of two as their NDV: there Eq 1 has two
    roots (the plateau boundary), and an approximate log2 flips the width."""
    rng = np.random.default_rng(seed)
    ndv = rng.integers(1, 1_000_000, m).astype(np.float64)
    if powers_of_two:
        ndv[: m // 4] = 2.0 ** rng.integers(0, 20, m // 4)
    rows = ndv * rng.uniform(1.5, 80, m)
    nulls = rows * rng.uniform(0, 0.2, m)
    mean_len = rng.uniform(1, 8, m) * len_scale
    bits = np.maximum(np.ceil(np.log2(np.maximum(ndv, 1)) - 1e-9), 1)
    S = ndv * mean_len + (rows - nulls) * bits / 8
    return [a.astype(np.float32) for a in (S, rows, nulls, mean_len)]


def _coupon_inputs(m, seed):
    rng = np.random.default_rng(seed)
    n = rng.integers(2, 4096, m).astype(np.float32)
    D = rng.uniform(1, 1e6, m).astype(np.float32)
    obs = (D * (1 - np.exp(-n / D))).astype(np.float32)
    obs[: m // 5] = n[: m // 5]  # saturated lanes
    return obs, n


def _minmax_inputs(b, r, seed):
    rng = np.random.default_rng(seed)
    mins = rng.normal(size=(b, r)).astype(np.float32)
    maxs = mins + np.abs(rng.normal(size=(b, r))).astype(np.float32)
    mins[:, ::5] = np.round(mins[:, ::5])  # ties: zero deltas, shared bounds
    maxs[:, :-1:3] = mins[:, 1::3][:, : maxs[:, :-1:3].shape[1]]
    maxs = np.maximum(maxs, mins)
    lengths = rng.integers(0, r + 1, b)
    valid = np.arange(r)[None, :] < lengths[:, None]  # packed to the left
    return mins, maxs, valid


@pytest.mark.parametrize("m", [7, 1000])
@pytest.mark.parametrize("len_scale", [1.0, 32.0])
def test_dict_newton_plain_matches_jax_kernel(m, len_scale, jax_ref):
    args = _dict_inputs(m, len_scale, seed=m)
    want = np.asarray(jops.dict_newton(*[jnp.asarray(a) for a in args], backend="pallas"))
    got = newton_ndv.dict_newton(*[torch.from_numpy(a) for a in args]).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-4)
    ref = np.asarray(jops.dict_newton(*[jnp.asarray(a) for a in args], backend="ref"))
    tref = tops.dict_newton(*[torch.from_numpy(a) for a in args], backend="ref").numpy()
    np.testing.assert_allclose(tref, ref, rtol=1e-4)


@pytest.mark.parametrize("m", [65, 4096])
def test_coupon_newton_plain_matches_jax_kernel(m, jax_ref):
    obs, n = _coupon_inputs(m, seed=m)
    want = np.asarray(jops.coupon_newton(jnp.asarray(obs), jnp.asarray(n), backend="pallas"))
    got = newton_ndv.coupon_newton(torch.from_numpy(obs), torch.from_numpy(n)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-3)
    ref = np.asarray(jops.coupon_newton(jnp.asarray(obs), jnp.asarray(n), backend="ref"))
    tref = tops.coupon_newton(torch.from_numpy(obs), torch.from_numpy(n), backend="ref").numpy()
    np.testing.assert_allclose(tref, ref, rtol=1e-3)


@pytest.mark.parametrize("b,r", [(1, 2), (3, 17), (32, 64)])
def test_minmax_scan_plain_matches_jax_kernel(b, r, jax_ref):
    mins, maxs, valid = _minmax_inputs(b, r, seed=b * r)
    want = jops.minmax_scan(jnp.asarray(mins), jnp.asarray(maxs), jnp.asarray(valid),
                            backend="pallas")
    got = minmax_scan.minmax_scan(torch.from_numpy(mins), torch.from_numpy(maxs),
                                  torch.from_numpy(valid))
    for f in got._fields:
        a, w = getattr(got, f).numpy(), np.asarray(getattr(want, f))
        if f in EXACT_FIELDS:
            assert np.array_equal(a, w), f
        else:
            np.testing.assert_allclose(a, w, rtol=1e-5, atol=1e-5, err_msg=f)
    ref = tops.minmax_scan(torch.from_numpy(mins), torch.from_numpy(maxs),
                           torch.from_numpy(valid), backend="ref")
    for f in EXACT_FIELDS:
        assert torch.equal(getattr(ref, f), getattr(got, f)), f


def test_ceil_log2_exact_at_powers_of_two():
    """The bit width is exact at every power of two (torch's log2 is exact
    there; XLA's CPU log2 is not at some 2^k, see ROADMAP Queue C)."""
    k = torch.arange(0, 31, dtype=torch.float32)
    assert torch.equal(newton_ndv._ceil_log2(2.0 ** k), torch.clamp(k, min=1.0))
    assert torch.equal(newton_ndv._ceil_log2(2.0 ** k + 0.5)[1:20], k[1:20] + 1)


def test_cpu_wrappers_run_plain_versions_and_launch_nothing():
    build.reset_launch_counts()
    args = [torch.from_numpy(a) for a in _dict_inputs(64, 4.0, seed=1)]
    assert torch.equal(newton_ndv.dict_newton(*args), newton_ndv.dict_newton_math(*args))
    obs, n = (torch.from_numpy(a) for a in _coupon_inputs(64, seed=2))
    assert torch.equal(newton_ndv.coupon_newton(obs, n), newton_ndv.coupon_newton_math(obs, n))
    mm = [torch.from_numpy(a) for a in _minmax_inputs(4, 9, seed=3)]
    for a, b in zip(minmax_scan.minmax_scan(*mm), minmax_scan.minmax_metrics_math(*mm)):
        assert torch.equal(a, b)
    assert build.launch_counts() == {"dict_newton": 0, "coupon_newton": 0, "minmax_scan": 0}


def test_cuda_backend_refuses_cpu_tensors():
    args = [torch.from_numpy(a) for a in _dict_inputs(8, 1.0, seed=4)]
    with pytest.raises(RuntimeError, match="cuda"):
        tops.dict_newton(*args, backend="cuda")
    with pytest.raises(RuntimeError, match="cuda"):
        tops.coupon_newton(args[0], args[1], backend="cuda")
    mm = [torch.from_numpy(a) for a in _minmax_inputs(2, 5, seed=5)]
    with pytest.raises(RuntimeError, match="cuda"):
        tops.minmax_scan(*mm, backend="cuda")
    with pytest.raises(ValueError):
        tops.use_kernels("pallas")


def test_wrappers_check_shapes_and_devices():
    meta = torch.ones(4, device="meta")
    with pytest.raises(ValueError, match="CPU or all CUDA"):
        newton_ndv.dict_newton(meta, meta, meta, meta)
    with pytest.raises(ValueError, match="CPU or all CUDA"):
        newton_ndv.coupon_newton(meta, torch.ones(4))
    x = torch.ones(4)
    with pytest.raises(ValueError):
        newton_ndv.dict_newton(x, x, x, torch.ones(5))
    with pytest.raises(ValueError):
        newton_ndv.coupon_newton(torch.ones(2, 2), torch.ones(2, 2))
    with pytest.raises(ValueError):
        minmax_scan.minmax_scan(torch.ones(2, 3), torch.ones(2, 3), torch.ones(2, 4, dtype=torch.bool))


def test_build_paths_stay_in_the_repository():
    assert build.build_dir().name == "build"
    assert (build.build_dir().parent / "src" / "repro_torch").is_dir()
    for src in build.SOURCES:
        assert (build.CSRC / src).is_file()
    assert "-fmad=false" in build.NVCC_FLAGS
    assert not any("fast" in f for f in build.NVCC_FLAGS)
    assert "arch=compute_90a,code=sm_90a" in build.NVCC_FLAGS


# -- on the card -------------------------------------------------------------


@pytest.mark.cuda
@pytest.mark.parametrize("m", [1, 1000, 1 << 20])
def test_dict_newton_kernel_matches_plain_on_cuda(cuda, m):
    args = [torch.from_numpy(a).to(cuda)
            for a in _dict_inputs(m, 8.0, seed=m, powers_of_two=True)]
    before = build.LAUNCHES["dict_newton"]
    got = newton_ndv.dict_newton(*args)
    assert build.LAUNCHES["dict_newton"] == before + 1
    torch.testing.assert_close(got, newton_ndv.dict_newton_math(*args), rtol=1e-4, atol=0)
    torch.testing.assert_close(
        newton_ndv.dict_newton_math(*args).cpu(),
        newton_ndv.dict_newton_math(*[a.cpu() for a in args]), rtol=1e-4, atol=0,
    )


@pytest.mark.cuda
@pytest.mark.parametrize("m", [1, 4096, 1 << 20])
def test_coupon_newton_kernel_matches_plain_on_cuda(cuda, m):
    obs, n = (torch.from_numpy(a).to(cuda) for a in _coupon_inputs(m, seed=m))
    got = newton_ndv.coupon_newton(obs, n)
    torch.testing.assert_close(got, newton_ndv.coupon_newton_math(obs, n), rtol=1e-3, atol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("b,r", [(1, 1), (3, 17), (64, 1024), (4096, 300)])
def test_minmax_scan_kernel_matches_plain_on_cuda(cuda, b, r):
    mm = [torch.from_numpy(a).to(cuda) for a in _minmax_inputs(b, r, seed=b + r)]
    got, want = minmax_scan.minmax_scan(*mm), minmax_scan.minmax_metrics_math(*mm)
    for f in got._fields:
        if f in EXACT_FIELDS:
            assert torch.equal(getattr(got, f), getattr(want, f)), f
        else:
            torch.testing.assert_close(getattr(got, f), getattr(want, f), rtol=1e-5, atol=1e-5)


@pytest.mark.cuda
def test_kernels_reject_what_they_cannot_read(cuda):
    x = torch.ones(8, device=cuda)
    with pytest.raises(TypeError):
        newton_ndv.dict_newton(x, x, x, x.double())
    with pytest.raises(ValueError):
        newton_ndv.coupon_newton(x, torch.ones(8))
    with pytest.raises(ValueError):
        m = torch.ones(4, 4, device=cuda).t()
        minmax_scan.minmax_scan(m, m, torch.ones(4, 4, dtype=torch.bool, device=cuda))
