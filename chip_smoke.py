#!/usr/bin/env python3
"""Build the PyTorch port's CUDA kernels and drive its main path on one card.

Run from the root of the repository, on a machine with an NVIDIA H100 and
the CUDA toolkit:

    python3 chip_smoke.py

It imports `repro_torch` from `src/` and nothing of JAX or of the JAX
package. Phases, each of which fails the run (non-zero exit) if it fails:

  1. build    nvcc compiles every kernel source into build/ for sm_90a;
              prints the build seconds, ptxas's register report and the
              card's name and power limit.
  2. kernels  each kernel's wrapper against its plain PyTorch version on the
              card, at the shapes the warehouse-scale estimate gives it:
              max errors within the stated tolerances, CUDA-event times
              (warm, median of 25 launches, L2 flushed before each), the
              plain version's time, and the roofline bound.
  3. catalog  a PQLite dataset written by the port's writer (the
              `datasets.lineitem` columns plus `generator.standard_suite`,
              over several files) estimated through
              `StatsCatalog(root).estimate(mode=...)` on "cuda" with the
              default `EngineConfig`, in both modes: equal to the same
              catalog on the CPU (discrete fields exact, floats rtol 1e-3),
              every kernel's launch count moved, one host-to-device copy of
              the batch after a warm estimate; cold and warm latency.
  4. scale    the engine on a warehouse catalog of B = 4096 columns x
              R = 1024 row groups (seeded `ColumnMetadata` across six
              layouts, packed by the port's `BatchPacker`) in both modes:
              the launch counts of this main-path run, latency, device
              memory peak; `chunked` (max_batch=1024) bit-identical to
              `local`; equal to the CPU within the same tolerances.
  5. report   one JSON line with every kernel's numbers, the card's name
              and power limit from nvidia-smi, and as the last line
              {"ok": true, "device": {"platform": "gpu", ...}}.

Without a CUDA device it prints nothing to standard output and exits 2.
"""
from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))

# H100 SXM peaks (NVIDIA data sheet, at the 700 W limit): HBM3 bytes/s and
# float32 operations/s outside the tensor cores.
HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12

# Operations per lane (or per (b, r) cell) that each function does on its
# inputs, counting every arithmetic op, compare, select, min/max and
# transcendental as one, from the plain versions in src/repro_torch/kernels:
#   dict_newton   7 set-up + 16 iterations x 19 + 20 for the plateau snap
#   coupon_newton 17 set-up + 40 iterations x 18 + 8 for the guards
#   minmax_scan   26 per cell (count, min, max, overlap, midpoints, signs,
#                 shared bounds)
DICT_OPS_PER_LANE = 7 + 16 * 19 + 20
COUPON_OPS_PER_LANE = 17 + 40 * 18 + 8
MINMAX_OPS_PER_CELL = 26

SCALE_B, SCALE_R = 4096, 1024
ROWS_PER_GROUP = 1 << 20
LAYOUTS = ("uniform", "zipf", "sorted", "partitioned", "clustered", "low_ndv")
SEED = 0
RTOL_PIPELINE = 1e-3   # kernel-path floats, bounded by coupon_newton
TOL = {"dict_newton": 1e-4, "coupon_newton": 1e-3, "minmax_scan": 1e-5}
DISCRETE = ("layout", "is_lower_bound", "dict_iterations", "route",
            "coupon_iterations", "clamp_flags")
# Provenance fields that are differences of O(1) quantities (1 - ratio, the
# distance to a threshold, a normalised residual): near zero their error is
# absolute, so they are held at atol = rtol as well.
MARGINS = ("route_margin", "detector_margin", "dict_residual")


def log(msg: str) -> None:
    print(msg, flush=True)


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()
    return out[0].strip()


# ---------------------------------------------------------------------------
# Phase 4 data: a warehouse catalog as footer metadata
# ---------------------------------------------------------------------------


def warehouse_columns(B: int, R: int, seed: int):
    """B seeded `ColumnMetadata` of up to R row groups of 1 M rows each.

    256 tables x 16 columns of ~1 B rows at B = 4096. The layouts cycle
    through uniform, zipf, sorted, partitioned, clustered and low-NDV; every
    fourth column is a string column; a third carry nulls; one in eight has
    fewer row groups than R, so the packer's masks are exercised.
    """
    from repro_torch.core.ndv.types import ColumnMetadata, PhysicalType

    rng = np.random.default_rng(seed)
    cols = []
    for b in range(B):
        kind = LAYOUTS[b % len(LAYOUTS)]
        is_str = b % 4 == 3
        n = R if b % 8 else int(rng.integers(R // 2, R))
        rows = np.full(n, float(ROWS_PER_GROUP))
        nulls = np.floor(rows * (rng.uniform(0, 0.05) if b % 3 == 0 else 0.0))
        nn = rows - nulls
        total = float(nn.sum())
        D = float(rng.integers(2, 200)) if kind == "low_ndv" else float(
            min(int(10 ** rng.uniform(2, 9.5)), total)
        )
        if kind in ("sorted", "partitioned"):
            local = np.full(n, max(1.0, D / n))
        elif kind == "zipf":
            local = D * -np.expm1(-nn / D) * rng.uniform(0.3, 0.9, n)
        elif kind == "clustered":
            local = (D / 8) * -np.expm1(-nn / (D / 8))
        else:
            local = D * -np.expm1(-nn / D)
        local = np.clip(np.round(local), 1, nn)
        mean_len = float(rng.uniform(6, 24)) if is_str else 8.0
        bits = np.maximum(np.ceil(np.log2(local)), 1)
        dict_enc = local / nn < 0.6
        sizes = np.where(dict_enc, local * mean_len + nn * bits / 8, nn * mean_len)

        if kind in ("sorted", "partitioned"):
            edges = np.linspace(0, D, n + 1)
            mins = np.floor(edges[:-1])
            maxs = np.maximum(mins, np.ceil(edges[1:]) - 1)
            if kind == "partitioned":
                perm = rng.permutation(n)
                mins, maxs = mins[perm], maxs[perm]
        elif kind == "clustered":
            center = rng.uniform(0, D, n)
            mins = np.floor(np.clip(center - D / 6, 0, D - 1))
            maxs = np.floor(np.clip(center + D / 6, 0, D - 1))
        else:
            tail = max(1, int(D / 1000))
            mins = rng.integers(0, tail + 1, n).astype(np.float64)
            maxs = (D - 1) - rng.integers(0, tail + 1, n)
        if is_str:
            lens_min = rng.integers(max(1, int(mean_len) - 3), int(mean_len) + 4, n)
            lens_max = rng.integers(max(1, int(mean_len) - 3), int(mean_len) + 4, n)
            ptype = PhysicalType.BYTE_ARRAY
        else:
            lens_min = lens_max = np.full(n, 8)
            ptype = PhysicalType.INT64
        cols.append(ColumnMetadata(
            chunk_sizes=sizes, chunk_rows=rows, chunk_nulls=nulls,
            chunk_dict_encoded=dict_enc, mins=mins, maxs=maxs,
            min_lengths=lens_min.astype(np.float64),
            max_lengths=lens_max.astype(np.float64),
            distinct_min_count=float(np.unique(mins).size),
            distinct_max_count=float(np.unique(maxs).size),
            physical_type=ptype, column_name=f"t{b // 16:03d}.c{b % 16:02d}_{kind}",
        ))
    return cols


# ---------------------------------------------------------------------------
# Comparison helpers
# ---------------------------------------------------------------------------


def max_errors(got, want):
    import torch

    got = got.double().cpu()
    want = want.double().cpu()
    abs_err = (got - want).abs()
    rel = abs_err / want.abs().clamp(min=1e-30)
    return float(abs_err.max()) if abs_err.numel() else 0.0, (
        float(rel.max()) if rel.numel() else 0.0
    )




def clamp_steps(est, batch):
    """Per lane and CLAMP_* bit of the §7 combine: the estimate just before
    that bound, the bound, and where the bound applies, replayed in
    `combine_estimates`' order from the estimates' components (no schema
    bounds are given here)."""
    import torch
    from repro_torch.core.ndv import combine

    est = type(est)(*[x.cpu() for x in est])
    v = batch.valid
    gmin = torch.where(v, batch.mins, 3.4e38).amin(dim=-1)
    gmax = torch.where(v, batch.maxs, -3.4e38).amax(dim=-1)
    cap = torch.clamp(torch.clamp(batch.N - batch.nulls, min=0.0), min=1.0)
    pre_cap = torch.maximum(est.ndv_dict, est.ndv_minmax)
    pre_range = torch.minimum(pre_cap, cap)
    range_bound = torch.clamp(gmax - gmin + 1.0, min=1.0)
    pre_byte = torch.where(batch.int_like, torch.minimum(pre_range, range_bound), pre_range)
    return {
        combine.CLAMP_NON_NULL: (pre_cap, cap, torch.ones_like(batch.int_like)),
        combine.CLAMP_INT_RANGE: (pre_range, range_bound, batch.int_like),
        combine.CLAMP_SINGLE_BYTE: (pre_byte, torch.clamp(cap, max=128.0), batch.single_byte),
    }


def replay_flags(steps):
    """clamp_flags as `combine_estimates` sets them from `clamp_steps`."""
    import torch

    flags = 0
    for bit, (pre, bound, applies) in steps.items():
        flags = flags | torch.where(applies & (bound < pre), bit, 0).to(torch.int32)
    return flags


def ulps_apart(x, bound):
    """|x - bound| in units of the float32 spacing at `bound`."""
    import torch

    spacing = torch.nextafter(bound, torch.full_like(bound, float("inf"))) - bound
    return ((x - bound).abs() / spacing).double()


def tie_window_ulps(bound, n_groups):
    """How far float32 rounding alone can move an estimate that equals
    `bound` in exact arithmetic, in ulps of `bound`. Improved mode's
    estimate reaches a dense key's range bound through two round trips in
    log space (the coupon inversion's exp(log D) per chunk, improved.py's
    exp(log x) blend) and a mean over the chunks. Each round trip is off by
    at most one ulp of the logarithm, |ln b| * 2^-23 relative, plus two
    ulps of expf; the mean by log2(n) * 2^-24. At R = 1024: 27 ulps at a
    bound of 335, 29 at 1254."""
    import torch

    b = bound.double()
    rel = (2.0 * torch.log(b).abs() + 4.0
           + 0.5 * torch.log2(n_groups.double().clamp(min=1.0))) * 2.0 ** -23
    spacing = (torch.nextafter(bound, torch.full_like(bound, float("inf"))) - bound).double()
    return torch.ceil(rel * b / spacing)


def check_clamp_ties(name, got, want, batch):
    """clamp_flags records whether a bound STRICTLY lowered the estimate.
    Where the estimate before the bound equals the bound, its last ulp
    decides the flag, and the card's and the CPU's math libraries may
    decide it differently. Every lane whose flags differ must be such a
    tie: for each differing bit, the estimate just before that bound is
    within `tie_window_ulps` of the bound on both devices. Prints every tie
    lane (ROADMAP Queue C item 2)."""
    a, b = got.clamp_flags.cpu(), want.clamp_flags.cpu()
    lanes = (a != b).nonzero().flatten().tolist()
    steps_got, steps_want = clamp_steps(got, batch), clamp_steps(want, batch)
    for dev, steps, flags in (("cuda", steps_got, a), ("cpu", steps_want, b)):
        if not bool((replay_flags(steps) == flags).all()):
            raise AssertionError(f"{name}: the replayed combine does not give the "
                                 f"{dev} clamp_flags, so its ties cannot be shown")
    worst = 0.0
    for i in lanes:
        for bit in steps_got:
            if not (int(a[i]) ^ int(b[i])) & bit:
                continue
            (pg, bound, _), (pw, _, _) = steps_got[bit], steps_want[bit]
            ug = float(ulps_apart(pg[i:i + 1], bound[i:i + 1]))
            uw = float(ulps_apart(pw[i:i + 1], bound[i:i + 1]))
            window = float(tie_window_ulps(bound[i:i + 1], batch.n_groups[i:i + 1]))
            log(f"[{name}] clamp tie lane {i} bit {bit}: flags cuda {int(a[i])} cpu "
                f"{int(b[i])}; estimate before the bound cuda {float(pg[i])!r} "
                f"({ug:g} ulp) cpu {float(pw[i])!r} ({uw:g} ulp), bound "
                f"{float(bound[i])!r}, tie window {window:g} ulp; ndv cuda {float(got.ndv[i])!r} cpu "
                f"{float(want.ndv[i])!r}; route_margin {float(want.route_margin[i]):.6g}, "
                f"detector_margin {float(want.detector_margin[i]):.6g}")
            if ug > window or uw > window:
                raise AssertionError(
                    f"{name}: clamp_flags differ on lane {i} ({int(a[i])} vs "
                    f"{int(b[i])}) where the estimate before bound {bit} is "
                    f"{ug:g} / {uw:g} ulps from it, outside the tie window of "
                    f"{window:g}")
            worst = max(worst, ug, uw)
    log(f"[{name}] clamp_flags differ on {len(lanes)} of {a.numel()} lanes, each a "
        f"tie of the estimate with the bound (at most {worst:g} float32 ulps apart)")


def compare_estimates(name, got, want, rtol, batch=None):
    """BatchEstimates on two devices: discrete fields exact, floats rtol.

    With `batch`, clamp_flags may differ only on lanes where the estimate
    ties with the bound (`check_clamp_ties`); every other discrete field
    stays exact."""
    import torch

    worst = {}
    for f in got._fields:
        a, b = getattr(got, f).cpu(), getattr(want, f).cpu()
        if a.shape != b.shape:
            raise AssertionError(f"{name}: {f} shape {tuple(a.shape)} != {tuple(b.shape)}")
        if f == "clamp_flags" and batch is not None:
            check_clamp_ties(name, got, want, batch)
            continue
        if f in DISCRETE:
            bad = (a != b).nonzero().flatten()
            if bad.numel():
                i = int(bad[0])
                raise AssertionError(
                    f"{name}: discrete field {f} differs on {bad.numel()} lanes, "
                    f"first lane {i}: {a[i].item()} vs {b[i].item()} "
                    f"(detector_margin {float(want.detector_margin[i])}, "
                    f"route_margin {float(want.route_margin[i])})"
                )
        else:
            if not bool(torch.isfinite(a).all()):
                raise AssertionError(f"{name}: {f} has non-finite values")
            atol = rtol if f in MARGINS else 0.0
            torch.testing.assert_close(a, b, rtol=rtol, atol=atol, msg=f"{name}: {f}")
            abs_err, rel_err = max_errors(a, b)
            worst[f] = (abs_err, rel_err)
    log(f"[{name}] worst (abs, rel) error per float field: "
        + ", ".join(f"{f} ({e[0]:.3g}, {e[1]:.3g})" for f, e in worst.items()))


def time_ms(fn, flush, reps: int = 25) -> float:
    """Median CUDA-event time of `fn` over `reps` launches, warm, with the
    L2 cache flushed before each launch (outside the timed region)."""
    import torch

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        flush()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def bound(bytes_moved: float, ops: float):
    t_bytes = bytes_moved / HBM_BYTES_PER_S * 1e3
    t_ops = ops / FP32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# ---------------------------------------------------------------------------
# Phases
# ---------------------------------------------------------------------------


def phase_build():
    from repro_torch.kernels import build

    t0 = time.perf_counter()
    built = build.build_all(ptxas_verbose=True)
    secs = time.perf_counter() - t0
    for src, info in built.items():
        report = [ln.strip() for ln in info["log"].splitlines() if "ptxas" in ln]
        log(f"[build] {src}: {info['seconds']:.2f} s")
        for ln in report:
            log(f"[build]   {ln}")
    for src in build.SOURCES:
        build.library(src)
    log(f"[build] {len(built)} source(s) compiled in parallel in {secs:.2f} s "
        f"into {build.build_dir()}")
    log(f"[build] {nvidia_smi_line()}")


def kernel_inputs(batch):
    """The three kernels' inputs at the shapes the estimate of `batch` gives
    them (the improved mode's per-chunk coupon launch is the widest)."""
    import torch
    from repro_torch.core.ndv import dict_inversion
    from repro_torch.kernels import newton_ndv

    B, R = batch.chunk_S.shape
    flat = lambda x: x.reshape(-1).contiguous()  # noqa: E731
    dict_in = (
        flat(batch.chunk_S), flat(batch.chunk_rows), flat(batch.chunk_nulls),
        flat(batch.mean_len[:, None].expand(B, R)),
    )
    fallback = dict_inversion.fallback_flags(
        batch.chunk_S, batch.chunk_rows, batch.chunk_nulls, batch.mean_len[:, None]
    )
    usable = batch.valid & batch.chunk_dict_encoded & ~fallback
    ndv_chunk = newton_ndv.dict_newton_math(*dict_in).reshape(B, R)
    coupon_chunk = (
        flat(torch.where(usable, ndv_chunk, 1.0)),
        flat(torch.clamp(batch.chunk_rows - batch.chunk_nulls, min=1.0)),
    )
    coupon_col = (batch.m_min.contiguous(),
                  batch.n_groups.to(torch.float32).contiguous())
    minmax_in = (batch.mins, batch.maxs, batch.valid)
    return dict_in, coupon_chunk, coupon_col, minmax_in


def phase_kernels(batch):
    import torch
    from repro_torch.kernels import minmax_scan as mm
    from repro_torch.kernels import newton_ndv as nk

    dict_in, coupon_chunk, coupon_col, minmax_in = kernel_inputs(batch)
    B, R = batch.chunk_S.shape
    scratch = torch.empty(64 << 20, dtype=torch.uint8, device=batch.device)
    flush = lambda: scratch.zero_()  # noqa: E731  (64 MB > the 50 MB L2)
    rows = {}

    # dict_newton
    k = nk.dict_newton(*dict_in)
    p = nk.dict_newton_math(*dict_in)
    torch.testing.assert_close(k, p, rtol=TOL["dict_newton"], atol=0.0)
    M = dict_in[0].numel()
    bms, by = bound(20.0 * M, DICT_OPS_PER_LANE * M)
    rows["dict_newton"] = dict(
        shape=f"M={M}", err=max_errors(k, p),
        ms=time_ms(lambda: nk.dict_newton(*dict_in), flush),
        plain_ms=time_ms(lambda: nk.dict_newton_math(*dict_in), flush),
        bound_ms=bms, bound_by=by,
    )

    # coupon_newton: the B*R per-chunk launch (improved) and the B launch
    k = nk.coupon_newton(*coupon_chunk)
    p = nk.coupon_newton_math(*coupon_chunk)
    torch.testing.assert_close(k, p, rtol=TOL["coupon_newton"], atol=0.0)
    kc = nk.coupon_newton(*coupon_col)
    pc = nk.coupon_newton_math(*coupon_col)
    torch.testing.assert_close(kc, pc, rtol=TOL["coupon_newton"], atol=0.0)
    M = coupon_chunk[0].numel()
    bms, by = bound(12.0 * M, COUPON_OPS_PER_LANE * M)
    err_chunk, err_col = max_errors(k, p), max_errors(kc, pc)
    rows["coupon_newton"] = dict(
        shape=f"M={M}", err=(max(err_chunk[0], err_col[0]), max(err_chunk[1], err_col[1])),
        ms=time_ms(lambda: nk.coupon_newton(*coupon_chunk), flush),
        plain_ms=time_ms(lambda: nk.coupon_newton_math(*coupon_chunk), flush),
        bound_ms=bms, bound_by=by,
    )
    Mc = coupon_col[0].numel()
    bms_c, by_c = bound(12.0 * Mc, COUPON_OPS_PER_LANE * Mc)
    log(f"[kernels] coupon_newton M={Mc}: ms="
        f"{time_ms(lambda: nk.coupon_newton(*coupon_col), flush)} plain_ms="
        f"{time_ms(lambda: nk.coupon_newton_math(*coupon_col), flush)} "
        f"bound_ms={bms_c} ({by_c}) max_abs_err={err_col[0]} max_rel_err={err_col[1]}")

    # minmax_scan: integer-valued fields exact, the float sum at rtol=atol=1e-5
    k = mm.minmax_scan(*minmax_in)
    p = mm.minmax_metrics_math(*minmax_in)
    for f in k._fields:
        a, b = getattr(k, f), getattr(p, f)
        if f == "overlap_sum":
            torch.testing.assert_close(a, b, rtol=TOL["minmax_scan"], atol=TOL["minmax_scan"])
        elif not torch.equal(a, b):
            raise AssertionError(f"minmax_scan: {f} differs from the plain version")
    err = max(max_errors(getattr(k, f), getattr(p, f)) for f in k._fields)
    bms, by = bound(9.0 * B * R + 24.0 * B, MINMAX_OPS_PER_CELL * B * R)
    rows["minmax_scan"] = dict(
        shape=f"B={B} R={R}", err=err,
        ms=time_ms(lambda: mm.minmax_scan(*minmax_in), flush),
        plain_ms=time_ms(lambda: mm.minmax_metrics_math(*minmax_in), flush),
        bound_ms=bms, bound_by=by,
    )
    for name, r in rows.items():
        log(f"[kernels] {name} {r['shape']}: max_abs_err={r['err'][0]} "
            f"max_rel_err={r['err'][1]} kernel_ms={r['ms']} plain_ms={r['plain_ms']} "
            f"bound_ms={r['bound_ms']} ({r['bound_by']}) tol={TOL[name]}")
    return rows


def write_dataset(root: str) -> int:
    """One table of the lineitem and standard-suite columns, split into
    4 PQLite files of 2^14 rows in row groups of 2048."""
    from repro_torch.columnar import datasets, generator, writer

    files, rows = 4, 1 << 16
    cols = {s.name: s.generate()[0] for s in generator.standard_suite(rows=rows, seed=SEED)}
    cols.update({k: v for k, (v, _) in datasets.lineitem(rows, seed=SEED).items()})
    per = rows // files
    shards = [{k: v[i * per:(i + 1) * per] for k, v in cols.items()} for i in range(files)]
    writer.write_dataset(root, shards, options=writer.WriterOptions(row_group_size=2048))
    return len(cols)


def phase_catalog():
    import torch
    from repro_torch.catalog import StatsCatalog
    from repro_torch.engine import EngineConfig, EstimationEngine
    from repro_torch.kernels import build

    with tempfile.TemporaryDirectory() as root:
        t0 = time.perf_counter()
        ncols = write_dataset(root)
        log(f"[catalog] wrote {ncols} columns x 4 files in {time.perf_counter() - t0:.1f} s")
        gpu = StatsCatalog(root)                      # default EngineConfig: cuda
        cpu = StatsCatalog(root, engine=EstimationEngine(EngineConfig(device="cpu")))
        assert gpu.engine.device.type == "cuda"
        build.reset_launch_counts()
        got, lat = {}, {}
        for mode in ("paper", "improved"):
            t0 = time.perf_counter()
            got[mode] = gpu.estimate(mode=mode)
            lat[mode] = (time.perf_counter() - t0) * 1e3
        counts = build.launch_counts()
        log(f"[catalog] launches over one estimate per mode: {counts}")
        missing = [k for k, v in counts.items() if v == 0]
        if missing:
            raise AssertionError(f"catalog path never launched {missing}")
        for mode in ("paper", "improved"):
            t0 = time.perf_counter()
            warm = gpu.estimate(mode=mode)
            warm_ms = (time.perf_counter() - t0) * 1e3
            if warm != got[mode]:
                raise AssertionError("warm estimate differs from cold")
            log(f"[catalog] {mode}: cold_ms={lat[mode]} warm_ms={warm_ms} "
                f"({len(warm)} columns, batch {tuple(gpu.packed_batch().chunk_S.shape)})")
        if gpu.stats.device_puts != 1:
            raise AssertionError(f"device_puts={gpu.stats.device_puts}, expected 1")
        for mode in ("paper", "improved"):
            want = cpu.estimate(mode=mode)
            pg, pc = gpu.provenance(mode=mode), cpu.provenance(mode=mode)
            worst = 0.0
            for name, e in want.items():
                g = got[mode][name]
                for f in ("layout", "is_lower_bound", "len_sample_size"):
                    if getattr(g, f) != getattr(e, f):
                        raise AssertionError(f"{mode} {name}: {f} {getattr(g, f)} != {getattr(e, f)}")
                for f in ("route", "clamp_flags", "dict_iterations", "coupon_iterations"):
                    if getattr(pg[name], f) != getattr(pc[name], f):
                        raise AssertionError(f"{mode} {name}: provenance {f} differs")
                for f in ("ndv", "ndv_dict", "ndv_minmax", "confidence",
                          "overlap_ratio", "monotonicity", "mean_len"):
                    a, b = getattr(g, f), getattr(e, f)
                    if not np.isfinite(a) or abs(a - b) > RTOL_PIPELINE * abs(b):
                        raise AssertionError(f"{mode} {name}: {f} {a} vs cpu {b}")
                    worst = max(worst, abs(a - b) / max(abs(b), 1e-30))
            log(f"[catalog] {mode}: cuda == cpu (discrete exact, worst float rel err {worst})")
        torch.cuda.synchronize()


def phase_scale(batch_host, device):
    import torch
    from repro_torch.engine import EngineConfig, EstimationEngine
    from repro_torch.kernels import build

    eng = EstimationEngine(EngineConfig())
    if eng.resolve_strategy(batch_host.batch) != "local":
        raise AssertionError("auto did not resolve to local at the default budget")
    batch = batch_host.to(device)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()

    build.reset_launch_counts()
    out = {m: eng.estimate(batch, mode=m) for m in ("paper", "improved")}
    torch.cuda.synchronize()
    launches = build.launch_counts()
    peak = torch.cuda.max_memory_allocated() - base
    log(f"[scale] main path B={batch.batch} R={batch.max_groups}: launches over "
        f"one estimate per mode {launches}; peak device memory above the "
        f"resident batch {peak / 2**20:.1f} MiB")
    missing = [k for k, v in launches.items() if v == 0]
    if missing:
        raise AssertionError(f"scale path never launched {missing}")

    for m in ("paper", "improved"):
        times = []
        for _ in range(21):
            t0 = time.perf_counter()
            eng.estimate(batch, mode=m)
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
        wall = statistics.median(times)
        log(f"[scale] {m}: estimate latency median {wall} ms, max {max(times)} ms "
            f"(21 warm runs, batch resident)")
        profile_estimate(eng, batch, m, wall)

    chunked = EstimationEngine(EngineConfig(max_batch=1024))
    if chunked.resolve_strategy(batch.batch) != "chunked":
        raise AssertionError("max_batch=1024 did not resolve to chunked")
    for m in ("paper", "improved"):
        c = chunked.estimate(batch, mode=m)
        for f in c._fields:
            if not torch.equal(getattr(c, f), getattr(out[m], f)):
                raise AssertionError(f"chunked != local on {m} {f}")
    log("[scale] chunked (4 x 1024) == local, bit for bit, both modes")

    cpu = EstimationEngine(EngineConfig(device="cpu"))
    for m in ("paper", "improved"):
        t0 = time.perf_counter()
        want = cpu.estimate(batch_host, mode=m)
        cpu_ms = (time.perf_counter() - t0) * 1e3
        compare_estimates(f"scale {m}", out[m], want, RTOL_PIPELINE, batch=batch_host)
        log(f"[scale] {m}: cuda == cpu (discrete fields exact but for clamp "
            f"ties, floats rtol {RTOL_PIPELINE}); the CPU took {cpu_ms:.0f} ms")
    return launches, peak


def profile_estimate(eng, batch, mode: str, wall_ms: float) -> None:
    """Device time of one estimate by kernel (torch.profiler), and the
    device's busy share of the unprofiled median latency."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        eng.estimate(batch, mode=mode)
        torch.cuda.synchronize()
    rows = []
    for e in prof.key_averages():
        # Kernels only: an operator's entry repeats its kernels' device time.
        if "CUDA" not in str(getattr(e, "device_type", "")):
            continue
        us = getattr(e, "self_device_time_total", None)
        if us is None:
            us = getattr(e, "self_cuda_time_total", 0)
        if us > 0:
            rows.append((us, e.count, e.key))
    if not rows:
        log(f"[profile] {mode}: the profiler saw no device time; breakdown not measured")
        return
    rows.sort(reverse=True)
    total_ms = sum(r[0] for r in rows) / 1e3
    launches = sum(r[1] for r in rows)
    log(f"[profile] {mode}: device busy {total_ms:.4f} ms in {launches} kernel "
        f"launches = {100 * total_ms / wall_ms:.1f}% of the {wall_ms:.4f} ms median "
        f"latency (idle {100 - 100 * total_ms / wall_ms:.1f}%)")
    for us, count, key in rows[:8]:
        log(f"[profile] {mode}:   {us / 1e3:.4f} ms  x{count}  {key[:90]}")


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; nothing run",
              file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.join(ROOT, "src"))
    from repro_torch.engine import EstimationEngine, EngineConfig

    device = torch.device("cuda", torch.cuda.current_device())
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    phase_build()

    t0 = time.perf_counter()
    cols = warehouse_columns(SCALE_B, SCALE_R, SEED)
    batch_host = EstimationEngine(EngineConfig(device="cpu")).make_packer().pack(cols)
    log(f"[scale] {len(cols)} columns packed to {tuple(batch_host.chunk_S.shape)} "
        f"in {time.perf_counter() - t0:.1f} s")

    rows = phase_kernels(batch_host.to(device))
    phase_catalog()
    launches, _ = phase_scale(batch_host, device)

    sources = {"dict_newton": "src/repro_torch/kernels/csrc/newton_ndv.cu",
               "coupon_newton": "src/repro_torch/kernels/csrc/newton_ndv.cu",
               "minmax_scan": "src/repro_torch/kernels/csrc/minmax_scan.cu"}
    replaces = {"dict_newton": "src/repro/kernels/newton_ndv.py:147",
                "coupon_newton": "src/repro/kernels/newton_ndv.py:170",
                "minmax_scan": "src/repro/kernels/minmax_scan.py:131"}
    kernels = [{
        "name": name, "route": "cuda", "source": sources[name],
        "replaces": replaces[name], "launches": launches[name],
        "max_abs_err": r["err"][0], "ms": r["ms"], "plain_ms": r["plain_ms"],
        "bound_ms": r["bound_ms"], "bound_by": r["bound_by"], "library_ms": None,
    } for name, r in rows.items()]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(nvidia_smi_line(), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
