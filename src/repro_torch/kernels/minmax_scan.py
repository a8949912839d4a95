"""Distribution-detector metrics over row-group stats: plain version + CUDA.

Computes, for every column of (B, R) min/max statistics, the paper's §6
reductions:

  overlap_sum   = sum_i max(0, min(max_i,max_{i+1}) - max(min_i,min_{i+1}))
  gmin / gmax   = global min / max over valid row groups
  sign_changes  = # midpoint-delta sign flips
  n_valid       = row-group count
  shared_bounds = # boundaries with max_i == min_{i+1}  (improved mode)

``minmax_metrics_math`` is the plain PyTorch version (any device);
``csrc/minmax_scan.cu`` is the CUDA kernel, one block per column. The
wrapper ``minmax_scan`` sends CPU tensors to the plain version and launches
the kernel for CUDA tensors, with no fallback between the two.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.kernels import build

BIG = 3.0e38


class MinMaxMetrics(NamedTuple):
    overlap_sum: torch.Tensor
    gmin: torch.Tensor
    gmax: torch.Tensor
    sign_changes: torch.Tensor
    n_valid: torch.Tensor
    shared_bounds: torch.Tensor


def minmax_metrics_math(
    mins: torch.Tensor, maxs: torch.Tensor, valid: torch.Tensor
) -> MinMaxMetrics:
    """The §6 metric reductions over (b, r) stats (``valid`` is bool)."""
    zero = torch.zeros((), dtype=torch.float32, device=mins.device)
    one = torch.ones((), dtype=torch.float32, device=mins.device)
    n = valid.to(torch.float32).sum(dim=1)
    gmin = torch.where(valid, mins, BIG).amin(dim=1)
    gmax = torch.where(valid, maxs, -BIG).amax(dim=1)

    pv = valid[:, :-1] & valid[:, 1:]
    lo = torch.maximum(mins[:, :-1], mins[:, 1:])
    hi = torch.minimum(maxs[:, :-1], maxs[:, 1:])
    overlap = torch.where(pv, torch.clamp(hi - lo, min=0.0), zero).sum(dim=1)

    mid = (mins + maxs) * 0.5
    d = torch.where(pv, mid[:, 1:] - mid[:, :-1], zero)
    sgn = torch.sign(d)
    sv = pv[:, :-1] & pv[:, 1:]
    changes = torch.where(sv & (sgn[:, :-1] * sgn[:, 1:] < 0), one, zero).sum(dim=1)

    shared = torch.where(pv & (maxs[:, :-1] == mins[:, 1:]), one, zero).sum(dim=1)
    return MinMaxMetrics(
        overlap_sum=overlap,
        gmin=gmin,
        gmax=gmax,
        sign_changes=changes,
        n_valid=n,
        shared_bounds=shared,
    )


def minmax_scan(
    mins: torch.Tensor, maxs: torch.Tensor, valid: torch.Tensor
) -> MinMaxMetrics:
    """Detector metrics for (B, R) row-group stats. Returns (B,) metrics.

    mins / maxs are float32 (B, R), valid is bool (B, R).
    """
    ins = [mins, maxs, valid]
    if mins.dim() != 2 or any(t.shape != mins.shape for t in ins):
        raise ValueError("minmax_scan: expected mins, maxs, valid of one (B, R) shape")
    if not build.on_cuda("minmax_scan", ins):
        return minmax_metrics_math(mins, maxs, valid)
    dev = build.check_cuda_inputs(
        "minmax_scan", ins, [torch.float32, torch.float32, torch.bool]
    )
    b, r = mins.shape
    out = torch.empty((6, b), dtype=torch.float32, device=mins.device)
    if b == 0:
        return MinMaxMetrics(*out.unbind(0))
    lib = build.library("minmax_scan.cu")
    code = lib.minmax_scan_launch(
        mins.data_ptr(), maxs.data_ptr(), valid.data_ptr(), out.data_ptr(),
        b, r, dev, build.stream_handle(dev),
    )
    build.LAUNCHES["minmax_scan"] += 1
    build.raise_on_error("minmax_scan", code)
    return MinMaxMetrics(*out.unbind(0))
