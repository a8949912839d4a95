"""Distribution detection from row-group range patterns (paper §6).

Classifies each column's physical layout from the sequence of per-row-group
(min_i, max_i) ranges:

  overlap(r_i, r_{i+1}) = max(0, min(max_i, max_{i+1}) - max(min_i, min_{i+1}))
  overlap_ratio = sum_i overlap(r_i, r_{i+1}) / total_span          (Eq 10-11)
  monotonicity  = 1 - sign_changes(delta midpoints) / (n - 2)       (Eq 12)

Classes (§6.2):
  Sorted:        overlap_ratio < 0.1 and monotonicity > 0.9
  Pseudo-sorted: overlap_ratio < 0.3 and monotonicity > 0.7
  Well-spread:   overlap_ratio > 0.7
  Mixed:         otherwise

All metrics are masked for padded row groups and vectorized over columns.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.core.ndv.types import Layout

SORTED_OVERLAP = 0.1
SORTED_MONO = 0.9
PSEUDO_OVERLAP = 0.3
PSEUDO_MONO = 0.7
WELL_SPREAD_OVERLAP = 0.7


class DistributionMetrics(NamedTuple):
    overlap_ratio: torch.Tensor   # (B,)
    monotonicity: torch.Tensor    # (B,)
    total_span: torch.Tensor      # (B,) global max - global min
    layout: torch.Tensor          # (B,) int32 Layout codes


def detect_distribution(
    mins: torch.Tensor,
    maxs: torch.Tensor,
    valid: torch.Tensor,
    *,
    backend: str = "auto",
) -> DistributionMetrics:
    """Compute Eq 10-12 metrics and classify (§6.2), batched.

    Args:
      mins / maxs: (B, R) per-row-group extrema (float key space).
      valid: (B, R) bool mask; row groups are packed to the left.
      backend: "auto"/"cuda" take the reductions from the `minmax_scan`
        kernel (its plain version for CPU tensors); "ref" from the plain
        version on any device. The ratio/classification tail is shared.

    Returns:
      DistributionMetrics with int32 layout codes from `Layout`.
    """
    mins = mins.to(torch.float32)
    maxs = maxs.to(torch.float32)
    valid = valid.to(torch.bool)

    from repro_torch.kernels import ops  # local: kernels.ref imports this package

    # The kernel path launches the `minmax_scan` kernel (its plain version
    # for CPU tensors); "ref" computes the same reductions with that plain
    # version, which is exact but for the order of one float sum.
    mm = ops.minmax_scan(mins, maxs, valid, backend=backend)
    n = mm.n_valid
    if ops.use_kernels(backend):
        # Row groups are packed to the left, so "any valid consecutive
        # pair" is exactly n >= 2.
        any_pairs = n >= 2.0
    else:
        any_pairs = (valid[:, :-1] & valid[:, 1:]).any(dim=-1)

    total_span = torch.clamp(mm.gmax - mm.gmin, min=0.0)

    # Degenerate spans (constant column / single row group): define the
    # overlap ratio as 1 when consecutive ranges coincide (full overlap) —
    # a constant column IS maximally well-spread.
    span_safe = torch.clamp(total_span, min=1e-30)
    degenerate = (total_span <= 0.0) & any_pairs
    overlap_ratio = torch.where(
        degenerate, 1.0, torch.clamp(mm.overlap_sum / span_safe, min=0.0)
    )
    # (ratio can legitimately exceed 1 for heavy overlap with many groups;
    #  classification only needs thresholds, keep the raw value.)

    denom = torch.clamp(n - 2.0, min=1.0)
    monotonicity = torch.where(n >= 3.0, 1.0 - mm.sign_changes / denom, 1.0)

    layout = classify(overlap_ratio, monotonicity, n)
    return DistributionMetrics(
        overlap_ratio=overlap_ratio,
        monotonicity=monotonicity,
        total_span=total_span,
        layout=layout,
    )


def classify(
    overlap_ratio: torch.Tensor,
    monotonicity: torch.Tensor,
    n_groups: torch.Tensor,
) -> torch.Tensor:
    """§6.2 decision rules -> int32 Layout codes."""
    sorted_ = (overlap_ratio < SORTED_OVERLAP) & (monotonicity > SORTED_MONO)
    pseudo = (overlap_ratio < PSEUDO_OVERLAP) & (monotonicity > PSEUDO_MONO)
    spread = overlap_ratio > WELL_SPREAD_OVERLAP
    out = torch.full_like(overlap_ratio, float(Layout.MIXED))
    out = torch.where(spread, float(Layout.WELL_SPREAD), out)
    out = torch.where(pseudo & ~spread, float(Layout.PSEUDO_SORTED), out)
    out = torch.where(sorted_, float(Layout.SORTED), out)
    # With a single row group there is no layout signal: treat as well-spread
    # (dictionary inversion is exact for one group).
    out = torch.where(n_groups <= 1, float(Layout.WELL_SPREAD), out)
    return out.to(torch.int32)
