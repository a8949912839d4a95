"""Hybrid combination of the two estimators + bounds (paper §7).

    ndv_final = min(max(ndv_dict, ndv_minmax), N - nulls)       (Eq 13)

Type-specific bounds:
    integer/date:       ndv <= max - min + 1                    (Eq 14)
    single-byte string: ndv <= ~128 (printable ASCII)           (Eq 15)

Schema constraints (FK bounds etc.) enter through ``schema_bound``.

Both component estimators *underestimate* in different regimes (Table 1), so
the max of the two is the better point estimate; the deterministic bounds are
then applied on top. A heuristic confidence score summarizes agreement and
reliability signals for downstream planners.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from repro_torch.core.ndv.types import Layout, SINGLE_BYTE_BOUND


class CombineResult(NamedTuple):
    ndv: torch.Tensor            # (B,) final estimate
    is_lower_bound: torch.Tensor  # (B,) bool
    confidence: torch.Tensor     # (B,) in [0, 1]
    route: torch.Tensor          # (B,) int32 — ROUTE_MINMAX / ROUTE_DICT
    route_margin: torch.Tensor   # (B,) in [0, 1) — decisiveness of Eq 13's max
    clamp_flags: torch.Tensor    # (B,) int32 CLAMP_* bitmask — bounds that bit


# Which of the paper's two signals won Eq 13's max for a lane.
ROUTE_MINMAX = 0   # §5 coupon-collector inversion
ROUTE_DICT = 1     # §4 dictionary-size inversion

# Bits of ``clamp_flags``: set when the corresponding deterministic bound
# actually reduced the estimate (strict decrease, not mere applicability).
CLAMP_NON_NULL = 1      # Eq 13 cap: ndv <= N - nulls
CLAMP_INT_RANGE = 2     # Eq 14: ndv <= max - min + 1
CLAMP_SINGLE_BYTE = 4   # Eq 15: single-byte string bound
CLAMP_SCHEMA = 8        # §7.3 schema constraint


def combine_estimates(
    ndv_dict: torch.Tensor,
    ndv_minmax: torch.Tensor,
    *,
    non_null: torch.Tensor,
    layout: torch.Tensor,
    likely_fallback: torch.Tensor,
    minmax_saturated: torch.Tensor,
    int_like: torch.Tensor,
    gmin: torch.Tensor,
    gmax: torch.Tensor,
    single_byte: torch.Tensor,
    len_sample: torch.Tensor,
    dict_encoded: Optional[torch.Tensor] = None,
    schema_bound: Optional[torch.Tensor] = None,
    suspect_clustered: Optional[torch.Tensor] = None,
) -> CombineResult:
    """Eq 13-15 (+ §7.3 schema bound), batched.

    Args:
      ndv_dict / ndv_minmax: component estimates, (B,).
      non_null: N - nulls, (B,).
      layout: int32 Layout codes from the detector, (B,).
      likely_fallback: Eq 5 indicator from dictionary inversion, (B,) bool.
      minmax_saturated: m == n saturation flag from coupon inversion, (B,).
      int_like: Eq 14 applies, (B,) bool.
      gmin / gmax: global column min / max (for Eq 14), (B,).
      single_byte: Eq 15 applies, (B,) bool.
      len_sample: |V| reliability indicator (Eq 4), (B,) int.
      dict_encoded: False where the writer recorded plain encoding. When the
        metadata *tells us* there is no dictionary, Eq 1 does not describe S
        and the dict estimate is meaningless — route around it.
      schema_bound: optional per-column upper bound from catalog constraints
        (§7.3), e.g. referenced-table row count for FK columns.

    Returns:
      CombineResult(final ndv, lower-bound flag, confidence).
    """
    f32 = lambda x: torch.as_tensor(x, dtype=torch.float32)  # noqa: E731
    ndv_dict = f32(ndv_dict)
    ndv_minmax = f32(ndv_minmax)
    non_null = torch.clamp(f32(non_null), min=0.0)
    dev = ndv_dict.device

    def flag(cond: torch.Tensor, bit: int) -> torch.Tensor:
        return torch.where(cond, bit, 0).to(torch.int32)

    # When the writer recorded plain encoding for every chunk, Eq 1's premise
    # is void; dictionary inversion degenerates to S/len ~ N which Eq 5 also
    # flags. Null out the dict estimate in that case.
    if dict_encoded is not None:
        dict_ok = torch.as_tensor(dict_encoded, dtype=torch.bool) & ~likely_fallback
    else:
        dict_ok = ~likely_fallback

    # On explicit plain-encoding metadata the dict estimate is *no* signal at
    # all; under Eq 5 detection it is a lower bound. In both cases Eq 13's max
    # still wants the larger component — keep the dict value as a floor but
    # mark the result as a lower bound.
    ndv = torch.maximum(ndv_dict, ndv_minmax)                   # Eq 13 (max)
    pre = ndv
    ndv = torch.minimum(ndv, torch.clamp(non_null, min=1.0))    # Eq 13 (cap)
    clamp_flags = flag(ndv < pre, CLAMP_NON_NULL)

    # Eq 14: integer-like range bound.
    range_bound = torch.clamp(f32(gmax) - f32(gmin) + 1.0, min=1.0)
    pre = ndv
    ndv = torch.where(int_like, torch.minimum(ndv, range_bound), ndv)
    clamp_flags = clamp_flags | flag(ndv < pre, CLAMP_INT_RANGE)

    # Eq 15: single-byte strings.
    pre = ndv
    ndv = torch.where(
        single_byte,
        torch.minimum(ndv, torch.clamp(torch.clamp(non_null, min=1.0), max=SINGLE_BYTE_BOUND)),
        ndv,
    )
    clamp_flags = clamp_flags | flag(ndv < pre, CLAMP_SINGLE_BYTE)

    # §7.3: schema constraint.
    if schema_bound is not None:
        sb = f32(schema_bound).to(dev)
        pre = ndv
        ndv = torch.where(sb > 0, torch.minimum(ndv, sb), ndv)
        clamp_flags = clamp_flags | flag(ndv < pre, CLAMP_SCHEMA)

    ndv = torch.clamp(ndv, min=1.0)

    # The estimate is only a lower bound when the *winning* signal said so:
    #  - dict wins while flagged as plain-encoding fallback, or
    #  - minmax wins while coupon-saturated (m == n) on sorted data.
    dict_wins = ndv_dict >= ndv_minmax
    is_lower_bound = torch.where(
        dict_wins,
        ~dict_ok,
        minmax_saturated & (layout != int(Layout.SORTED)),
    )
    if suspect_clustered is not None:
        # Clustered signature (overlapping ranges + saturated extrema
        # diversity): runs shrink each chunk's effective sample, so every
        # metadata estimator under-sees the domain — report a lower bound.
        is_lower_bound = is_lower_bound | suspect_clustered.to(torch.bool)
    # Saturated coupon on *detected sorted* layout is the designed regime
    # (each row group covers its own range): the paper treats it as accurate,
    # not merely a bound. Anywhere else, saturation means "at least this".

    # Heuristic confidence: agreement of the two estimators (within 2x),
    # detector decisiveness, and len-sample reliability.
    ratio = torch.minimum(ndv_dict, ndv_minmax) / torch.clamp(
        torch.maximum(ndv_dict, ndv_minmax), min=1.0
    )
    agree = torch.clamp(ratio * 2.0, 0.0, 1.0)
    len_rel = torch.clamp(f32(len_sample) / 16.0, 0.1, 1.0)
    layout_conf = torch.where(layout == int(Layout.MIXED), 0.6, 1.0)
    confidence = torch.clamp(
        0.25 + 0.45 * agree + 0.3 * len_rel * layout_conf, 0.0, 1.0
    )
    confidence = torch.where(is_lower_bound, confidence * 0.5, confidence)
    # Route margin: how decisively Eq 13's max picked its winner. 0 means
    # the two signals tied (a coin-flip route); -> 1 means the loser was
    # negligible. Complements `agree` — provenance consumers read both.
    route_margin = 1.0 - ratio
    return CombineResult(
        ndv=ndv,
        is_lower_bound=is_lower_bound,
        confidence=confidence,
        route=torch.where(dict_wins, ROUTE_DICT, ROUTE_MINMAX).to(torch.int32),
        route_margin=route_margin.to(torch.float32),
        clamp_flags=clamp_flags,
    )
