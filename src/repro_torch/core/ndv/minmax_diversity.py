"""Min/max diversity estimation via coupon-collector inversion (paper §5).

The n row-group minima are modeled as n uniform draws (with replacement)
from a population of NDV distinct values:

    E[m] = NDV * (1 - exp(-n / NDV))                            (Eq 7)

Given the observed distinct-extrema count m, invert

    g(NDV) = NDV * (1 - exp(-n/NDV)) - m = 0                    (Eq 8)

with Newton-Raphson and derivative

    g'(NDV) = 1 - exp(-n/NDV) * (1 + n/NDV)                     (Eq 9)

Separate estimates from m_min and m_max; keep the larger (paper §5.3).

Numerical notes:
  * g is monotonically increasing in NDV with g(NDV) -> n - m as NDV -> inf,
    so a root exists only when m < n. When m == n (every row group exposed a
    different extremum — the sorted case), the MLE diverges; we return the
    standard regularized estimate from the (m = n-1/2) continuity-corrected
    count, and flag saturation so the combiner can treat it as a lower bound.
  * We iterate in log-space (NDV = exp(t)) which keeps Newton stable for the
    huge dynamic range (NDV in [1, 1e12]).
"""
from __future__ import annotations

from typing import NamedTuple

import torch

NEWTON_ITERS = 40
NEWTON_TOL = 1e-6


def coupon_expected(ndv: torch.Tensor, n: torch.Tensor) -> torch.Tensor:
    """E[distinct] = NDV*(1-exp(-n/NDV)) (Eq 6), safe at ndv -> 0."""
    ndv = torch.clamp(ndv, min=1e-9)
    return ndv * -torch.expm1(-n / ndv)


def coupon_derivative(ndv: torch.Tensor, n: torch.Tensor) -> torch.Tensor:
    """g'(NDV) (Eq 9)."""
    ndv = torch.clamp(ndv, min=1e-9)
    r = n / ndv
    return -torch.expm1(-r) - torch.exp(-r) * r


class CouponInversionResult(NamedTuple):
    ndv: torch.Tensor         # (B,) estimate
    saturated: torch.Tensor   # (B,) bool — m ~= n, estimate is a lower bound
    iterations: torch.Tensor  # (B,) int32


def invert_coupon(
    m: torch.Tensor,
    n: torch.Tensor,
    *,
    iters: int = NEWTON_ITERS,
    tol: float = NEWTON_TOL,
    backend: str = "auto",
) -> CouponInversionResult:
    """Solve Eq 8 for NDV given observed distinct count m out of n draws.

    Args:
      m: observed number of distinct extrema (1 <= m <= n), any shape.
      n: number of row groups (draws), same shape.
      backend: "ref" solves here, stopping each lane at a tolerance; "auto"/
        "cuda" route the full inversion — saturation handling included —
        through the fixed-iteration `coupon_newton` kernel.

    Returns:
      CouponInversionResult. For the saturated case (m == n) we return the
      inversion at m_eff = n - 0.5 (continuity correction) and set
      ``saturated`` so the caller treats it as a lower bound.
    """
    m = torch.as_tensor(m, dtype=torch.float32)
    n = torch.as_tensor(n, dtype=torch.float32)

    from repro_torch.kernels import ops  # local: kernels.ref imports this module

    if ops.use_kernels(backend):
        from repro_torch.kernels.newton_ndv import COUPON_ITERS

        ndv = ops.coupon_newton(
            m.reshape(-1).contiguous(), n.reshape(-1).contiguous(), backend=backend
        ).reshape(m.shape)
        return CouponInversionResult(
            ndv=ndv,
            saturated=m >= n - 0.5,
            iterations=torch.full(m.shape, COUPON_ITERS, dtype=torch.int32, device=m.device),
        )

    # Saturation band of half a coupon: observed counts are integral, and
    # the inversion is hopelessly ill-conditioned within < 0.5 of n anyway.
    saturated = m >= n - 0.5
    # Continuity-corrected observation for the saturated case.
    m_eff = torch.where(saturated, torch.clamp(n - 0.5, min=0.5), m)
    m_eff = torch.minimum(torch.clamp(m_eff, min=0.5), torch.clamp(n - 1e-3, min=0.5))

    # Initial guess. Expanding Eq 7 to second order: m ~ n - n^2/(2 NDV)
    # => NDV0 ~ n^2 / (2 (n - m)). Good near saturation; clamp elsewhere.
    ndv0 = torch.clamp(n * n / (2.0 * torch.clamp(n - m_eff, min=1e-3)), 1.0, 1e12)
    t = torch.log(ndv0)

    it = torch.zeros(m.shape, dtype=torch.int32, device=m.device)
    done = torch.zeros(m.shape, dtype=torch.bool, device=m.device)
    for _ in range(iters):
        ndv = torch.exp(t)
        g = coupon_expected(ndv, n) - m_eff
        gp = coupon_derivative(ndv, n)
        # d/dt g(exp(t)) = g'(ndv) * ndv
        step = g / torch.clamp(gp * ndv, min=1e-12)
        new_t = torch.clamp(t - step, 0.0, 28.0)  # NDV in [1, ~1.4e12]
        stop = done | (torch.abs(g) <= tol * torch.clamp(m_eff, min=1.0))
        t = torch.where(stop, t, new_t)
        it = it + (~stop).to(torch.int32)
        done = stop
    ndv = torch.exp(t)
    # Saturated observations (m == n) carry no upper-bound information: the
    # MLE diverges, and the continuity-corrected root (~n^2/2) is far too
    # aggressive as a POINT estimate (it would dominate Eq 13's max). Report
    # the observable itself — m, a hard lower bound — and let the saturation
    # flag drive lower-bound semantics downstream.
    m1 = torch.clamp(m, min=1.0)
    ndv = torch.where(saturated, m1, ndv)
    # Degenerate inputs: n == 0 -> no information; m <= 1 -> at least 1 value.
    ndv = torch.where(n <= 0, 1.0, ndv)
    ndv = torch.where(m_eff <= 0.5001, m1, ndv)
    return CouponInversionResult(
        ndv=torch.maximum(ndv, m1),
        saturated=saturated,
        iterations=it,
    )


class MinMaxDiversityResult(NamedTuple):
    ndv: torch.Tensor          # (B,) max of min-side / max-side estimates
    ndv_from_min: torch.Tensor
    ndv_from_max: torch.Tensor
    saturated: torch.Tensor    # (B,) bool — the winning side saturated
    iterations: torch.Tensor   # (B,) int32 — Newton iterations, winning side


def estimate_minmax_diversity(
    m_min: torch.Tensor,
    m_max: torch.Tensor,
    n_groups: torch.Tensor,
    *,
    backend: str = "auto",
) -> MinMaxDiversityResult:
    """Paper §5.3: invert both sides, retain the larger estimate."""
    lo = invert_coupon(m_min, n_groups, backend=backend)
    hi = invert_coupon(m_max, n_groups, backend=backend)
    take_hi = hi.ndv >= lo.ndv
    return MinMaxDiversityResult(
        ndv=torch.where(take_hi, hi.ndv, lo.ndv),
        ndv_from_min=lo.ndv,
        ndv_from_max=hi.ndv,
        saturated=torch.where(take_hi, hi.saturated, lo.saturated),
        iterations=torch.where(take_hi, hi.iterations, lo.iterations),
    )
