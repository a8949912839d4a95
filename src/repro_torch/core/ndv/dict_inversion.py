"""Dictionary size inversion (paper §4).

Inverts the dictionary-encoded storage equation

    S = ndv * len + (N - nulls) * ceil(log2(ndv)) / 8          (Eq 1)

for ``ndv`` via Newton-Raphson, using the *exact* residual f but a smooth
approximation of the derivative (the ceiling has zero derivative a.e.):

    f'(ndv) ~= len + (N - nulls) / (8 * ndv * ln 2)            (Eq 3)

Everything is vectorized over a batch of columns. The reference solve
(``backend="ref"``) stops each lane at a tolerance; the kernel path runs the
fixed-iteration solve of `repro_torch.kernels.newton_ndv`.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

NEWTON_ITERS = 32          # paper reports 5-10 to 1e-6; 32 is belt-and-braces
NEWTON_TOL = 1e-6
LN2 = 0.6931471805599453

# Eq 5 thresholds for plain-encoding fallback detection.
FALLBACK_NDV_RATIO = 0.9
FALLBACK_SIZE_LO = 0.8
FALLBACK_SIZE_HI = 1.2


def _f32(x) -> torch.Tensor:
    return torch.as_tensor(x, dtype=torch.float32)


def ceil_log2(ndv: torch.Tensor) -> torch.Tensor:
    """ceil(log2(ndv)) with ceil_log2(1) == 1 (1 bit minimum index width).

    Parquet's RLE/bit-packed hybrid needs at least 1 bit per index even for a
    single-entry dictionary, so we clamp below at 1 bit. Uses float log2 with
    a tiny epsilon nudge so exact powers of two are stable.
    """
    ndv = torch.clamp(ndv, min=1.0)
    bits = torch.ceil(torch.log2(ndv) - 1e-9)
    return torch.clamp(bits, min=1.0)


def dict_size_model(ndv, mean_len, non_null) -> torch.Tensor:
    """Forward model: Eq 1 (what the writer's uncompressed size should be)."""
    return ndv * mean_len + non_null * ceil_log2(ndv) / 8.0


def residual(ndv, size, mean_len, non_null) -> torch.Tensor:
    """Exact residual f(ndv) (Eq 2)."""
    return dict_size_model(ndv, mean_len, non_null) - size


def residual_derivative(ndv, mean_len, non_null) -> torch.Tensor:
    """Smooth derivative approximation (Eq 3)."""
    return mean_len + non_null / (8.0 * torch.clamp(ndv, min=1.0) * LN2)


class DictInversionResult(NamedTuple):
    ndv: torch.Tensor            # (B,) point estimate (>= 1)
    iterations: torch.Tensor     # (B,) int32 iterations to convergence
    converged: torch.Tensor      # (B,) bool — |f| <= tol * scale at exit
    likely_fallback: torch.Tensor  # (B,) bool — Eq 5 fired; treat as lower bound


def fallback_flags(size, num_values, null_count, mean_len) -> torch.Tensor:
    """Eq 5 plain-encoding fallback indicator (closed form, solver-free).

    The first indicator uses the solver's degenerate-high-NDV interpretation
    S/len (the converged root absorbs index overhead and sits at
    (1 - bits/(8 len)) * rows for plain-encoded chunks, which would miss the
    0.9 threshold for narrow fixed-width types).
    """
    size = _f32(size)
    non_null = torch.clamp(_f32(num_values) - _f32(null_count), min=0.0)
    mean_len = torch.clamp(_f32(mean_len), min=1e-6)
    ndv_ratio = (size / mean_len) / torch.clamp(non_null, min=1.0)
    size_ratio = size / torch.clamp(non_null * mean_len, min=1e-6)
    return (
        (ndv_ratio >= FALLBACK_NDV_RATIO)
        & (size_ratio >= FALLBACK_SIZE_LO)
        & (size_ratio <= FALLBACK_SIZE_HI)
    )


def invert_dict_size(
    size: torch.Tensor,
    num_values: torch.Tensor,
    null_count: torch.Tensor,
    mean_len: torch.Tensor,
    *,
    iters: int = NEWTON_ITERS,
    tol: float = NEWTON_TOL,
    backend: str = "auto",
) -> DictInversionResult:
    """Solve Eq 2 for ndv, batched over columns.

    Args:
      size: (B,) or (B, R) total_uncompressed_size S in bytes.
      num_values: row count N, same shape.
      null_count: null count, same shape.
      mean_len: mean value byte length (Eq 4 / schema width), broadcastable.
      backend: "ref" solves here, stopping each lane at a tolerance (the
        reference numerics); "auto"/"cuda" run the fixed-iteration solve of
        the `dict_newton` kernel, with the Eq 5 flags and the constant
        iteration count filled in from the closed forms.

    Returns:
      DictInversionResult with ndv clamped to [1, N - nulls].
    """
    from repro_torch.kernels import ops  # local: kernels.ref imports this module

    if ops.use_kernels(backend):
        shape = size.shape
        flat = lambda x: torch.broadcast_to(_f32(x).to(size.device), shape).reshape(-1).contiguous()  # noqa: E731
        ndv = ops.dict_newton(
            flat(size), flat(num_values), flat(null_count), flat(mean_len),
            backend=backend,
        ).reshape(shape)
        # The kernel is fixed-iteration and branch-free: it always runs
        # DICT_ITERS steps and converges by construction on Eq 2's
        # monotone residual.
        from repro_torch.kernels.newton_ndv import DICT_ITERS

        return DictInversionResult(
            ndv=ndv,
            iterations=torch.full(shape, DICT_ITERS, dtype=torch.int32, device=size.device),
            converged=torch.ones(shape, dtype=torch.bool, device=size.device),
            likely_fallback=fallback_flags(size, num_values, null_count, mean_len),
        )

    size = _f32(size)
    non_null = torch.clamp(_f32(num_values) - _f32(null_count), min=0.0)
    mean_len = torch.clamp(_f32(mean_len), min=1e-6)

    # Initial guess: index overhead assumed small (paper §4.2).
    ndv = torch.clamp(size / mean_len, min=1.0)

    # Relative tolerance scale: sizes span bytes..TB, so scale by S.
    scale = torch.clamp(size, min=1.0)
    cap = torch.clamp(non_null, min=1.0)

    it = torch.zeros(size.shape, dtype=torch.int32, device=size.device)
    done = torch.zeros(size.shape, dtype=torch.bool, device=size.device)
    for _ in range(iters):
        f = residual(ndv, size, mean_len, non_null)
        fp = residual_derivative(ndv, mean_len, non_null)
        step = f / fp
        new_ndv = torch.minimum(torch.clamp(ndv - step, min=1.0), cap)
        stop = done | (torch.abs(f) <= tol * scale)
        ndv = torch.where(stop, ndv, new_ndv)
        it = it + (~stop).to(torch.int32)
        done = stop
    # The ceiling makes f piecewise-linear in ndv with jumps at powers of 2;
    # after Newton converges on the smooth surrogate's root, snap within the
    # final bit-width plateau by re-solving the linear piece exactly:
    #   ndv = (S - non_null*bits/8) / len   with bits = ceil_log2(ndv*)
    bits = ceil_log2(ndv)
    linear_ndv = (size - non_null * bits / 8.0) / mean_len
    # Only accept the snap if it stays inside the same bit plateau.
    same_plateau = ceil_log2(torch.clamp(linear_ndv, min=1.0)) == bits
    ndv = torch.where(same_plateau & (linear_ndv >= 1.0), linear_ndv, ndv)
    ndv = torch.minimum(torch.clamp(ndv, min=1.0), cap)

    return DictInversionResult(
        ndv=ndv,
        iterations=it,
        converged=done,
        likely_fallback=fallback_flags(size, num_values, null_count, mean_len),
    )
