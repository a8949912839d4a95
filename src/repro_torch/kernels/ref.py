"""Reference-numerics oracles for every kernel of the port.

Each ``ref_*`` runs the estimator modules' own reference solves (the Newton
loops that stop at a tolerance), never a kernel. `backend="ref"` resolves
here for the two Newton kernels (the detector's reductions are exact but for
one float sum, so `minmax_scan`'s plain version serves as its reference),
and ``ref_fused_estimate`` is what ``fuse="on"`` runs wherever no fused
kernel runs.
"""
from __future__ import annotations

import torch

from repro_torch.core.ndv import dict_inversion, minmax_diversity


def ref_dict_newton(size, rows, nulls, mean_len) -> torch.Tensor:
    """Oracle for newton_ndv.dict_newton (flat tensors)."""
    return dict_inversion.invert_dict_size(
        size, rows, nulls, mean_len, backend="ref"
    ).ndv


def ref_coupon_newton(m_obs, n_draws) -> torch.Tensor:
    """Oracle for newton_ndv.coupon_newton (flat tensors)."""
    return minmax_diversity.invert_coupon(m_obs, n_draws, backend="ref").ndv


def ref_fused_estimate(batch, schema_bound=None, *, mode: str = "paper"):
    """The reference pipeline in one call — what ``fuse="on"`` computes.

    The same call the JAX package's fused twin makes: the whole §4-§7
    pipeline with the reference numerics, with an absent schema bound
    materialised as +inf.
    """
    # local: the estimator imports kernels.ops lazily; importing it at
    # module scope here would close the cycle ops -> ref -> estimator.
    from repro_torch.core.ndv.estimator import estimate_batch_core

    if schema_bound is None:
        schema_bound = torch.full(
            (batch.batch,), float("inf"), dtype=torch.float32, device=batch.device
        )
    return estimate_batch_core(batch, schema_bound, mode=mode, backend="ref")
