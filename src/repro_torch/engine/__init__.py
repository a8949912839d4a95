"""Estimation engine: the single execution seam between packed batches and
estimates.

The paper's estimators are embarrassingly parallel over columns — every
reduction inside `estimate_batch` runs along the row-group axis (R) or is
per-lane, never across the column axis (B). That makes the B axis free to
split. `EstimationEngine` owns that split and the device:

  local    one `estimate_batch` call on the engine's device.
  chunked  stream batches wider than a budget (`max_batch`) through
           equal-size sub-batches, so B — and with it device memory —
           stays bounded regardless of dataset width. The budget is a
           fixed power of two or "auto", read from the card's memory
           (`torch.cuda.mem_get_info`).

The multi-device strategies of the JAX package (`sharded`, `composed`) are
not ported yet (ROADMAP Queue A item 11); asking for them raises.

The parity contract is strict: for real (non-padding) lanes, chunked output
is bit-identical to local. Strategy is therefore numerics-neutral and never
enters `cache_key`/`cache_token`.

The config also carries the device ("cuda" unless the caller asks for the
CPU; a missing card raises) and the `kernels/ops` backend knob ("auto" /
"cuda" / "ref"), which routes the Newton inversions and the detector scan
through the CUDA kernels or the reference numerics.
"""
from repro_torch.engine.config import DEFAULT_MAX_BATCH, EngineConfig  # noqa: F401
from repro_torch.engine.engine import (  # noqa: F401
    EstimationEngine,
    auto_chunk_budget,
    default_engine,
    default_packer,
    detect_device_memory,
    resolve_device,
)
