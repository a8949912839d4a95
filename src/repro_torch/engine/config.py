"""Engine configuration: one frozen record that names an execution plan.

`EngineConfig` is deliberately tiny and hashable — `StatsCatalog` keys its
estimate caches by the engine's numerics identity (`cache_key`), so two
engines that would compute differently never share a cache line.
"""
from __future__ import annotations

import dataclasses
from typing import Union

from repro_torch.kernels.ops import BACKENDS, FUSE_MODES

STRATEGIES = ("auto", "local", "sharded", "chunked", "composed")

# The chunk budget used when max_batch="auto" finds no device memory to
# read (the CPU), and the fixed default.
DEFAULT_MAX_BATCH = 4096


@dataclasses.dataclass(frozen=True)
class EngineConfig:
    """Execution plan for `EstimationEngine`.

    Attributes:
      strategy: "local" (one estimate_batch call on the device), "chunked"
        (stream batches wider than `max_batch` through equal sub-batches),
        or "auto" — chunked only when the batch exceeds `max_batch`,
        otherwise local. "sharded" and "composed" (several devices) are
        accepted names but raise NotImplementedError when run: they are
        ROADMAP Queue A item 11.
      backend: the `repro_torch.kernels.ops` knob. "auto" takes the kernel
        path (CUDA kernels on the card, their plain PyTorch versions on the
        CPU); "cuda" takes the kernel path and refuses CPU tensors; "ref"
        takes the reference numerics (Newton loops that stop at a
        tolerance).
      max_batch: the chunk budget — the widest B a single `estimate_batch`
        call may see under the chunked strategy. Must be a power of two so
        power-of-two-bucketed batches always split into equal full chunks.
        "auto" derives the budget from the card's memory at first use
        (`EstimationEngine.resolve_max_batch()`), falling back to
        `DEFAULT_MAX_BATCH` on the CPU.
      fuse: "auto" | "on" | "off". This slice has no fused kernel: "auto"
        and "off" run the per-stage path; "on" runs the reference pipeline
        in one call where no kernel is asked for, and raises on CUDA with a
        kernel backend (see `repro_torch.kernels.ops`).
      device: where the engine computes: "cuda" (the default) or "cpu", or
        an indexed device such as "cuda:0". "cuda" without a visible card
        raises RuntimeError when an engine is built; it never carries on on
        the CPU.

    Cache-key neutrality: by the parity contract `strategy`, `max_batch`
    and `fuse` never change results, so they stay out of
    `EstimationEngine.cache_key` / `cache_token`. Only `backend` and the
    device's type choose the numerics, and only they are identity.
    """

    strategy: str = "auto"
    backend: str = "auto"
    max_batch: Union[int, str] = DEFAULT_MAX_BATCH
    fuse: str = "auto"
    device: str = "cuda"

    def __post_init__(self):
        if self.strategy not in STRATEGIES:
            raise ValueError(
                f"strategy {self.strategy!r} not in {STRATEGIES}"
            )
        if self.backend not in BACKENDS:
            raise ValueError(f"backend {self.backend!r} not in {BACKENDS}")
        if self.fuse not in FUSE_MODES:
            raise ValueError(f"fuse {self.fuse!r} not in {FUSE_MODES}")
        if str(self.device).split(":")[0] not in ("cuda", "cpu"):
            raise ValueError(f'device must be "cuda" or "cpu", got {self.device!r}')
        mb = self.max_batch
        if isinstance(mb, str):
            if mb != "auto":
                raise ValueError(
                    f'max_batch must be "auto" or a power of two, got {mb!r}'
                )
        elif mb < 1 or (mb & (mb - 1)) != 0:
            raise ValueError(f"max_batch must be a power of two, got {mb}")
