// Distribution-detector reductions (paper §6) for Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/minmax_scan.py:minmax_scan
// (pallas_call at minmax_scan.py:131, math minmax_metrics_math :52-88).
// For each column b of (B, R) row-group stats it writes six float32 values,
// field-major into out[6][B]:
//   0 overlap_sum   sum_i max(0, min(max_i,max_{i+1}) - max(min_i,min_{i+1}))
//   1 gmin          min over valid row groups (3e38 when none)
//   2 gmax          max over valid row groups (-3e38 when none)
//   3 sign_changes  # sign flips between consecutive midpoint deltas
//   4 n_valid       # valid row groups
//   5 shared_bounds # valid pairs with max_i == min_{i+1}
//
// What bounds it on this card: each (b, r) cell is read once (9 bytes:
// two float32 stats and one bool) for a handful of compares and adds, so
// the kernel is bound by device-memory bytes, not by operations.
//
// Design: one block of 256 threads per column and a strided loop over R.
// Each thread reads its neighbours i+1 and i+2 straight from device memory
// (they are the next threads' cells, so they hit L1/L2), which makes every
// consecutive-pair term local to one thread: no carry between tiles is
// needed, unlike the TPU kernel that kept the whole R axis in one VMEM
// block. The ragged edge is masked with r < R; R is not padded to 128
// lanes (that padding was a TPU tiling artefact). Per-thread partials are
// reduced with warp shuffles and then across the block's 8 warps through
// shared memory.
//
// Numerics: gmin, gmax, n_valid, sign_changes and shared_bounds are exact
// (the counts are integers, accumulated as ints and written as float32).
// overlap_sum is a float sum taken in another order than the plain
// version's, so it agrees to rounding only (held at rtol = atol = 1e-5).
// A zero midpoint delta has sign 0 and never counts as a flip, as with
// jnp.sign / torch.sign. `valid` arrives as torch.bool and is read as bytes.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr float kBig = 3.0e38f;

__device__ __forceinline__ int sgn(float d) { return (d > 0.0f) - (d < 0.0f); }

__global__ void __launch_bounds__(kThreads)
minmax_scan_kernel(const float* __restrict__ mins, const float* __restrict__ maxs,
                   const uint8_t* __restrict__ valid, float* __restrict__ out,
                   int64_t B, int64_t R) {
  const int64_t b = blockIdx.x;
  const float* mn = mins + b * R;
  const float* mx = maxs + b * R;
  const uint8_t* vd = valid + b * R;

  float overlap = 0.0f, gmin = kBig, gmax = -kBig;
  int changes = 0, n = 0, shared = 0;
  for (int64_t i = threadIdx.x; i < R; i += kThreads) {
    const bool v0 = vd[i] != 0;
    const float mn0 = mn[i], mx0 = mx[i];
    if (v0) {
      ++n;
      gmin = fminf(gmin, mn0);
      gmax = fmaxf(gmax, mx0);
    }
    if (i + 1 < R) {
      const bool v1 = vd[i + 1] != 0;
      const bool pv0 = v0 && v1;
      const float mn1 = mn[i + 1], mx1 = mx[i + 1];
      if (pv0) {
        const float lo = fmaxf(mn0, mn1);
        const float hi = fminf(mx0, mx1);
        overlap += fmaxf(hi - lo, 0.0f);
        shared += (mx0 == mn1);
      }
      if (i + 2 < R && pv0 && vd[i + 2] != 0) {
        const float mid0 = (mn0 + mx0) * 0.5f;
        const float mid1 = (mn1 + mx1) * 0.5f;
        const float mid2 = (mn[i + 2] + mx[i + 2]) * 0.5f;
        changes += (sgn(mid1 - mid0) * sgn(mid2 - mid1) < 0);
      }
    }
  }

  // Warp-level reduction.
  for (int off = 16; off > 0; off >>= 1) {
    overlap += __shfl_down_sync(0xffffffffu, overlap, off);
    gmin = fminf(gmin, __shfl_down_sync(0xffffffffu, gmin, off));
    gmax = fmaxf(gmax, __shfl_down_sync(0xffffffffu, gmax, off));
    changes += __shfl_down_sync(0xffffffffu, changes, off);
    n += __shfl_down_sync(0xffffffffu, n, off);
    shared += __shfl_down_sync(0xffffffffu, shared, off);
  }

  __shared__ float s_overlap[kWarps], s_gmin[kWarps], s_gmax[kWarps];
  __shared__ int s_changes[kWarps], s_n[kWarps], s_shared[kWarps];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (lane == 0) {
    s_overlap[warp] = overlap;
    s_gmin[warp] = gmin;
    s_gmax[warp] = gmax;
    s_changes[warp] = changes;
    s_n[warp] = n;
    s_shared[warp] = shared;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    for (int w = 1; w < kWarps; ++w) {
      overlap += s_overlap[w];
      gmin = fminf(gmin, s_gmin[w]);
      gmax = fmaxf(gmax, s_gmax[w]);
      changes += s_changes[w];
      n += s_n[w];
      shared += s_shared[w];
    }
    out[0 * B + b] = overlap;
    out[1 * B + b] = gmin;
    out[2 * B + b] = gmax;
    out[3 * B + b] = (float)changes;
    out[4 * B + b] = (float)n;
    out[5 * B + b] = (float)shared;
  }
}

}  // namespace

extern "C" {

// mins, maxs: device float32 (B, R) row-major; valid: device bool (B, R);
// out: device float32 (6, B). Launches on `stream` of CUDA device `device`,
// allocates nothing, and returns cudaGetLastError().
int minmax_scan_launch(const void* mins, const void* maxs, const void* valid,
                       void* out, int64_t B, int64_t R, int device,
                       void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (B > 0) {
    minmax_scan_kernel<<<(unsigned)B, kThreads, 0, (cudaStream_t)stream>>>(
        (const float*)mins, (const float*)maxs, (const uint8_t*)valid,
        (float*)out, B, R);
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
