// Forward hash-grid lookup for Hopper (sm_90a):
//   out[c, i] = table[c * ld + idx[i]]   for 0 <= idx[i] < rows, else 0,
// optionally with each value rounded to bf16 (nearest-even) and widened back.
//
// Replaces the TPU Pallas kernel ucnerf_tpu/ops/gather.py::gather_sorted_cm
// (pallas_call at gather.py:172, wrapped by take_cm at gather.py:184).  The
// Pallas kernel sorts the indices, walks table windows with a one-hot MXU
// contraction and sorts the result back, because a TPU gather reads a whole
// (8, 128) tile per index.  Hopper loads 4-byte words directly, so this kernel
// keeps the indices in their original order: one thread per index, the index
// loaded once, the C channel words loaded from the channel planes, and the
// C stores coalesced across the warp (out is channel-major, [C, M]).
//
// Bound (bytes): per call M * (4 B index + 4*C B output) plus the table slice
// once.  A hashed level's slice is 2^21 rows * 16 B = 32 MB, which fits the
// H100's 50 MB L2, so the random loads are served from L2 and DRAM traffic is
// the streams.  At a proposal level of a 15000-ray chunk (M = 92.2 M) that is
// 1.84 GB, about 0.55 ms at 3.35 TB/s; a NeRF level (M = 23.0 M) about
// 0.14 ms.
//
// Offsets are 64-bit: at M = 92 M and C = 4, c * M + i passes 2^31.

#include <cstdint>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

template <int C, bool kBf16>
__global__ void take_cm_kernel(const float* __restrict__ table, int64_t ld,
                               int64_t rows, const int32_t* __restrict__ idx,
                               int64_t m, float* __restrict__ out,
                               int channels) {
  const int nc = C > 0 ? C : channels;
  const int64_t step = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
       i < m; i += step) {
    const int32_t r = __ldg(idx + i);
    const bool valid = r >= 0 && static_cast<int64_t>(r) < rows;
    if (C > 0) {
      // Issue all C loads before any store (memory-level parallelism).
      float v[C > 0 ? C : 1];
#pragma unroll
      for (int c = 0; c < (C > 0 ? C : 1); ++c) {
        v[c] = valid ? __ldg(table + c * ld + r) : 0.0f;
      }
#pragma unroll
      for (int c = 0; c < (C > 0 ? C : 1); ++c) {
        float x = v[c];
        if (kBf16) x = __bfloat162float(__float2bfloat16_rn(x));
        out[c * m + i] = x;
      }
    } else {
      for (int c = 0; c < nc; ++c) {
        float x = valid ? __ldg(table + c * ld + r) : 0.0f;
        if (kBf16) x = __bfloat162float(__float2bfloat16_rn(x));
        out[c * m + i] = x;
      }
    }
  }
}

template <int C>
void launch(const float* table, int64_t ld, int64_t rows, const int32_t* idx,
            int64_t m, float* out, int channels, bool bf16,
            cudaStream_t stream) {
  constexpr int kThreads = 256;
  // Grid-stride loop: enough blocks to fill 132 SMs many times over.
  const int64_t want = (m + kThreads - 1) / kThreads;
  const int blocks = static_cast<int>(want < 132 * 32 ? want : 132 * 32);
  if (bf16) {
    take_cm_kernel<C, true><<<blocks, kThreads, 0, stream>>>(
        table, ld, rows, idx, m, out, channels);
  } else {
    take_cm_kernel<C, false><<<blocks, kThreads, 0, stream>>>(
        table, ld, rows, idx, m, out, channels);
  }
}

}  // namespace

// table: C channel planes of `rows` floats, plane c at table + c * ld.
// idx: m int32 row indices.  out: [C, m] float32, preallocated.
// Returns cudaGetLastError() after the launch (0 on success).
extern "C" int ucnerf_take_cm(const void* table, long long ld, long long rows,
                              const void* idx, long long m, void* out,
                              int channels, int bf16, void* stream) {
  const auto* t = static_cast<const float*>(table);
  const auto* ix = static_cast<const int32_t*>(idx);
  auto* o = static_cast<float*>(out);
  auto s = static_cast<cudaStream_t>(stream);
  if (m > 0) {
    if (channels == 4) {
      launch<4>(t, ld, rows, ix, m, o, channels, bf16 != 0, s);
    } else {
      launch<0>(t, ld, rows, ix, m, o, channels, bf16 != 0, s);
    }
  }
  return static_cast<int>(cudaGetLastError());
}
