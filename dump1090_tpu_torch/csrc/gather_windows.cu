// Candidate-window gather for Hopper (sm_90a): K1.
//
// Replaces the Pallas TPU kernel dump1090_tpu/ops/gather.py::_gather_kernel
// (launched by gather_windows) together with the padded row that
// dump1090_tpu/ops/demod.py::gather_candidate_windows builds for it.  For
// buffer b, candidate k and window sample j < 256 it writes
//
//   p   = clamp(pos[b, k], 0, s_pad - 256)
//   src = p + j - lead
//   out[b, k, j] = uint16(m[b, src])  if 0 <= src < S, else 0
//
// m is int32 magnitudes (B, S), narrowed to their low 16 bits, or uint16
// rows.  This is the gather from the TPU's padded row (lead zeros, m, then
// zeros up to s_pad samples), but that row is never built: the TPU needed it
// so that each window sat in one aligned (16, 128) VMEM tile; here only its
// length survives, as the clamp of a window's start.  lead = 1 puts m[pos-1]
// at window index 0 (the file, host and live paths); lead = 0 with a uint16
// m_pad of s_pad samples is the JAX-shaped gather_windows(m_pad, pos).
//
// What bounds it on this card: bytes.  It reads the union of the windows
// (4 bytes a sample from int32 magnitudes) and writes every window once
// (512 bytes), with no arithmetic to speak of.
//
// What the design does about it: one block per (buffer, 16-candidate chunk),
// one warp per candidate.  At step i lane l loads window sample 32*i + l, so
// each of the warp's 8 steps is one coalesced 128-byte read of int32
// magnitudes.  The lane narrows in registers and writes its uint16 into the
// warp's 512-byte shared slot; after __syncwarp each lane takes 8
// consecutive samples as one 16-byte vector, and the warp's store is one
// coalesced 512-byte transaction.
//
// A staged form (the chunk's span of ascending positions loaded once into
// shared memory, the windows cut from there) was tried and dropped: on
// dense air a 16-candidate chunk spans about 10,000 samples, too wide to
// stage, and it was not faster at the file decode's (512, 256) on an H100
// (PERF.md).
//
// Every load is bounds-checked against the row, so no position reads
// outside m; a ragged last chunk (MC not a multiple of 16) is masked per
// warp.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kWindow = 256;          // samples per window (241 used)
constexpr int kChunk = 16;            // candidates per block, one warp each
constexpr int kSteps = kWindow / 32;  // lane-strided loads per window

template <typename T>
__device__ __forceinline__ uint16_t sample(const T* __restrict__ row, int src, int s) {
  // the cast keeps the low 16 bits of an int32 magnitude
  return (src >= 0 && src < s) ? static_cast<uint16_t>(__ldg(row + src)) : uint16_t{0};
}

template <typename T>
__global__ void __launch_bounds__(kChunk * 32)
gather_windows_kernel(const T* __restrict__ m, const int32_t* __restrict__ pos,
                      uint16_t* __restrict__ out, int s, int s_pad, int lead, int mc) {
  __shared__ __align__(16) uint16_t slot[kChunk][kWindow];
  const int b = blockIdx.y;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int k = blockIdx.x * kChunk + warp;
  const T* row = m + static_cast<size_t>(b) * s;
  const int32_t* prow = pos + static_cast<size_t>(b) * mc;
  const int hi = s_pad - kWindow;
  uint16_t* dst = out + (static_cast<size_t>(b) * mc + k) * kWindow;

  if (k >= mc) return;  // ragged last chunk
  const int st = min(max(prow[k], 0), hi) - lead;
  uint16_t v[kSteps];
#pragma unroll
  for (int i = 0; i < kSteps; ++i) v[i] = sample(row, st + 32 * i + lane, s);
#pragma unroll
  for (int i = 0; i < kSteps; ++i) slot[warp][32 * i + lane] = v[i];
  __syncwarp();
  reinterpret_cast<uint4*>(dst)[lane] = reinterpret_cast<const uint4*>(slot[warp])[lane];
}

template <typename T>
cudaError_t launch(const void* m, const void* pos, void* out, int n_buffers, int s, int s_pad,
                   int lead, int mc, cudaStream_t stream) {
  const dim3 grid((mc + kChunk - 1) / kChunk, n_buffers);
  const T* mt = static_cast<const T*>(m);
  const int32_t* p = static_cast<const int32_t*>(pos);
  uint16_t* o = static_cast<uint16_t*>(out);
  gather_windows_kernel<T><<<grid, kChunk * 32, 0, stream>>>(mt, p, o, s, s_pad, lead, mc);
  return cudaGetLastError();
}

}  // namespace

// m: int32 (elem_bytes 4) or uint16 (elem_bytes 2) rows (n_buffers, s);
// pos: int32 (n_buffers, mc); out: uint16 (n_buffers, mc, 256).
extern "C" int gather_windows(const void* m, int elem_bytes, const void* pos, void* out,
                              int n_buffers, int s, int s_pad, int lead, int mc, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (elem_bytes == 4) {
    return static_cast<int>(launch<int32_t>(m, pos, out, n_buffers, s, s_pad, lead, mc, st));
  }
  if (elem_bytes == 2) {
    return static_cast<int>(launch<uint16_t>(m, pos, out, n_buffers, s, s_pad, lead, mc, st));
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

extern "C" const char* d1090_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
