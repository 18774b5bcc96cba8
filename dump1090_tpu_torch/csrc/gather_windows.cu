// Candidate-window gather for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel dump1090_tpu/ops/gather.py::_gather_kernel
// (launched by gather_windows).  For each buffer b and candidate k it copies
// the 256 uint16 samples m_pad[b, pos[b,k] : pos[b,k] + 256] to
// out[b, k, :].  m_pad carries a one-sample lead, so out[b, k, 0] = m[pos-1].
//
// What bounds it on this card: bytes.  Each window is read once and written
// once (about B*MC*512 bytes each way, plus the positions), with no
// arithmetic to speak of, so the floor is device-memory bandwidth.
//
// What the design does about it: one block per (buffer, 16-candidate chunk),
// one warp per candidate.  A window is 512 contiguous bytes, so each lane
// writes one 16-byte vector and the warp's store is a single fully
// coalesced 512-byte transaction.  The start position is arbitrary (not
// 16-byte aligned), so each lane reads its 8 samples as 2-byte loads; the
// warp's loads span the same 512 contiguous bytes, which L1 serves after
// the first touch.  The TPU kernel had to stage whole rows in VMEM and cut
// windows with sublane rolls because of Mosaic's alignment rules; none of
// that is needed here.  A ragged last chunk (MC not a multiple of 16) is
// masked per warp instead of padding the positions.
//
// Positions are clamped into [0, s_pad - 256] like XLA's dynamic_slice, so
// no input can read out of bounds; every in-range position is copied
// exactly.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kWindow = 256;          // samples per window (241 used)
constexpr int kChunk = 16;            // candidates per block, one warp each
constexpr int kLaneSamples = kWindow / 32;

__global__ void __launch_bounds__(kChunk * 32)
gather_windows_kernel(const uint16_t* __restrict__ m_pad,
                      const int32_t* __restrict__ pos,
                      uint16_t* __restrict__ out, int s_pad, int mc) {
  const int b = blockIdx.y;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int k = blockIdx.x * kChunk + warp;
  if (k >= mc) return;  // ragged last chunk

  const size_t slot = static_cast<size_t>(b) * mc + k;
  const int p = min(max(pos[slot], 0), s_pad - kWindow);
  const uint16_t* src = m_pad + static_cast<size_t>(b) * s_pad + p + lane * kLaneSamples;

  uint32_t v[kLaneSamples / 2];
#pragma unroll
  for (int i = 0; i < kLaneSamples / 2; ++i) {
    v[i] = static_cast<uint32_t>(src[2 * i]) |
           (static_cast<uint32_t>(src[2 * i + 1]) << 16);
  }
  uint4* dst = reinterpret_cast<uint4*>(out + slot * kWindow) + lane;
  *dst = make_uint4(v[0], v[1], v[2], v[3]);
}

}  // namespace

extern "C" int gather_windows(const void* m_pad, const void* pos, void* out,
                              int n_buffers, int s_pad, int mc, void* stream) {
  const dim3 grid((mc + kChunk - 1) / kChunk, n_buffers);
  gather_windows_kernel<<<grid, kChunk * 32, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint16_t*>(m_pad), static_cast<const int32_t*>(pos),
      static_cast<uint16_t*>(out), s_pad, mc);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* d1090_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
