// Both demodulation passes of every candidate for Hopper (sm_90a): K4.
//
// Replaces no Pallas kernel.  The JAX package runs the phase-correction walk
// as one lax.scan (dump1090_tpu/ops/demod.py:188-251), which XLA fuses with
// the bit slicing and the noise gate around it.  The port's plain version,
// ops/demod.py::candidate_passes_window_plain, runs the walk as a Python loop
// of 111 steps of vector ops: about 1,230 kernel launches a dispatch, which
// the host pays for on every path.  This kernel computes what that function
// returns, bit for bit, for each of the N candidate windows (valid or not),
// in one launch:
//
//   pass 1  the 112 cells of w[17:241] sliced (dump1090.c:1666-1706): bit =
//           low > high; cell 0 with low == high is the demod error, value 2;
//           a later cell with |low - high| < 256 repeats the bit before it.
//           Bytes are packed first bit first by OR, so an inherited 2 spills
//           into the bit above.  The error count is cell 0's error.
//   pass 2  the same over the phase-corrected samples (applyPhaseCorrection,
//           dump1090.c:1471-1558), or over the uncorrected ones where
//           pos <= 0 (dump1090.c:1658-1663).
//   gate    per pass, the mean |low - high| of the UNCORRECTED samples over
//           the length the pass's own DF claims (dump1090.c:1709-1726).
//
// The arithmetic is the plain version's: samples as int32 (uint16 windows
// zero-extended), the walk's factor 16384*e // max(e + on_time, 1) in 64
// bits with floor division, kept to its low 32 bits, and the scale
// min((v*f) >> 14, 65535) on int32 that wraps.  Only the direction that
// early > late selects is walked; the plain version walks both and keeps it.
//
// What bounds it on this card.  Bytes: a candidate reads 232 window samples
// (w[0], w[1], w[3], w[4], w[7], w[8], w[10], w[11], w[17:241]) and its
// position and writes six outputs, about 506 bytes, so a 512 x 256 archive
// group moves 66 MB, ~20 us at 3.35 TB/s.  But the walk is a chain of 111
// dependent steps, and each slice a chain of 112 cells through the repeat
// rule, so at the feeder's 256 candidates one chain and the launch set the
// time, and at a large N the ~3,000 instructions a candidate compete with
// the bytes.
//
// What the design does about it: one lane per candidate, so each chain runs
// in registers with no traffic between lanes, and 32 candidates a block (one
// warp).  The warp stages its 32 rows' message samples in shared memory with
// coalesced loads (lane l takes sample l + 32 i of a row; eight rows in
// flight), each row padded to an odd number of 32-bit words, so that 32 lanes
// reading the same sample of their own rows hit 32 banks.  Each lane slices
// its row with the gate's sums, walks it in place, and slices it again.  The
// walk loads eight steps' samples ahead of the chain: no step reads a sample
// another step writes (it reads one of the other parity and its own target),
// so the chain waits on no shared-memory load.  Lanes past N stage zeros and
// write nothing.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kCands = 32;         // candidates a block: one warp, a lane each
constexpr int kFirst = 17;         // w[0] = m[pos-1], then the 16 preamble samples
constexpr int kMsg = 224;          // message samples w[17:241]
constexpr int kCells = kMsg / 2;   // 112 bits
constexpr int kWindow = kFirst + kMsg;
constexpr int kSteps = kCells - 1; // the walk's steps after its seed
constexpr int kRowsInFlight = 8;   // rows a staging round
constexpr int kAhead = 8;          // walk steps loaded ahead of the chain
constexpr int kRepeatDelta = 256;  // |low - high| below this repeats the bit
constexpr int kNoiseGate = 10 * 255;

// a shared row's stride in elements: an odd number of 32-bit words
template <typename T> struct Stride;
template <> struct Stride<uint16_t> { static constexpr int value = kMsg + 2; };  // 113 words
template <> struct Stride<int32_t> { static constexpr int value = kMsg + 1; };   // 225 words

// int32 arithmetic that wraps, as the plain version's tensors do
__device__ __forceinline__ int wrap_sub(int a, int b) {
  return static_cast<int>(static_cast<unsigned>(a) - static_cast<unsigned>(b));
}
__device__ __forceinline__ int wrap_abs(int a) {
  return a < 0 ? static_cast<int>(0u - static_cast<unsigned>(a)) : a;
}
__device__ __forceinline__ long long floor_div(long long a, long long b) {  // b > 0
  const long long q = a / b;
  return (a % b != 0 && a < 0) ? q - 1 : q;
}

// scaleSample (dump1090.c:1473-1476)
__device__ __forceinline__ int scale(int v, int f) {
  return min(static_cast<int>(static_cast<unsigned>(v) * static_cast<unsigned>(f)) >> 14, 65535);
}

// Slices the 112 cells of row s into 14 bytes at out and returns the DF (the
// first byte's top five bits); *err gets cell 0's demod error.  kSums adds
// each cell's |low - high| to *s56 (the first 56 cells) and *s112.
template <bool kSums, typename T>
__device__ __forceinline__ int slice(const T* s, uint8_t* __restrict__ out, int* err,
                                     long long* s56, long long* s112) {
  int cur = 0, df = 0;
  for (int j = 0; j < kCells / 8; ++j) {
    int acc = 0;
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      const int t = 8 * j + k;
      const int lo = s[2 * t], hi = s[2 * t + 1];
      const int delta = wrap_abs(wrap_sub(lo, hi));
      if constexpr (kSums) {
        *s112 += delta;
        if (t < kCells / 2) *s56 += delta;
      }
      if (t == 0) {
        *err = lo == hi;
        cur = lo == hi ? 2 : lo > hi;
      } else if (delta >= kRepeatDelta) {
        cur = lo > hi;
      }
      acc |= cur << (7 - k);
    }
    out[j] = static_cast<uint8_t>(acc);
    if (j == 0) df = (acc & 0xFF) >> 3;
  }
  return df;
}

__device__ __forceinline__ uint8_t noise_gate(int df, long long s56, long long s112) {
  const bool is_long = df >= 16 && df <= 21;
  return floor_div(is_long ? s112 : s56, is_long ? 14 * 4 : 7 * 4) >= kNoiseGate;
}

// applyPhaseCorrection in place on row s, from the window's preamble samples
template <typename T>
__device__ __forceinline__ void walk(T* s, const T* __restrict__ wc) {
  const long long on_time = static_cast<long long>(wc[1]) + wc[3] + wc[8] + wc[10];
  const long long early = (static_cast<long long>(wc[0]) + wc[7]) * 2;
  const long long late = (static_cast<long long>(wc[4]) + wc[11]) * 2;
  // late >= early: seed sample 0 and walk forward writing the even samples;
  // early > late: seed sample 223 and walk backward writing the odd ones
  const bool fwd = !(early > late);
  const long long e = fwd ? late : early;
  const unsigned q = static_cast<unsigned>(
      static_cast<unsigned long long>(floor_div(16384 * e, e + on_time > 1 ? e + on_time : 1)));
  const int up = static_cast<int>(16384u + q), down = static_cast<int>(16384u - q);
  // forward: up where the chain's sample beats the odd one beside it;
  // backward: down where the even one beside it beats the chain's
  const int f_hit = fwd ? up : down, f_miss = fwd ? down : up;
  const int s0 = fwd ? 0 : kMsg - 1, d = fwd ? 1 : -1;
  int v = scale(s[s0], up);
  s[s0] = static_cast<T>(v);
  for (int k0 = 0; k0 < kSteps; k0 += kAhead) {
    int a[kAhead], t[kAhead];
#pragma unroll
    for (int i = 0; i < kAhead; ++i) {
      if (k0 + i < kSteps) {
        a[i] = s[s0 + d * (2 * (k0 + i) + 1)];
        t[i] = s[s0 + d * (2 * (k0 + i) + 2)];
      }
    }
#pragma unroll
    for (int i = 0; i < kAhead; ++i) {
      if (k0 + i < kSteps) {
        v = scale(t[i], (fwd ? v > a[i] : a[i] > v) ? f_hit : f_miss);
        s[s0 + d * (2 * (k0 + i) + 2)] = static_cast<T>(v);
      }
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(kCands)
candidate_passes_kernel(const T* __restrict__ w, int row, const int32_t* __restrict__ pos,
                        uint8_t* __restrict__ msg, int32_t* __restrict__ errors,
                        uint8_t* __restrict__ gate, int n) {
  constexpr int kStride = Stride<T>::value;
  __shared__ T rows[kCands * kStride];
  const int lane = threadIdx.x;
  const int c0 = blockIdx.x * kCands;

  for (int r0 = 0; r0 < kCands; r0 += kRowsInFlight) {
    int v[kRowsInFlight][kMsg / 32];
#pragma unroll
    for (int r = 0; r < kRowsInFlight; ++r) {
      const bool inside = c0 + r0 + r < n;
      const size_t base = static_cast<size_t>(c0 + r0 + r) * row + kFirst + lane;
#pragma unroll
      for (int i = 0; i < kMsg / 32; ++i) v[r][i] = inside ? static_cast<int>(w[base + 32 * i]) : 0;
    }
#pragma unroll
    for (int r = 0; r < kRowsInFlight; ++r) {
#pragma unroll
      for (int i = 0; i < kMsg / 32; ++i) {
        rows[(r0 + r) * kStride + 32 * i + lane] = static_cast<T>(v[r][i]);
      }
    }
  }
  __syncwarp();

  const int c = c0 + lane;
  if (c >= n) return;
  T* s = rows + lane * kStride;
  const T* wc = w + static_cast<size_t>(c) * row;
  long long s56 = 0, s112 = 0;
  int err;
  const int df1 = slice<true>(s, msg + static_cast<size_t>(c) * 14, &err, &s56, &s112);
  errors[c] = err;
  gate[c] = noise_gate(df1, s56, s112);
  if (pos[c] > 0) walk(s, wc);
  const int df2 = slice<false>(s, msg + (static_cast<size_t>(n) + c) * 14, &err, nullptr, nullptr);
  errors[n + c] = err;
  gate[n + c] = noise_gate(df2, s56, s112);
}

template <typename T>
cudaError_t launch(const void* w, int row, const void* pos, void* msg, void* errors, void* gate,
                   int n, cudaStream_t stream) {
  const int blocks = (n + kCands - 1) / kCands;
  candidate_passes_kernel<T><<<blocks, kCands, 0, stream>>>(
      static_cast<const T*>(w), row, static_cast<const int32_t*>(pos),
      static_cast<uint8_t*>(msg), static_cast<int32_t*>(errors), static_cast<uint8_t*>(gate), n);
  return cudaGetLastError();
}

}  // namespace

// w: uint16 (elem_bytes 2) or int32 (elem_bytes 4) windows (n, row), row >= 241;
// pos: int32 (n,); msg: uint8 (2, n, 14); errors: int32 (2, n); gate: bool (2, n),
// pass 1 then pass 2.
extern "C" int candidate_passes(const void* w, int elem_bytes, int row, const void* pos, void* msg,
                                void* errors, void* gate, int n, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (n <= 0 || row < kWindow) return static_cast<int>(cudaErrorInvalidValue);
  if (elem_bytes == 2) {
    return static_cast<int>(launch<uint16_t>(w, row, pos, msg, errors, gate, n, st));
  }
  if (elem_bytes == 4) {
    return static_cast<int>(launch<int32_t>(w, row, pos, msg, errors, gate, n, st));
  }
  return static_cast<int>(cudaErrorInvalidValue);
}
