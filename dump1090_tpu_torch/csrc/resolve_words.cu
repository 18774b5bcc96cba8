// Sequential candidate resolver for Hopper (sm_90a), in two forms.
//
// resolve_words_kernel replaces the Pallas TPU kernel
// dump1090_tpu/ops/resolve.py::_resolve_kernel_factory in its single-stream
// form (cps=None, launched by _resolve_words_pallas, call :690).  It walks
// the flat candidate stream of one dispatch group in order: buffer b owns
// slots [b*mc, (b+1)*mc), of which only the first nbuf[b] are walked.  Per
// slot it applies _step_semantics exactly (ops/resolve.py:412-456): the
// skip-until position (reset on PF_NEWBUF, advanced past good frames), the
// 1024-entry ICAO cache of (addr, ts) with its 60 s TTL, pass 2 only when
// pass 1 was not good and PF_GATE1 is set, and at most one cache write per
// candidate.  It emits one decision word (R_* bits) per walked slot, 0 on
// every other slot, and returns the updated cache.
//
// resolve_words_streams_kernel replaces the same Pallas kernel in its
// multi-stream form (cps=grid_per, launched by
// _resolve_words_pallas_streams, call :751): S INDEPENDENT walks laid end to
// end, stream s owning buffers [s*NB, (s+1)*NB) and cache row s.  Each
// stream starts at skip 0 with its own cache row, exactly as if it were
// walked alone.  The TPU ran the streams one after another on its scalar
// core, swapping the cache row at each stream boundary; here they are
// independent blocks, one per stream (gridDim.x = S), which run in parallel
// on the card's SMs.
//
// What bounds both on this card: the serial chain of dependent steps.  Each
// step's skip and cache state depend on the previous step's, so the walk is
// latency, not bytes or operations: the input is a few MB, which the card
// could stream in microseconds, while ~1e5 dependent steps at tens of ns
// each take milliseconds.  For the multi-stream form the chain is one
// stream's executed steps: the longest stream sets the kernel's time.
//
// What the design does about it: the streams run in parallel, one block
// each, so the critical path is the longest stream and not their sum.
// Within a stream the chain runs on one thread with every operand in shared
// memory, the fastest memory that thread can index by data.  The 8 KB cache
// lives in shared memory for the whole walk.  The block's other threads
// stage the next chunk of the four input streams (pf, w1, w2, h12) into
// shared memory with coalesced loads and write the finished chunk's words
// back, so the walking thread never waits on device memory inside a step.
// The hash slots of both passes arrive precomputed (h12, as _hash_words
// does), which takes the two multiply-shift hashes off the chain.
// Overlapping the staging with the walk (double buffering) and shortening
// the chain itself are work for later.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

// word layouts: dump1090_tpu_torch/ops/resolve.py (PF_*, W_*, R_*, SKIP_*)
constexpr int PF_POS_MASK = (1 << 17) - 1;
constexpr int PF_VALID = 1 << 17;
constexpr int PF_NEWBUF = 1 << 18;
constexpr int PF_GATE1 = 1 << 19;
constexpr int W_ADDR_MASK = (1 << 24) - 1;
constexpr int W_ATTEMPT = 1 << 24;
constexpr int W_CRCOK_SEEN = 1 << 25;
constexpr int W_CRCOK_NOSEEN = 1 << 26;
constexpr int W_ADDABLE = 1 << 27;
constexpr int W_LONG = 1 << 28;
constexpr int SKIP_SHORT = 129;
constexpr int SKIP_EXTRA_LONG = 112;

constexpr int kCacheLen = 1024;
constexpr int kCacheTtl = 60;
constexpr int kChunk = 1024;   // slots staged in shared memory per round
constexpr int kThreads = 256;

__device__ __forceinline__ bool cache_seen(const int* ca, const int* ct, int h,
                                           int addr, int now) {
  const int a = ca[h];
  // int32 wraparound, as the reference's time_t difference on 32 bits
  const int age = static_cast<int>(static_cast<unsigned>(now) - static_cast<unsigned>(ct[h]));
  return a == addr && a != 0 && age <= kCacheTtl;
}

struct WalkSmem {
  int ca[kCacheLen];
  int ct[kCacheLen];
  int pf[kChunk];
  int w1[kChunk];
  int w2[kChunk];
  int h12[kChunk];
  int words[kChunk];
};

// One stream's walk by the whole block: pointers are already offset to the
// stream's first slot, first buffer count and cache row.
__device__ __forceinline__ void walk_stream(
    const int* __restrict__ pf, const int* __restrict__ w1,
    const int* __restrict__ w2, const int* __restrict__ h12,
    const int* __restrict__ nbuf, const int* __restrict__ ca_in,
    const int* __restrict__ ct_in, int* __restrict__ words,
    int* __restrict__ ca_out, int* __restrict__ ct_out, int n_buffers, int mc,
    int now, WalkSmem& sm) {
  const int tid = threadIdx.x;
  for (int i = tid; i < kCacheLen; i += kThreads) {
    sm.ca[i] = ca_in[i];
    sm.ct[i] = ct_in[i];
  }

  const long long n = static_cast<long long>(n_buffers) * mc;
  int skip = 0;  // live in thread 0 only
  for (long long c0 = 0; c0 < n; c0 += kChunk) {
    const int len = static_cast<int>(n - c0 < kChunk ? n - c0 : kChunk);
    for (int i = tid; i < len; i += kThreads) {
      sm.pf[i] = pf[c0 + i];
      sm.w1[i] = w1[c0 + i];
      sm.w2[i] = w2[c0 + i];
      sm.h12[i] = h12[c0 + i];
      sm.words[i] = 0;
    }
    __syncthreads();

    if (tid == 0) {
      const int b_first = static_cast<int>(c0 / mc);
      const int b_last = static_cast<int>((c0 + len - 1) / mc);
      for (int b = b_first; b <= b_last; ++b) {
        const long long start = static_cast<long long>(b) * mc;
        const int cnt = min(max(nbuf[b], 0), mc);
        const long long lo = start > c0 ? start : c0;
        const long long hi = start + cnt < c0 + len ? start + cnt : c0 + len;
        for (int i = static_cast<int>(lo - c0); i < static_cast<int>(hi - c0); ++i) {
          const int p = sm.pf[i];
          const int v1 = sm.w1[i];
          const int v2 = sm.w2[i];
          const int hh = sm.h12[i];
          const int pos = p & PF_POS_MASK;
          if (p & PF_NEWBUF) skip = 0;
          const bool run = (p & PF_VALID) && pos >= skip;

          // pass 1 (uncorrected)
          const int h1 = hh & 0x3FF;
          const int a1 = v1 & W_ADDR_MASK;
          const bool seen1 = cache_seen(sm.ca, sm.ct, h1, a1, now);
          const bool att1 = run && (v1 & W_ATTEMPT);
          const bool crcok1 = seen1 ? (v1 & W_CRCOK_SEEN) : (v1 & W_CRCOK_NOSEEN);
          const bool good1 = att1 && crcok1;
          const bool add1 = att1 && (v1 & W_ADDABLE);
          if (good1) skip = pos + SKIP_SHORT + ((v1 & W_LONG) ? SKIP_EXTRA_LONG : 0);

          // pass 2 (phase-corrected retry; a noise-gate failure on pass 1
          // skips it, dump1090.c:1724-1726).  Its lookup sees the cache as
          // it was before this step: the write happens after both passes.
          const bool run2 = run && (p & PF_GATE1) && !good1;
          const int h2 = (hh >> 10) & 0x3FF;
          const int a2 = v2 & W_ADDR_MASK;
          const bool seen2 = cache_seen(sm.ca, sm.ct, h2, a2, now);
          const bool att2 = run2 && (v2 & W_ATTEMPT);
          const bool crcok2 = seen2 ? (v2 & W_CRCOK_SEEN) : (v2 & W_CRCOK_NOSEEN);
          const bool good2 = att2 && crcok2;
          const bool add2 = att2 && (v2 & W_ADDABLE);
          if (good2) skip = pos + SKIP_SHORT + ((v2 & W_LONG) ? SKIP_EXTRA_LONG : 0);

          if (add1) {
            sm.ca[h1] = a1;
            sm.ct[h1] = now;
          } else if (add2) {
            sm.ca[h2] = a2;
            sm.ct[h2] = now;
          }
          sm.words[i] = run | (att1 << 1) | (crcok1 << 2) | (good1 << 3) |
                        (run2 << 4) | (att2 << 5) | (crcok2 << 6) | (good2 << 7);
        }
      }
    }
    __syncthreads();

    for (int i = tid; i < len; i += kThreads) words[c0 + i] = sm.words[i];
    __syncthreads();  // the next round overwrites the staged chunk
  }

  for (int i = tid; i < kCacheLen; i += kThreads) {
    ca_out[i] = sm.ca[i];
    ct_out[i] = sm.ct[i];
  }
}

// K2: one stream, one block.
__global__ void __launch_bounds__(kThreads)
resolve_words_kernel(const int* __restrict__ pf, const int* __restrict__ w1,
                     const int* __restrict__ w2, const int* __restrict__ h12,
                     const int* __restrict__ nbuf, const int* __restrict__ ca_in,
                     const int* __restrict__ ct_in, int* __restrict__ words,
                     int* __restrict__ ca_out, int* __restrict__ ct_out,
                     int n_buffers, int mc, int now) {
  __shared__ WalkSmem sm;
  walk_stream(pf, w1, w2, h12, nbuf, ca_in, ct_in, words, ca_out, ct_out,
              n_buffers, mc, now, sm);
}

// K3: stream blockIdx.x of S, each with bufs_per_stream buffers.
__global__ void __launch_bounds__(kThreads)
resolve_words_streams_kernel(const int* __restrict__ pf, const int* __restrict__ w1,
                             const int* __restrict__ w2, const int* __restrict__ h12,
                             const int* __restrict__ nbuf, const int* __restrict__ ca_in,
                             const int* __restrict__ ct_in, int* __restrict__ words,
                             int* __restrict__ ca_out, int* __restrict__ ct_out,
                             int bufs_per_stream, int mc, int now) {
  __shared__ WalkSmem sm;
  const long long s = blockIdx.x;
  const long long slots = s * bufs_per_stream * mc;
  const long long row = s * kCacheLen;
  walk_stream(pf + slots, w1 + slots, w2 + slots, h12 + slots,
              nbuf + s * bufs_per_stream, ca_in + row, ct_in + row,
              words + slots, ca_out + row, ct_out + row, bufs_per_stream, mc,
              now, sm);
}

}  // namespace

extern "C" int resolve_words(const void* pf, const void* w1, const void* w2,
                             const void* h12, const void* nbuf,
                             const void* ca_in, const void* ct_in, void* words,
                             void* ca_out, void* ct_out, int n_buffers, int mc,
                             int now, void* stream) {
  resolve_words_kernel<<<1, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(pf), static_cast<const int*>(w1),
      static_cast<const int*>(w2), static_cast<const int*>(h12),
      static_cast<const int*>(nbuf), static_cast<const int*>(ca_in),
      static_cast<const int*>(ct_in), static_cast<int*>(words),
      static_cast<int*>(ca_out), static_cast<int*>(ct_out), n_buffers, mc, now);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int resolve_words_streams(const void* pf, const void* w1, const void* w2,
                                     const void* h12, const void* nbuf,
                                     const void* ca_in, const void* ct_in,
                                     void* words, void* ca_out, void* ct_out,
                                     int n_streams, int bufs_per_stream, int mc,
                                     int now, void* stream) {
  resolve_words_streams_kernel<<<n_streams, kThreads, 0,
                                 static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(pf), static_cast<const int*>(w1),
      static_cast<const int*>(w2), static_cast<const int*>(h12),
      static_cast<const int*>(nbuf), static_cast<const int*>(ca_in),
      static_cast<const int*>(ct_in), static_cast<int*>(words),
      static_cast<int*>(ca_out), static_cast<int*>(ct_out), bufs_per_stream, mc,
      now);
  return static_cast<int>(cudaGetLastError());
}
