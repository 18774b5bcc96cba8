// Sequential candidate resolver for Hopper (sm_90a), in two forms.
//
// resolve_words_kernel replaces the Pallas TPU kernel
// dump1090_tpu/ops/resolve.py::_resolve_kernel_factory in its single-stream
// form (cps=None, launched by _resolve_words_pallas, call :690).  It walks
// the flat candidate stream of one dispatch group in order: buffer b owns
// slots [b*mc, (b+1)*mc), of which only the first nbuf[b] (clamped to
// [0, mc]) are walked.  Per slot it applies _step_semantics exactly
// (ops/resolve.py:412-456): the skip-until position (reset on PF_NEWBUF,
// advanced past good frames), the 1024-entry ICAO cache of (addr, ts) with
// its 60 s TTL, pass 2 only when pass 1 was not good and PF_GATE1 is set,
// and at most one cache write per candidate (pass 1's before pass 2's).  It
// emits one decision word (R_* bits) per walked slot, 0 on every other
// slot, and returns the updated cache.
//
// resolve_words_streams_kernel replaces the same Pallas kernel in its
// multi-stream form (cps=grid_per, launched by
// _resolve_words_pallas_streams, call :751): S independent walks laid end to
// end, stream s owning buffers [s*NB, (s+1)*NB) and cache row s, each from
// skip 0.  The TPU ran the streams one after another on its scalar core;
// here they are independent blocks, one per stream (gridDim.x = S), and both
// kernels call the one walk below, so they cannot drift apart.
//
// What bounds the walk on this card.  Not bytes: the input is a few MB.  It
// is the chain of dependent steps: a step's skip depends on the last good
// step before it, and its two cache lookups on every earlier write.  A
// single thread paying that chain step by step took about 240 cycles a step.
// Here a warp settles a batch of up to 32 steps at once, so what bounds the
// walk is its number of batches times the latency of one: a few dozen
// dependent warp operations (shuffles, ballots, shared-memory loads, tens of
// cycles each with one warp issuing), whatever the batch's good steps.  A
// batch never crosses a buffer or a chunk, so there are at least as many
// batches as each buffer's walked slots over 32, plus one per cut.  On real
// air almost no batch cuts, and a batch takes about 0.57 us on an H100; on
// a stream built to cut every batch, a batch commits under 2 steps, and a
// step costs about 5 times what one thread walking alone paid.  The chunk
// ring is off that chain, as its copies land a chunk ahead of the walk;
// but a walk of one chunk, as each of K3's streams is at its usual width,
// waits for its first chunk, the cache build and the write-back.  The
// batches and their cuts are counted per block into `counts` when the
// caller asks.
//
// What the design does about it:
//
//  * The TTL is folded out of the chain.  `now` is one value per launch (K2
//    reads it from a one-element device tensor, so that a CUDA graph
//    replays the launch at a new clock; K3 takes it as an argument) and
//    every write stores ts = now, so whether an input entry is fresh is fixed
//    for the walk, and a written entry is always fresh.  One array
//    live[h] = (ca[h] != 0 && age <= 60) ? ca[h] : 0, built once in
//    parallel, turns a lookup into one load and a compare.  A written[h]
//    byte marks entries whose ts becomes `now`.
//
//  * A batch is up to 32 consecutive walked slots of one buffer, a lane
//    each.  settle() takes every lane's step for run = true against the cache
//    at the batch's start, and its successor: the first later good lane that
//    runs if this one runs and is good.  Five rounds of pointer doubling fold
//    the successors into each lane's chain and the lanes that run along it.
//    plan() then needs only the skip carried in: it names the first good
//    lane that runs, and one shuffle of its chain and runs settles every
//    lane.  A PF_NEWBUF on any lane resets the skip from that lane on.
//
//  * The cut.  A lane's lookups can be turned only by the running lanes
//    before it that write its slots; each slot then holds the address of its
//    last writer.  The first lane whose crcok bits differ under that cache
//    cuts the batch, and only the lanes before it commit: their words, and
//    each slot's last writer's address.  Lane 0 always reads the true cache,
//    so a batch commits at least one step, and the next batch starts at the
//    cut.  On real air a repeated aircraft rewrites its own address and a
//    clean DF17 frame passes CRC either way, so real air cuts almost never.
//
//  * Two warps walk.  Warp 1 settles the batch after the current one, on the
//    guess that the current one commits all its lanes, while warp 0 plans and
//    commits the current one; they meet at a named barrier once a batch.
//    Warp 0 checks a settled batch against the cache as it stands after the
//    commit before; if its lookups give other crcok bits, or the guess
//    failed (a cut), warp 0 settles the batch again itself.
//
//  * The staging runs beside the walk.  Warps 2-7 keep a ring of two
//    1024-slot chunks in shared memory.  One thread issues the Hopper bulk
//    asynchronous copies (TMA: cp.async.bulk to shared memory, completed on
//    an mbarrier that the walking warps wait on) of the next chunk's four
//    input streams: one instruction a stream, no registers held while it
//    flies, which the per-thread cp.async would not give.  The other stager
//    threads write the finished chunk's words back, zero the next chunk's
//    words, stage its buffer counts and, once its inputs land, each slot's
//    skip windows: which of the next 32 slots sit at or past its skip end,
//    so that a successor is a mask and a bit scan.  A bulk copy moves
//    16-byte aligned runs, so each stream sits in its ring slot at the same
//    offset modulo 16 bytes as in device memory, and the up to 3 slots on
//    either side of the aligned run are copied by plain loads.  One
//    __syncthreads per chunk.  Shared memory is about 80 KB a block, so it
//    is dynamic.

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
constexpr int R_CRCOK1 = 4;
constexpr int R_CRCOK2 = 64;

constexpr int kCacheLen = 1024;
constexpr int kCacheTtl = 60;
constexpr int kChunk = 1024;          // slots per ring slot
constexpr int kSlot = kChunk + 4;     // room to keep each stream's 16-byte phase
constexpr int kThreads = 256;         // warps 0 and 1 walk, warps 2-7 stage
constexpr int kWalkers = 64;
constexpr int kStagers = kThreads - kWalkers;
constexpr unsigned kAll = 0xffffffffu;

// The lanes from the lowest set bit of m on (none if m is 0), and the index
// of that bit (m != 0).  Both by plain arithmetic on the lowest bit, which
// is shorter on the walk's chain than a bit scan (__ffs).
__device__ __forceinline__ unsigned from_first(unsigned m) {
  return ~((m & (0u - m)) - 1u);
}

__device__ __forceinline__ int lowest(unsigned m) {
  return __popc((m & (0u - m)) - 1u);
}

struct WalkSmem {
  unsigned long long full[2];           // mbarrier per ring slot: its inputs landed
  int4 rec[2][96];                      // warp 1's settled batch (Lane), for warp 0
  int in[2][4][kSlot];                  // pf, w1, w2, h12 of a chunk
  int words[2][kChunk];
  int cnt[2][kChunk + 1];               // clamped counts of the chunk's buffers
  // per slot, which of the next 32 slots of its chunk sit at or past its
  // skip end after a good short [0] or long [1] frame (bit b: slot + 1 + b)
  unsigned ends[2][2][kChunk];
  int live[kCacheLen];                  // the fresh address of each entry, or 0
  unsigned writers[2][kCacheLen];       // each walking warp's scratch for settle()
  unsigned char written[kCacheLen];
  int cut[2];                           // warp 0's committed count, for warp 1
};

// the walking warps 0 and 1 meet here once a batch
__device__ __forceinline__ void named_sync() {
  asm volatile("bar.sync 1, %0;" ::"n"(kWalkers) : "memory");
}

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(unsigned long long* bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_u32(bar)), "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive_expect_tx(unsigned long long* bar, unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_wait(unsigned long long* bar, unsigned parity) {
  unsigned done = 0;
  while (!done) {
    asm volatile(
        "{\n\t.reg .pred p;\n\t"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n\t"
        "selp.u32 %0, 1, 0, p;\n\t}"
        : "=r"(done)
        : "r"(smem_u32(bar)), "r"(parity)
        : "memory");
  }
}

__device__ __forceinline__ void bulk_g2s(void* dst, const void* src, unsigned bytes,
                                         unsigned long long* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];" ::"r"(
          smem_u32(dst)),
      "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

struct Stream {
  const int* src[4];  // pf, w1, w2, h12 at the stream's first slot
  int shift[4];       // each one's offset in int32s past a 16-byte boundary
  const int* nbuf;
  long long n;        // slots
  int mc;
};

__device__ __forceinline__ int chunk_len(const Stream& st, int c) {
  const long long rest = st.n - static_cast<long long>(c) * kChunk;
  return static_cast<int>(rest < kChunk ? rest : kChunk);
}

// Issue chunk c's input copies into ring slot `slot` (one thread): the
// 16-byte aligned run of each stream by TMA, the ragged ends by plain loads
// made visible by the arrive's release.
__device__ void issue_chunk(const Stream& st, int c, int slot, WalkSmem& sm) {
  const long long c0 = static_cast<long long>(c) * kChunk;
  const int len = chunk_len(st, c);
  unsigned bytes = 0;
  int body_lo[4], body_n[4];
  for (int a = 0; a < 4; ++a) {
    // c0 is a multiple of 4 slots, so the chunk keeps the stream's phase
    const int head = min((4 - st.shift[a]) & 3, len);
    const int body = (len - head) & ~3;
    int* dst = &sm.in[slot][a][st.shift[a]];
    for (int i = 0; i < head; ++i) dst[i] = st.src[a][c0 + i];
    for (int i = head + body; i < len; ++i) dst[i] = st.src[a][c0 + i];
    body_lo[a] = head;
    body_n[a] = body;
    bytes += body * 4u;
  }
  mbar_arrive_expect_tx(&sm.full[slot], bytes);
  for (int a = 0; a < 4; ++a) {
    if (body_n[a] > 0) {
      bulk_g2s(&sm.in[slot][a][st.shift[a] + body_lo[a]], st.src[a] + c0 + body_lo[a],
               body_n[a] * 4u, &sm.full[slot]);
    }
  }
}

// The stagers' share of preparing chunk c in ring slot `slot`: its words
// zeroed and its buffers' clamped counts.  `t` is the thread's index among
// `nt` threads taking part.
__device__ void prepare_chunk(const Stream& st, int c, int slot, WalkSmem& sm, int t, int nt) {
  for (int i = t; i < kChunk; i += nt) sm.words[slot][i] = 0;
  const long long c0 = static_cast<long long>(c) * kChunk;
  const long long b_first = c0 / st.mc;
  const int nb = static_cast<int>((c0 + chunk_len(st, c) - 1) / st.mc - b_first) + 1;
  for (int j = t; j < nb; j += nt) sm.cnt[slot][j] = min(max(st.nbuf[b_first + j], 0), st.mc);
}

// The stagers' second share, once chunk c's inputs have landed in ring slot
// `slot`: each slot's skip windows (WalkSmem::ends).  They depend on
// positions alone, so they are ready before the walk reaches the chunk.
__device__ void skip_windows(const Stream& st, int c, int slot, WalkSmem& sm, int t, int nt) {
  mbar_wait(&sm.full[slot], (c >> 1) & 1);
  const int len = chunk_len(st, c);
  const int* pf = &sm.in[slot][0][st.shift[0]];
  for (int j = t; j < len; j += nt) {
    const int pos = pf[j] & PF_POS_MASK;
    unsigned short_end = 0, long_end = 0;
    for (int b = 0; b < 32 && j + 1 + b < len; ++b) {
      const int later = pf[j + 1 + b] & PF_POS_MASK;
      short_end |= static_cast<unsigned>(later >= pos + SKIP_SHORT) << b;
      long_end |= static_cast<unsigned>(later >= pos + SKIP_SHORT + SKIP_EXTRA_LONG) << b;
    }
    sm.ends[slot][0][j] = short_end;
    sm.ends[slot][1][j] = long_end;
  }
}

// One lane's step of a batch, settled for everything but the skip carried
// in: what the walk needs of it once that skip is known.
struct Lane {
  int flags;         // L_* bits | pos << 12
  int word;          // its decision word if it runs; its crcok bits alone if not
  int end;           // its skip end if it runs and is good
  unsigned reach;    // itself and its successors: the chain that starts here
  unsigned runs;     // the lanes that run if the chain starts here (it and all after it)
  unsigned w1, w2;   // earlier lanes that write its pass-1 / pass-2 lookup slot if they run
  unsigned later;    // later lanes that write its write slot if they run
  int hh;            // its two lookup slots (h12)
  int wa;            // the address it writes if it runs (at slot wh)
  int a1, a2;        // the addresses it looks up
};

constexpr int L_VALID = 1, L_NEWBUF = 2, L_GOOD = 4, L_WRITES = 8, L_ADD1 = 16;
constexpr int L_SEEN1 = 32, L_NOSEEN1 = 64, L_SEEN2 = 128, L_NOSEEN2 = 256;  // CRC-ok policy
constexpr int L_POS_SHIFT = 12;

__device__ __forceinline__ int lane_wh(const Lane& l) {
  return (l.flags & L_ADD1) ? (l.hh & 0x3FF) : ((l.hh >> 10) & 0x3FF);
}

// the crcok bit of a pass whose lookup of `a` finds `r`, under its policy
__device__ __forceinline__ bool crcok_of(int flags, int seen_bit, int noseen_bit, int r, int a) {
  return flags & ((r == a && a != 0) ? seen_bit : noseen_bit);
}

// Settle one batch of up to 32 walked slots [i, i + nb) of ring slot
// `slot`, a warp's lane per slot, against the cache as it stands.  Each
// lane takes its step for run = true and finds its successor: the first
// later good lane that runs if this lane runs and is good (at or past its
// skip end, from the stagers' windows, or after a PF_NEWBUF); the lanes in
// between that run under its skip are its segment.  Pointer doubling folds
// the successors into `reach` and the segments into `runs`, so that once
// the first chain lane is known, one shuffle of each gives the chain and
// every lane's run.  The warp's table `writers` (zero between calls) finds
// which lanes write each lane's lookup slots.
__device__ __forceinline__ Lane settle(const Stream& st, int slot, int i, int nb,
                                       const WalkSmem& sm, unsigned* writers) {
  const int lane = threadIdx.x & 31;
  const bool act = lane < nb;
  const int k = i + min(lane, nb - 1);  // lanes past the batch read its last slot, masked below
  const int p = act ? sm.in[slot][0][st.shift[0] + k] : 0;
  const int v1 = sm.in[slot][1][st.shift[1] + k];
  const int v2 = sm.in[slot][2][st.shift[2] + k];
  const int hh = sm.in[slot][3][st.shift[3] + k];
  const unsigned short_end = sm.ends[slot][0][k];
  const unsigned long_end = sm.ends[slot][1][k];

  const int pos = p & PF_POS_MASK;
  const bool valid = p & PF_VALID;
  const int h1 = hh & 0x3FF;
  const int h2 = (hh >> 10) & 0x3FF;
  const int a1 = v1 & W_ADDR_MASK;
  const int a2 = v2 & W_ADDR_MASK;
  const int policy = (v1 & W_CRCOK_SEEN ? L_SEEN1 : 0) | (v1 & W_CRCOK_NOSEEN ? L_NOSEEN1 : 0) |
                     (v2 & W_CRCOK_SEEN ? L_SEEN2 : 0) | (v2 & W_CRCOK_NOSEEN ? L_NOSEEN2 : 0);
  // both lookups see the cache from before the step, here from before
  // the batch: the cut keeps only the lanes for which that gives the same
  const bool crcok1 = crcok_of(policy, L_SEEN1, L_NOSEEN1, sm.live[h1], a1);
  const bool crcok2 = crcok_of(policy, L_SEEN2, L_NOSEEN2, sm.live[h2], a2);
  // the step as it goes when it runs
  const bool att1 = v1 & W_ATTEMPT;
  const bool good1 = att1 && crcok1;
  const bool run2 = (p & PF_GATE1) && !good1;
  const bool att2 = run2 && (v2 & W_ATTEMPT);
  const bool good2 = att2 && crcok2;
  const bool good = valid && (good1 || good2);
  const bool good_long = (good1 ? v1 : v2) & W_LONG;
  const bool add1 = att1 && (v1 & W_ADDABLE);
  const bool writes = valid && (add1 || (att2 && (v2 & W_ADDABLE)));
  const int wh = add1 ? h1 : h2;

  const unsigned newbuf = __ballot_sync(kAll, p & PF_NEWBUF);
  const unsigned valids = __ballot_sync(kAll, valid);
  const unsigned goods = __ballot_sync(kAll, good);
  const unsigned above = lane == 31 ? 0u : ~0u << (lane + 1);
  const unsigned below = (1u << lane) - 1u;
  const unsigned past = lane == 31 ? 0u : (good_long ? long_end : short_end) << (lane + 1);
  const unsigned under = valids & above & (past | from_first(newbuf & above));
  const unsigned succ_set = goods & under;
  const int succ = succ_set ? lowest(succ_set) : 32;
  // after round r, reach and runs cover the lane and its next 2^r - 1
  // successors, and next is the 2^r-th; 5 rounds cover a warp
  unsigned reach = 1u << lane;
  unsigned runs = reach | (under & (succ == 32 ? kAll : (1u << succ) - 1u));
  int next = succ == 32 ? lane : succ;
#pragma unroll
  for (int r = 0; r < 5; ++r) {
    reach |= __shfl_sync(kAll, reach, next);
    runs |= __shfl_sync(kAll, runs, next);
    next = __shfl_sync(kAll, next, next);
  }
  // which lanes write each slot
  __syncwarp();
  if (writes) atomicOr(&writers[wh], 1u << lane);
  __syncwarp();
  const unsigned at1 = writers[h1];
  const unsigned at2 = writers[h2];
  const unsigned atw = writers[wh];
  __syncwarp();
  if (writes) writers[wh] = 0;

  Lane l;
  l.flags = valid | (p & PF_NEWBUF ? L_NEWBUF : 0) | (good ? L_GOOD : 0) |
            (writes ? L_WRITES : 0) | (add1 ? L_ADD1 : 0) | policy | pos << L_POS_SHIFT;
  l.word = 1 | (att1 << 1) | (crcok1 << 2) | (good1 << 3) | (run2 << 4) | (att2 << 5) |
           (crcok2 << 6) | (good2 << 7);
  l.end = pos + SKIP_SHORT + (good_long ? SKIP_EXTRA_LONG : 0);
  l.reach = reach;
  l.runs = runs;
  l.w1 = at1 & below;
  l.w2 = at2 & below;
  l.later = writes ? atw & above : 0u;
  l.hh = hh;
  l.wa = add1 ? a1 : a2;
  l.a1 = a1;
  l.a2 = a2;
  return l;
}

__device__ __forceinline__ void store_lane(const Lane& l, int4* rec) {
  const int lane = threadIdx.x & 31;
  rec[lane] = make_int4(l.flags, l.word, l.end, static_cast<int>(l.reach));
  rec[32 + lane] = make_int4(static_cast<int>(l.runs), static_cast<int>(l.w1),
                             static_cast<int>(l.w2), static_cast<int>(l.later));
  rec[64 + lane] = make_int4(l.hh, l.wa, l.a1, l.a2);
}

__device__ __forceinline__ Lane load_lane(const int4* rec) {
  const int lane = threadIdx.x & 31;
  const int4 a = rec[lane];
  const int4 b = rec[32 + lane];
  const int4 c = rec[64 + lane];
  return Lane{a.x, a.y, a.z, static_cast<unsigned>(a.w), static_cast<unsigned>(b.x),
              static_cast<unsigned>(b.y), static_cast<unsigned>(b.z),
              static_cast<unsigned>(b.w), c.x, c.y, c.z, c.w};
}

// What a settled batch comes to under the skip carried in: every lane's
// run, the chain, the running writers and the cut.
struct Plan {
  unsigned runs, chain, newbuf, rw;
  int cut;
  bool holds;  // the settled lookups still give the same crcok bits
};

// Plan a settled batch (warp 0; no stores, so a plan on a settled batch
// that no longer holds is dropped).  From the skip carried in, the first
// chain lane and with it every lane's run; then the cut, the first lane
// whose lookups, against the cache as the running lanes before it leave it
// (each slot holding the address of its last writer), give other crcok
// bits than at the batch's start.
__device__ __forceinline__ Plan plan(const Lane& l, int nb, int skip, const WalkSmem& sm) {
  const int lane = threadIdx.x & 31;
  const int pos = l.flags >> L_POS_SHIFT;
  const bool valid = l.flags & L_VALID;
  // the cache as it stands now, against which the batch was settled
  const int r1 = sm.live[l.hh & 0x3FF];
  const int r2 = sm.live[(l.hh >> 10) & 0x3FF];
  Plan pl;
  pl.newbuf = __ballot_sync(kAll, l.flags & L_NEWBUF);
  const unsigned valids = __ballot_sync(kAll, valid);
  const unsigned goods = __ballot_sync(kAll, l.flags & L_GOOD);
  const unsigned writers = __ballot_sync(kAll, l.flags & L_WRITES);
  // the lanes that run under the skip carried in, up to the first chain lane
  const unsigned pre = __ballot_sync(kAll, valid && pos >= skip) | (valids & from_first(pl.newbuf));
  const unsigned first = goods & pre;
  const int f = first ? lowest(first) : 32;
  const unsigned chain_f = __shfl_sync(kAll, l.reach, f & 31);
  const unsigned runs_f = __shfl_sync(kAll, l.runs, f & 31);
  pl.chain = f == 32 ? 0u : chain_f;
  pl.runs = f == 32 ? pre : (pre & ((1u << f) - 1u)) | runs_f;

  pl.rw = pl.runs & writers;
  const unsigned m1 = l.w1 & pl.rw;
  const unsigned m2 = l.w2 & pl.rw;
  const int t1 = __shfl_sync(kAll, l.wa, m1 ? 31 - __clz(m1) : 0);
  const int t2 = __shfl_sync(kAll, l.wa, m2 ? 31 - __clz(m2) : 0);
  const bool moved1 = m1 && crcok_of(l.flags, L_SEEN1, L_NOSEEN1, t1, l.a1) != bool(l.word & R_CRCOK1);
  const bool moved2 = m2 && crcok_of(l.flags, L_SEEN2, L_NOSEEN2, t2, l.a2) != bool(l.word & R_CRCOK2);
  const unsigned cf = __ballot_sync(kAll, lane < nb && (moved1 || moved2));
  pl.cut = cf ? lowest(cf) : nb;
  const bool same1 = crcok_of(l.flags, L_SEEN1, L_NOSEEN1, r1, l.a1) == bool(l.word & R_CRCOK1);
  const bool same2 = crcok_of(l.flags, L_SEEN2, L_NOSEEN2, r2, l.a2) == bool(l.word & R_CRCOK2);
  pl.holds = !__any_sync(kAll, lane < nb && !(same1 && same2));
  return pl;
}

// Commit the lanes of a planned batch before its cut (warp 0): their words,
// and the address of each slot's last committed writer.  `skip` moves on
// to the skip after the last committed lane.
__device__ __forceinline__ void commit(const Lane& l, const Plan& pl, int slot, int i,
                                       int& skip, WalkSmem& sm) {
  const int lane = threadIdx.x & 31;
  const unsigned committed = pl.cut == 32 ? kAll : (1u << pl.cut) - 1u;
  const bool run = pl.runs >> lane & 1u;
  if (lane < pl.cut) {
    sm.words[slot][i + lane] = run ? l.word : l.word & (R_CRCOK1 | R_CRCOK2);
    if (pl.rw >> lane & 1u) {
      const int wh = lane_wh(l);
      sm.written[wh] = 1;
      if (!(l.later & pl.rw & committed)) sm.live[wh] = l.wa;
    }
  }
  // the skip after the last committed lane q: its own end if it is on the
  // chain, else that of the last chain lane before it, or the skip carried
  // in; 0 if a PF_NEWBUF came since
  const int q = pl.cut - 1;
  const unsigned on = pl.chain & committed;
  const int c = on ? 31 - __clz(on) : -1;
  const unsigned since = c < 0 ? committed : committed & ~((2u << c) - 1u);
  const int c_end = __shfl_sync(kAll, l.end, c & 31);
  skip = (c == q) ? c_end : (pl.newbuf & since) ? 0 : (c < 0 ? skip : c_end);
  if (pl.rw & committed) __syncwarp();  // later lookups see the writes
}

// The buffers a chunk holds: the first one's start (chunk-relative, <= 0),
// their number, the chunk's length and the buffer width.
struct Span {
  int first_start, count, len, mc;
};

// Where the walk of a chunk stands: the chunk's buffer j, the batch's first
// slot i and the end hi of the buffer's walked slots (chunk-relative).
struct Cursor {
  int j, i, hi;
};

// Move `at` to the next slot to walk, past exhausted buffers of the chunk
// (whose counts are in ring slot `slot`).  False when the chunk is done.
__device__ __forceinline__ bool seek(const WalkSmem& sm, int slot, const Span& sp, Cursor& at) {
  while (at.i >= at.hi) {
    if (++at.j >= sp.count) return false;
    const int start = sp.first_start + at.j * sp.mc;
    at.i = max(start, 0);
    at.hi = min(start + sm.cnt[slot][at.j], sp.len);
  }
  return true;
}

// Walk chunk c (ring slot `slot`) by warps 0 and 1.  Warp 1 settles the
// batch after the current one, on the guess that the current one commits
// all its lanes, while warp 0 plans and commits the current one; they meet
// at a named barrier once a batch.  When the guess fails (a cut), or the
// current batch's writes turn a settled lookup, warp 0 settles the batch
// again itself.
__device__ void walk_chunk(const Stream& st, int c, int slot, int& skip, int& batches,
                           int& cuts, WalkSmem& sm) {
  const int warp = threadIdx.x >> 5;
  const long long c0 = static_cast<long long>(c) * kChunk;
  const int len = chunk_len(st, c);
  const long long b_first = c0 / st.mc;
  const Span sp{static_cast<int>(b_first * st.mc - c0),
                static_cast<int>((c0 + len - 1) / st.mc - b_first) + 1, len, st.mc};
  mbar_wait(&sm.full[slot], (c >> 1) & 1);
  Cursor at{-1, 0, 0};
  if (!seek(sm, slot, sp, at)) return;
  unsigned* writers = sm.writers[warp];
  if (warp == 1) store_lane(settle(st, slot, at.i, min(32, at.hi - at.i), sm, writers), sm.rec[0]);
  named_sync();
  bool settled = true;  // warp 1's guess for the current batch holds
  for (int t = 0;; ++t) {
    const int nb = min(32, at.hi - at.i);
    Cursor guess{at.j, at.i + nb, at.hi};
    const bool more = seek(sm, slot, sp, guess);
    if (warp == 1) {
      if (more) {
        store_lane(settle(st, slot, guess.i, min(32, guess.hi - guess.i), sm, writers),
                   sm.rec[(t + 1) & 1]);
      }
    } else {
      // plan on warp 1's settling while checking that it holds
      Lane l = load_lane(sm.rec[t & 1]);
      Plan pl = plan(l, nb, skip, sm);
      if (!settled || !pl.holds) {
        l = settle(st, slot, at.i, nb, sm, writers);
        pl = plan(l, nb, skip, sm);
      }
      commit(l, pl, slot, at.i, skip, sm);
      const int done = pl.cut;
      ++batches;
      cuts += done < nb;
      if ((threadIdx.x & 31) == 0) sm.cut[t & 1] = done;
    }
    named_sync();
    const int done = sm.cut[t & 1];
    settled = done == nb;
    at.i += done;
    if (!seek(sm, slot, sp, at)) return;
  }
}

// One stream's walk by the whole block.
__device__ void walk_stream(const Stream& st, const int* __restrict__ ca_in,
                            const int* __restrict__ ct_in, int* __restrict__ words,
                            int* __restrict__ ca_out, int* __restrict__ ct_out, int now,
                            int* __restrict__ counts, WalkSmem& sm) {
  const int tid = threadIdx.x;
  const int nchunks = static_cast<int>((st.n + kChunk - 1) / kChunk);
  if (tid == kWalkers) {  // the first chunk's copies fly while the cache is built
    mbar_init(&sm.full[0], 1);
    mbar_init(&sm.full[1], 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    if (nchunks > 0) issue_chunk(st, 0, 0, sm);
  }
  for (int h = tid; h < kCacheLen; h += kThreads) {
    const int a = ca_in[h];
    // int32 wraparound, as the reference's time_t difference on 32 bits
    const int age = static_cast<int>(static_cast<unsigned>(now) - static_cast<unsigned>(ct_in[h]));
    sm.live[h] = (a != 0 && age <= kCacheTtl) ? a : 0;
    sm.written[h] = 0;
    sm.writers[0][h] = 0;
    sm.writers[1][h] = 0;
  }
  __syncthreads();  // the barriers are initialised
  if (nchunks > 0 && tid >= kWalkers) {
    prepare_chunk(st, 0, 0, sm, tid - kWalkers, kStagers);
    skip_windows(st, 0, 0, sm, tid - kWalkers, kStagers);
  }
  __syncthreads();

  int skip = 0;  // warp 0's, lane-uniform
  int batches = 0, cuts = 0;
  for (int c = 0; c < nchunks; ++c) {
    const int slot = c & 1;
    if (tid < kWalkers) {
      walk_chunk(st, c, slot, skip, batches, cuts, sm);
    } else {
      const int t = tid - kWalkers;
      const int other = slot ^ 1;
      if (c > 0) {  // chunk c-1's words out, then its ring slot is chunk c+1's
        const long long p0 = static_cast<long long>(c - 1) * kChunk;
        for (int i = t; i < kChunk; i += kStagers) words[p0 + i] = sm.words[other][i];
      }
      if (c + 1 < nchunks) {
        if (t == 0) issue_chunk(st, c + 1, other, sm);
        prepare_chunk(st, c + 1, other, sm, t, kStagers);
        skip_windows(st, c + 1, other, sm, t, kStagers);
      }
    }
    __syncthreads();
  }

  if (nchunks > 0) {
    const int last = (nchunks - 1) & 1;
    const long long p0 = static_cast<long long>(nchunks - 1) * kChunk;
    const int len = chunk_len(st, nchunks - 1);
    for (int i = tid; i < len; i += kThreads) words[p0 + i] = sm.words[last][i];
  }
  for (int h = tid; h < kCacheLen; h += kThreads) {
    const bool w = sm.written[h];
    ca_out[h] = w ? sm.live[h] : ca_in[h];
    ct_out[h] = w ? now : ct_in[h];
  }
  if (counts != nullptr && tid == 0) {
    counts[2 * blockIdx.x] = batches;
    counts[2 * blockIdx.x + 1] = cuts;
  }
}

__device__ __forceinline__ Stream make_stream(const int* pf, const int* w1, const int* w2,
                                              const int* h12, const int* nbuf,
                                              int n_buffers, int mc) {
  Stream st;
  st.src[0] = pf;
  st.src[1] = w1;
  st.src[2] = w2;
  st.src[3] = h12;
  for (int a = 0; a < 4; ++a) {
    st.shift[a] = static_cast<int>((reinterpret_cast<uintptr_t>(st.src[a]) >> 2) & 3);
  }
  st.nbuf = nbuf;
  st.n = static_cast<long long>(n_buffers) * mc;
  st.mc = mc;
  return st;
}

// K2: one stream, one block.
__global__ void __launch_bounds__(kThreads)
resolve_words_kernel(const int* __restrict__ pf, const int* __restrict__ w1,
                     const int* __restrict__ w2, const int* __restrict__ h12,
                     const int* __restrict__ nbuf, const int* __restrict__ ca_in,
                     const int* __restrict__ ct_in, int* __restrict__ words,
                     int* __restrict__ ca_out, int* __restrict__ ct_out,
                     int* __restrict__ counts, int n_buffers, int mc,
                     const int* __restrict__ now) {
  extern __shared__ __align__(16) unsigned char smem[];
  WalkSmem& sm = *reinterpret_cast<WalkSmem*>(smem);
  walk_stream(make_stream(pf, w1, w2, h12, nbuf, n_buffers, mc), ca_in, ct_in, words, ca_out,
              ct_out, *now, counts, sm);
}

// K3: stream blockIdx.x of S, each with bufs_per_stream buffers.
__global__ void __launch_bounds__(kThreads)
resolve_words_streams_kernel(const int* __restrict__ pf, const int* __restrict__ w1,
                             const int* __restrict__ w2, const int* __restrict__ h12,
                             const int* __restrict__ nbuf, const int* __restrict__ ca_in,
                             const int* __restrict__ ct_in, int* __restrict__ words,
                             int* __restrict__ ca_out, int* __restrict__ ct_out,
                             int* __restrict__ counts, int bufs_per_stream, int mc, int now) {
  extern __shared__ __align__(16) unsigned char smem[];
  WalkSmem& sm = *reinterpret_cast<WalkSmem*>(smem);
  const long long s = blockIdx.x;
  const long long slots = s * bufs_per_stream * mc;
  const long long row = s * kCacheLen;
  walk_stream(make_stream(pf + slots, w1 + slots, w2 + slots, h12 + slots,
                          nbuf + s * bufs_per_stream, bufs_per_stream, mc),
              ca_in + row, ct_in + row, words + slots, ca_out + row, ct_out + row, now, counts,
              sm);
}

template <typename Kernel>
cudaError_t allow_smem(Kernel kernel) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(sizeof(WalkSmem)));
}

}  // namespace

extern "C" int resolve_words(const void* pf, const void* w1, const void* w2,
                             const void* h12, const void* nbuf,
                             const void* ca_in, const void* ct_in, void* words,
                             void* ca_out, void* ct_out, void* counts, int n_buffers,
                             int mc, const void* now, void* stream) {
  const cudaError_t attr = allow_smem(resolve_words_kernel);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  resolve_words_kernel<<<1, kThreads, sizeof(WalkSmem), static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(pf), static_cast<const int*>(w1),
      static_cast<const int*>(w2), static_cast<const int*>(h12),
      static_cast<const int*>(nbuf), static_cast<const int*>(ca_in),
      static_cast<const int*>(ct_in), static_cast<int*>(words),
      static_cast<int*>(ca_out), static_cast<int*>(ct_out), static_cast<int*>(counts),
      n_buffers, mc, static_cast<const int*>(now));
  return static_cast<int>(cudaGetLastError());
}

extern "C" int resolve_words_streams(const void* pf, const void* w1, const void* w2,
                                     const void* h12, const void* nbuf,
                                     const void* ca_in, const void* ct_in,
                                     void* words, void* ca_out, void* ct_out, void* counts,
                                     int n_streams, int bufs_per_stream, int mc,
                                     int now, void* stream) {
  const cudaError_t attr = allow_smem(resolve_words_streams_kernel);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  resolve_words_streams_kernel<<<n_streams, kThreads, sizeof(WalkSmem),
                                 static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(pf), static_cast<const int*>(w1),
      static_cast<const int*>(w2), static_cast<const int*>(h12),
      static_cast<const int*>(nbuf), static_cast<const int*>(ca_in),
      static_cast<const int*>(ct_in), static_cast<int*>(words),
      static_cast<int*>(ca_out), static_cast<int*>(ct_out), static_cast<int*>(counts),
      bufs_per_stream, mc, now);
  return static_cast<int>(cudaGetLastError());
}
