// Native host runtime: sequential candidate resolver + Mode S frame decoder.
//
// Behavioral contract: the scan-order control flow of detectModeS
// (dump1090.c:1563-1793) and the full field decode of decodeModesMessage
// and helpers (dump1090.c:896-1310), exactly as replayed by the verified
// Python implementations in models/resolver.py and models/decoder.py.
//
// Role in the architecture: the TPU kernels (ops/demod.py) evaluate every
// preamble candidate in parallel and hand the host a compacted candidate
// stream; this library replays, at native speed, the O(candidates)
// sequential rules a data-parallel kernel cannot absorb — the good-CRC skip
// rule, the phase-correction retry, and the stateful ICAO-cache acceptance —
// plus the per-message field extraction.  It is the framework's equivalent
// of the reference's C hot path on the host side of the host/device split.
//
// Exposed as a plain C ABI loaded with ctypes (no pybind11 in this image).
// The ICAO cache lives in caller-owned arrays so the Python network-input
// decode path and this library share one cache with zero synchronization.

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>

namespace {

constexpr int kLongBits = 112;
constexpr int kShortBits = 56;
constexpr uint32_t kCrcPoly = 0xFFF409;  // g(x) low 24 coefficient bits
constexpr int kNErrorInfo = 5778;        // 107 single + 5671 double syndromes
constexpr int kErrorBitsFirst = 5;       // DF field excluded from correction
constexpr int kIcaoCacheLen = 1024;
constexpr int64_t kIcaoCacheTtl = 60;
constexpr int kDf11IidMaxSyndrome = 80;
constexpr int kMaxBitErrors = 2;
constexpr int kPreambleUs = 8;

const char kAisCharset[] =
    "?ABCDEFGHIJKLMNOPQRSTUVWXYZ????? ???????????????0123456789??????";

// ---------------------------------------------------------------------------
// Output record — one decoded frame, the POD twin of models/decoder.py's
// ModesMessage (struct modesMessage, dump1090.c:210-260).  Field order and
// packing are mirrored by RECORD_DTYPE in native/__init__.py.
// ---------------------------------------------------------------------------
#pragma pack(push, 1)
struct Record {
  uint8_t msg[14];
  uint8_t msgbits;
  uint8_t msgtype;
  uint8_t crcok;
  uint8_t phase_corrected;
  int32_t crc;
  int32_t errorbit;
  uint8_t aa1, aa2, aa3, ca;
  int32_t iid;
  uint8_t metype, mesub, heading_is_valid, aircraft_type;
  int32_t heading;
  int32_t fflag, tflag;
  int32_t raw_latitude, raw_longitude;
  char flight[9];
  uint8_t ew_dir, ns_dir, vert_rate_source, vert_rate_sign;
  int32_t ew_velocity, ns_velocity, vert_rate, velocity;
  int32_t movement, movement_valid, ground_track, ground_track_valid;
  uint8_t fs, dr, um, unit;
  int32_t identity, altitude;
  int32_t pos;
};
#pragma pack(pop)

// Stats delta slots (order matches DecoderStats / native/__init__.py).
enum StatsIdx {
  kValidPreamble = 0,
  kOutOfPhase,
  kDemodulated,
  kGoodCrc,
  kBadCrc,
  kFixed,
  kSingleBitFix,
  kTwoBitsFix,
  kNumStats,
};

struct ErrorInfo {
  uint32_t syndrome;
  int8_t bits;
  int8_t pos0;
  int8_t pos1;
};

struct State {
  uint32_t checksum_table[kLongBits];  // x^(111-k) mod g(x); last 24 zero
  ErrorInfo error_table[kNErrorInfo];  // stable-sorted by syndrome
};

// CRC-24 generator expansion (ops/crc.py checksum_table; the hardcoded
// table at dump1090.c:683-698 derived from the polynomial instead).
void build_checksum_table(uint32_t* table) {
  std::memset(table, 0, sizeof(uint32_t) * kLongBits);
  uint32_t rem = kCrcPoly;  // x^24 mod g(x): contribution of last data bit
  for (int k = kLongBits - 24 - 1; k >= 0; --k) {
    table[k] = rem;
    rem <<= 1;
    if (rem & (1u << 24)) rem ^= (1u << 24) | kCrcPoly;
  }
}

// Syndrome of an all-zero long frame with the given bits flipped.
uint32_t flip_syndrome(const uint32_t* table, int p0, int p1) {
  uint32_t s = 0;
  for (int p : {p0, p1}) {
    if (p < 0) continue;
    if (p < kLongBits - 24)
      s ^= table[p];
    else
      s ^= 1u << (kLongBits - 1 - p);
  }
  return s & 0xFFFFFF;
}

// 1-bit and 2-bit error syndrome table over bits 5..111, insertion order and
// stable sort matching modesInitErrorInfo (dump1090.c:795-841) and
// ops/crc.py bit_error_table.
void build_error_table(const uint32_t* cks, ErrorInfo* tbl) {
  int n = 0;
  for (int i = kErrorBitsFirst; i < kLongBits; ++i) {
    tbl[n++] = {flip_syndrome(cks, i, -1), 1, (int8_t)i, -1};
    for (int j = i + 1; j < kLongBits && n < kNErrorInfo; ++j)
      tbl[n++] = {flip_syndrome(cks, i, j), 2, (int8_t)i, (int8_t)j};
  }
  std::stable_sort(tbl, tbl + kNErrorInfo,
                   [](const ErrorInfo& a, const ErrorInfo& b) {
                     return a.syndrome < b.syndrome;
                   });
}

// glibc-bsearch probe sequence (mid = (lo+hi)>>1) so that among duplicate
// syndromes we land on the same entry the reference lands on
// (dump1090.c:862-865; ops/crc.py _glibc_bsearch).
int bsearch_syndrome(const ErrorInfo* tbl, uint32_t key) {
  int lo = 0, hi = kNErrorInfo;
  while (lo < hi) {
    int mid = (lo + hi) >> 1;
    uint32_t v = tbl[mid].syndrome;
    if (key < v)
      hi = mid;
    else if (key > v)
      lo = mid + 1;
    else
      return mid;
  }
  return -1;
}

inline int message_bits_for_df(int df) {
  return (df == 16 || df == 17 || df == 18 || df == 19 || df == 20 ||
          df == 21)
             ? kLongBits
             : kShortBits;
}

// CRC of the data portion only (dump1090.c:703-719).
uint32_t compute_crc(const State* st, const uint8_t* msg, int bits) {
  int offset = (bits == kLongBits) ? 0 : kLongBits - kShortBits;
  uint32_t crc = 0;
  for (int j = 0; j < bits - 24; ++j) {
    if (msg[j >> 3] & (1u << (7 - (j & 7)))) crc ^= st->checksum_table[j + offset];
  }
  return crc & 0xFFFFFF;
}

// 24-bit syndrome: computed CRC XOR transmitted CRC (dump1090.c:733-742).
uint32_t checksum(const State* st, const uint8_t* msg, int bits) {
  uint32_t crc = compute_crc(st, msg, bits);
  int nb = bits / 8;
  uint32_t rem = ((uint32_t)msg[nb - 3] << 16) | ((uint32_t)msg[nb - 2] << 8) |
                 msg[nb - 1];
  return (crc ^ rem) & 0xFFFFFF;
}

// Correct up to maxfix bit errors in place; returns count and writes the
// message-relative fixed positions (fixBitErrors, dump1090.c:854-894).
int fix_bit_errors(const State* st, uint8_t* msg, int bits, int maxfix,
                   int* rel_out) {
  uint32_t syn = checksum(st, msg, bits);
  int idx = bsearch_syndrome(st->error_table, syn);
  if (idx < 0) return 0;
  const ErrorInfo& ei = st->error_table[idx];
  if (ei.bits > maxfix) return 0;
  int offset = kLongBits - bits;
  int rel[2] = {ei.pos0 - offset, ei.bits == 2 ? ei.pos1 - offset : 0};
  for (int k = 0; k < ei.bits; ++k)
    if (rel[k] < 0 || rel[k] >= bits) return 0;
  for (int k = 0; k < ei.bits; ++k)
    msg[rel[k] >> 3] ^= 1u << (7 - (rel[k] & 7));
  for (int k = 0; k < ei.bits; ++k) rel_out[k] = rel[k];
  return ei.bits;
}

// ---------------------------------------------------------------------------
// ICAO address cache over caller-owned arrays (dump1090.c:896-925).
// ---------------------------------------------------------------------------
inline uint32_t icao_hash(uint32_t a) {
  a = ((a >> 16) ^ a) * 0x45D9F3Bu;
  a = ((a >> 16) ^ a) * 0x45D9F3Bu;
  a = (a >> 16) ^ a;
  return a & (kIcaoCacheLen - 1);
}

inline void icao_add(uint32_t* addrs, int64_t* ts, uint32_t addr, int64_t now) {
  uint32_t h = icao_hash(addr);
  addrs[h] = addr;
  ts[h] = now;
}

inline bool icao_seen(const uint32_t* addrs, const int64_t* ts, uint32_t addr,
                      int64_t now) {
  uint32_t h = icao_hash(addr);
  return addrs[h] != 0 && addrs[h] == addr && now - ts[h] <= kIcaoCacheTtl;
}

// Recover the ICAO address of Address/Parity frames; accept iff recently
// seen (bruteForceAP, dump1090.c:942-983).
bool brute_force_ap(const State* st, const uint8_t* msg, Record* r,
                    uint32_t* addrs, int64_t* ts, int64_t now) {
  int t = r->msgtype;
  if (!(t == 0 || t == 4 || t == 5 || t == 16 || t == 20 || t == 21 ||
        t == 24))
    return false;
  int lastbyte = r->msgbits / 8 - 1;
  uint32_t crc = compute_crc(st, msg, r->msgbits);
  uint8_t b0 = msg[lastbyte] ^ (crc & 0xFF);
  uint8_t b1 = msg[lastbyte - 1] ^ ((crc >> 8) & 0xFF);
  uint8_t b2 = msg[lastbyte - 2] ^ ((crc >> 16) & 0xFF);
  uint32_t addr = (uint32_t)b0 | ((uint32_t)b1 << 8) | ((uint32_t)b2 << 16);
  if (icao_seen(addrs, ts, addr, now)) {
    r->aa1 = b2;
    r->aa2 = b1;
    r->aa3 = b0;
    return true;
  }
  return false;
}

// 13-bit altitude field of DF 0/4/16/20 (dump1090.c:985-1012).
void decode_ac13(const uint8_t* msg, int32_t* alt, uint8_t* unit) {
  *alt = 0;
  *unit = 0;  // feet
  if (!(msg[3] & 0x40)) {    // M bit clear
    if (msg[3] & 0x10) {     // Q bit set
      int n = ((msg[2] & 31) << 6) | ((msg[3] & 0x80) >> 2) |
              ((msg[3] & 0x20) >> 1) | (msg[3] & 15);
      *alt = n * 25 - 1000;
    }
  } else {
    *unit = 1;  // meters (not implemented by the reference either)
  }
}

// 12-bit altitude field of DF17 airborne position (dump1090.c:1014-1030).
void decode_ac12(const uint8_t* msg, int32_t* alt, uint8_t* unit) {
  *alt = 0;
  *unit = 0;
  if (msg[5] & 1) {  // Q bit
    int n = ((msg[5] >> 1) << 4) | ((msg[6] & 0xF0) >> 4);
    *alt = n * 25 - 1000;
  }
}

// DF17/18 ME-field decode (dump1090.c:1225-1308).
void decode_extended_squitter(Record* r, const uint8_t* b) {
  if (r->metype >= 1 && r->metype <= 4) {
    r->aircraft_type = r->metype - 1;
    int six[8] = {
        b[5] >> 2,
        ((b[5] & 3) << 4) | (b[6] >> 4),
        ((b[6] & 15) << 2) | (b[7] >> 6),
        b[7] & 63,
        b[8] >> 2,
        ((b[8] & 3) << 4) | (b[9] >> 4),
        ((b[9] & 15) << 2) | (b[10] >> 6),
        b[10] & 63,
    };
    for (int i = 0; i < 8; ++i) r->flight[i] = kAisCharset[six[i]];
    r->flight[8] = 0;
  } else if (r->metype >= 5 && r->metype <= 8) {
    r->movement = ((b[4] & 0x07) << 4) | (b[5] >> 4);
    r->movement_valid = r->movement != 0;
    r->ground_track_valid = (b[5] >> 3) & 1;
    r->ground_track = (((b[5] & 0x07) << 4) | (b[6] >> 4)) * 360 / 128;
    r->fflag = (b[6] >> 2) & 1;
    r->tflag = (b[6] >> 3) & 1;
    r->raw_latitude = ((b[6] & 3) << 15) | (b[7] << 7) | (b[8] >> 1);
    r->raw_longitude = ((b[8] & 1) << 16) | (b[9] << 8) | b[10];
  } else if (r->metype >= 9 && r->metype <= 18) {
    r->fflag = b[6] & (1 << 2);
    r->tflag = b[6] & (1 << 3);
    decode_ac12(b, &r->altitude, &r->unit);
    r->raw_latitude = ((b[6] & 3) << 15) | (b[7] << 7) | (b[8] >> 1);
    r->raw_longitude = ((b[8] & 1) << 16) | (b[9] << 8) | b[10];
  } else if (r->metype == 19 && r->mesub >= 1 && r->mesub <= 4) {
    if (r->mesub == 1 || r->mesub == 2) {
      r->ew_dir = (b[5] & 4) >> 2;
      r->ew_velocity = ((b[5] & 3) << 8) | b[6];
      r->ns_dir = (b[7] & 0x80) >> 7;
      r->ns_velocity = ((b[7] & 0x7F) << 3) | ((b[8] & 0xE0) >> 5);
      r->vert_rate_source = (b[8] & 0x10) >> 4;
      r->vert_rate_sign = (b[8] & 0x8) >> 3;
      r->vert_rate = ((b[8] & 7) << 6) | ((b[9] & 0xFC) >> 2);
      // the reference stores double sqrt/atan2 results into int fields
      // (truncation toward zero), dump1090.c:1285-1299
      r->velocity = (int32_t)std::sqrt((double)r->ns_velocity * r->ns_velocity +
                                       (double)r->ew_velocity * r->ew_velocity);
      if (r->velocity) {
        int ewv = r->ew_dir ? -r->ew_velocity : r->ew_velocity;
        int nsv = r->ns_dir ? -r->ns_velocity : r->ns_velocity;
        double heading = std::atan2((double)ewv, (double)nsv) * 360.0 /
                         (2.0 * M_PI);
        // truncate into the int FIRST, then normalize — the reference adds
        // 360 to the already-truncated int (dump1090.c:1296-1299)
        r->heading = (int32_t)heading;
        if (r->heading < 0) r->heading += 360;
      } else {
        r->heading = 0;
      }
    } else {  // mesub 3/4: magnetic heading
      r->heading_is_valid = b[5] & (1 << 2);
      r->heading =
          (int32_t)((360.0 / 128) * (((b[5] & 3) << 5) | (b[6] >> 3)));
    }
  }
}

// Full field decode of one 56/112-bit frame (decodeModesMessage,
// dump1090.c:1091-1310; models/decoder.py decode_message).
void decode_message(const State* st, const uint8_t* raw, Record* r,
                    uint32_t* icao_addrs, int64_t* icao_ts, int64_t now,
                    int fix_errors, int aggressive, int64_t* stats) {
  std::memset(r, 0, sizeof(Record));
  uint8_t msg[14];
  std::memcpy(msg, raw, 14);

  r->msgtype = msg[0] >> 3;
  r->msgbits = message_bits_for_df(r->msgtype);
  r->crc = (int32_t)checksum(st, msg, r->msgbits);
  r->errorbit = -1;
  r->crcok = r->crc == 0;

  if (!r->crcok && fix_errors &&
      (r->msgtype == 11 || r->msgtype == 17 || r->msgtype == 18)) {
    int maxfix = aggressive ? kMaxBitErrors : 1;
    int rel[2];
    int nfixed = fix_bit_errors(st, msg, r->msgbits, maxfix, rel);
    if (nfixed) {
      r->crc = (int32_t)checksum(st, msg, r->msgbits);
      r->crcok = r->crc == 0;
      r->errorbit = rel[0];
      if (stats) {
        if (nfixed == 1)
          stats[kSingleBitFix] += 1;
        else
          stats[kTwoBitsFix] += 1;
      }
    }
  }

  r->ca = msg[0] & 7;
  r->aa1 = msg[1];
  r->aa2 = msg[2];
  r->aa3 = msg[3];
  r->metype = msg[4] >> 3;
  r->mesub = msg[4] & 7;
  r->fs = msg[0] & 7;
  r->dr = (msg[1] >> 3) & 31;
  r->um = ((msg[1] & 7) << 3) | (msg[2] >> 5);

  // Gillham-interleaved 13-bit identity (squawk), dump1090.c:1163-1179
  {
    int a = ((msg[3] & 0x80) >> 5) | (msg[2] & 0x02) | ((msg[2] & 0x08) >> 3);
    int b = ((msg[3] & 0x02) << 1) | ((msg[3] & 0x08) >> 2) |
            ((msg[3] & 0x20) >> 5);
    int c = ((msg[2] & 0x01) << 2) | ((msg[2] & 0x04) >> 1) |
            ((msg[2] & 0x10) >> 4);
    int d = ((msg[3] & 0x01) << 2) | ((msg[3] & 0x04) >> 1) |
            ((msg[3] & 0x10) >> 4);
    r->identity = a * 1000 + b * 100 + c * 10 + d;
  }

  if (r->msgtype != 11 && r->msgtype != 17 && r->msgtype != 18) {
    r->crcok = brute_force_ap(st, msg, r, icao_addrs, icao_ts, now);
  } else {
    uint32_t addr =
        ((uint32_t)r->aa1 << 16) | ((uint32_t)r->aa2 << 8) | r->aa3;
    if (r->crcok && r->errorbit == -1) icao_add(icao_addrs, icao_ts, addr, now);
    // DF11 with a small residual syndrome: treat it as the Interrogator
    // Identifier if we know the aircraft (dump1090.c:1204-1209)
    if (r->msgtype == 11 && !r->crcok && r->crc < kDf11IidMaxSyndrome &&
        icao_seen(icao_addrs, icao_ts, addr, now)) {
      r->iid = r->crc;
      r->crcok = 1;
    }
  }

  if (r->msgtype == 0 || r->msgtype == 4 || r->msgtype == 16 ||
      r->msgtype == 20)
    decode_ac13(msg, &r->altitude, &r->unit);

  if (r->msgtype == 17 || r->msgtype == 18) decode_extended_squitter(r, msg);

  r->phase_corrected = 0;
  std::memcpy(r->msg, msg, 14);
}

// detectModeS stat block (dump1090.c:1737-1753) with the reference's
// single-bit double count quirk (models/resolver.py _update_detect_stats).
void update_detect_stats(int64_t* stats, const Record* r, int errors) {
  if (errors == 0) stats[kDemodulated] += 1;
  if (r->errorbit == -1) {
    if (r->crcok)
      stats[kGoodCrc] += 1;
    else
      stats[kBadCrc] += 1;
  } else {
    stats[kBadCrc] += 1;
    stats[kFixed] += 1;
    if (r->errorbit < kLongBits)
      stats[kSingleBitFix] += 1;
    else
      stats[kTwoBitsFix] += 1;
  }
}

}  // namespace

extern "C" {

int64_t d1090_record_size(void) { return (int64_t)sizeof(Record); }

void* d1090_create(void) {
  State* st = new State();
  build_checksum_table(st->checksum_table);
  build_error_table(st->checksum_table, st->error_table);
  return st;
}

void d1090_destroy(void* state) { delete static_cast<State*>(state); }

// Introspection hooks for differential tests against ops/crc.py.
uint32_t d1090_checksum(void* state, const uint8_t* msg, int32_t bits) {
  return checksum(static_cast<State*>(state), msg, bits);
}

int32_t d1090_fix_bit_errors(void* state, uint8_t* msg, int32_t bits,
                             int32_t maxfix, int32_t* rel_out) {
  return fix_bit_errors(static_cast<State*>(state), msg, bits, maxfix,
                        rel_out);
}

// Decode one raw frame (the network hex-input path, decodeHexMessage ->
// decodeModesMessage).  Returns 0.
int32_t d1090_decode_one(void* state, const uint8_t* raw14, Record* out,
                         uint32_t* icao_addrs, int64_t* icao_ts, int64_t now,
                         int32_t fix_errors, int32_t aggressive,
                         int64_t* stats) {
  decode_message(static_cast<State*>(state), raw14, out, icao_addrs, icao_ts,
                 now, fix_errors, aggressive, stats);
  return 0;
}

// Replay one block's candidates in scan order (models/resolver.py
// resolve_block; detectModeS tail, dump1090.c:1728-1793).  Writes every
// message the reference would hand to useModesMessage into `out` and
// returns the count.  `out` must hold at least 2*n_cand records (each
// candidate emits at most one message per pass).  Stats deltas are
// accumulated into `stats[8]`.
int64_t d1090_resolve_block(void* state, const int32_t* pos,
                            const uint8_t* msg1, const int32_t* errors1,
                            const uint8_t* gate1, const uint8_t* msg2,
                            const int32_t* errors2, const uint8_t* gate2,
                            int64_t n_cand, uint32_t* icao_addrs,
                            int64_t* icao_ts, int64_t now, int32_t fix_errors,
                            int32_t aggressive, int64_t* stats, Record* out,
                            int64_t out_cap) {
  State* st = static_cast<State*>(state);
  int64_t n_out = 0;
  int32_t next_j = 0;
  for (int64_t k = 0; k < n_cand; ++k) {
    int32_t j = pos[k];
    if (j < next_j) continue;  // inside a previously decoded good message
    stats[kValidPreamble] += 1;

    // ---- pass 1: uncorrected (use_correction == 0) ----------------------
    bool good = false;
    if (!gate1[k]) continue;  // noise-gate failure skips the retry entirely
    int errors = errors1[k];
    if (errors == 0 || (aggressive && errors < 3)) {
      if (n_out >= out_cap) return -1;
      Record* r = &out[n_out];
      decode_message(st, msg1 + k * 14, r, icao_addrs, icao_ts, now,
                     fix_errors, aggressive, stats);
      r->pos = j;
      if (r->crcok) {  // stats gated on (crcok || use_correction)
        update_detect_stats(stats, r, errors);
        next_j = j + (kPreambleUs + (r->msgbits / 8) * 8) * 2 + 1;
        good = true;
      }
      ++n_out;
    }
    if (good) continue;

    // ---- pass 2: phase-corrected retry (use_correction == 1) ------------
    if (j > 0) stats[kOutOfPhase] += 1;  // correction applied only when j > 0
    if (!gate2[k]) continue;
    errors = errors2[k];
    if (errors == 0 || (aggressive && errors < 3)) {
      if (n_out >= out_cap) return -1;
      Record* r = &out[n_out];
      decode_message(st, msg2 + k * 14, r, icao_addrs, icao_ts, now,
                     fix_errors, aggressive, stats);
      r->pos = j;
      update_detect_stats(stats, r, errors);  // unconditional on retry
      if (r->crcok) {
        r->phase_corrected = 1;
        next_j = j + (kPreambleUs + (r->msgbits / 8) * 8) * 2 + 1;
      }
      ++n_out;
    }
  }
  return n_out;
}

// Resolve a whole batch of blocks in one call: candidate arrays are the
// (NB, MC, ...) fixed-shape kernel outputs, n_per_row the exact per-buffer
// preamble counts.  Rows are resolved in order against the shared state.
// Returns total records written (out_counts[r] = records of row r).
//
// PRECONDITION: every n_per_row[r] <= mc and out_cap >= 2*sum(n)+1.  The
// caller must verify this BEFORE calling: rows mutate the shared ICAO cache
// as they resolve, so aborting midway (the negative returns below) leaves
// state a per-row retry cannot reproduce.  The Python binding pre-checks
// and treats a negative return as an internal error.
int64_t d1090_resolve_blocks(void* state, const int32_t* pos,
                             const uint8_t* msg1, const int32_t* errors1,
                             const uint8_t* gate1, const uint8_t* msg2,
                             const int32_t* errors2, const uint8_t* gate2,
                             const int32_t* n_per_row, int64_t nb, int64_t mc,
                             uint32_t* icao_addrs, int64_t* icao_ts,
                             int64_t now, int32_t fix_errors,
                             int32_t aggressive, int64_t* stats, Record* out,
                             int64_t out_cap, int64_t* out_counts) {
  int64_t total = 0;
  for (int64_t r = 0; r < nb; ++r) {
    int64_t n = n_per_row[r];
    if (n > mc) return -(r + 1);
    int64_t w = d1090_resolve_block(
        state, pos + r * mc, msg1 + r * mc * 14, errors1 + r * mc,
        gate1 + r * mc, msg2 + r * mc * 14, errors2 + r * mc, gate2 + r * mc,
        n, icao_addrs, icao_ts, now, fix_errors, aggressive, stats,
        out + total, out_cap - total);
    if (w < 0) return INT64_MIN;  // cannot happen with out_cap >= 2*sum(n)
    out_counts[r] = w;
    total += w;
  }
  return total;
}

}  // extern "C"
