"""Numeric constants of the Mode S / ADS-B air interface and of the
reference behavioral contract.

Every constant here is part of the observable behavior of the reference
implementation (antirez/dump1090, dump1090.c:49-95) and is
therefore part of this framework's compatibility surface.  The framework's
*architecture* is independent of these values: they parameterize batched array
kernels instead of a scalar scan loop.
"""

# ---- air interface / sampling ------------------------------------------------
SAMPLE_RATE = 2_000_000          # samples/s (0.5 us per sample)
DEFAULT_FREQ = 1_090_000_000     # Hz
PREAMBLE_US = 8                  # preamble length in microseconds
LONG_MSG_BITS = 112
SHORT_MSG_BITS = 56
LONG_MSG_BYTES = LONG_MSG_BITS // 8
SHORT_MSG_BYTES = SHORT_MSG_BITS // 8
FULL_LEN_US = PREAMBLE_US + LONG_MSG_BITS       # 120 us: preamble + longest frame

# samples (at 2 MHz, 2 samples/us)
PREAMBLE_SAMPLES = PREAMBLE_US * 2              # 16
MSG_SAMPLES = LONG_MSG_BITS * 2                 # 224
FULL_LEN_SAMPLES = FULL_LEN_US * 2              # 240

# ---- demodulator decision thresholds (dump1090.c:1675-1726) ------------------
BIT_REPEAT_DELTA = 256           # |low-high| below this repeats the previous bit
NOISE_GATE = 10 * 255            # mean per-bit delta gate (scaled by msglen*4)

# ---- reference block geometry (dump1090.c:53-54, 326-331) ---------------------
# The reference reads 256 KiB of uint8 IQ per buffer and carries the last
# (FULL_LEN-1) us of IQ to the front of the next buffer, so frames straddling a
# read are demodulated on the next pass.
DATA_LEN_BYTES = 16 * 16384                       # 262144 bytes = 131072 samples
BLOCK_SAMPLES = DATA_LEN_BYTES // 2               # 131072 new IQ samples/block
CARRY_SAMPLES = (FULL_LEN_US - 1) * 2             # 238 samples carried over
BUF_SAMPLES = BLOCK_SAMPLES + CARRY_SAMPLES       # 131310 magnitude samples
# scan positions per buffer: j in [0, BUF_SAMPLES - FULL_LEN_SAMPLES)
SCAN_POSITIONS = BUF_SAMPLES - FULL_LEN_SAMPLES   # 131070
# the most preamble candidates a buffer can hold: the preamble predicate
# forbids adjacent hits, so at most every other scan position
MAX_BUFFER_CANDIDATES = SCAN_POSITIONS // 2 + 1  # 65536

# ---- magnitude scaling (dump1090.c:346-364) -----------------------------------
MAG_SCALE = 360                  # |iq| in 0..181.02 scaled into uint16 0..65167
MAG_SCALE_SQ = MAG_SCALE * MAG_SCALE   # 129600; sqrt(v)*360 == sqrt(v*129600)

# ---- CRC-24 (dump1090.c:683-753) ----------------------------------------------
# Mode S generator polynomial (degree 24):
#   g(x) = x^24+x^23+x^22+x^21+x^20+x^19+x^18+x^17+x^16+x^15+x^14+x^13+x^12
#        + x^10+x^3+1
# Its low 24 coefficient bits:
CRC_POLY = 0xFFF409
CRC_BITS = 24

# ---- syndrome error-correction table (dump1090.c:70-75, 795-841) ---------------
MAX_BITERRORS = 2
ERRORBITS_FIRST = 5              # DF field (bits 0-4) excluded from correction
N_ERRORINFO = 5778               # 107 single + 5671 double bit error syndromes

# ---- ICAO address cache (dump1090.c:65-66, 896-925) ----------------------------
ICAO_CACHE_LEN = 1024            # power of two
ICAO_CACHE_TTL = 60              # seconds

# ---- DF11 IID acceptance (dump1090.c:1204-1209) --------------------------------
DF11_IID_MAX_SYNDROME = 80

# ---- networking defaults (dump1090.c:93-103) -----------------------------------
NET_OUTPUT_RAW_PORT = 30002
NET_INPUT_RAW_PORT = 30001
NET_HTTP_PORT = 8080
NET_OUTPUT_SBS_PORT = 30003

# ---- interactive mode (dump1090.c:89-91) ---------------------------------------
INTERACTIVE_REFRESH_MS = 250
INTERACTIVE_ROWS = 15
INTERACTIVE_TTL = 60

# ---- AIS charset for flight idents (dump1090.c:1092) ----------------------------
AIS_CHARSET = "?ABCDEFGHIJKLMNOPQRSTUVWXYZ????? ???????????????0123456789??????"

LONG_MSG_DFS = (16, 17, 18, 19, 20, 21)


def message_bits_for_df(df: int) -> int:
    """Frame length in bits by Downlink Format (dump1090.c:746-753)."""
    return LONG_MSG_BITS if df in LONG_MSG_DFS else SHORT_MSG_BITS
