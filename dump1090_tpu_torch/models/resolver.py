"""Sequential candidate resolver — exact replay of the reference scan rules
(a port of dump1090_tpu/models/resolver.py: the Python twin of the C++
runtime in native/, and the --debug path).

Behavioral contract: the control flow of detectModeS, dump1090.c:1563-1793.

The device demodulator (ops/demod.py) evaluates every candidate position
independently; this module replays, in scan order and in O(candidates), the
three sequential rules a data-parallel kernel cannot absorb:

  * the skip rule — after a good-CRC message at j the scanner jumps to
    j + (8 + msglen*8)*2 + 1, so preambles inside a decoded frame are never
    examined (dump1090.c:1769-1771);
  * the phase-correction retry — a failed position is retried once with the
    corrected pass (pass 2), whose result the kernel already computed
    (dump1090.c:1786-1791);
  * stateful decode — the ICAO cache couples acceptance of address/parity
    frames to decode history (dump1090.c:942-983, 1196-1209).

It also reproduces the reference's stat counters exactly, including their
asymmetric update condition `(crcok || use_correction)` and the single-bit
double count (dump1090.c:1737-1753; SURVEY §2.4/C21).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable

import numpy as np
import torch

from ..constants import LONG_MSG_BITS, LONG_MSG_BYTES, PREAMBLE_US
from .decoder import DecoderConfig, DecoderStats, IcaoCache, ModesMessage, decode_message


@dataclass
class DebugContext:
    """Per-buffer state for --debug dumps (dump1090.c:529-661, flag dispatch
    :1597-1791).  `mag` is the buffer's magnitude vector; `reject_code` the
    per-position preamble rejection stage (ops.demod.preamble_reject_stages),
    both as host numpy arrays."""

    flags: object                 # utils.debug.DebugFlags
    mag: np.ndarray
    reject_code: np.ndarray | None = None
    out: object = None
    frames_path: str = "frames.js"

    def __post_init__(self):
        import sys

        if self.out is None:
            self.out = sys.stdout
        # the reference's scratch msg[] is uninitialized before the first
        # bit-slice of each buffer; we start from zeros (documented divergence)
        self.last_msg = np.zeros(LONG_MSG_BYTES, dtype=np.uint8)

    def dump(self, descr: str, msg: np.ndarray, offset: int) -> None:
        from ..utils.debug import dump_raw_message

        dump_raw_message(
            descr, msg, self.mag, offset,
            js=self.flags.js, out=self.out, frames_path=self.frames_path,
        )


@dataclass
class BlockCandidates:
    """Host-side (numpy) view of one block's compacted kernel output,
    trimmed to the true candidate count and sorted by position."""

    pos: np.ndarray       # [n] int32, ascending scan positions
    msg1: np.ndarray      # [n, 14] uint8
    errors1: np.ndarray   # [n] int32
    gate1: np.ndarray     # [n] bool
    msg2: np.ndarray
    errors2: np.ndarray
    gate2: np.ndarray

    @classmethod
    def from_device(cls, cand) -> "BlockCandidates":
        """From one buffer's Candidates (ops.demod), torch tensors or their
        numpy copies.  Tensors are fetched all eight in one go (the
        pipeline's _Fetch: one event, not a copy per field).  Raises
        OverflowError when the exact count exceeds the candidate shape."""
        if isinstance(cand.n, torch.Tensor):
            from .pipeline import _Fetch

            cand = type(cand)(*_Fetch(list(cand)).get())
        n = int(cand.n)
        c = min(n, cand.pos.shape[0])
        if n > cand.pos.shape[0]:
            raise OverflowError(
                f"candidate overflow: {n} preambles > max_candidates "
                f"{cand.pos.shape[0]}; raise max_candidates"
            )
        return cls(
            pos=np.asarray(cand.pos)[:c],
            msg1=np.asarray(cand.msg1)[:c],
            errors1=np.asarray(cand.errors1)[:c],
            gate1=np.asarray(cand.gate1)[:c],
            msg2=np.asarray(cand.msg2)[:c],
            errors2=np.asarray(cand.errors2)[:c],
            gate2=np.asarray(cand.gate2)[:c],
        )


_REJECT_DESCR = {
    1: "Unexpected ratio among first 10 samples",
    2: "Too high level in samples between 3 and 6",
    3: "Too high level in samples between 10 and 15",
}


def resolve_block(
    cands: BlockCandidates,
    cache: IcaoCache,
    cfg: DecoderConfig,
    stats: DecoderStats,
    emit: Callable[[ModesMessage], None],
    debug: "DebugContext | None" = None,
) -> None:
    """Replay one block's candidates in scan order, emitting every message
    the reference would hand to useModesMessage (dump1090.c:1777)."""
    next_j = 0
    dbg = debug if debug is not None and debug.flags.any_demod_dump else None

    # --debug p: rejected scan positions with m[j] above the dump level,
    # interleaved with candidates in scan order (dump1090.c:1612-1650)
    events: list[tuple[int, int]] = [(int(p), k) for k, p in enumerate(cands.pos)]
    if dbg is not None and dbg.flags.nopreamble and dbg.reject_code is not None:
        from ..utils.debug import DEBUG_NOPREAMBLE_LEVEL

        rej = np.nonzero(
            (dbg.reject_code > 0)
            & (dbg.mag[: len(dbg.reject_code)] > DEBUG_NOPREAMBLE_LEVEL)
        )[0]
        events = sorted(events + [(int(p), -1) for p in rej])

    for j, k in events:
        if j < next_j:
            continue  # inside a previously decoded good message
        if k < 0:  # --debug p rejection dump
            dbg.dump(_REJECT_DESCR[int(dbg.reject_code[j])], dbg.last_msg, j)
            continue
        stats.valid_preamble += 1

        # ---- pass 1: uncorrected (use_correction == 0) --------------------
        good = False
        msg1 = cands.msg1[k]
        if not bool(cands.gate1[k]):
            # noise-gate failure skips the retry entirely (dump1090.c:1724-1726)
            if dbg is not None:
                dbg.last_msg = msg1
            continue
        errors = int(cands.errors1[k])
        if errors == 0 or (cfg.aggressive and errors < 3):
            mm = decode_message(msg1, cache, cfg, stats)
            if mm.crcok:  # stats gated on (crcok || use_correction)
                _update_detect_stats(stats, mm, errors)
            if dbg is not None:  # if/else-if chain, dump1090.c:1755-1766
                if dbg.flags.demod:
                    dbg.dump("Demodulated with 0 errors", msg1, j)
                elif dbg.flags.badcrc and mm.msgtype == 17 and (
                    not mm.crcok or mm.errorbit != -1
                ):
                    dbg.dump("Decoded with bad CRC", msg1, j)
                elif dbg.flags.goodcrc and mm.crcok and mm.errorbit == -1:
                    dbg.dump("Decoded with good CRC", msg1, j)
            if mm.crcok:
                next_j = j + (PREAMBLE_US + (mm.msgbits // 8) * 8) * 2 + 1
                good = True
            emit(mm)
        if good:
            if dbg is not None:
                dbg.last_msg = msg1
            continue

        # ---- pass 2: phase-corrected retry (use_correction == 1) ----------
        msg2 = cands.msg2[k]
        if dbg is not None:
            dbg.last_msg = msg2
        if j > 0:
            stats.out_of_phase += 1  # correction applied only when j > 0
        if not bool(cands.gate2[k]):
            continue
        errors = int(cands.errors2[k])
        if errors == 0 or (cfg.aggressive and errors < 3):
            mm = decode_message(msg2, cache, cfg, stats)
            _update_detect_stats(stats, mm, errors)  # unconditional on retry
            if mm.crcok:
                mm.phase_corrected = True
                next_j = j + (PREAMBLE_US + (mm.msgbits // 8) * 8) * 2 + 1
            emit(mm)
        elif dbg is not None and dbg.flags.demoderr:
            # dump1090.c:1779-1782: only on the corrected retry
            dbg.out.write(f"The following message has {errors} demod errors\n")
            dbg.dump("Demodulated with errors", msg2, j)


def _update_detect_stats(stats: DecoderStats, mm: ModesMessage, errors: int) -> None:
    """detectModeS stat block, dump1090.c:1737-1753.  The errorbit <
    LONG_MSG_BITS test is always true (errorbit is a message bit position),
    so single_bit_fix double counts and two_bits_fix is decode-path only —
    a reference quirk we reproduce."""
    if errors == 0:
        stats.demodulated += 1
    if mm.errorbit == -1:
        if mm.crcok:
            stats.goodcrc += 1
        else:
            stats.badcrc += 1
    else:
        stats.badcrc += 1
        stats.fixed += 1
        if mm.errorbit < LONG_MSG_BITS:
            stats.single_bit_fix += 1
        else:
            stats.two_bits_fix += 1
