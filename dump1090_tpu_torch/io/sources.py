"""IQ sample sources with reference-identical block geometry (a copy of
dump1090_tpu/io/sources.py's iq_buffers and open_iq_source).

Behavioral contract: the reader thread, dump1090.c:436-527.

Every buffer yielded is the full `data_len`-byte array the reference's decode
loop sees: 476 bytes (238 IQ samples) carried from the previous buffer's tail
followed by 256 KiB of fresh samples, padded with 127 (zero signal) at EOF.
The first buffer's carry region is 127-filled (modesInit memsets the buffer,
dump1090.c:344).

EOF semantics: the reader thread flags `Modes.exit` *while filling* the buffer
in which EOF occurs (dump1090.c:497), and the reference's decode loop checks
that flag before taking a pending buffer (dump1090.c:2989).  Because a
page-cached file read always completes while the decoder is still busy with
the previous buffer, the EOF buffer is signaled-but-never-decoded — unless it
is the *first* buffer, which the decoder is already blocked waiting for
(dump1090.c:2969-2971).  We reproduce that: the padded EOF buffer is yielded
only when it is the first.  (For a reader slower than the decoder — a
trickling stdin pipe — the reference would racily decode the final buffer;
pass `decode_eof_buffer=True` to get that behavior.)
"""

from __future__ import annotations

import io
import sys
import time
from typing import BinaryIO, Iterator

import numpy as np

from ..constants import CARRY_SAMPLES, DATA_LEN_BYTES

CARRY_BYTES = CARRY_SAMPLES * 2          # 476
BUF_BYTES = DATA_LEN_BYTES + CARRY_BYTES  # 262620


def iq_buffers(
    stream: BinaryIO,
    *,
    loop: bool = False,
    seekable: bool | None = None,
    decode_eof_buffer: bool = False,
    throttle_s: float = 0.0,
) -> Iterator[np.ndarray]:
    """Yield the uint8[BUF_BYTES] buffers the reference's decode loop actually
    decodes (readDataFromFile, dump1090.c:460-514; EOF race, see module doc).

    loop: at EOF of a seekable stream, seek to 0 and read on (--loop; the
    stream then never ends).  seekable: whether loop may seek (None: ask
    the stream).  decode_eof_buffer: also yield the padded buffer in which
    EOF occurs when it is not the first (a reader slower than the decoder).
    throttle_s: sleep before each fill, the reference's interactive-mode
    playback brake (usleep(5000) per 65.5 ms buffer, dump1090.c:471-477)."""
    if seekable is None:
        seekable = stream.seekable()
    data = np.full(BUF_BYTES, 127, dtype=np.uint8)
    first = True
    while True:
        if throttle_s > 0:
            time.sleep(throttle_s)
        data[:CARRY_BYTES] = data[DATA_LEN_BYTES : DATA_LEN_BYTES + CARRY_BYTES]
        filled = 0
        hit_eof = False
        while filled < DATA_LEN_BYTES:
            chunk = stream.read(DATA_LEN_BYTES - filled)
            if not chunk:
                if loop and seekable:
                    stream.seek(0)
                    continue
                hit_eof = True
                break
            arr = np.frombuffer(chunk, dtype=np.uint8)
            data[CARRY_BYTES + filled : CARRY_BYTES + filled + len(arr)] = arr
            filled += len(arr)
        if filled < DATA_LEN_BYTES:
            data[CARRY_BYTES + filled :] = 127  # pad with no-signal
        if not hit_eof or first or decode_eof_buffer:
            yield data.copy()
        first = False
        if hit_eof:
            return


def open_iq_source(filename: str) -> BinaryIO:
    """'-' means stdin, like the reference (dump1090.c:2948-2950)."""
    if filename == "-":
        return sys.stdin.buffer
    try:
        return open(filename, "rb")
    except IsADirectoryError:
        # C fopen() on a directory SUCCEEDS and every fread() then reads as
        # EOF, so the reference decodes a directory exactly like an empty
        # file (one padded first buffer, exit 0) rather than erroring
        return io.BytesIO(b"")
