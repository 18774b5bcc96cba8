"""The port's IQ source (dump1090_tpu_torch/io/sources.py::iq_buffers)
against the JAX package's, on the CPU: every combination of loop, seekable
and decode_eof_buffer, on a seekable and a non-seekable stream, at lengths
of 0, a partial buffer, one buffer and one buffer plus a tail.  The same
seeded bytes give the same buffers, bit for bit (contract: the reader
thread, dump1090.c:436-527)."""

import io
import itertools

import numpy as np
import pytest

from dump1090_tpu.io.sources import iq_buffers as jax_iq_buffers
from dump1090_tpu_torch.io.sources import BUF_BYTES, CARRY_BYTES, iq_buffers
from dump1090_tpu_torch.constants import DATA_LEN_BYTES

LENGTHS = {"empty": 0, "partial": 1000, "one": DATA_LEN_BYTES, "one_plus_tail": DATA_LEN_BYTES + 777}
TAKE = 5  # a looping stream never ends: compare its first buffers


class Pipe(io.RawIOBase):
    """A non-seekable stream over bytes that hands out at most 4,099 bytes a
    read, as a pipe does."""

    def __init__(self, data: bytes):
        self._data, self._at = data, 0

    def readable(self) -> bool:
        return True

    def read(self, n: int = -1) -> bytes:
        n = 4099 if n < 0 else min(n, 4099)
        out = self._data[self._at:self._at + n]
        self._at += len(out)
        return out


def _data(n: int) -> bytes:
    return np.random.default_rng(n).integers(0, 256, n, dtype=np.uint8).tobytes()


def _buffers(fn, data: bytes, stream_kind: str, **kw) -> list:
    stream = io.BytesIO(data) if stream_kind == "seekable" else Pipe(data)
    return list(itertools.islice(fn(stream, **kw), TAKE))


def _cases():
    """Every (stream, length, loop, seekable, decode_eof_buffer) but those
    that never end in either package: an empty stream that loops and seeks
    rewinds for ever, as the reference's --loop on an empty file does."""
    for kind, length, loop, seekable, eof in itertools.product(
            ["seekable", "pipe"], LENGTHS, [False, True], [None, False, True], [False, True]):
        if not (loop and seekable is not False and kind == "seekable" and length == "empty"):
            yield kind, length, loop, seekable, eof


@pytest.mark.parametrize("stream_kind,length,loop,seekable,decode_eof_buffer", list(_cases()))
def test_iq_buffers_match_jax(stream_kind, length, loop, seekable, decode_eof_buffer):
    data = _data(LENGTHS[length])
    kw = dict(loop=loop, seekable=seekable, decode_eof_buffer=decode_eof_buffer)
    if loop and seekable and stream_kind == "pipe":
        # told that a pipe seeks, both packages try to rewind it at EOF
        for fn in (iq_buffers, jax_iq_buffers):
            with pytest.raises(OSError):
                _buffers(fn, data, stream_kind, **kw)
        return
    got = _buffers(iq_buffers, data, stream_kind, **kw)
    want = _buffers(jax_iq_buffers, data, stream_kind, **kw)
    assert len(got) == len(want) >= 1
    for g, w in zip(got, want):
        assert g.dtype == np.uint8 and g.shape == (BUF_BYTES,)
        np.testing.assert_array_equal(g, w)


def test_decode_eof_buffer_yields_the_padded_last_buffer():
    """One buffer plus a tail: the padded EOF buffer (the tail after the
    previous buffer's carry) comes only with decode_eof_buffer; a
    non-seekable stream never loops."""
    data = _data(DATA_LEN_BYTES + 777)
    assert len(list(iq_buffers(io.BytesIO(data)))) == 1
    bufs = list(iq_buffers(io.BytesIO(data), decode_eof_buffer=True))
    assert len(bufs) == 2
    np.testing.assert_array_equal(bufs[1][:CARRY_BYTES], bufs[0][DATA_LEN_BYTES:])
    assert bytes(bufs[1][CARRY_BYTES:CARRY_BYTES + 777]) == data[DATA_LEN_BYTES:]
    assert (bufs[1][CARRY_BYTES + 777:] == 127).all()
    assert len(list(iq_buffers(Pipe(data), loop=True))) == 1
    assert len(list(iq_buffers(io.BytesIO(data), loop=True, seekable=False))) == 1


def test_loop_is_keyword_only():
    with pytest.raises(TypeError):
        iq_buffers(io.BytesIO(b""), True)
