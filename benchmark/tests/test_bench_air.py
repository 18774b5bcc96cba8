"""The generator: the same seed gives the same bytes, another seed other
bytes, the mix holds every DF the reference decodes, and the markers
decode to their buffers' sequence numbers."""

import json

import numpy as np

from benchmark import air, spec
from benchmark.reference import decoder, demod, modes


def mix(name="dense"):
    return json.loads((spec.HERE / "traffic" / f"{name}.json").read_text())


def test_same_seed_same_bytes_other_seed_other_bytes():
    a, na = air.blocks(2**31 + 7, 3, mix())
    b, nb = air.blocks(2**31 + 7, 3, mix())
    c, _ = air.blocks(2**31 + 8, 3, mix())
    assert a.shape == (3, modes.DATA_LEN_BYTES) and a.dtype == np.uint8
    assert np.array_equal(a, b) and np.array_equal(na, nb)
    assert (a != c).mean() > 0.5


def test_frames_hold_every_downlink_format_and_clean_crcs():
    rng = np.random.default_rng(5)
    pool = rng.integers(1, 1 << 24, 16)
    msgs, bits = air.frames(rng, 4000, pool, mix()["kinds"], (1.0, 0.0, 0.0))
    dfs = set((msgs[:, 0] >> 3).tolist())
    assert {0, 4, 5, 11, 16, 17, 18, 20, 21, 24} <= dfs
    syn = modes.syndromes(msgs, bits)
    # no flips: DF11/17/18 carry a clean CRC or (DF11) a small interrogator id;
    # address/parity frames carry the CRC XOR an address of the pool
    ext = np.isin(msgs[:, 0] >> 3, (17, 18))
    assert (syn[ext] == 0).all()
    df11 = (msgs[:, 0] >> 3) == 11
    assert (syn[df11] < 80).all() and (syn[df11] > 0).any()
    ap = np.isin(msgs[:, 0] >> 3, modes.AP_DFS)
    assert np.isin(syn[ap], pool).all()


def test_markers_decode_to_their_sequence_numbers():
    bufs = air.paced_buffers(2**31 + 3, 3, mix("live_dense"))
    assert bufs.shape == (3, modes.BUF_BYTES)
    c = demod.demodulate(bufs)
    seen = {}

    def emit(b, mm):
        if mm.crcok and mm.addr == air.MARKER_ADDR:
            seen[b] = air.marker_seq(mm.msg)

    decoder.walk(c, decoder.IcaoCache(lambda: 0), decoder.DecoderConfig(), decoder.Stats(), emit)
    assert seen == {0: 0, 1: 1, 2: 2}


def test_marker_ends_before_the_carried_samples():
    assert air.MARKER_OFF + air.MARKER_LEN < modes.BLOCK_SAMPLES - modes.CARRY_SAMPLES
