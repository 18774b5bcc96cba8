"""The port's sequential resolver (models/resolver.py, the Python twin of the
C++ runtime and the --debug path) against the JAX package's, on the CPU:
the same candidate rows of mixed traffic (every DF, 0-2 flipped bits, CPR
pairs, frames whose first bit is a demod error) through both resolve_block
calls, in the default, --no-fix and --aggressive configurations.  Every
ModesMessage field, the 8 counters and the ICAO cache are equal.  Also
BlockCandidates.from_device on torch tensors, and its overflow."""

import dataclasses
import io

import numpy as np
import pytest
import torch

from dump1090_tpu.models import decoder as jdec
from dump1090_tpu.models import resolver as jres
from dump1090_tpu_torch.constants import BUF_SAMPLES, FULL_LEN_SAMPLES
from dump1090_tpu_torch.io.sources import iq_buffers
from dump1090_tpu_torch.models import decoder as tdec
from dump1090_tpu_torch.models import resolver as tres
from dump1090_tpu_torch.ops.demod import Candidates, demod_batch
from dump1090_tpu_torch.utils.synth import traffic_capture

NOW = 1_700_000_000
SCAN = BUF_SAMPLES - FULL_LEN_SAMPLES
MODES = {"fix": (True, False), "nofix": (False, False), "aggressive": (True, True)}


@pytest.fixture(scope="module")
def rows():
    """The Candidates of 4 buffers of mixed traffic, fetched to numpy, one
    row per buffer."""
    data, _ = traffic_capture(4, 180, seed=31, blank_every=11)
    bufs = np.stack(list(iq_buffers(io.BytesIO(data))))
    cand = demod_batch(torch.from_numpy(bufs), scan_len=SCAN, max_candidates=512)
    host = [f.numpy() for f in cand]
    return [Candidates(*(f[b] for f in host)) for b in range(len(bufs))]


def _resolve_all(res, dec, rows, fix, aggressive):
    cache = dec.IcaoCache(clock=lambda: NOW)
    stats = dec.DecoderStats()
    cfg = dec.DecoderConfig(fix_errors=fix, aggressive=aggressive)
    out = []
    for row in rows:
        res.resolve_block(res.BlockCandidates.from_device(row), cache, cfg, stats, out.append)
    return out, stats, cache


@pytest.mark.parametrize("mode", list(MODES))
def test_resolve_block_matches_jax(rows, mode):
    fix, aggressive = MODES[mode]
    got, stats, cache = _resolve_all(tres, tdec, rows, fix, aggressive)
    want, jstats, jcache = _resolve_all(jres, jdec, rows, fix, aggressive)
    assert [dataclasses.asdict(m) for m in got] == [dataclasses.asdict(m) for m in want]
    assert dataclasses.astuple(stats) == dataclasses.astuple(jstats)
    np.testing.assert_array_equal(cache.addr, jcache.addr)
    np.testing.assert_array_equal(cache.ts, jcache.ts)
    assert sum(m.crcok for m in got) > 400 and any(not m.crcok for m in got)
    assert stats.out_of_phase > 0 and stats.valid_preamble > len(got) // 2
    assert {m.msgtype for m in got if m.crcok} >= {0, 4, 5, 11, 16, 17, 18, 20, 21}
    if fix:
        assert stats.fixed > 0
    else:
        assert stats.fixed == 0
    if aggressive:
        assert stats.two_bits_fix > 0


def test_block_candidates_from_tensors_and_overflow(rows):
    """Torch tensors are fetched in one go and trimmed to the exact count;
    a count above the shape raises OverflowError."""
    row = rows[0]
    as_tensors = Candidates(*(torch.from_numpy(np.asarray(f)) for f in row))
    got = tres.BlockCandidates.from_device(as_tensors)
    want = jres.BlockCandidates.from_device(row)
    for name in ("pos", "msg1", "errors1", "gate1", "msg2", "errors2", "gate2"):
        np.testing.assert_array_equal(getattr(got, name), getattr(want, name), err_msg=name)
    assert len(got.pos) == int(row.n) > 0
    over = as_tensors._replace(n=torch.tensor(row.pos.shape[0] + 1, dtype=torch.int32))
    with pytest.raises(OverflowError, match="candidate overflow"):
        tres.BlockCandidates.from_device(over)
