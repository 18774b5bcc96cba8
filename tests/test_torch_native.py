"""The port's C++ host runtime (dump1090_tpu_torch/native/, built with g++
into _build/) against the port's Python resolver and the JAX package's own
native runtime, on the CPU: the same candidate rows of mixed traffic
through each, every ModesMessage field, the 8 counters and the ICAO cache
equal; the batch call against the per-row one, with its overflow found
before the cache is touched; the CRC hooks and decode_one against the
Python decode; the build keyed by a hash and safe to run from several
threads at once; and native=True|None|False.  Needs g++ (skips without)."""

import ctypes
import dataclasses
import io
import shutil
import threading

import numpy as np
import pytest
import torch

from dump1090_tpu_torch import native as tn
from dump1090_tpu_torch.constants import BUF_SAMPLES, FULL_LEN_SAMPLES
from dump1090_tpu_torch.io.sources import iq_buffers
from dump1090_tpu_torch.models import decoder as tdec
from dump1090_tpu_torch.models.resolver import BlockCandidates, resolve_block
from dump1090_tpu_torch.ops import crc as crc_ops
from dump1090_tpu_torch.ops.demod import Candidates, demod_batch
from dump1090_tpu_torch.utils.synth import traffic_capture, traffic_frames

NOW = 1_700_000_000
SCAN = BUF_SAMPLES - FULL_LEN_SAMPLES
MODES = {"fix": (True, False), "nofix": (False, False), "aggressive": (True, True)}


@pytest.fixture(scope="module")
def resolver():
    if shutil.which("g++") is None:
        pytest.skip("g++ is not installed: the native runtime cannot be built")
    return tn.NativeResolver()


@pytest.fixture(scope="module")
def host():
    """The fetched (NB, MC, ...) Candidates of 4 buffers of mixed traffic."""
    data, _ = traffic_capture(4, 180, seed=41, blank_every=11)
    bufs = np.stack(list(iq_buffers(io.BytesIO(data))))
    cand = demod_batch(torch.from_numpy(bufs), scan_len=SCAN, max_candidates=512)
    return [f.numpy() for f in cand]


def _rows(host):
    return [BlockCandidates.from_device(Candidates(*(f[b] for f in host)))
            for b in range(host[0].shape[0])]


def _state(fix, aggressive, dec=tdec):
    return (dec.IcaoCache(clock=lambda: NOW), dec.DecoderStats(),
            dec.DecoderConfig(fix_errors=fix, aggressive=aggressive))


def _dicts(msgs):
    return [dataclasses.asdict(m) for m in msgs]


@pytest.mark.parametrize("mode", list(MODES))
def test_native_matches_python_and_jax_native(resolver, host, mode):
    from dump1090_tpu.models import decoder as jdec
    from dump1090_tpu.native import NativeResolver as JaxNativeResolver

    fix, aggressive = MODES[mode]
    runs = {}
    for name, resolve, dec in (
        ("native", resolver.resolve_block, tdec),
        ("python", resolve_block, tdec),
        ("jax_native", JaxNativeResolver().resolve_block, jdec),
    ):
        cache, stats, cfg = _state(fix, aggressive, dec)
        out = []
        for bc in _rows(host):
            resolve(bc, cache, cfg, stats, out.append)
        runs[name] = (_dicts(out), dataclasses.astuple(stats), cache.addr.copy(), cache.ts.copy())
    for other in ("python", "jax_native"):
        assert runs["native"][:2] == runs[other][:2], other
        np.testing.assert_array_equal(runs["native"][2], runs[other][2])
        np.testing.assert_array_equal(runs["native"][3], runs[other][3])
    msgs, counts = runs["native"][:2]
    assert sum(m["crcok"] for m in msgs) > 400 and counts[1] > 0  # out_of_phase
    assert (counts[5] > 0) == fix and (counts[7] > 0) == aggressive


def test_batch_call_equals_per_row_and_overflow_leaves_state(resolver, host):
    """resolve_blocks_records (one call for the batch) equals
    resolve_block_records row by row; a row whose count exceeds the shape
    raises OverflowError(row) before the cache or the counters change."""
    cache, stats, cfg = _state(True, False)
    records, counts = resolver.resolve_blocks_records(host[1:], host[0], cache, cfg, stats)
    cache2, stats2, _ = _state(True, False)
    per_row = [resolver.resolve_block_records(bc, cache2, cfg, stats2) for bc in _rows(host)]
    assert counts.tolist() == [len(r) for r in per_row]
    assert records.tobytes() == np.concatenate(per_row).tobytes()
    assert stats == stats2 and (cache.addr == cache2.addr).all()
    assert tn.records_to_raw_lines(records) == b"".join(
        b"*" + bytes(r["msg"][: r["msgbits"] // 8]).hex().encode() + b";\n"
        for r in records if r["crcok"])
    n = host[0].copy()
    n[2] = host[1].shape[1] + 1
    before = (cache.addr.copy(), cache.ts.copy(), dataclasses.astuple(stats))
    with pytest.raises(OverflowError) as e:
        resolver.resolve_blocks_records(host[1:], n, cache, cfg, stats)
    assert e.value.args == (2,)
    assert (cache.addr == before[0]).all() and (cache.ts == before[1]).all()
    assert dataclasses.astuple(stats) == before[2]


def test_records_become_messages_lazily(resolver, host):
    """RecordMessage reads crcok without building the message, then turns
    into a ModesMessage equal to the Python resolver's."""
    cache, stats, cfg = _state(True, False)
    records = resolver.resolve_block_records(_rows(host)[0], cache, cfg, stats)
    msgs = tn.records_to_messages(records)
    assert all(type(m) is tn.RecordMessage for m in msgs) and msgs[0].crcok in (True, False)
    assert type(msgs[0]) is tn.RecordMessage
    cache2, stats2, _ = _state(True, False)
    want = []
    resolve_block(_rows(host)[0], cache2, cfg, stats2, want.append)
    assert _dicts(msgs) == _dicts(want)
    assert all(type(m) is tdec.ModesMessage for m in msgs)


def test_decode_one_and_crc_hooks_match_python(resolver):
    """Frames of every DF with 0-2 flipped bits, and random bytes, through
    the native decode and the Python one under one clock; the checksum and
    the bit-error fix hooks against ops/crc.py."""
    rng = np.random.default_rng(1)
    frames = [np.frombuffer(f, np.uint8) for f, _ in traffic_frames(5, 300)]
    frames += [rng.integers(0, 256, 14, dtype=np.uint8) for _ in range(100)]
    cache_py, stats_py, cfg = _state(True, True)
    cache_c, stats_c, _ = _state(True, True)
    for f in frames:
        assert dataclasses.asdict(tdec.decode_message(f, cache_py, cfg, stats_py)) == \
            dataclasses.asdict(resolver.decode_one(bytes(f), cache_c, cfg, stats_c))
    assert stats_py == stats_c and (cache_py.addr == cache_c.addr).all()
    lib = resolver._lib
    for f in frames[:200]:
        msg = np.zeros(14, np.uint8)
        msg[: len(f)] = f
        for bits in (56, 112):
            assert lib.d1090_checksum(resolver._state, msg.ctypes.data, bits) == \
                crc_ops.checksum(msg, bits)
            for maxfix in (1, 2):
                m_py, m_c = msg.copy(), msg.copy()
                rel_py = crc_ops.fix_bit_errors(m_py, bits, maxfix)
                rel = np.zeros(2, np.int32)
                k = lib.d1090_fix_bit_errors(resolver._state, m_c.ctypes.data, bits, maxfix,
                                             rel.ctypes.data)
                assert rel[:k].tolist() == rel_py and (m_py == m_c).all()


def test_cache_arrays_are_checked(resolver, host):
    cache, stats, cfg = _state(True, False)
    cache.ts = cache.ts.astype(np.int32)
    with pytest.raises(TypeError, match="ICAO cache"):
        resolver.resolve_block_records(_rows(host)[0], cache, cfg, stats)


def test_build_is_keyed_and_safe_from_many_threads(resolver, tmp_path, monkeypatch):
    """Three threads build into an empty build directory at once: one
    library named by the hash of the source and the flags, no temporary
    file left, and it loads with the record size of RECORD_DTYPE."""
    monkeypatch.setattr(tn, "BUILD_DIR", tmp_path / "_build")
    errors = []

    def build():
        try:
            tn.build()
        except Exception as e:  # surfaced by the assert below
            errors.append(e)

    threads = [threading.Thread(target=build) for _ in range(3)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    assert not errors and not any(t.is_alive() for t in threads)
    files = sorted(p.name for p in (tmp_path / "_build").iterdir())
    assert files == [tn.library_path().name] and tn.library_path().name.startswith("libmodes_native-")
    lib = ctypes.CDLL(str(tn.library_path()))
    lib.d1090_record_size.restype = ctypes.c_int64
    assert lib.d1090_record_size() == tn.RECORD_DTYPE.itemsize == 119


def test_native_true_none_false(tmp_path, monkeypatch, capsys):
    """native=True raises when the library cannot be built; None takes the
    Python resolver and says so on stderr; False never builds."""
    from dump1090_tpu_torch.models.pipeline import DemodPipeline

    monkeypatch.setattr(tn, "_lib", None)
    monkeypatch.setattr(tn, "BUILD_DIR", tmp_path / "_build")
    monkeypatch.setattr(tn.shutil, "which", lambda name: None)
    with pytest.raises(RuntimeError, match="g\\+\\+ not found"):
        DemodPipeline(device="cpu", native=True)
    assert DemodPipeline(device="cpu")._native is None
    assert "native runtime unavailable" in capsys.readouterr().err
    assert DemodPipeline(device="cpu", native=False)._native is None
    assert capsys.readouterr().err == "" and not (tmp_path / "_build").exists()
