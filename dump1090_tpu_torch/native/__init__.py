"""Native host runtime: ctypes bindings over modes_native.cpp (a copy of
dump1090_tpu/native/, host code with no CUDA in it).

The C++ library implements the sequential candidate resolver and the full
frame decoder, the host half of the host-resolve path: the device
demodulates (ops/demod.py), and this library replays the skip rule, the
phase-correction retry and the ICAO-cache acceptance at native speed.
models/resolver.py and models/decoder.py are its Python twins.

The library is compiled with g++ at first use into `_build/` in the
package, keyed by a hash of the source and the flags (a stale or missing
library is rebuilt).  The build writes a temporary file and renames it, so
several processes may build at once.  `load` raises when g++ is missing or
the library cannot be built or loaded; DemodPipeline(native=None) then
takes the Python twin, native=True raises.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path

import numpy as np

from ..io.raw_lines import raw_lines_from_fields
from ..models.decoder import STAT_FIELDS

_DIR = Path(__file__).resolve().parent
_SRC = _DIR / "modes_native.cpp"
BUILD_DIR = _DIR.parent / "_build"
CXX_FLAGS = ("-O2", "-std=c++17", "-shared", "-fPIC")

# POD mirror of struct Record in modes_native.cpp (packed, order-exact).
RECORD_DTYPE = np.dtype(
    [
        ("msg", np.uint8, (14,)),
        ("msgbits", np.uint8),
        ("msgtype", np.uint8),
        ("crcok", np.uint8),
        ("phase_corrected", np.uint8),
        ("crc", np.int32),
        ("errorbit", np.int32),
        ("aa1", np.uint8),
        ("aa2", np.uint8),
        ("aa3", np.uint8),
        ("ca", np.uint8),
        ("iid", np.int32),
        ("metype", np.uint8),
        ("mesub", np.uint8),
        ("heading_is_valid", np.uint8),
        ("aircraft_type", np.uint8),
        ("heading", np.int32),
        ("fflag", np.int32),
        ("tflag", np.int32),
        ("raw_latitude", np.int32),
        ("raw_longitude", np.int32),
        ("flight", "S9"),
        ("ew_dir", np.uint8),
        ("ns_dir", np.uint8),
        ("vert_rate_source", np.uint8),
        ("vert_rate_sign", np.uint8),
        ("ew_velocity", np.int32),
        ("ns_velocity", np.int32),
        ("vert_rate", np.int32),
        ("velocity", np.int32),
        ("movement", np.int32),
        ("movement_valid", np.int32),
        ("ground_track", np.int32),
        ("ground_track_valid", np.int32),
        ("fs", np.uint8),
        ("dr", np.uint8),
        ("um", np.uint8),
        ("unit", np.uint8),
        ("identity", np.int32),
        ("altitude", np.int32),
        ("pos", np.int32),
    ],
    align=False,
)

_vp, _i32, _i64 = ctypes.c_void_p, ctypes.c_int32, ctypes.c_int64
_SIGNATURES = {
    "d1090_record_size": ([], _i64),
    "d1090_create": ([], _vp),
    "d1090_destroy": ([_vp], None),
    "d1090_checksum": ([_vp, _vp, _i32], ctypes.c_uint32),
    "d1090_fix_bit_errors": ([_vp, _vp, _i32, _i32, _vp], _i32),
    # (state, raw14, out, icao_addrs, icao_ts, now, fix_errors, aggressive, stats)
    "d1090_decode_one": ([_vp, _vp, _vp, _vp, _vp, _i64, _i32, _i32, _vp], _i32),
    # (state, pos, msg1, errors1, gate1, msg2, errors2, gate2, n_cand,
    #  icao_addrs, icao_ts, now, fix_errors, aggressive, stats, out, out_cap)
    "d1090_resolve_block": ([_vp] * 8 + [_i64, _vp, _vp, _i64, _i32, _i32, _vp, _vp, _i64],
                            _i64),
    # (state, pos, msg1, errors1, gate1, msg2, errors2, gate2, n_per_row, nb,
    #  mc, icao_addrs, icao_ts, now, fix_errors, aggressive, stats, out,
    #  out_cap, out_counts)
    "d1090_resolve_blocks": ([_vp] * 9 + [_i64, _i64, _vp, _vp, _i64, _i32, _i32, _vp, _vp,
                                          _i64, _vp], _i64),
}

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None


def library_path() -> Path:
    h = hashlib.sha256(" ".join(CXX_FLAGS).encode())
    h.update(_SRC.read_bytes())
    return BUILD_DIR / f"libmodes_native-{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile modes_native.cpp into the shared library (no-op when cached)."""
    so = library_path()
    if so.exists():
        return so
    gxx = shutil.which("g++")
    if gxx is None:
        raise RuntimeError("g++ not found on PATH: the native host runtime is compiled at first use")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=BUILD_DIR, prefix=so.stem + "-", suffix=".tmp")
    os.close(fd)
    try:
        r = subprocess.run([gxx, *CXX_FLAGS, str(_SRC), "-o", tmp], capture_output=True,
                           text=True)
        if r.returncode != 0:
            raise RuntimeError(f"g++ failed on native/modes_native.cpp:\n{r.stderr}")
        os.replace(tmp, so)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return so


def load() -> ctypes.CDLL:
    """The loaded native library, built on first use.  Raises if it cannot
    be built or loaded, or if its record layout is not RECORD_DTYPE's."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            for name, (argtypes, restype) in _SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = restype
            if lib.d1090_record_size() != RECORD_DTYPE.itemsize:
                raise RuntimeError(
                    f"record layout drift: C++ {lib.d1090_record_size()} B vs "
                    f"dtype {RECORD_DTYPE.itemsize} B"
                )
            _lib = lib
    return _lib


def _ptr(a: np.ndarray) -> int:
    return a.ctypes.data


def _check_cache(cache) -> None:
    """The library writes the caller's ICAO cache arrays in place: they must
    be the 1024-entry uint32 and int64 arrays of models.decoder.IcaoCache."""
    for a, dt in ((cache.addr, np.uint32), (cache.ts, np.int64)):
        if a.dtype != dt or a.shape != (1024,) or not a.flags.c_contiguous or not a.flags.writeable:
            raise TypeError(f"ICAO cache array must be writable contiguous {np.dtype(dt)} (1024,), "
                            f"got {a.dtype} {a.shape}")


def _candidate_arrays(pos, msg1, errors1, gate1, msg2, errors2, gate2):
    """The seven candidate fields as contiguous arrays of the C types."""
    return (
        np.ascontiguousarray(pos, dtype=np.int32),
        np.ascontiguousarray(msg1, dtype=np.uint8),
        np.ascontiguousarray(errors1, dtype=np.int32),
        np.ascontiguousarray(gate1, dtype=np.bool_).view(np.uint8),
        np.ascontiguousarray(msg2, dtype=np.uint8),
        np.ascontiguousarray(errors2, dtype=np.int32),
        np.ascontiguousarray(gate2, dtype=np.bool_).view(np.uint8),
    )


def _add_stats(stats, deltas: np.ndarray) -> None:
    for name, d in zip(STAT_FIELDS, deltas.tolist()):
        setattr(stats, name, getattr(stats, name) + d)


class NativeResolver:
    """Native twin of models.resolver.resolve_block.

    Shares the caller's IcaoCache arrays and DecoderStats object, so the
    Python network-input decode path and this resolver observe one state.
    """

    def __init__(self):
        self._lib = load()
        self._state = self._lib.d1090_create()
        self._out = np.zeros(4096, dtype=RECORD_DTYPE)

    def __del__(self):
        state = getattr(self, "_state", None)
        if state:
            self._lib.d1090_destroy(state)

    def resolve_block(self, cands, cache, cfg, stats, emit) -> None:
        """Exact twin of models.resolver.resolve_block (no debug path:
        callers asking for --debug dumps use the Python resolver)."""
        for mm in records_to_messages(self.resolve_block_records(cands, cache, cfg, stats)):
            emit(mm)

    def resolve_block_records(self, cands, cache, cfg, stats) -> np.ndarray:
        """Like resolve_block, but returns the packed Record array (a copy)
        instead of message objects: the bulk path for consumers that
        post-process records vectorially (the CLI's --raw mode)."""
        n = len(cands.pos)
        if n == 0:
            return np.empty(0, dtype=RECORD_DTYPE)
        _check_cache(cache)
        if self._out.shape[0] < 2 * n:
            self._out = np.zeros(2 * n, dtype=RECORD_DTYPE)
        arrays = _candidate_arrays(cands.pos, cands.msg1, cands.errors1, cands.gate1,
                                   cands.msg2, cands.errors2, cands.gate2)
        deltas = np.zeros(len(STAT_FIELDS), dtype=np.int64)
        n_out = self._lib.d1090_resolve_block(
            self._state, *map(_ptr, arrays), n, _ptr(cache.addr), _ptr(cache.ts),
            cache.clock(), int(cfg.fix_errors), int(cfg.aggressive), _ptr(deltas),
            _ptr(self._out), self._out.shape[0],
        )
        if n_out < 0:
            raise OverflowError("native resolver output overflow")
        _add_stats(stats, deltas)
        return self._out[:n_out].copy()

    def resolve_blocks_records(self, cand_host, n_arr, cache, cfg, stats):
        """Resolve a whole batch in one native call.

        cand_host: the (NB, MC, ...) demod output arrays on the host (pos,
        msg1, errors1, gate1, msg2, errors2, gate2: the Candidates field
        order without n); n_arr: the exact per-row counts.  Returns
        (records, counts), the records concatenated in row order, or raises
        OverflowError(row) if a row's count exceeds MC."""
        nb, mc = cand_host[0].shape
        # checked BEFORE the native call: resolving rows mutates the shared
        # ICAO cache as it goes, so an overflow must be found while the
        # state is untouched (the caller's per-row fallback re-resolves
        # from this exact state)
        if int(n_arr.max(initial=0)) > mc:
            raise OverflowError(int(np.argmax(n_arr)))
        _check_cache(cache)
        cap = 2 * nb * mc + 1
        if self._out.shape[0] < cap:
            self._out = np.zeros(cap, dtype=RECORD_DTYPE)
        arrays = _candidate_arrays(*cand_host)
        n32 = np.ascontiguousarray(n_arr, dtype=np.int32)
        counts = np.zeros(nb, dtype=np.int64)
        deltas = np.zeros(len(STAT_FIELDS), dtype=np.int64)
        total = self._lib.d1090_resolve_blocks(
            self._state, *map(_ptr, arrays), _ptr(n32), nb, mc, _ptr(cache.addr),
            _ptr(cache.ts), cache.clock(), int(cfg.fix_errors), int(cfg.aggressive),
            _ptr(deltas), _ptr(self._out), self._out.shape[0], _ptr(counts),
        )
        if total < 0:  # unreachable given the check above
            raise RuntimeError(f"native batch resolve failed ({total})")
        _add_stats(stats, deltas)
        return self._out[:total].copy(), counts

    def decode_one(self, raw: bytes, cache, cfg, stats=None):
        """Native twin of models.decoder.decode_message."""
        _check_cache(cache)
        buf = np.zeros(14, dtype=np.uint8)
        b = np.frombuffer(bytes(raw), dtype=np.uint8)[:14]
        buf[: len(b)] = b
        out = np.zeros(1, dtype=RECORD_DTYPE)
        deltas = np.zeros(len(STAT_FIELDS), dtype=np.int64)
        self._lib.d1090_decode_one(
            self._state, _ptr(buf), _ptr(out), _ptr(cache.addr), _ptr(cache.ts), cache.clock(),
            int(cfg.fix_errors), int(cfg.aggressive), _ptr(deltas),
        )
        if stats is not None:
            _add_stats(stats, deltas)
        return records_to_messages(out)[0]


class RecordMessage:
    """Lazily materialized ModesMessage: wraps one packed native Record and
    becomes a real ModesMessage (via __class__ swap) on the first access to
    any field other than `crcok`.

    The message hub drops bad-CRC frames after reading only `crcok`
    (useModesMessage, dump1090.c:1802-1803), so in the default configuration
    the Python-object conversion is paid only for usable messages."""

    def __init__(self, row, crcok: bool):
        d = object.__getattribute__(self, "__dict__")
        d["crcok"] = crcok
        d["_row"] = row

    def __getattr__(self, name):
        if name.startswith("__"):
            # dunder probes (copy/pickle/inspect protocols) must not consume
            # the packed record: materialize only for real field access
            raise AttributeError(name)
        from ..models.decoder import ModesMessage

        dd = object.__getattribute__(self, "__dict__")
        row = dd.pop("_row", None)
        if row is None:
            raise AttributeError(name)
        d = dict(zip(row.dtype.names, row.tolist()))
        d["msg"] = bytes(d["msg"])
        d["flight"] = d["flight"].split(b"\0")[0].decode("ascii", "replace")
        d["crcok"] = bool(d["crcok"])
        d["phase_corrected"] = bool(d["phase_corrected"])
        d.pop("pos")
        dd.update(d)
        # from here on this IS a ModesMessage (addr/hexaddr properties,
        # dataclass __eq__/__repr__/asdict all behave identically)
        object.__setattr__(self, "__class__", ModesMessage)
        return getattr(self, name)


def records_to_messages(records: np.ndarray) -> list:
    """Wrap packed Record rows as lazily materialized ModesMessage objects.

    `records` must own its data (rows hold views into it); callers pass a
    fresh copy per block."""
    if "__dataclass_fields__" not in RecordMessage.__dict__:
        # dataclasses.asdict/fields() probe the *type*, bypassing
        # __getattr__; mirror the dataclass metadata so a RecordMessage
        # quacks fully
        from ..models.decoder import ModesMessage

        RecordMessage.__dataclass_fields__ = ModesMessage.__dataclass_fields__
        RecordMessage.__dataclass_params__ = ModesMessage.__dataclass_params__
    crcok = records["crcok"].tolist()
    return [RecordMessage(row, ok != 0) for row, ok in zip(records, crcok)]


def records_to_raw_lines(records: np.ndarray, upper: bool = False) -> bytes:
    """Vectorized `*<hex>;\\n` lines for the good-CRC records of a block:
    the bulk form of displayModesMessage's --raw branch
    (dump1090.c:1317-1324, 2381-2393)."""
    return raw_lines_from_fields(
        records["msg"], records["msgbits"], records["crcok"] != 0, upper=upper
    )
