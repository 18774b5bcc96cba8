"""RTL-SDR device source: ctypes bindings over librtlsdr (a copy of
dump1090_tpu/io/rtlsdr.py; host code, no device work).

Behavioral contract: modesInitRTLSDR + rtlsdrCallback + readerThreadEntryPoint
(dump1090.c:385-434, 442-458, 516-527).  Accelerator hosts rarely have a USB
dongle, so the library binds lazily at runtime: when librtlsdr is present the
device becomes a first-class source yielding the exact reference buffer
geometry (476-byte carry + 256 KiB of fresh samples), and when it is not,
construction raises RtlSdrUnavailable and the CLI degrades with a clean
error.

Reference semantics reproduced exactly:

  * init sequence and stderr wording: device enumeration, gain mode
    (auto / max-available / explicit tenths-of-dB), ppm correction, AGC,
    center frequency, 2 Msps, buffer reset, reported gain (:385-434);
  * async read geometry: 12 in-flight buffers of 256 KiB
    (MODES_ASYNC_BUF_NUMBER/MODES_DATA_LEN, :53-54, :516-527);
  * the callback's carry memcpy and clamp (:442-458), including the
    depth-one mailbox: a buffer that arrives before the previous one was
    consumed OVERWRITES it (the reference sets data_ready without waiting —
    a slow decoder drops signal, it does not backpressure the radio);
  * short reads leave the tail of the previous buffer in place (the
    reference memcpys only `len` bytes over a reused buffer).

Set DUMP1090_TPU_LIBRTLSDR to an explicit .so path to override discovery
(the unit tests point it at a stub library, tests/stub_rtlsdr.c, whose
RTLSDR_STUB_DATA and RTLSDR_STUB_DELAY_US variables drive this copy and the
JAX package's alike).
"""

from __future__ import annotations

import ctypes
import ctypes.util
import os
import sys
import threading

import numpy as np

from ..constants import DATA_LEN_BYTES, DEFAULT_FREQ, SAMPLE_RATE
from .sources import BUF_BYTES, CARRY_BYTES

MODES_AUTO_GAIN = -100
MODES_MAX_GAIN = 999999
ASYNC_BUF_NUMBER = 12  # MODES_ASYNC_BUF_NUMBER, dump1090.c:53


class RtlSdrUnavailable(RuntimeError):
    """librtlsdr could not be loaded (no .so on this host)."""


class RtlSdrError(RuntimeError):
    """Device present but could not be opened/enumerated (reference exits 1)."""


_CALLBACK = ctypes.CFUNCTYPE(
    None, ctypes.POINTER(ctypes.c_ubyte), ctypes.c_uint32, ctypes.c_void_p
)


def _load_lib(path: str | None = None):
    path = path or os.environ.get("DUMP1090_TPU_LIBRTLSDR") or \
        ctypes.util.find_library("rtlsdr")
    if not path:
        raise RtlSdrUnavailable("librtlsdr not found on this host")
    try:
        lib = ctypes.CDLL(path)
    except OSError as e:
        raise RtlSdrUnavailable(f"could not load {path}: {e}") from e
    lib.rtlsdr_get_device_count.restype = ctypes.c_uint32
    lib.rtlsdr_get_device_usb_strings.argtypes = [
        ctypes.c_uint32, ctypes.c_char_p, ctypes.c_char_p, ctypes.c_char_p
    ]
    lib.rtlsdr_open.argtypes = [
        ctypes.POINTER(ctypes.c_void_p), ctypes.c_uint32
    ]
    for name in ("rtlsdr_set_tuner_gain_mode", "rtlsdr_set_tuner_gain",
                 "rtlsdr_set_freq_correction", "rtlsdr_set_agc_mode"):
        getattr(lib, name).argtypes = [ctypes.c_void_p, ctypes.c_int]
    lib.rtlsdr_set_center_freq.argtypes = [ctypes.c_void_p, ctypes.c_uint32]
    lib.rtlsdr_set_sample_rate.argtypes = [ctypes.c_void_p, ctypes.c_uint32]
    lib.rtlsdr_reset_buffer.argtypes = [ctypes.c_void_p]
    lib.rtlsdr_get_tuner_gain.argtypes = [ctypes.c_void_p]
    lib.rtlsdr_get_tuner_gain.restype = ctypes.c_int
    lib.rtlsdr_get_tuner_gains.argtypes = [
        ctypes.c_void_p, ctypes.POINTER(ctypes.c_int)
    ]
    lib.rtlsdr_get_tuner_gains.restype = ctypes.c_int
    lib.rtlsdr_read_async.argtypes = [
        ctypes.c_void_p, _CALLBACK, ctypes.c_void_p,
        ctypes.c_uint32, ctypes.c_uint32,
    ]
    lib.rtlsdr_cancel_async.argtypes = [ctypes.c_void_p]
    lib.rtlsdr_close.argtypes = [ctypes.c_void_p]
    return lib


class RtlSdrSource:
    """Live RTL-SDR capture with the reference's buffer geometry.

    Iterate `buffers()` for the same uint8[BUF_BYTES] arrays the file source
    (io/sources.iq_buffers) yields — carry region first, then fresh samples.
    """

    def __init__(
        self,
        dev_index: int = 0,
        gain: int = MODES_MAX_GAIN,
        enable_agc: bool = False,
        freq: int = DEFAULT_FREQ,
        ppm: int = 0,
        lib_path: str | None = None,
        err=None,
    ):
        self._lib = _load_lib(lib_path)
        self._err = err or sys.stderr
        self.gain = gain

        lib = self._lib
        device_count = lib.rtlsdr_get_device_count()
        if not device_count:
            self._err.write("No supported RTLSDR devices found.\n")
            raise RtlSdrError("no devices")
        self._err.write(f"Found {device_count} device(s):\n")
        vendor = ctypes.create_string_buffer(256)
        product = ctypes.create_string_buffer(256)
        serial = ctypes.create_string_buffer(256)
        for j in range(device_count):
            lib.rtlsdr_get_device_usb_strings(j, vendor, product, serial)
            sel = "(currently selected)" if j == dev_index else ""
            self._err.write(
                f"{j}: {vendor.value.decode()}, {product.value.decode()}, "
                f"SN: {serial.value.decode()} {sel}\n"
            )

        self._dev = ctypes.c_void_p()
        if lib.rtlsdr_open(ctypes.byref(self._dev), dev_index) < 0:
            self._err.write("Error opening the RTLSDR device\n")
            raise RtlSdrError(f"open({dev_index}) failed")

        # gain, frequency, sample rate; exact reference sequence and wording
        lib.rtlsdr_set_tuner_gain_mode(
            self._dev, 0 if gain == MODES_AUTO_GAIN else 1
        )
        if gain != MODES_AUTO_GAIN:
            if gain == MODES_MAX_GAIN:
                gains = (ctypes.c_int * 100)()
                numgains = lib.rtlsdr_get_tuner_gains(self._dev, gains)
                self.gain = int(gains[numgains - 1])
                self._err.write(
                    f"Max available gain is: {self.gain/10.0:.2f}\n"
                )
            lib.rtlsdr_set_tuner_gain(self._dev, self.gain)
            self._err.write(f"Setting gain to: {self.gain/10.0:.2f}\n")
        else:
            self._err.write("Using automatic gain control.\n")
        lib.rtlsdr_set_freq_correction(self._dev, ppm)
        if enable_agc:
            lib.rtlsdr_set_agc_mode(self._dev, 1)
        lib.rtlsdr_set_center_freq(self._dev, freq)
        lib.rtlsdr_set_sample_rate(self._dev, SAMPLE_RATE)
        lib.rtlsdr_reset_buffer(self._dev)
        self._err.write(
            "Gain reported by device: "
            f"{lib.rtlsdr_get_tuner_gain(self._dev)/10.0:.2f}\n"
        )

        # depth-one mailbox, the reference's data buffer + data_ready flag
        self._data = np.full(BUF_BYTES, 127, dtype=np.uint8)
        self._cond = threading.Condition()
        self._ready = False
        self._done = False
        self._thread: threading.Thread | None = None
        # keep the ctypes callback object alive for the device's lifetime
        self._cb = _CALLBACK(self._on_samples)

    # -- the reader side (rtlsdrCallback, dump1090.c:442-458) ---------------

    def _on_samples(self, buf, length, ctx) -> None:
        length = min(int(length), DATA_LEN_BYTES)
        with self._cond:
            # carry the unprocessed tail of the previous buffer to the front
            self._data[:CARRY_BYTES] = self._data[
                DATA_LEN_BYTES : DATA_LEN_BYTES + CARRY_BYTES
            ]
            self._data[CARRY_BYTES : CARRY_BYTES + length] = \
                np.ctypeslib.as_array(buf, shape=(length,))
            self._ready = True  # overwrites an unconsumed buffer, like the ref
            self._cond.notify()

    def _reader(self) -> None:
        self._lib.rtlsdr_read_async(
            self._dev, self._cb, None, ASYNC_BUF_NUMBER, DATA_LEN_BYTES
        )
        with self._cond:
            self._done = True
            self._cond.notify()

    # -- the decode side ------------------------------------------------------

    def buffers(self):
        """Yield uint8[BUF_BYTES] buffers until the async read ends (device
        unplugged / cancel)."""
        self._thread = threading.Thread(
            target=self._reader, name="rtlsdr-reader", daemon=True
        )
        self._thread.start()
        try:
            while True:
                with self._cond:
                    while not self._ready and not self._done:
                        self._cond.wait(timeout=1.0)
                    if self._ready:
                        self._ready = False
                        out = self._data.copy()
                    elif self._done:
                        return
                    else:
                        continue
                yield out
        finally:
            self.close()

    def close(self) -> None:
        if self._dev:
            try:
                self._lib.rtlsdr_cancel_async(self._dev)
                if self._thread is not None and self._thread.is_alive():
                    self._thread.join(timeout=5)
                    if self._thread.is_alive():
                        # rtlsdr_read_async is still executing: one more
                        # cancel+join round, then LEAK the handle rather
                        # than rtlsdr_close() under a live callback (a
                        # use-after-free inside librtlsdr)
                        self._lib.rtlsdr_cancel_async(self._dev)
                        self._thread.join(timeout=5)
                        if self._thread.is_alive():
                            import sys

                            sys.stderr.write(
                                "rtlsdr: reader thread did not exit after "
                                "cancel; leaking device handle instead of "
                                "closing under a live async read.\n"
                            )
                            return
                self._lib.rtlsdr_close(self._dev)
            finally:
                self._dev = None
