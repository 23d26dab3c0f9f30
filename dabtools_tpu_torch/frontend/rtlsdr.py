"""RTL-SDR frontend: librtlsdr via ctypes feeding the native IQ ring.

Reference counterpart: the RTL-SDR path of `upstream:dab2eti.c` (R2 in
SURVEY.md s2a) — open the dongle, set 2.048 Msps, tune, start the async
read; the USB callback thread pushes u8 IQ into a lock-free SPSC ring
(`utils.native.IqRing`, the `upstream:sdr_fifo.c` equivalent) and the
receiver thread drains complex64 blocks.

No pyrtlsdr dependency: the binding is ~10 ctypes prototypes.  The class
takes an injectable ``libhandle`` so the full data path (callback ->
ring -> u8->cf32 conversion -> block framing) is testable without a
dongle; with real hardware it finds ``librtlsdr.so`` via the loader.
"""

from __future__ import annotations

import ctypes
import ctypes.util
import logging
import threading

import numpy as np

log = logging.getLogger("dabtools_tpu.rtlsdr")

# librtlsdr async callback: (unsigned char *buf, uint32_t len, void *ctx)
_READ_CB = ctypes.CFUNCTYPE(None, ctypes.POINTER(ctypes.c_ubyte),
                            ctypes.c_uint32, ctypes.c_void_p)

DEFAULT_RATE = 2_048_000
# Matches the reference's librtlsdr defaults: 16 URBs x 256 KiB.
ASYNC_BUF_NUM = 15
ASYNC_BUF_LEN = 256 * 1024


def load_librtlsdr(path: str | None = None) -> ctypes.CDLL:
    """Load + prototype librtlsdr, or raise with an actionable message."""
    name = path or ctypes.util.find_library("rtlsdr") or "librtlsdr.so.0"
    try:
        so = ctypes.CDLL(name)
    except OSError as e:
        raise RuntimeError(
            f"librtlsdr not found ({e}); install librtlsdr0 or pass "
            "--rtlsdr-lib /path/to/librtlsdr.so") from None
    so.rtlsdr_get_device_count.restype = ctypes.c_uint32
    so.rtlsdr_open.restype = ctypes.c_int
    so.rtlsdr_open.argtypes = [ctypes.POINTER(ctypes.c_void_p),
                               ctypes.c_uint32]
    so.rtlsdr_close.restype = ctypes.c_int
    so.rtlsdr_close.argtypes = [ctypes.c_void_p]
    so.rtlsdr_set_sample_rate.restype = ctypes.c_int
    so.rtlsdr_set_sample_rate.argtypes = [ctypes.c_void_p, ctypes.c_uint32]
    so.rtlsdr_set_center_freq.restype = ctypes.c_int
    so.rtlsdr_set_center_freq.argtypes = [ctypes.c_void_p, ctypes.c_uint32]
    so.rtlsdr_set_tuner_gain_mode.restype = ctypes.c_int
    so.rtlsdr_set_tuner_gain_mode.argtypes = [ctypes.c_void_p, ctypes.c_int]
    so.rtlsdr_set_tuner_gain.restype = ctypes.c_int
    so.rtlsdr_set_tuner_gain.argtypes = [ctypes.c_void_p, ctypes.c_int]
    so.rtlsdr_reset_buffer.restype = ctypes.c_int
    so.rtlsdr_reset_buffer.argtypes = [ctypes.c_void_p]
    so.rtlsdr_read_async.restype = ctypes.c_int
    so.rtlsdr_read_async.argtypes = [ctypes.c_void_p, _READ_CB,
                                     ctypes.c_void_p, ctypes.c_uint32,
                                     ctypes.c_uint32]
    so.rtlsdr_cancel_async.restype = ctypes.c_int
    so.rtlsdr_cancel_async.argtypes = [ctypes.c_void_p]
    return so


class _PyRing:
    """Pure-Python SPSC fallback when libdabhost isn't built."""

    def __init__(self, capacity: int):
        self._buf = bytearray()
        self._cap = capacity
        self._lock = threading.Lock()
        self.dropped = 0

    def write(self, data) -> int:
        with self._lock:
            room = self._cap - len(self._buf)
            take = min(room, len(data))
            self._buf += bytes(data[:take])
            self.dropped += len(data) - take
            return take

    def read(self, n: int) -> bytes:
        with self._lock:
            out = bytes(self._buf[:n])
            del self._buf[:n]
            return out

    @property
    def fill(self) -> int:
        return len(self._buf)


class RtlSdrSource:
    """Tuned RTL-SDR delivering complex64 blocks at 2.048 Msps.

    ``libhandle``: injectable librtlsdr-compatible object (tests pass a
    fake; None = load the real library).  Use as a context manager or
    call :meth:`close`.
    """

    def __init__(self, frequency_hz: float, gain_db: float | None = None,
                 device_index: int = 0, sample_rate: int = DEFAULT_RATE,
                 libhandle=None, lib_path: str | None = None,
                 ring_capacity: int = 1 << 24, raw_u8: bool = True):
        self.raw_u8 = raw_u8
        self._lib = libhandle if libhandle is not None \
            else load_librtlsdr(lib_path)
        self._dev = ctypes.c_void_p()
        n = self._lib.rtlsdr_get_device_count()
        if n == 0:
            raise RuntimeError("no RTL-SDR devices found")
        if self._lib.rtlsdr_open(ctypes.byref(self._dev), device_index):
            raise RuntimeError(f"rtlsdr_open({device_index}) failed")
        self._lib.rtlsdr_set_sample_rate(self._dev, int(sample_rate))
        self._lib.rtlsdr_set_center_freq(self._dev, int(frequency_hz))
        if gain_db is None:
            self._lib.rtlsdr_set_tuner_gain_mode(self._dev, 0)   # AGC
        else:
            self._lib.rtlsdr_set_tuner_gain_mode(self._dev, 1)
            self._lib.rtlsdr_set_tuner_gain(self._dev, int(gain_db * 10))
        self._lib.rtlsdr_reset_buffer(self._dev)
        log.info("rtlsdr: tuned %.3f MHz @ %.3f Msps (gain %s)",
                 frequency_hz / 1e6, sample_rate / 1e6,
                 "AGC" if gain_db is None else f"{gain_db:.1f} dB")

        try:
            from dabtools_tpu_torch.utils.native import IqRing
            self._ring = IqRing(ring_capacity)
            self._native_ring = True
        except Exception:   # libdabhost not built on this machine
            self._ring = _PyRing(ring_capacity)
            self._native_ring = False
        self._stop = threading.Event()
        self._data_ready = threading.Event()

        # The callback ref must outlive the async loop (ctypes GC trap).
        def _cb(buf, length, _ctx):
            self._ring.write(ctypes.string_at(buf, length))
            self._data_ready.set()

        self._cb = _READ_CB(_cb)
        self._thread = threading.Thread(
            target=self._lib.rtlsdr_read_async,
            args=(self._dev, self._cb, None, ASYNC_BUF_NUM, ASYNC_BUF_LEN),
            name="rtlsdr-usb", daemon=True)
        self._thread.start()

    def read_block(self, n_samples: int, timeout_s: float = 5.0):
        """Blocking read of ``n_samples`` complex64 samples (u8 -> cf32).

        Returns fewer than requested only after ``timeout_s`` without new
        USB data (device unplugged / stream cancelled).
        """
        need = 2 * n_samples
        chunks: list[bytes] = []
        got = 0
        while got < need and not self._stop.is_set():
            c = self._ring.read(need - got)
            if c:
                chunks.append(c)
                got += len(c)
                continue
            self._data_ready.clear()
            if not self._data_ready.wait(timeout_s):
                break
        raw = np.frombuffer(b"".join(chunks), dtype=np.uint8)
        raw = raw[: raw.size // 2 * 2]
        if self.raw_u8:
            # wire-format u8: DabReceiver converts on device (4x less
            # host->device traffic than cf32)
            return raw
        from dabtools_tpu_torch.mod.impairments import u8_to_complex
        return u8_to_complex(raw)

    @property
    def dropped_bytes(self) -> int:
        return int(self._ring.dropped)

    def close(self):
        if self._stop.is_set():
            return
        self._stop.set()
        self._data_ready.set()
        self._lib.rtlsdr_cancel_async(self._dev)
        self._thread.join(timeout=5.0)
        self._lib.rtlsdr_close(self._dev)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
