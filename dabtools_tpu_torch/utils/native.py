"""ctypes bindings for the native host runtime (``native/dabhost.cc``).

``lib()`` returns the loaded library or None (pure-NumPy fallbacks are used
then).  Build on demand with ``ensure_built()`` or
``make -C dabtools_tpu_torch/native``.  pybind11 is not available in this image;
ctypes keeps the binding dependency-free.
"""

from __future__ import annotations

import ctypes
import functools
import logging
import pathlib
import subprocess

import numpy as np

log = logging.getLogger("dabtools_tpu.native")

_DIR = pathlib.Path(__file__).resolve().parent.parent / "native"
_SO = _DIR / "libdabhost.so"


def ensure_built(quiet: bool = True) -> bool:
    """Build libdabhost.so if missing; True on success."""
    if _SO.exists():
        return True
    try:
        subprocess.run(["make", "-C", str(_DIR)], check=True,
                       capture_output=quiet, timeout=120)
        return _SO.exists()
    except Exception as e:  # toolchain missing etc.
        log.debug("native build failed: %s", e)
        return False


@functools.cache
def lib() -> ctypes.CDLL | None:
    if not _SO.exists() and not ensure_built():
        return None
    try:
        so = ctypes.CDLL(str(_SO))
    except OSError as e:
        log.warning("could not load %s: %s", _SO, e)
        return None
    # A stale .so built before a symbol was added must trigger a rebuild,
    # not an AttributeError from every (sometimes unguarded) caller.
    if not hasattr(so, "dabhost_eti_build_batch"):  # newest symbol
        log.info("libdabhost.so is stale (missing symbols); rebuilding")
        try:
            subprocess.run(["make", "-C", str(_DIR), "-B"], check=True,
                           capture_output=True, timeout=120)
            so = ctypes.CDLL(str(_SO))
        except Exception as e:  # noqa: BLE001
            log.warning("native rebuild failed (%s); using NumPy "
                        "fallbacks", e)
            return None
        if not hasattr(so, "dabhost_eti_build_batch"):
            log.warning("rebuilt libdabhost.so still lacks symbols; "
                        "using NumPy fallbacks")
            return None
    u8p = ctypes.POINTER(ctypes.c_uint8)
    so.dabhost_init.restype = None
    so.dabhost_crc16_ccitt.restype = ctypes.c_uint16
    so.dabhost_crc16_ccitt.argtypes = [u8p, ctypes.c_size_t]
    so.dabhost_firecode.restype = ctypes.c_uint16
    so.dabhost_firecode.argtypes = [u8p, ctypes.c_size_t]
    so.dabhost_crc16_ok_batch.restype = None
    so.dabhost_crc16_ok_batch.argtypes = [u8p, ctypes.c_size_t,
                                          ctypes.c_size_t, u8p]
    so.dabhost_prbs_xor.restype = None
    so.dabhost_prbs_xor.argtypes = [u8p, ctypes.c_size_t]
    so.dabhost_eti_find_fsync.restype = ctypes.c_int64
    so.dabhost_eti_find_fsync.argtypes = [u8p, ctypes.c_size_t,
                                          ctypes.c_size_t]
    so.dabhost_eti_build.restype = ctypes.c_int64
    so.dabhost_eti_build.argtypes = [
        ctypes.c_uint8, ctypes.c_uint8, ctypes.c_uint8, ctypes.c_uint8,
        u8p, ctypes.c_size_t, u8p, ctypes.c_size_t, u8p, ctypes.c_size_t,
        u8p]
    so.dabhost_eti_build_batch.restype = ctypes.c_int64
    so.dabhost_eti_build_batch.argtypes = [
        ctypes.c_size_t, ctypes.c_uint8, ctypes.c_uint8, u8p,
        ctypes.c_uint8, u8p, ctypes.c_size_t, u8p, ctypes.c_size_t,
        u8p, ctypes.c_size_t, u8p]
    so.dabhost_u8_to_cf32.restype = None
    so.dabhost_u8_to_cf32.argtypes = [u8p, ctypes.POINTER(ctypes.c_float),
                                      ctypes.c_size_t, ctypes.c_float]
    so.dabhost_ring_create.restype = ctypes.c_void_p
    so.dabhost_ring_create.argtypes = [ctypes.c_size_t]
    so.dabhost_ring_free.restype = None
    so.dabhost_ring_free.argtypes = [ctypes.c_void_p]
    so.dabhost_ring_fill.restype = ctypes.c_size_t
    so.dabhost_ring_fill.argtypes = [ctypes.c_void_p]
    so.dabhost_ring_write.restype = ctypes.c_size_t
    so.dabhost_ring_write.argtypes = [ctypes.c_void_p, u8p, ctypes.c_size_t]
    so.dabhost_ring_read.restype = ctypes.c_size_t
    so.dabhost_ring_read.argtypes = [ctypes.c_void_p, u8p, ctypes.c_size_t]
    so.dabhost_ring_dropped.restype = ctypes.c_uint64
    so.dabhost_ring_dropped.argtypes = [ctypes.c_void_p]
    so.dabhost_init()
    return so


def _u8(arr: bytes | np.ndarray):
    a = np.frombuffer(bytes(arr), dtype=np.uint8)
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), a.size


def crc16_ccitt(data) -> int:
    p, n = _u8(data)
    return int(lib().dabhost_crc16_ccitt(p, n))


def firecode(data) -> int:
    p, n = _u8(data)
    return int(lib().dabhost_firecode(p, n))


def crc16_ok_batch(blocks: np.ndarray) -> np.ndarray:
    """(n, block_len) uint8 -> (n,) bool: trailing-2-byte DAB CRC valid."""
    a = np.ascontiguousarray(blocks, dtype=np.uint8)
    n, block_len = a.shape
    ok = np.empty(n, dtype=np.uint8)
    lib().dabhost_crc16_ok_batch(
        a.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), n, block_len,
        ok.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)))
    return ok.astype(bool)


def prbs_xor(data: np.ndarray) -> np.ndarray:
    out = np.array(np.frombuffer(bytes(data), dtype=np.uint8))
    lib().dabhost_prbs_xor(
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), out.size)
    return out


def eti_find_fsync(buf, start: int = 0) -> int:
    p, n = _u8(buf)
    return int(lib().dabhost_eti_find_fsync(p, n, start))


def eti_build_batch(fct0: int, fp0: int, err: bytes, mid: int,
                    stc: bytes, n_streams: int, fic_all: bytes,
                    fic_len: int, subch_all: bytes,
                    subch_len: int) -> bytes:
    """Assemble len(err) consecutive ETI frames in ONE native call."""
    n = len(err)
    out = np.empty(n * 6144, dtype=np.uint8)
    ep, _ = _u8(err)
    sp, _ = _u8(stc)
    fp_, _ = _u8(fic_all)
    dp, _ = _u8(subch_all)
    r = lib().dabhost_eti_build_batch(
        n, fct0, fp0, ep, mid, sp, n_streams, fp_, fic_len, dp, subch_len,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)))
    if r != n * 6144:
        raise ValueError("ETI frame overflow")
    return out.tobytes()


def eti_build(fct: int, fp: int, err: int, mid: int, stc: bytes,
              n_streams: int, fic: bytes, subch: bytes) -> bytes:
    # empty, not zeros: dabhost_eti_build writes every byte (0x55 tail)
    out = np.empty(6144, dtype=np.uint8)
    sp, _ = _u8(stc)
    fic_p, fic_l = _u8(fic)
    dp, dl = _u8(subch)
    r = lib().dabhost_eti_build(
        fct, fp, err, mid, sp, n_streams, fic_p, fic_l, dp, dl,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)))
    if r != 6144:
        raise ValueError("ETI frame overflow")
    return out.tobytes()


def u8_to_cf32(u8: np.ndarray, scale: float = 64.0) -> np.ndarray:
    a = np.ascontiguousarray(np.frombuffer(bytes(u8), dtype=np.uint8))
    out = np.empty(a.size, dtype=np.float32)
    lib().dabhost_u8_to_cf32(
        a.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        a.size, scale)
    return out.view(np.complex64)


class IqRing:
    """Lock-free SPSC byte ring (the `upstream:sdr_fifo.c` equivalent)."""

    def __init__(self, capacity_pow2: int = 1 << 24):
        if capacity_pow2 & (capacity_pow2 - 1):
            raise ValueError("capacity must be a power of two")
        self._lib = lib()
        if self._lib is None:
            raise RuntimeError("native library unavailable")
        self._rb = self._lib.dabhost_ring_create(capacity_pow2)
        if not self._rb:
            raise MemoryError("ring allocation failed")

    def write(self, data) -> int:
        p, n = _u8(data)
        return int(self._lib.dabhost_ring_write(self._rb, p, n))

    def read(self, n: int) -> bytes:
        out = np.empty(n, dtype=np.uint8)
        got = self._lib.dabhost_ring_read(
            self._rb, out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), n)
        return out[:got].tobytes()

    @property
    def fill(self) -> int:
        return int(self._lib.dabhost_ring_fill(self._rb))

    @property
    def dropped(self) -> int:
        return int(self._lib.dabhost_ring_dropped(self._rb))

    def __del__(self):
        if getattr(self, "_rb", None):
            self._lib.dabhost_ring_free(self._rb)
            self._rb = None
