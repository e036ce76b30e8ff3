"""ctypes bindings for the native C++ layer.

The reference declared a liquid-compatible ``bsequence_*`` C ABI but left
every function unimplemented (/root/reference/c_shim/src/lib.rs). Here the
ABI is implemented for real in C++ (native/bsequence.cpp); this module loads
it and exposes a thin Python wrapper used by the conformance tests to prove
C-ABI parity with the Python BSequence.

Build: ``make -C native`` (auto-attempted on first import if g++ is present).
"""

from __future__ import annotations

import ctypes
import subprocess
from pathlib import Path

__all__ = ["load_native", "NativeBSequence", "native_available"]

_NATIVE_DIR = Path(__file__).resolve().parent.parent.parent / "native"
_LIB_PATH = _NATIVE_DIR / "libyagi_native.so"
_lib = None


def load_native(build_if_missing: bool = True):
    """Load (building if needed) the native shared library; None on failure."""
    global _lib
    if _lib is not None:
        return _lib
    if not _LIB_PATH.exists() and build_if_missing:
        try:
            subprocess.run(
                ["make", "-C", str(_NATIVE_DIR)],
                check=True,
                capture_output=True,
                timeout=120,
            )
        except Exception:
            return None
    if not _LIB_PATH.exists():
        return None
    lib = ctypes.CDLL(str(_LIB_PATH))
    lib.bsequence_create.restype = ctypes.c_void_p
    lib.bsequence_create.argtypes = [ctypes.c_uint]
    lib.bsequence_destroy.argtypes = [ctypes.c_void_p]
    lib.bsequence_reset.argtypes = [ctypes.c_void_p]
    lib.bsequence_push.argtypes = [ctypes.c_void_p, ctypes.c_uint]
    lib.bsequence_init.argtypes = [ctypes.c_void_p, ctypes.c_char_p]
    lib.bsequence_circshift.argtypes = [ctypes.c_void_p]
    lib.bsequence_correlate.restype = ctypes.c_int
    lib.bsequence_correlate.argtypes = [ctypes.c_void_p, ctypes.c_void_p]
    lib.bsequence_add.argtypes = [ctypes.c_void_p] * 3
    lib.bsequence_mul.argtypes = [ctypes.c_void_p] * 3
    lib.bsequence_accumulate.restype = ctypes.c_uint
    lib.bsequence_accumulate.argtypes = [ctypes.c_void_p]
    lib.bsequence_get_length.restype = ctypes.c_uint
    lib.bsequence_get_length.argtypes = [ctypes.c_void_p]
    lib.bsequence_index.restype = ctypes.c_uint
    lib.bsequence_index.argtypes = [ctypes.c_void_p, ctypes.c_uint]
    lib.bsequence_create_ccodes.restype = ctypes.c_int
    lib.bsequence_create_ccodes.argtypes = [ctypes.c_void_p, ctypes.c_void_p]
    _lib = lib
    return lib


def native_available() -> bool:
    return load_native() is not None


class NativeBSequence:
    """Python handle over the C ABI (mirrors liquid's bsequence object)."""

    def __init__(self, num_bits: int):
        self._lib = load_native()
        if self._lib is None:
            raise RuntimeError("native library unavailable (g++ build failed?)")
        self._q = self._lib.bsequence_create(num_bits)
        if not self._q:
            raise ValueError("invalid bsequence length")

    def __del__(self):
        if getattr(self, "_q", None) and self._lib is not None:
            self._lib.bsequence_destroy(self._q)
            self._q = None

    def push(self, bit: int) -> None:
        self._lib.bsequence_push(self._q, bit)

    def init(self, data: bytes) -> None:
        self._lib.bsequence_init(self._q, data)

    def circshift(self) -> None:
        self._lib.bsequence_circshift(self._q)

    def correlate(self, other: "NativeBSequence") -> int:
        return self._lib.bsequence_correlate(self._q, other._q)

    def accumulate(self) -> int:
        return self._lib.bsequence_accumulate(self._q)

    def get_length(self) -> int:
        return self._lib.bsequence_get_length(self._q)

    def index(self, i: int) -> int:
        return self._lib.bsequence_index(self._q, i)

    def add(self, other: "NativeBSequence") -> "NativeBSequence":
        out = NativeBSequence(self.get_length())
        self._lib.bsequence_add(self._q, other._q, out._q)
        return out

    def mul(self, other: "NativeBSequence") -> "NativeBSequence":
        out = NativeBSequence(self.get_length())
        self._lib.bsequence_mul(self._q, other._q, out._q)
        return out

    @classmethod
    def create_ccodes(cls, num_bits: int):
        a = cls(num_bits)
        b = cls(num_bits)
        rc = a._lib.bsequence_create_ccodes(a._q, b._q)
        if rc != 0:
            raise ValueError("invalid ccode length")
        return a, b


def _bind_iq_loader(lib) -> None:
    import numpy as _np  # noqa: F401 (ctypes pointers built per call)

    lib.iql_open.restype = ctypes.c_void_p
    lib.iql_open.argtypes = [
        ctypes.c_char_p, ctypes.c_int, ctypes.c_long, ctypes.c_int,
    ]
    lib.iql_next.restype = ctypes.c_long
    lib.iql_next.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p]
    lib.iql_total_read.restype = ctypes.c_long
    lib.iql_total_read.argtypes = [ctypes.c_void_p]
    lib.iql_close.argtypes = [ctypes.c_void_p]


class IqStreamLoader:
    """Native double-buffered IQ capture reader (native/iq_loader.cpp).

    Background C++ thread reads interleaved IQ from disk and deinterleaves
    into planar f32 blocks — the exact boundary format the device runtime
    requires (utils/planar.py) — so Python only blocks when the disk can't
    keep up with the device. Formats: "cf32", "ci16" (÷32768), "cu8"
    (offset-128, ÷128).

    >>> with IqStreamLoader(path, "ci16", block_samples=1 << 17) as src:
    ...     for re, im in src:
    ...         step(chain, re, im)
    """

    _FORMATS = {"cf32": 0, "ci16": 1, "cu8": 2}

    def __init__(self, path, fmt: str = "cf32", block_samples: int = 1 << 17,
                 n_buffers: int = 4):
        import numpy as np

        self._np = np
        self._lib = load_native()
        if self._lib is None:
            raise RuntimeError("native library unavailable (g++ build failed?)")
        if not hasattr(self._lib, "_iql_bound"):
            _bind_iq_loader(self._lib)
            self._lib._iql_bound = True
        if fmt not in self._FORMATS:
            raise ValueError(f"unknown IQ format {fmt!r}")
        self.block_samples = int(block_samples)
        self._h = self._lib.iql_open(
            str(path).encode(), self._FORMATS[fmt], self.block_samples,
            int(n_buffers),
        )
        if not self._h:
            raise OSError(f"cannot open IQ stream {path!r}")

    def next_block(self):
        """(re, im) float32 arrays of ≤ block_samples; (None, None) at EOF."""
        np = self._np
        re = np.empty(self.block_samples, np.float32)
        im = np.empty(self.block_samples, np.float32)
        n = self._lib.iql_next(
            self._h,
            re.ctypes.data_as(ctypes.c_void_p),
            im.ctypes.data_as(ctypes.c_void_p),
        )
        if n <= 0:
            return None, None
        return re[:n], im[:n]

    def total_read(self) -> int:
        return self._lib.iql_total_read(self._h)

    def __iter__(self):
        while True:
            re, im = self.next_block()
            if re is None:
                return
            yield re, im

    def close(self) -> None:
        if getattr(self, "_h", None):
            self._lib.iql_close(self._h)
            self._h = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def __del__(self):
        self.close()
