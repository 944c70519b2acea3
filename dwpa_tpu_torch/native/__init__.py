"""Native (C++) fast paths, loaded via ctypes.

``pack_fast`` is the candidate-feed fast path: ``$HEX[...]`` decode,
length filter and HMAC key-block packing fused in one C pass
(``pack_fast.cpp``, a copy of ``dwpa_tpu/native/pack_fast.cpp``).  The
shared library is built at first use by ``ops/_gxx.py`` into
``build/dwpa_tpu_torch/``; loading degrades gracefully
(``load_pack() -> None``) so every caller keeps the pure Python packer
as fallback — the native path is an optimization, never a requirement.

This is host code: it runs on the feed's producer threads and on the
engine's consumer thread alike, and touches no device.  ``CALLS`` counts
the batches it packed, so a run can show that the native path was taken.
"""

import ctypes
import subprocess
import threading
from pathlib import Path

_PACK_SRC = Path(__file__).resolve().parent / "pack_fast.cpp"
#: src path -> ctypes lib | None (None = build/load failed; cached so the
#: per-batch hot path never re-attempts a doomed g++ run)
_LIBS = {}
_LIBS_LOCK = threading.Lock()  # first use may come from any producer thread

#: Batches packed by :func:`pack_candidates_fast` in this process.
CALLS = 0
_CALLS_LOCK = threading.Lock()


def _load_lib(src: Path, configure, auto_build: bool = True):
    """Shared build-if-stale + CDLL + cache logic for every native lib.

    ``configure(lib)`` sets restype/argtypes.  Failures are cached as
    None — callers on hot paths fall back to Python exactly once.
    """
    from ..ops import _gxx

    with _LIBS_LOCK:
        if src in _LIBS:
            return _LIBS[src]
        lib = None
        try:
            so = _gxx.build(src) if auto_build else _gxx.library_path(src)
            lib = ctypes.CDLL(str(so))
            configure(lib)
        except (OSError, subprocess.CalledProcessError):
            lib = None
        _LIBS[src] = lib
        return lib


def _configure_pack(lib):
    lib.dwpa_pack.restype = ctypes.c_long
    lib.dwpa_pack.argtypes = [
        ctypes.c_char_p,
        ctypes.POINTER(ctypes.c_longlong), ctypes.POINTER(ctypes.c_longlong),
        ctypes.c_long, ctypes.c_int, ctypes.c_int,
        ctypes.POINTER(ctypes.c_uint32), ctypes.POINTER(ctypes.c_uint8),
    ]


def load_pack(auto_build: bool = True):
    """ctypes handle to the pack_fast library, or None if unavailable."""
    return _load_lib(_PACK_SRC, _configure_pack, auto_build)


def pack_candidates_fast(words, min_len: int, max_len: int,
                         capacity: int = None):
    """Fused unhex + length-filter + key-block pack over a word list.

    ``words``: list of bytes.  Returns ``(pw_words uint32[cap, 16],
    lens uint8[n], n)`` with accepted rows 0..n-1 packed and rows n..cap
    zero (cap = max(capacity, len(words)) — callers pass their batch
    target so the padding rows come for free), or None when the native
    library is unavailable or the input isn't a plain bytes list.
    """
    global CALLS
    import numpy as np

    lib = load_pack()
    if lib is None or not all(type(w) is bytes for w in words):
        return None
    count = len(words)
    blob = b"".join(words)
    lens_in = np.fromiter((len(w) for w in words), np.int64, count=count)
    offs = np.zeros(count, dtype=np.int64)
    if count > 1:
        np.cumsum(lens_in[:-1], out=offs[1:])
    cap = max(capacity or 0, count)
    out = np.zeros((cap, 16), dtype=np.uint32)
    out_lens = np.empty(count, dtype=np.uint8)
    n = lib.dwpa_pack(
        blob, offs.ctypes.data_as(ctypes.POINTER(ctypes.c_longlong)),
        lens_in.ctypes.data_as(ctypes.POINTER(ctypes.c_longlong)),
        count, min_len, max_len,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint32)),
        out_lens.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
    )
    if n < 0:
        return None
    with _CALLS_LOCK:
        CALLS += 1
    return out, out_lens[:n], int(n)
