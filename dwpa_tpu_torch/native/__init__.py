"""Native (C++) fast paths, loaded via ctypes.

``pack_fast`` is the candidate-feed fast path: ``$HEX[...]`` decode,
length filter and HMAC key-block packing fused in one C pass
(``pack_fast.cpp``, a copy of ``dwpa_tpu/native/pack_fast.cpp``).
``capture_fast`` is the bulk pcap/pcapng -> m22000 extractor
(``capture_fast.cpp``, a copy of ``dwpa_tpu/native/capture_fast.cpp``),
the native seat the reference fills with hcxpcapngtool
(web/common.php:481).  Each shared library is built at first use by
``ops/_gxx.py`` into ``build/dwpa_tpu_torch/``; loading degrades
gracefully (``load_pack()`` / ``load()`` -> None) so every caller keeps
the pure Python packer or parser as fallback — the native path is an
optimization, never a requirement.

This is host code: it runs on the feed's producer threads, on the
engine's consumer thread and in the server's tools alike, and touches no
device.  ``CALLS`` counts the batches the packer packed, so a run can
show that the native path was taken.
"""

import ctypes
import subprocess
import threading
from pathlib import Path

_DIR = Path(__file__).resolve().parent
_SRC = _DIR / "capture_fast.cpp"
_PACK_SRC = _DIR / "pack_fast.cpp"
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


def _configure_capture(lib):
    lib.dwpa_extract.restype = ctypes.c_int
    lib.dwpa_extract.argtypes = [
        ctypes.c_char_p, ctypes.c_size_t, ctypes.c_int, ctypes.c_double,
        ctypes.POINTER(ctypes.c_char_p), ctypes.POINTER(ctypes.c_size_t),
    ]
    lib.dwpa_free.argtypes = [ctypes.c_char_p]


def load(auto_build: bool = True):
    """ctypes handle to the native capture library, or None."""
    return _load_lib(_SRC, _configure_capture, auto_build)


def extract_hashlines_fast(blob: bytes, nc_hint: bool = True,
                           eapol_timeout: float = 30.0):
    """Native twin of server.capture.extract_hashlines.

    Returns ([hashline str, ...], [probe ssid bytes, ...]); raises
    RuntimeError when the library is unavailable (callers select the
    fast path explicitly and fall back themselves).  ``eapol_timeout``
    mirrors hcxpcapngtool's --eapoltimeout pairing gate (seconds).
    """
    lib = load()
    if lib is None:
        raise RuntimeError("native capture parser unavailable (g++ build failed?)")
    out = ctypes.c_char_p()
    out_len = ctypes.c_size_t()
    rc = lib.dwpa_extract(blob, len(blob), int(nc_hint),
                          ctypes.c_double(eapol_timeout),
                          ctypes.byref(out), ctypes.byref(out_len))
    if rc != 0:
        raise RuntimeError(f"dwpa_extract failed: rc={rc}")
    try:
        text = ctypes.string_at(out, out_len.value)
    finally:
        lib.dwpa_free(out)
    lines, probes = [], []
    for rec in text.split(b"\n"):
        if rec.startswith(b"H "):
            lines.append(rec[2:].decode("ascii"))
        elif rec.startswith(b"P "):
            probes.append(bytes.fromhex(rec[2:].decode("ascii")))
    return lines, probes


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
    import numpy as np

    if load_pack() is None or not all(type(w) is bytes for w in words):
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
    n = pack_spans(blob, offs, lens_in, min_len, max_len, out, out_lens)
    if n is None:
        return None
    return out, out_lens[:n], n


def pack_spans(blob: bytes, offs, lens, min_len: int, max_len: int,
               out, out_lens):
    """The native pack of the words ``blob[offs[i]:offs[i] + lens[i]]``
    (``offs``/``lens`` contiguous int64 arrays) into ``out`` (zeroed
    uint32[>= n, 16]) and ``out_lens`` (uint8[>= n]): accepted rows
    from row 0 in order, as ``pack_candidates_fast`` packs a word list.
    -> the accepted count, or None when the native library is
    unavailable or refuses the arguments."""
    global CALLS

    lib = load_pack()
    if lib is None:
        return None
    n = lib.dwpa_pack(
        blob, offs.ctypes.data_as(ctypes.POINTER(ctypes.c_longlong)),
        lens.ctypes.data_as(ctypes.POINTER(ctypes.c_longlong)),
        len(offs), min_len, max_len,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint32)),
        out_lens.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
    )
    if n < 0:
        return None
    with _CALLS_LOCK:
        CALLS += 1
    return int(n)
