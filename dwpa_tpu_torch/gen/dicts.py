"""Streaming wordlist reading (plain or gzip) with md5 integrity checks.

Mirrors the reference client's dictionary handling: dicts arrive as
``.txt.gz`` files whose md5 must match the server's ``dicts.dhash``
(help_crack/help_crack.py:533-534); words are one candidate per line.
Reading is chunked so multi-GB dictionaries never fully materialize —
the host stays ahead of the device by yielding fixed-size batches.
"""

import gzip
import hashlib
import io

import numpy as np


def md5_file(path: str, chunk: int = 1 << 20) -> str:
    """Hex md5 of a file (the reference's dict integrity check)."""
    h = hashlib.md5()
    with open(path, "rb") as f:
        while True:
            b = f.read(chunk)
            if not b:
                return h.hexdigest()
            h.update(b)


class DictStream:
    """Iterate candidate byte-strings from a wordlist file or fileobj.

    Transparently gunzips (by magic, like the reference's valid_cap gz
    handling, web/common.php:454-456).  Strips line endings only; interior
    whitespace is significant.  ``skip``/``limit`` support keyspace
    slicing for resume.
    """

    def __init__(self, source, skip: int = 0, limit: int = None):
        self.source = source
        self.skip = skip
        self.limit = limit

    def _open(self):
        """-> (fileobj, owned_raw) — only close files this stream opened
        itself, so a caller-supplied fileobj stays usable for re-iteration
        (seekable sources are rewound instead)."""
        if isinstance(self.source, (str, bytes)):
            f = open(self.source, "rb")
            owns = True
        else:
            f = self.source
            owns = False
            if getattr(f, "seekable", lambda: False)():
                f.seek(0)
        # Sniff gzip on any peekable or seekable object, not just
        # BufferedReader.
        head = b""
        if hasattr(f, "peek"):
            head = f.peek(2)[:2]
        elif getattr(f, "seekable", lambda: False)():
            head = f.read(2)
            f.seek(0)
        if head == b"\x1f\x8b" or (
            isinstance(self.source, (str, bytes))
            and str(self.source).endswith(".gz")
        ):
            return gzip.open(f), (f if owns else None)
        return f, (f if owns else None)

    #: decompressed bytes per read — one gunzip call amortized over
    #: thousands of lines instead of the line iterator's per-line trips
    #: through the gzip object (bench: host_feed.dictstream_words_per_s)
    CHUNK = 1 << 18

    def _chunks(self):
        """The decompressed bytes, ``CHUNK`` at a time; the files this
        stream opened are closed when the generator is."""
        f, owned_raw = self._open()
        try:
            while chunk := f.read(self.CHUNK):
                yield chunk
        finally:
            if f is not self.source and f is not owned_raw:
                f.close()  # the gzip wrapper (never closes the underlying)
            if owned_raw is not None:
                owned_raw.close()

    def __iter__(self):
        # Chunked read + manual b"\n" split with a carry for the partial
        # tail.  Semantics are bit-identical to iterating the binary
        # fileobj line-by-line: lines split on b"\n" ONLY (a lone \r
        # stays inside its line), ``skip`` counts line indices INCLUDING
        # blank lines, ``limit`` counts yielded words, trailing \r/\n
        # runs are stripped, and a final line without a newline still
        # counts.
        skip, limit = self.skip, self.limit
        n = i = 0
        carry = b""
        for chunk in self._chunks():
            if carry:
                chunk = carry + chunk
            lines = chunk.split(b"\n")
            carry = lines.pop()
            for line in lines:
                if i < skip:
                    i += 1
                    continue
                i += 1
                if limit is not None and n >= limit:
                    return
                word = line.rstrip(b"\r\n")
                if word:
                    n += 1
                    yield word
        if carry and i >= skip and (limit is None or n < limit):
            word = carry.rstrip(b"\r\n")
            if word:
                yield word

    def spans(self):
        """The words as ``(buf, starts, lens)`` per decompressed chunk, in
        stream order: word ``k`` of a chunk is ``buf[starts[k]:starts[k]
        + lens[k]]`` (int64 arrays), under ``__iter__``'s line rules with
        no ``skip`` or ``limit``.  The cold feed's source: the lines are
        found with numpy, so no bytes object is made a word."""
        carry = b""
        for chunk in self._chunks():
            buf = carry + chunk if carry else chunk
            cut = buf.rfind(b"\n") + 1
            carry = buf[cut:]
            if cut:
                yield (buf, *line_spans(buf, cut))
        if carry:
            yield (carry, *line_spans(carry, len(carry)))

    def batches(self, size: int):
        """Yield lists of up to ``size`` words."""
        batch = []
        for w in self:
            batch.append(w)
            if len(batch) == size:
                yield batch
                batch = []
        if batch:
            yield batch


def line_spans(buf: bytes, end: int):
    """``(starts, lens)`` (int64) of the words of ``buf[:end]``: its lines
    split on ``\n`` alone, each without its trailing run of ``\r``, the
    empty ones dropped (``DictStream``'s line rules; ``end`` lies just past
    a newline, or at the end of a last line that has none)."""
    if end <= 0:
        return np.zeros(0, np.int64), np.zeros(0, np.int64)
    a = np.frombuffer(buf, np.uint8, count=end)
    nl = np.flatnonzero(a == 10)
    starts = np.concatenate(([0], nl + 1))
    ends = np.concatenate((nl, [end]))
    cr = np.flatnonzero((ends > starts) & (a[np.maximum(ends - 1, 0)] == 13))
    while cr.size:
        ends[cr] -= 1
        cr = cr[(ends[cr] > starts[cr]) & (a[np.maximum(ends[cr] - 1, 0)] == 13)]
    keep = ends > starts
    return starts[keep], (ends - starts)[keep]
