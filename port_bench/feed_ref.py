"""A plain reference of the client's pass-2 dict feed at its defaults (no
dict cache), for checking what the feed hands the engine.

The feed's semantics: every word of every dict of a unit, in the unit's
order, once, in blocks of the batch.  Each ``.gz`` dict is read whole
with ``gzip`` and split on ``\\n`` alone; a line loses its trailing run
of ``\\r`` and ``\\n``, a line left empty is dropped, and a last line with
no newline still counts (the line rules ``DictStream`` documents).  The
unit's words are one stream, dict after dict; a resume ``skip`` drops
that many words from its head, and pass 2 cuts the rest into blocks of
``batch_size`` words by plain slicing, the first at offset ``skip``.  A
block may hold the tail of one dict and the head of the next.

Departures from what reaches the PBKDF2 kernel, on purpose: the feed
hands every word on as it is in the file, so words shorter than 8 or
longer than 63 bytes, and ``$HEX[...]`` words, stay here as they are
(the engine's packer drops the first two and decodes the third).

It imports nothing of the program.
"""

import gzip
import zlib


def dict_words(path) -> list:
    """The words of one gzipped dict, in file order."""
    with gzip.open(path, "rb") as f:
        lines = f.read().split(b"\n")
    return [w for w in (line.rstrip(b"\r\n") for line in lines) if w]


def blocks(paths, batch_size: int, skip: int = 0) -> list:
    """The unit's pass-2 blocks over the dicts at ``paths``: ``[(offset,
    count, words)]``."""
    words = [w for p in paths for w in dict_words(p)]
    return [(o, len(words[o:o + batch_size]), words[o:o + batch_size])
            for o in range(skip, len(words), batch_size)]


def words_crc(words) -> int:
    """CRC-32 of a block's words, each followed by a newline."""
    crc = 0
    for w in words:
        crc = zlib.crc32(w + b"\n", crc)
    return crc
