"""Torn-write / short-read filesystem fault injection.

The journal formats (found outbox, PMK store, dict cache, resume file)
all promise "a torn tail is skipped, not fatal".  These helpers produce
the torn states those promises are tested against — deterministic
primitives plus a seeded injector for soak-style sweeps.
"""

import os
import random


def tear_tail(path: str, nbytes: int) -> int:
    """Simulate a power loss mid-append: drop the last ``nbytes`` of the
    file (clamped to its size).  Returns the bytes actually removed."""
    size = os.path.getsize(path)
    cut = min(max(0, int(nbytes)), size)
    with open(path, "r+b") as f:
        f.truncate(size - cut)
    return cut


def flip_byte(path: str, offset: int) -> int:
    """Corrupt one byte in place (negative offsets index from the end)
    — the classic bit-rot a CRC frame must catch.  Returns the absolute
    offset flipped."""
    size = os.path.getsize(path)
    if offset < 0:
        offset += size
    if not 0 <= offset < size:
        raise ValueError(f"offset {offset} outside file of {size} bytes")
    with open(path, "r+b") as f:
        f.seek(offset)
        byte = f.read(1)
        f.seek(offset)
        f.write(bytes([byte[0] ^ 0xFF]))
    return offset


def short_read(path: str, nbytes: int) -> bytes:
    """Read as a crashing reader would: only the first ``nbytes``."""
    with open(path, "rb") as f:
        return f.read(max(0, int(nbytes)))


class FsFaultInjector:
    """Seeded sweep driver over the primitives above: each call draws
    its parameters from ``random.Random(seed)``, so a failing sweep
    index is reproducible from the seed alone."""

    def __init__(self, seed: int):
        self.seed = seed
        self._rng = random.Random(seed)
        self.log = []  # (op, path, arg)

    def tear(self, path: str, max_bytes: int = 64) -> int:
        cut = tear_tail(path, self._rng.randint(1, max(1, max_bytes)))
        self.log.append(("tear", path, cut))
        return cut

    def flip(self, path: str) -> int:
        size = os.path.getsize(path)
        if size == 0:
            raise ValueError(f"cannot flip a byte of empty {path}")
        off = flip_byte(path, self._rng.randrange(size))
        self.log.append(("flip", path, off))
        return off
