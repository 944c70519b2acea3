"""Hashcat mask attack generator.

Pure-host enumeration of ``?d?l?u?s?a?b?h?H`` masks with literals — e.g.
``?d?d?d?d?d?d?d?d`` is the 8-digit brute sweep.  The generator yields in
hashcat's positional order (last position fastest) so keyspace slices
(skip/limit) line up with hashcat's ``-s``/``-l`` semantics for resume.

This is the host half of ``dwpa_tpu.gen.mask``; the on-device generator
(``MaskPrep``, ``mask_blocks``, ``device_mask_words``) is not ported yet.
"""

import string

CHARSETS = {
    "l": string.ascii_lowercase.encode(),
    "u": string.ascii_uppercase.encode(),
    "d": string.digits.encode(),
    "s": b" !\"#$%&'()*+,-./:;<=>?@[\\]^_`{|}~",
    "h": b"0123456789abcdef",
    "H": b"0123456789ABCDEF",
}
CHARSETS["a"] = CHARSETS["l"] + CHARSETS["u"] + CHARSETS["d"] + CHARSETS["s"]
CHARSETS["b"] = bytes(range(256))


def parse_mask(mask: str, custom: dict = None):
    """Mask string -> list of per-position byte alphabets."""
    custom = custom or {}
    out = []
    i = 0
    while i < len(mask):
        c = mask[i]
        if c == "?":
            if i + 1 >= len(mask):
                raise ValueError("dangling '?' in mask")
            key = mask[i + 1]
            if key == "?":
                out.append(b"?")
            elif key in "1234":
                out.append(custom[key])
            elif key in CHARSETS:
                out.append(CHARSETS[key])
            else:
                raise ValueError(f"unknown mask charset ?{key}")
            i += 2
        else:
            out.append(c.encode("latin1"))
            i += 1
    return out


def mask_keyspace(mask: str, custom: dict = None) -> int:
    n = 1
    for alpha in parse_mask(mask, custom):
        n *= len(alpha)
    return n


def mask_words(mask: str, custom: dict = None, skip: int = 0, limit: int = None):
    """Yield mask words; ``skip``/``limit`` slice the keyspace for resume.

    Odometer enumeration: the digit vector is seeded once from ``skip``
    (the only arbitrary-precision divmod walk), then each word is the
    previous one with a last-position-fastest increment — O(1) amortized
    carries per word instead of a full per-index divmod chain, which
    keeps the host parity-oracle legs in tests (and the no-device
    fallback) off the slow path.
    """
    alphas = parse_mask(mask, custom)
    total = mask_keyspace(mask, custom)
    end = total if limit is None else min(total, skip + limit)
    if skip >= end:
        return
    sizes = [len(a) for a in alphas]
    digits = mask_digits_at(mask, skip, custom)
    word = bytearray(alphas[p][digits[p]] for p in range(len(alphas)))
    last = len(alphas) - 1
    for _ in range(end - skip - 1):
        yield bytes(word)
        p = last
        while True:  # increment with carry, last position fastest
            d = digits[p] + 1
            if d < sizes[p]:
                digits[p] = d
                word[p] = alphas[p][d]
                break
            digits[p] = 0
            word[p] = alphas[p][0]
            p -= 1
    yield bytes(word)


def mask_digits_at(mask: str, idx: int, custom: dict = None):
    """Mixed-radix digit vector (last position fastest) for keyspace
    index ``idx`` — the host-side seed for the on-device generator
    (arbitrary-precision here, so keyspaces beyond 2^32 slice fine)."""
    alphas = parse_mask(mask, custom)
    digits = [0] * len(alphas)
    rem = idx
    for p in range(len(alphas) - 1, -1, -1):
        rem, digits[p] = divmod(rem, len(alphas[p]))
    return digits
