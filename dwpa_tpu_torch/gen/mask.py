"""Hashcat mask attack generator.

Pure-host enumeration of ``?d?l?u?s?a?b?h?H`` masks with literals — e.g.
``?d?d?d?d?d?d?d?d`` is the 8-digit brute sweep.  The generator yields in
hashcat's positional order (last position fastest) so keyspace slices
(skip/limit) line up with hashcat's ``-s``/``-l`` semantics for resume.

``mask_blocks`` frames a keyspace slice as feed blocks that carry no
candidate bytes (``MaskPrep``); the engine generates each block on the
device with ``device_mask_words`` — the torch twin of
``dwpa_tpu.gen.mask``'s XLA generator.
"""

import string

import numpy as np

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


class MaskPrep:
    """Block prep marking a keyspace slice for ON-DEVICE generation.

    The mask analog of ``feed.framing.RulesPrep``: a ``Block`` carrying
    one of these owns the keyspace range ``[start, start + count)`` and
    materializes NO host-side bytes — ``M22000Engine._prepare_block``
    recognizes the ``mask_gen`` marker and runs ``device_mask_words`` on
    the engine's device.  This puts mask work behind the same framed-block
    interface as dict and rules feeds: ``crack_blocks`` schedules it with
    no new dispatch regime.
    """

    __slots__ = ("mask", "custom", "start")

    mask_gen = True

    def __init__(self, mask: str, custom: dict, start: int):
        self.mask = mask
        self.custom = custom
        self.start = start


def mask_blocks(mask: str, batch_size: int, skip: int = 0,
                limit: int = None, custom: dict = None):
    """Frame a mask keyspace slice into feed ``Block``s of ``MaskPrep``
    — same ``(offset, count)`` geometry as ``mask_words`` consumed
    through ``frame_blocks``, zero candidate bytes.  ``offset`` is the
    ABSOLUTE keyspace index (hashcat ``-s`` coordinates), so resume
    checkpoints interop with ``crack_mask(skip=...)``."""
    from ..feed.framing import Block

    total = mask_keyspace(mask, custom)
    end = total if limit is None else min(total, skip + limit)
    pos = skip
    while pos < end:
        n = min(batch_size, end - pos)
        yield Block(offset=pos, count=n, words=[],
                    prep=MaskPrep(mask, custom, pos))
        pos += n


def device_mask_words(mask: str, start: int, batch: int, custom: dict = None,
                      *, device=None):
    """int32[batch, W] packed HMAC key rows (uint32 bits) for ``batch``
    consecutive mask words starting at keyspace index ``start``, generated
    entirely on ``device`` (default ``cuda:0``): no host packing, no H2D
    of candidates.

    The host contributes only the O(positions) starting digit vector and
    the positions' alphabets (one small table, one copy).  On the device
    a carry chain over positions (last position fastest, matching
    ``mask_words`` order) runs in int64, so ``arange(batch) + digit`` can
    pass 2**31; digits map through each position's alphabet and the bytes
    pack big-endian into words, in int64 too, wrapped to int32 at the
    end.  The absolute keyspace index never reaches the device, only its
    per-position digits, so keyspaces beyond 2**64 slice fine.

    ``W`` is the engine's trimmed row width for words of this mask's
    fixed length (``models.m22000._trim_cols``: 4, 8 or 16 columns); the
    columns past it would be zero, and the PBKDF2 kernel rebuilds them.
    """
    import torch

    from ..models.m22000 import _trim_cols
    from ..parallel.device import resolve_device

    alphas = parse_mask(mask, custom)
    if len(alphas) > 63:
        raise ValueError(f"mask has {len(alphas)} positions; a WPA PSK "
                         "caps at 63")
    if not 0 < batch < 2**31:
        raise ValueError(f"batch {batch} outside (0, 2^31)")
    dev = resolve_device(device)
    digits = mask_digits_at(mask, start, custom)
    npos = len(alphas)
    cols = _trim_cols(npos)
    # Every position's alphabet in one table, built per call (no module
    # state) and copied once; position p's bytes start at offs[p].
    offs = np.cumsum([0] + [len(a) for a in alphas])
    table = torch.from_numpy(np.frombuffer(b"".join(alphas), np.uint8).astype(np.int64))
    if dev.type == "cuda":
        table = table.pin_memory().to(dev, non_blocking=True)
    carry = torch.arange(batch, dtype=torch.int64, device=dev)
    byte = torch.zeros((batch, 4 * cols), dtype=torch.int64, device=dev)
    for p in range(npos - 1, -1, -1):
        total = carry + digits[p]
        radix = len(alphas[p])
        byte[:, p] = table[total % radix + int(offs[p])]
        carry = total // radix
    b = byte.reshape(batch, cols, 4)
    words = (b[..., 0] << 24) | (b[..., 1] << 16) | (b[..., 2] << 8) | b[..., 3]
    return torch.where(words >= 1 << 31, words - (1 << 32), words).to(torch.int32)
