"""SHA-1 as batched int32-lane torch ops (FIPS 180-4).

One plain compression: the 80 rounds are a Python loop over int32
tensors of any (broadcastable) shape, with the message schedule grown as
a list.  Constant message words (Python ints, e.g. padding) fold on the
host.  This is the plain form behind the PBKDF2 reference and every
verify path; the PBKDF2 hot loop on the GPU runs in the CUDA kernel
(``csrc/pbkdf2_sha1.cu``) instead.

The hoisted 20-byte form (:func:`sha1_20_prologue` /
:func:`sha1_compress_20`) is the JAX package's PBKDF2 loop shape; the
op census (``ops/opcount.py``) counts it.
"""

from .common import rotl32, wadd, wrotl, wxor

# FIPS 180-4 initial state and stage constants.
IV = (0x67452301, 0xEFCDAB89, 0x98BADCFE, 0x10325476, 0xC3D2E1F0)
K0, K1, K2, K3 = 0x5A827999, 0x6ED9EBA1, 0x8F1BBCDC, 0xCA62C1D6


def _rounds(state, w, start=0):
    """SHA-1 rounds ``start``..79 over the (growing) schedule list ``w``.

    Returns the working variables, not yet added back into the state.
    Round ``t`` reads ``w[t]`` and appends the expanded schedule word for
    ``t >= 16``; constant-int words fold away.
    """
    a, b, c, d, e = state
    for t in range(start, 80):
        if t >= 16:
            w.append(wrotl(wxor(wxor(w[t - 3], w[t - 8]), wxor(w[t - 14], w[t - 16])), 1))
        if t < 20:
            f, k = d ^ (b & (c ^ d)), K0
        elif t < 40:
            f, k = b ^ c ^ d, K1
        elif t < 60:
            f, k = (b & c) | (d & (b ^ c)), K2
        else:
            f, k = b ^ c ^ d, K3
        tmp = wadd(rotl32(a, 5), f, e, k, w[t])
        a, b, c, d, e = tmp, a, rotl32(b, 30), c, d
    return a, b, c, d, e


def sha1_compress(state, block):
    """One SHA-1 compression.

    ``state``: 5 int32 tensors.  ``block``: 16 big-endian message words,
    each an int32 tensor (broadcast against the state) or a Python int.
    Returns the new 5-tuple state.
    """
    return tuple(s + x for s, x in zip(state, _rounds(state, list(block))))


def sha1_20_prologue(state):
    """The loop-invariant prefix of a 20-byte-message compression.

    In the PBKDF2 loop the HMAC pad states are fixed per candidate and
    only the 5 message words change, so every subexpression of rounds 0-4
    that depends on ``state`` alone is computed once: f0/f1 in full, the
    c-rotations of rounds 0-1 and the e+K addends of rounds 2-4.  Returns
    an opaque tuple for :func:`sha1_compress_20`.
    """
    a, b, c, d, e = state
    c0r = rotl32(b, 30)  # c after round 0; d at round 2; e at round 3
    a0r = rotl32(a, 30)  # c after round 1; d at round 3; e at round 4
    f0 = d ^ (b & (c ^ d))
    p0 = wadd(rotl32(a, 5), f0, e, K0)
    f1 = c ^ (a & (c0r ^ c))
    p1 = wadd(f1, d, K0)
    x2 = a0r ^ c0r
    return (state, c0r, a0r, p0, p1, x2, wadd(c, K0), wadd(c0r, K0), wadd(a0r, K0))


def sha1_compress_20(pro, m5):
    """One compression of a 20-byte message from a hoisted prologue.

    Bit-identical to ``sha1_compress(state, m5 + padding)`` for the
    PBKDF2/HMAC message shape (20-byte message, 84 bytes hashed), with
    rounds 0-4 reusing the values of :func:`sha1_20_prologue`.
    """
    state, c0r, a0r, p0, p1, x2, p2, p3, p4 = pro
    w0, w1, w2, w3, w4 = m5
    t0 = wadd(p0, w0)
    t1 = rotl32(t0, 5) + wadd(p1, w1)
    f2 = c0r ^ (t0 & x2)
    t2 = rotl32(t1, 5) + f2 + wadd(p2, w2)
    cv3 = rotl32(t0, 30)
    f3 = a0r ^ (t1 & (cv3 ^ a0r))
    t3 = rotl32(t2, 5) + f3 + wadd(p3, w3)
    cv4 = rotl32(t1, 30)
    f4 = cv3 ^ (t2 & (cv4 ^ cv3))
    t4 = rotl32(t3, 5) + f4 + wadd(p4, w4)
    # State entering round 5; schedule words 5..15 are the fixed padding.
    w = [w0, w1, w2, w3, w4, 0x80000000] + [0] * 9 + [84 * 8]
    out = _rounds((t4, t3, rotl32(t2, 30), cv4, cv3), w, start=5)
    return tuple(s + x for s, x in zip(state, out))
