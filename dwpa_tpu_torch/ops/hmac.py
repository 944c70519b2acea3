"""HMAC over the batched word-list primitives.

The WPA pipeline only HMACs with keys <= 64 bytes (PSK <= 63, PMK = 32,
KCK = 16), so the key always fits one hash block and the ipad/opad
states are computed once per candidate (two compressions) and reused for
every message.

Message blocks arriving here are already padded on the host, with the
length field counting the 64-byte key block.  Words may be Python ints
(constants) or int32 tensors broadcast against the batch; the pad
states take the broadcast shape of the key block's tensors.
"""

from .common import iv_state, wxor
from .md5 import IV as MD5_IV, md5_compress
from .sha1 import IV as SHA1_IV, sha1_20_prologue, sha1_compress, sha1_compress_20
from .sha256 import IV as SHA256_IV, sha256_compress

IPAD = 0x36363636
OPAD = 0x5C5C5C5C


def _precompute(iv, compress, key_block):
    st = iv_state(iv, key_block)
    i = compress(st, [wxor(w, IPAD) for w in key_block])
    o = compress(st, [wxor(w, OPAD) for w in key_block])
    return i, o


def hmac_sha1_precompute(key_block):
    """key_block: 16 words (zero-padded key) -> (istate, ostate)."""
    return _precompute(SHA1_IV, sha1_compress, key_block)


def hmac_md5_precompute(key_block):
    return _precompute(MD5_IV, md5_compress, key_block)


def hmac_sha256_precompute(key_block):
    return _precompute(SHA256_IV, sha256_compress, key_block)


def _outer_sha1(ostate, inner_digest):
    # outer message = 20-byte digest; total hashed = 64 (key) + 20 = 84 bytes
    return sha1_compress(ostate, list(inner_digest) + [0x80000000] + [0] * 9 + [84 * 8])


def hmac_sha1_20(istate, ostate, m5):
    """HMAC-SHA1 of a 20-byte message given precomputed pad states: the
    PBKDF2 iteration shape, exactly two compressions."""
    inner = sha1_compress(istate, list(m5) + [0x80000000] + [0] * 9 + [84 * 8])
    return _outer_sha1(ostate, inner)


def hmac_sha1_20_prologue(istate, ostate):
    """The per-candidate loop-invariant work of :func:`hmac_sha1_20`, for
    :func:`hmac_sha1_20_hoisted` (the JAX package's PBKDF2 loop shape)."""
    return sha1_20_prologue(istate), sha1_20_prologue(ostate)


def hmac_sha1_20_hoisted(pro, m5):
    """HMAC-SHA1 of a 20-byte message from hoisted pad-state prologues;
    bit-identical to :func:`hmac_sha1_20` (the message and the inner
    digest are both 5 words)."""
    ipro, opro = pro
    return sha1_compress_20(opro, sha1_compress_20(ipro, m5))


def hmac_sha1_blocks(istate, ostate, msg_blocks):
    """HMAC-SHA1 over pre-padded message blocks (after the key block)."""
    st = istate
    for blk in msg_blocks:
        st = sha1_compress(st, blk)
    return _outer_sha1(ostate, st)


def hmac_md5_blocks(istate, ostate, msg_blocks):
    """HMAC-MD5 over pre-padded (little-endian word) message blocks."""
    st = istate
    for blk in msg_blocks:
        st = md5_compress(st, blk)
    # outer message = 16-byte digest (4 LE words); total = 64 + 16 = 80 bytes
    return md5_compress(ostate, list(st) + [0x80] + [0] * 9 + [80 * 8, 0])


def hmac_sha256_blocks(istate, ostate, msg_blocks):
    """HMAC-SHA256 over pre-padded message blocks."""
    st = istate
    for blk in msg_blocks:
        st = sha256_compress(st, blk)
    # outer message = 32-byte digest; total = 64 + 32 = 96 bytes
    return sha256_compress(ostate, list(st) + [0x80000000] + [0] * 6 + [96 * 8])
