"""The plain reference: m22000 (WPA-PBKDF2-PMKID+EAPOL) in hashlib and Python.

It judges what the program under test reports and imports nothing of it.
``check_psk`` says whether a PSK cracks a hashline the way hashcat's mode
22000 with ``--nonce-error-corrections=N`` does: the PMK from PBKDF2-HMAC-
SHA1 (4096 iterations, the ESSID as salt), then the PMKID
(HMAC-SHA1(PMK, "PMK Name" | AP | STA)) or, for an EAPOL net, the PTK's
KCK and the MIC (keyver 1: HMAC-MD5, 2: HMAC-SHA1, 3: AES-128-CMAC over a
KCK from the SHA-256 KDF) over the AP nonce as captured and, unless the
message pair says the nonce is exact, with its last four bytes moved by
up to ``nc // 2 + 1`` in either byte order (the flags 0x20 / 0x40 limit
the order to little / big endian).

The same functions build the benchmark's hashlines (``eapol_m2``,
``mic``, ``pmkid``), so what a line holds and how it is judged come from
one place that the program does not share.
"""

import hashlib
import hmac
import struct

LABEL_V12 = b"Pairwise key expansion\x00"
LABEL_V3 = b"\x01\x00Pairwise key expansion"
MP_APLESS, MP_LE, MP_BE, MP_NC = 0x10, 0x20, 0x40, 0x80


def pmk(psk: bytes, essid: bytes) -> bytes:
    return hashlib.pbkdf2_hmac("sha1", psk, essid, 4096, 32)


def pmkid(pmk_: bytes, mac_ap: bytes, mac_sta: bytes) -> bytes:
    return hmac.new(pmk_, b"PMK Name" + mac_ap + mac_sta, hashlib.sha1).digest()[:16]


# -- AES-128 (encrypt only) and CMAC, FIPS-197 / RFC 4493 ----------------------


def _xtime(b):
    return ((b << 1) ^ 0x1B) & 0xFF if b & 0x80 else b << 1


def _sbox():
    # the multiplicative inverse in GF(2^8) from powers of the generator 3,
    # then the affine map
    exp, x = [], 1
    for _ in range(255):
        exp.append(x)
        x ^= _xtime(x)
    log = {v: i for i, v in enumerate(exp)}
    inv = [0] + [exp[(255 - log[a]) % 255] for a in range(1, 256)]
    out = []
    for v in inv:
        s = v
        for k in range(1, 5):
            s ^= ((v << k) | (v >> (8 - k))) & 0xFF
        out.append(s ^ 0x63)
    return out


SBOX = _sbox()


def _round_keys(key: bytes):
    words = [list(key[i:i + 4]) for i in range(0, 16, 4)]
    rcon = 1
    for i in range(4, 44):
        t = list(words[-1])
        if i % 4 == 0:
            t = [SBOX[t[1]] ^ rcon, SBOX[t[2]], SBOX[t[3]], SBOX[t[0]]]
            rcon = _xtime(rcon)
        words.append([a ^ b for a, b in zip(words[i - 4], t)])
    return [sum(words[4 * r:4 * r + 4], []) for r in range(11)]


def aes128_encrypt(key: bytes, block: bytes) -> bytes:
    rk = _round_keys(key)
    s = [b ^ k for b, k in zip(block, rk[0])]
    for r in range(1, 11):
        s = [SBOX[b] for b in s]
        s = [s[(i + 4 * (i % 4)) % 16] for i in range(16)]   # ShiftRows, column-major
        if r < 10:
            mixed = []
            for c in range(0, 16, 4):
                a = s[c:c + 4]
                t = a[0] ^ a[1] ^ a[2] ^ a[3]
                mixed += [a[i] ^ t ^ _xtime(a[i] ^ a[(i + 1) % 4]) for i in range(4)]
            s = mixed
        s = [b ^ k for b, k in zip(s, rk[r])]
    return bytes(s)


def _dbl(b: bytes) -> bytes:
    v = int.from_bytes(b, "big") << 1
    if b[0] & 0x80:
        v ^= 0x87
    return (v & ((1 << 128) - 1)).to_bytes(16, "big")


def aes_cmac(key: bytes, msg: bytes) -> bytes:
    k1 = _dbl(aes128_encrypt(key, bytes(16)))
    n = max(1, -(-len(msg) // 16))
    last = msg[16 * (n - 1):]
    if len(msg) and len(msg) % 16 == 0:
        last = bytes(a ^ b for a, b in zip(last, k1))
    else:
        last = (last + b"\x80").ljust(16, b"\x00")
        last = bytes(a ^ b for a, b in zip(last, _dbl(k1)))
    c = bytes(16)
    for i in range(n - 1):
        c = aes128_encrypt(key, bytes(a ^ b for a, b in zip(c, msg[16 * i:16 * i + 16])))
    return aes128_encrypt(key, bytes(a ^ b for a, b in zip(c, last)))


# -- EAPOL ----------------------------------------------------------------------


def eapol_m2(keyver: int, snonce: bytes, key_data: bytes) -> bytes:
    """An EAPOL-Key message 2 with a zero MIC: version 2, type 3, the key
    information of ``keyver`` (HMAC-MD5 / HMAC-SHA1 / AES-CMAC, pairwise,
    MIC set), replay counter 1, the station's nonce, ``key_data``."""
    body = struct.pack(">BHH8s32s16s8s8s16sH", 2, {1: 0x0109, 2: 0x010A, 3: 0x010B}[keyver],
                       0, b"\x00" * 7 + b"\x01", snonce, bytes(16), bytes(8), bytes(8),
                       bytes(16), len(key_data)) + key_data
    return struct.pack(">BBH", 2, 3, len(body)) + body


def key_pairs(mac_ap, mac_sta, anonce, snonce):
    """The PRF's MAC pair and nonce pair, each lower first, and the AP
    nonce's offset in the nonce pair (nonces ordered by their first 6
    bytes, as hashcat orders them)."""
    macs = mac_ap + mac_sta if mac_ap < mac_sta else mac_sta + mac_ap
    if snonce[:6] < anonce[:6]:
        return macs, snonce + anonce, 32
    return macs, anonce + snonce, 0


def mic(pmk_: bytes, keyver: int, macs: bytes, nonces: bytes, eapol: bytes) -> bytes:
    if keyver == 3:
        kck = hmac.new(pmk_, LABEL_V3 + macs + nonces + b"\x80\x01", hashlib.sha256).digest()[:16]
        return aes_cmac(kck, eapol)
    kck = hmac.new(pmk_, LABEL_V12 + macs + nonces + b"\x00", hashlib.sha1).digest()[:16]
    return hmac.new(kck, eapol, hashlib.md5 if keyver == 1 else hashlib.sha1).digest()[:16]


def nonce_variants(anonce: bytes, message_pair: int, nc: int):
    """The AP nonces a verifier tries: the captured one, then its last
    four bytes moved by 1 .. nc // 2 + 1 each way, in the byte orders the
    message pair allows."""
    out = [anonce]
    if message_pair & MP_APLESS:
        return out
    orders = [o for o, bit in (("<I", MP_LE), (">I", MP_BE)) if message_pair & bit] or ["<I", ">I"]
    for d in range(1, nc // 2 + 2):
        for fmt in orders:
            last = struct.unpack_from(fmt, anonce, 28)[0]
            for s in (d, -d):
                out.append(anonce[:28] + struct.pack(fmt, (last + s) & 0xFFFFFFFF))
    return out


# -- hashlines ---------------------------------------------------------------------


def parse_line(line: str) -> dict:
    f = line.split("*")
    if len(f) != 9 or f[0] != "WPA" or f[1] not in ("01", "02"):
        raise ValueError(f"not an m22000 line: {line[:40]}")
    net = {"type": int(f[1]), "target": bytes.fromhex(f[2]), "mac_ap": bytes.fromhex(f[3]),
           "mac_sta": bytes.fromhex(f[4]), "essid": bytes.fromhex(f[5])}
    if net["type"] == 2:
        net["anonce"], net["eapol"] = bytes.fromhex(f[6]), bytes.fromhex(f[7])
        net["message_pair"] = int(f[8] or "0", 16)
        net["keyver"] = struct.unpack_from(">H", net["eapol"], 5)[0] & 7
    return net


def check_psk(line: str, psk: bytes, nc: int) -> bool:
    """Whether ``psk`` cracks ``line`` (hashcat -m 22000
    --nonce-error-corrections=``nc``)."""
    net = parse_line(line)
    if not 8 <= len(psk) <= 63:
        return False
    key = pmk(psk, net["essid"])
    if net["type"] == 1:
        return pmkid(key, net["mac_ap"], net["mac_sta"]) == net["target"]
    snonce = net["eapol"][17:49]
    for anonce in nonce_variants(net["anonce"], net["message_pair"], nc):
        macs, nonces, _ = key_pairs(net["mac_ap"], net["mac_sta"], anonce, snonce)
        if mic(key, net["keyver"], macs, nonces, net["eapol"]) == net["target"]:
            return True
    return False
