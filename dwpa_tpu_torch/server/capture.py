"""pcap/pcapng -> m22000 hashline extraction (hcxpcapngtool-equivalent).

The reference system depends on the external C tool hcxpcapngtool for all
capture parsing (server ingestion common.php:481, backfills
misc/fill_pr.php:37, misc/enrich_pmkid.php:44).  This module implements the
same extraction natively:

- container parsing: classic pcap (usec/nsec magics, both endiannesses)
  and pcapng (SHB/IDB/EPB blocks);
- link layers: raw IEEE 802.11 (DLT 105), radiotap (DLT 127), PPI (192);
- 802.11: beacon / probe-response / association-request SSIDs (per-BSSID
  ESSID map, "--max-essids=1" semantics: keep the most frequent),
  probe-request SSIDs (the PROBEREQUEST sidecar output used for dynamic
  dictionaries, prdict.php), and EAPOL-Key frames;
- EAPOL-Key classification by key_info flags (M1..M4), PMKID harvesting
  from M1 key-data RSN KDEs, and message pairing by replay counter:
  M1+M2 (pair 0), M2+M3 (pair 2), M1+M4 / M3+M4 (pairs 1/3) when M4
  carries a nonzero SNONCE;
- m22000 serialization via models.hashline (format documented at
  web/common.php:114-155): EAPOL field = the STA message with its MIC
  zeroed, ANONCE from the AP message, message_pair low bits = pairing.

Pure host-side code — parsing throughput is irrelevant next to PBKDF2, so
clarity wins; a C++ fast path is only worth it for bulk archive re-parses.
"""

import struct
from collections import Counter, defaultdict
from dataclasses import dataclass, field

from ..models import hashline as hl

DLT_IEEE802_11 = 105
DLT_RADIOTAP = 127
DLT_PPI = 192

# EAPOL-Key key_information flags
KI_KEYVER = 0x0007
KI_PAIRWISE = 0x0008
KI_INSTALL = 0x0040
KI_ACK = 0x0080
KI_MIC = 0x0100
KI_SECURE = 0x0200


# ---------------------------------------------------------------------------
# Container readers -> iterable of (linktype, frame_bytes)
# ---------------------------------------------------------------------------


def _pcap_frames(data: bytes):
    magic = data[:4]
    if magic in (b"\xd4\xc3\xb2\xa1", b"\x4d\x3c\xb2\xa1"):
        endian = "<"
    elif magic in (b"\xa1\xb2\xc3\xd4", b"\xa1\xb2\x3c\x4d"):
        endian = ">"
    else:
        raise ValueError("not a pcap file")
    # The nanosecond-resolution magics (a1b23c4d and its byte swap).
    frac = 1e-9 if magic in (b"\xa1\xb2\x3c\x4d", b"\x4d\x3c\xb2\xa1") else 1e-6
    if len(data) < 24:
        return  # truncated global header: no frames, not a crash
    linktype = struct.unpack_from(endian + "I", data, 20)[0] & 0xFFFF
    off = 24
    while off + 16 <= len(data):
        sec, sub, caplen, _ = struct.unpack_from(endian + "IIII", data, off)
        off += 16
        if off + caplen > len(data):
            break
        yield linktype, sec + sub * frac, data[off : off + caplen]
        off += caplen


def _if_tsresol(body: bytes, endian: str) -> float:
    """Seconds per timestamp unit from an IDB's if_tsresol option (code 9,
    default 10^-6; high bit set means a power-of-two resolution)."""
    off = 8  # linktype(2) + reserved(2) + snaplen(4)
    while off + 4 <= len(body):
        code, ln = struct.unpack_from(endian + "HH", body, off)
        if code == 0:  # opt_endofopt
            break
        if code == 9 and ln >= 1 and off + 4 < len(body):
            v = body[off + 4]
            return 2.0 ** -(v & 0x7F) if v & 0x80 else 10.0 ** -(v & 0x7F)
        off += 4 + ln + ((-ln) % 4)
    return 1e-6


def _pcapng_frames(data: bytes):
    if data[:4] != b"\x0a\x0d\x0d\x0a":
        raise ValueError("not a pcapng file")
    endian = "<" if data[8:12] == b"\x4d\x3c\x2b\x1a" else ">"
    off = 0
    ifaces = []  # (linktype, seconds-per-ts-unit)
    while off + 12 <= len(data):
        btype, blen = struct.unpack_from(endian + "II", data, off)
        if blen < 12 or off + blen > len(data):
            break
        body = data[off + 8 : off + blen - 4]
        if btype == 0x00000001 and len(body) >= 2:  # IDB
            ifaces.append((struct.unpack_from(endian + "H", body, 0)[0],
                           _if_tsresol(body, endian)))
        elif btype == 0x00000006 and len(body) >= 20:  # EPB
            iface, tsh, tsl, caplen, _ = struct.unpack_from(
                endian + "IIIII", body, 0
            )
            frame = body[20 : 20 + caplen]
            lt, res = (ifaces[iface] if iface < len(ifaces)
                       else (DLT_IEEE802_11, 1e-6))
            yield lt, ((tsh << 32) | tsl) * res, frame
        elif btype == 0x00000003 and len(body) >= 4:  # Simple Packet Block
            lt = ifaces[0][0] if ifaces else DLT_IEEE802_11
            caplen = struct.unpack_from(endian + "I", body, 0)[0]
            yield lt, None, body[4 : 4 + caplen]  # SPB carries no timestamp
        off += blen


def iter_frames(data: bytes):
    """Yield (timestamp-seconds-or-None, 802.11-frame) from a pcap or
    pcapng blob.  The timestamp (epoch seconds, float) feeds the EAPOL
    pairing time gate; pcapng Simple Packet Blocks carry none."""
    if data[:4] == b"\x0a\x0d\x0d\x0a":
        src = _pcapng_frames(data)
    else:
        src = _pcap_frames(data)
    for lt, ts, frame in src:
        if lt == DLT_RADIOTAP:
            if len(frame) < 4:
                continue
            rtlen = struct.unpack_from("<H", frame, 2)[0]
            frame = frame[rtlen:]
        elif lt == DLT_PPI:
            if len(frame) < 4:
                continue
            pplen = struct.unpack_from("<H", frame, 2)[0]
            frame = frame[pplen:]
        elif lt != DLT_IEEE802_11:
            continue
        if frame:
            yield ts, frame


# ---------------------------------------------------------------------------
# 802.11 parsing
# ---------------------------------------------------------------------------


@dataclass
class EapolMsg:
    num: int                 # 1..4
    ap: bytes
    sta: bytes
    replay: int
    nonce: bytes
    key_information: int
    frame: bytes             # full EAPOL frame, MIC zeroed
    mic: bytes
    pmkids: list = field(default_factory=list)
    ts: float = None         # capture timestamp (epoch s), None if unknown


def _tagged_ssid(body: bytes, off: int):
    """Walk tagged parameters; return the SSID tag payload or None."""
    while off + 2 <= len(body):
        tag, ln = body[off], body[off + 1]
        if off + 2 + ln > len(body):
            return None
        if tag == 0:
            ssid = body[off + 2 : off + 2 + ln]
            return ssid if 0 < len(ssid) <= 32 and any(ssid) else None
        off += 2 + ln
    return None


def _parse_eapol_key(ap: bytes, sta: bytes, eapol: bytes):
    # 802.1X: ver(1) type(1) len(2); EAPOL-Key descriptor follows
    if len(eapol) < 95 + 4 or eapol[1] != 3:
        return None
    # Descriptor type must be RSN (2) or WPA (254); other 802.1X type-3
    # packets can carry a coincidental pairwise bit (hcxpcapngtool checks).
    if eapol[4] not in (2, 254):
        return None
    ki = struct.unpack_from(">H", eapol, 5)[0]
    if not ki & KI_PAIRWISE:
        return None
    replay = struct.unpack_from(">Q", eapol, 9)[0]
    nonce = eapol[17:49]
    mic = eapol[81:97]
    kd_len = struct.unpack_from(">H", eapol, 97)[0]
    key_data = eapol[99 : 99 + kd_len]

    ack, has_mic, secure = ki & KI_ACK, ki & KI_MIC, ki & KI_SECURE
    if ack and not has_mic:
        num = 1
    elif ack and has_mic:
        num = 3
    elif has_mic and not secure:
        num = 2
    else:
        num = 4

    pmkids = []
    if num in (1, 3):
        # RSN PMKID KDE: dd <len> 00 0f ac 04 <pmkid>
        off = 0
        while off + 2 <= len(key_data):
            t, ln = key_data[off], key_data[off + 1]
            chunk = key_data[off + 2 : off + 2 + ln]
            if (t == 0xDD and ln >= 20 and len(chunk) >= 20
                    and chunk[:4] == b"\x00\x0f\xac\x04"):
                pmkid = chunk[4:20]
                if any(pmkid) and pmkid != b"\xff" * 16:
                    pmkids.append(pmkid)
            off += 2 + ln

    zeroed = eapol[:81] + b"\x00" * 16 + eapol[97:]
    # truncate to the 802.1X-declared length (body + 4-byte header)
    declared = struct.unpack_from(">H", eapol, 2)[0] + 4
    zeroed = zeroed[: max(95, min(declared, len(zeroed)))]
    return EapolMsg(num, ap, sta, replay, nonce, ki, zeroed, mic, pmkids)


def parse_80211(frame: bytes):
    """One 802.11 frame -> ('essid'|'probe'|'eapol', payload) or None."""
    if len(frame) < 24:
        return None
    fc = struct.unpack_from("<H", frame, 0)[0]
    ftype = (fc >> 2) & 3
    subtype = (fc >> 4) & 0xF
    to_ds, from_ds = fc & 0x100, fc & 0x200
    a1, a2, a3 = frame[4:10], frame[10:16], frame[16:22]

    if ftype == 0:  # management
        body_off = 24
        if subtype in (8, 5):  # beacon / probe response
            ssid = _tagged_ssid(frame, body_off + 12)
            if ssid:
                return "essid", (a3, ssid)
        elif subtype == 4:  # probe request
            ssid = _tagged_ssid(frame, body_off)
            if ssid:
                return "probe", ssid
        elif subtype in (0, 2):  # assoc / reassoc request
            skip = 4 if subtype == 0 else 10
            ssid = _tagged_ssid(frame, body_off + skip)
            if ssid:
                return "essid", (a3, ssid)
        return None

    if ftype == 2:  # data
        hdr = 24
        if to_ds and from_ds:
            hdr += 6
        if subtype & 8:  # QoS
            hdr += 2
        if fc & 0x8000:  # order bit: HT control
            hdr += 4
        llc = frame[hdr : hdr + 8]
        if len(llc) < 8 or llc[:3] != b"\xaa\xaa\x03" or llc[6:8] != b"\x88\x8e":
            return None
        eapol = frame[hdr + 8 :]
        if to_ds:
            ap, sta = a1, a2
        elif from_ds:
            ap, sta = a2, a1
        else:
            ap, sta = a3, a2
        msg = _parse_eapol_key(ap, sta, eapol)
        if msg:
            return "eapol", msg
    return None


# ---------------------------------------------------------------------------
# Handshake assembly
# ---------------------------------------------------------------------------

# (sta_msg_num, ap_msg_num, replay_delta, message_pair) — replay_delta is
# ap.replay - sta.replay for a valid pairing
_PAIRINGS = [
    (2, 1, 0, 0x00),   # M1+M2
    (2, 3, 1, 0x02),   # M2+M3 (M3 carries the authenticated ANONCE)
    (4, 1, -1, 0x01),  # M1+M4
    (4, 3, 0, 0x03),   # M3+M4
]


#: Max inter-frame gap for M1/M2 (and the other pairings) to count as one
#: handshake exchange — the reference's hcxpcapngtool invocation passes
#: --eapoltimeout=30000 ms (web/common.php:481).  Without the gate, a long
#: capture in which replay counters recur across sessions can pair a MIC
#: with an ANONCE from a *different* exchange, emitting uncrackable junk.
EAPOL_TIMEOUT_S = 30.0


def extract_hashlines(blob: bytes, nc_hint: bool = True,
                      eapol_timeout: float = EAPOL_TIMEOUT_S):
    """Capture blob -> ([m22000 hashline str, ...], [probe-request ssid, ...]).

    Deduped: one PMKID line per (ap, sta, pmkid); the best EAPOL pairing
    per (ap, sta) in _PAIRINGS preference order, restricted to message
    pairs captured within ``eapol_timeout`` seconds of each other
    (frames without timestamps — pcapng SPBs — are never gated).
    """
    essids = defaultdict(Counter)       # ap -> Counter[ssid]
    probes = []
    ap_msgs = defaultdict(list)         # (ap, sta) -> [EapolMsg 1/3]
    sta_msgs = defaultdict(list)        # (ap, sta) -> [EapolMsg 2/4]
    ap_nonces = defaultdict(list)       # ap -> [anonce] in capture order
    pmkid_seen = set()
    pmkid_rows = []

    for ts, frame in iter_frames(blob):
        try:
            parsed = parse_80211(frame)
        except (struct.error, IndexError):
            continue
        if not parsed:
            continue
        kind, payload = parsed
        if kind == "essid":
            ap, ssid = payload
            essids[ap][ssid] += 1
        elif kind == "probe":
            if payload not in probes:
                probes.append(payload)
        else:
            msg = payload
            msg.ts = ts
            bucket = ap_msgs if msg.num in (1, 3) else sta_msgs
            bucket[(msg.ap, msg.sta)].append(msg)
            if msg.num in (1, 3):
                ap_nonces[msg.ap].append(msg.nonce)
            for pmkid in msg.pmkids:
                key = (msg.ap, msg.sta, pmkid)
                if key not in pmkid_seen:
                    pmkid_seen.add(key)
                    pmkid_rows.append((msg.ap, msg.sta, pmkid))

    def best_essid(ap):
        c = essids.get(ap)
        return c.most_common(1)[0][0] if c else None

    endian_cache = {}

    def endian_bits(ap):
        """Observed nonce-increment endianness -> MP_LE/MP_BE hint bits.

        hcxpcapngtool behavior: routers that increment the ANONCE between
        retransmissions reveal whether the counter's last 4 bytes step as
        little- or big-endian; the hint halves the verifier's NC search
        (models/m22000._nc_variants honors it).  Ambiguous evidence
        (both/neither) emits no hint — NC search stays two-sided.
        Memoized per AP: ap_nonces is frozen before any line is emitted.
        """
        if ap in endian_cache:
            return endian_cache[ap]
        le = be = False
        nonces = ap_nonces.get(ap, [])
        for a, b in zip(nonces, nonces[1:]):
            if a[:28] != b[:28] or a == b:
                continue
            for fmt, is_le in (("<I", True), (">I", False)):
                d = (struct.unpack(fmt, b[28:])[0]
                     - struct.unpack(fmt, a[28:])[0]) & 0xFFFFFFFF
                if d >= 0x80000000:
                    d -= 0x100000000
                if 0 < abs(d) <= 128:
                    if is_le:
                        le = True
                    else:
                        be = True
                    break
        bits = (hl.MP_LE if le else hl.MP_BE) if le != be else 0
        endian_cache[ap] = bits
        return bits

    lines = []
    for ap, sta, pmkid in pmkid_rows:
        essid = best_essid(ap)
        if essid:
            lines.append(
                hl.serialize(hl.TYPE_PMKID, pmkid, ap, sta, essid, message_pair=1)
            )

    for (ap, sta), stas in sta_msgs.items():
        essid = best_essid(ap)
        if not essid:
            continue
        aps = ap_msgs.get((ap, sta), [])
        done = False
        for sta_num, ap_num, delta, mp in _PAIRINGS:
            if done:
                break
            for sm in stas:
                if sm.num != sta_num or not any(sm.nonce):
                    continue
                for am in aps:
                    if am.num != ap_num or am.replay - sm.replay != delta:
                        continue
                    if (am.ts is not None and sm.ts is not None
                            and abs(am.ts - sm.ts) > eapol_timeout):
                        continue  # different exchanges, not a handshake
                    mp_final = mp | (0x80 if nc_hint else 0) | endian_bits(ap)
                    lines.append(
                        hl.serialize(
                            hl.TYPE_EAPOL, sm.mic, ap, sta, essid,
                            am.nonce, sm.frame, mp_final,
                        )
                    )
                    done = True
                    break
                if done:
                    break
    return lines, probes
