"""Synthetic m22000 fixture builders (known-PSK hashlines).

Hashlines are generated from the oracle (``oracle/m22000.py``), so the
challenge gate and the tests never depend on captured data: build an
EAPOL-Key frame, derive the real MIC for the chosen PSK, then serialize
the line the way a capture converter would.  The capture builders below
wrap such handshakes in pcap/pcapng containers, the server tests' source
of fake submissions.
"""

import hashlib
import struct

import numpy as np
import torch

from .models import hashline as hl
from .oracle import m22000 as oracle


def _rand(seed: str, n: int) -> bytes:
    """Deterministic pseudo-random bytes (stable fixtures, no RNG state)."""
    out = b""
    i = 0
    while len(out) < n:
        out += hashlib.sha256(f"{seed}:{i}".encode()).digest()
        i += 1
    return out[:n]


def make_pmkid_line(psk: bytes, essid: bytes, seed: str = "pmkid",
                    mac_ap: bytes = None, mac_sta: bytes = None) -> str:
    """A PMKID hashline whose PSK is ``psk``."""
    mac_ap = mac_ap or _rand(seed + "ap", 6)
    mac_sta = mac_sta or _rand(seed + "sta", 6)
    pmk = oracle.pmk_from_psk(psk, essid)
    pmkid = oracle.compute_pmkid(pmk, mac_ap, mac_sta)
    return hl.serialize(hl.TYPE_PMKID, pmkid, mac_ap, mac_sta, essid, message_pair=1)


def build_eapol_m2(key_information: int, snonce: bytes, key_data: bytes = b"") -> bytes:
    """A structurally-valid EAPOL-Key (message 2) frame with a zeroed MIC.

    Layout per IEEE 802.1X / 802.11i: version, type=3 (Key), BE length,
    descriptor type, key_information at offset 5 (where the verifier reads
    it), snonce at 17:49, zero MIC at 81:97.
    """
    body = struct.pack(
        ">BHH8s32s16s8s8s16sH",
        2,                      # descriptor type (RSN)
        key_information,
        0,                      # key length (0 in M2)
        b"\x00" * 7 + b"\x01",  # replay counter
        snonce,
        b"\x00" * 16,           # key IV
        b"\x00" * 8,            # key RSC
        b"\x00" * 8,            # key ID
        b"\x00" * 16,           # MIC (zeroed for MIC computation/storage)
        len(key_data),
    ) + key_data
    return struct.pack(">BBH", 2, 3, len(body)) + body


def make_eapol_line(
    psk: bytes,
    essid: bytes,
    keyver: int = 2,
    nc_delta: int = 0,
    endian: str = "LE",
    message_pair: int = 0x00,
    seed: str = "eapol",
    key_data: bytes = None,
    mac_ap: bytes = None,
    mac_sta: bytes = None,
) -> str:
    """An EAPOL hashline whose PSK is ``psk``.

    ``nc_delta``/``endian`` simulate a nonce-incrementing router: the MIC is
    derived from the *corrected* AP nonce while the line stores the captured
    one, so a verifier must apply +nc_delta (re-packed per ``endian``) to
    match — the reference's nonce-error-correction semantics.
    """
    mac_ap = mac_ap or _rand(seed + "ap", 6)
    mac_sta = mac_sta or _rand(seed + "sta", 6)
    anonce_rec = _rand(seed + "anonce", 32)
    snonce = _rand(seed + "snonce", 32)
    if key_data is None:
        key_data = _rand(seed + "rsnie", 22)

    key_information = {1: 0x0109, 2: 0x010A, 3: 0x010B}[keyver]
    eapol = build_eapol_m2(key_information, snonce, key_data)

    # The nonce the router actually used (what the MIC is computed over).
    anonce_real = anonce_rec
    if nc_delta:
        fmt = "<I" if endian == "LE" else ">I"
        last = struct.unpack_from(fmt, anonce_rec, 28)[0]
        anonce_real = anonce_rec[:28] + struct.pack(fmt, (last + nc_delta) & 0xFFFFFFFF)
        message_pair |= hl.MP_NC_NEEDED

    pmk = oracle.pmk_from_psk(psk, essid)
    if mac_ap < mac_sta:
        m = mac_ap + mac_sta
    else:
        m = mac_sta + mac_ap
    if snonce[:6] < anonce_real[:6]:
        n = snonce + anonce_real
    else:
        n = anonce_real + snonce
    mic = oracle.compute_mic(pmk, keyver, m, n, eapol)

    return hl.serialize(
        hl.TYPE_EAPOL, mic, mac_ap, mac_sta, essid, anonce_rec, eapol, message_pair
    )


# ---------------------------------------------------------------------------
# Planted nets for the crack step's verify (K3 and its plain version)
# ---------------------------------------------------------------------------

#: Verify test cases: (keyver, EAPOL key data, AP nonce offset) of three
#: nets each, with the exact nonce, an LE and a BE nonce correction
#: (``VERIFY_NC``).  Keyver 100 is PMKID.  29 key-data bytes make keyver
#: 3's EAPOL frame a multiple of 16 bytes, so its last CMAC block is
#: complete (F = 7); 157 make 16 blocks, complete (F = 15), and 160 make
#: 17, the last padded (F = 16).  The offset, 0 or 32, is where the AP
#: nonce sits in the PRF's nonce pair: at 0 an LE correction changes keyver
#: 1/2's PRF block 0.  None takes whichever the seed gives.
VERIFY_CASES = {"pmkid": (100, None, None), "kv1": (1, None, None), "kv2": (2, None, None),
                "kv3": (3, None, None), "kv3_complete": (3, b"\x30" * 29, None),
                "kv1_ap0": (1, None, 0), "kv1_ap32": (1, None, 32),
                "kv2_ap0": (2, None, 0), "kv2_ap32": (2, None, 32),
                "kv3_ap0": (3, None, 0), "kv3_ap32": (3, None, 32),
                "kv3_f15": (3, b"\x41" * 157, 32), "kv3_f16": (3, b"\x42" * 160, 0)}
VERIFY_NC = [(0, ""), (2, "LE"), (-3, "BE")]


def verify_case_specs(case):
    """The three net specs ``(keyver, nc_delta, endian, key_data,
    ap_off)`` of a :data:`VERIFY_CASES` case."""
    keyver, key_data, ap_off = VERIFY_CASES[case]
    return [(keyver, nc, endian, key_data, ap_off) for nc, endian in VERIFY_NC]


def verify_lines(specs, essid, tag):
    """One hashline per spec ``(keyver, nc_delta, endian, key_data[,
    ap_off])``, each with its own PSK ``<tag>-<i>``: a PMKID line for
    keyver 100, else an EAPOL line whose MIC needs the nonce correction
    ``nc_delta`` (0: the exact nonce) and, if ``ap_off`` is given, whose
    AP nonce sits at that offset of the PRF's nonce pair (the first seed
    ``<tag>-<i>``, ``<tag>-<i>.1``, ... that puts it there).  ->
    [(line, psk)]."""
    out = []
    for i, (keyver, nc, endian, key_data, *rest) in enumerate(specs):
        ap_off = rest[0] if rest else None
        psk = b"%s-%02d" % (tag.encode(), i)
        if keyver == 100:
            out.append((make_pmkid_line(psk, essid, seed=f"{tag}-{i}"), psk))
            continue
        kw = dict(nc_delta=nc, endian=endian) if nc else {}
        for k in range(64):
            seed = f"{tag}-{i}" + (f".{k}" if k else "")
            line = make_eapol_line(psk, essid, keyver=keyver, seed=seed, key_data=key_data, **kw)
            if ap_off is None or oracle.nonce_pairs(hl.parse(line))[2] == ap_off:
                break
        else:
            raise ValueError(f"no seed of {tag}-{i} puts the AP nonce at {ap_off}")
        out.append((line, psk))
    return out


def short_cmac_net(net, psk, essid, msg):
    """Keyver 3 net ``net`` (PSK ``psk``) with its MIC taken over ``msg``
    (at most 16 bytes) in place of its EAPOL frame, under the exact
    nonce: a CMAC with no full block (F = 0), its last block complete
    when ``msg`` has 16 bytes.  ``prep_net`` never makes one (an EAPOL
    frame is longer than 16 bytes)."""
    import dataclasses

    mac_m, mac_n, _ = oracle.nonce_pairs(net.line)
    complete = len(msg) == 16
    last = msg if complete else msg + b"\x80" + b"\x00" * (15 - len(msg))
    mic = oracle.compute_mic(hashlib.pbkdf2_hmac("sha1", psk, essid, 4096, 32), 3,
                             mac_m, mac_n, msg)
    dev = net.prf_blocks.device

    def byte_values(data):
        return torch.tensor(list(data), dtype=torch.int32, device=dev)

    return dataclasses.replace(
        net, cmac_full=torch.zeros((0, 16), dtype=torch.int32, device=dev),
        cmac_last=byte_values(last), cmac_last_complete=complete, cmac_target=byte_values(mic))


def plant_pmks(pmk, essid, psks, columns):
    """Write PSK i's real PMK (big-endian words) into the uint32[8, B]
    matrix ``pmk`` at each column of ``columns[i]``.  -> {column: i}."""
    planted = {}
    for i, psk in enumerate(psks):
        words = np.frombuffer(hashlib.pbkdf2_hmac("sha1", psk, essid, 4096, 32), ">u4")
        for col in columns[i]:
            if col in planted:
                raise ValueError(f"column {col} planted twice")
            pmk[:, col] = words
            planted[col] = i
    return planted


def planted_hits(nets, specs, planted):
    """The (net, variant, column) hits a verify must find for
    :func:`plant_pmks`'s columns: each net's variant of its nonce
    correction (the exact nonce's for PMKID and ``nc_delta`` 0)."""
    def variant(i):
        nc, endian = specs[i][1:3]
        return 0 if nets[i].keyver == 100 else nets[i].variants.index(
            (nc, endian) if nc else (0, None))

    return {(i, variant(i), col) for col, i in planted.items()}


def stacked_consts(nets):
    """Nets of one verify part -> ``(kind, static, consts)``: their
    constants stacked on a net axis, then K3's derived constants
    (``ops/verify_prep.derive``), in the order of the kind's match
    function (``parallel/step._KINDS``)."""
    from .ops.verify_prep import derive
    from .parallel.step import _KINDS, _kind_of

    kind = _kind_of(nets[0])
    statics, fields, _ = _KINDS[kind]
    static = statics(nets[0])
    consts = [torch.stack([getattr(n, f) for n in nets]) for f in fields]
    return kind, static, consts + list(derive(kind, static, consts))


def plain_part(kind, static, pmk, consts):
    """A verify part through the plain version (``ops/verify.py``) on any
    device, shaped as ``_KINDS[kind]``'s match: what K3 is held to.  The
    derived constants after the fields, if ``consts`` has them, are not
    read."""
    from .ops import verify as vf
    from .parallel.step import _KINDS

    consts = consts[:len(_KINDS[kind][1])]

    if kind == "pmkid":
        return vf.pmkid_plain(pmk, *consts)[:, None]
    if kind == "cmac":
        return vf.eapol_cmac_match_plain(pmk, *consts, last_complete=static[0])
    return vf.eapol_match_plain(pmk, *consts, keyver=static[0])


# ---------------------------------------------------------------------------
# Synthetic captures (for testing the hcxpcapngtool-equivalent parser)
# ---------------------------------------------------------------------------


def _dot11_mgmt(subtype: int, dst: bytes, src: bytes, bssid: bytes, body: bytes):
    fc = (subtype << 4) | 0x00
    return struct.pack("<HH", fc, 0) + dst + src + bssid + struct.pack("<H", 0) + body


def _dot11_data_eapol(src: bytes, dst: bytes, bssid: bytes, eapol: bytes,
                      from_ds: bool):
    fc = 0x0008 | (0x0200 if from_ds else 0x0100)  # data frame, FromDS/ToDS
    if from_ds:
        a1, a2, a3 = dst, bssid, src
    else:
        a1, a2, a3 = bssid, src, dst
    hdr = struct.pack("<HH", fc, 0) + a1 + a2 + a3 + struct.pack("<H", 0)
    llc = b"\xaa\xaa\x03\x00\x00\x00\x88\x8e"
    return hdr + llc + eapol


def build_eapol_key_frame(key_information: int, replay: int, nonce: bytes,
                          mic: bytes = b"\x00" * 16, key_data: bytes = b"") -> bytes:
    """A full EAPOL-Key frame (802.1X header + key descriptor)."""
    body = struct.pack(
        ">BHH8s32s16s8s8s16sH",
        2, key_information, 0,
        replay.to_bytes(8, "big"), nonce,
        b"\x00" * 16, b"\x00" * 8, b"\x00" * 8, mic, len(key_data),
    ) + key_data
    return struct.pack(">BBH", 2, 3, len(body)) + body


def beacon_frame(bssid: bytes, essid: bytes) -> bytes:
    body = b"\x00" * 12 + bytes([0, len(essid)]) + essid
    return _dot11_mgmt(8, b"\xff" * 6, bssid, bssid, body)


def probe_request_frame(sta: bytes, essid: bytes) -> bytes:
    body = bytes([0, len(essid)]) + essid
    return _dot11_mgmt(4, b"\xff" * 6, sta, b"\xff" * 6, body)


def pcap_bytes(frames, linktype: int = 105, endian: str = "<",
               nsec: bool = False, times=None) -> bytes:
    """Wrap raw 802.11 frames in a classic pcap container.

    ``endian``: '<' (the common case) or '>' (big-endian writer);
    ``nsec``: use the nanosecond-resolution magic.  ``times``: per-frame
    epoch seconds (float ok; default: 1 s apart) — the knob for
    exercising the --eapoltimeout pairing gate.  Exercises every
    container variant server/capture.py accepts.
    """
    magic = 0xA1B23C4D if nsec else 0xA1B2C3D4
    res = 1e9 if nsec else 1e6
    out = struct.pack(endian + "IHHiIII", magic, 2, 4, 0, 0, 65535, linktype)
    for i, fr in enumerate(frames):
        t = (1700000000 + i) if times is None else times[i]
        sec = int(t)
        sub = round((t - sec) * res)
        out += struct.pack(endian + "IIII", sec, sub, len(fr), len(fr)) + fr
    return out


def pcapng_bytes(frames, linktype: int = 105, endian: str = "<",
                 simple: bool = False, times=None) -> bytes:
    """Wrap frames in a pcapng container (SHB + IDB + EPB/SPB blocks).

    ``times``: per-frame epoch seconds for EPBs (default 1 s apart,
    microsecond units — the pcapng default resolution); SPBs carry no
    timestamp by design."""
    def block(btype: int, body: bytes) -> bytes:
        pad = (-len(body)) % 4
        total = 12 + len(body) + pad
        return (struct.pack(endian + "II", btype, total) + body + b"\x00" * pad
                + struct.pack(endian + "I", total))

    bom = struct.pack(endian + "I", 0x1A2B3C4D)
    shb = block(0x0A0D0D0A, bom + struct.pack(endian + "HHq", 1, 0, -1))
    idb = block(0x00000001, struct.pack(endian + "HHI", linktype, 0, 65535))
    out = shb + idb
    for i, fr in enumerate(frames):
        if simple:
            out += block(0x00000003, struct.pack(endian + "I", len(fr)) + fr)
        else:
            t = (1700000000 + i) if times is None else times[i]
            units = round(t * 1e6)
            body = struct.pack(endian + "IIIII", 0, (units >> 32) & 0xFFFFFFFF,
                               units & 0xFFFFFFFF, len(fr), len(fr)) + fr
            out += block(0x00000006, body)
    return out


def radiotap_wrap(frames, rt_len: int = 8):
    """Prepend a minimal radiotap header (DLT 127) to each frame."""
    hdr = struct.pack("<BBHI", 0, 0, rt_len, 0).ljust(rt_len, b"\x00")
    return [hdr + fr for fr in frames]


def ppi_wrap(frames, ppi_len: int = 8):
    """Prepend a minimal PPI header (DLT 192) to each frame."""
    hdr = struct.pack("<BBHI", 0, 0, ppi_len, 105).ljust(ppi_len, b"\x00")
    return [hdr + fr for fr in frames]


def make_handshake_frames(psk: bytes, essid: bytes, seed: str = "cap",
                          with_pmkid: bool = True, probes=()) -> tuple:
    """Raw 802.11 frames (beacon + probes + M1 + M2) for a known PSK.

    Returns (frames, expected_hashline_count); wrap with ``pcap_bytes`` /
    ``pcapng_bytes`` / ``radiotap_wrap`` to exercise a container path.
    The M2 MIC is real (derived from the PSK via the oracle) so
    end-to-end ingest->crack tests can recover ``psk``.
    """
    mac_ap = _rand(seed + "ap", 6)
    mac_sta = _rand(seed + "sta", 6)
    anonce = _rand(seed + "anonce", 32)
    snonce = _rand(seed + "snonce", 32)
    pmk = oracle.pmk_from_psk(psk, essid)

    key_data_m1 = b""
    expected = 1
    if with_pmkid:
        pmkid = oracle.compute_pmkid(pmk, mac_ap, mac_sta)
        key_data_m1 = b"\xdd\x14\x00\x0f\xac\x04" + pmkid
        expected = 2

    m1 = build_eapol_key_frame(0x008A, 1, anonce, key_data=key_data_m1)
    m2_zero = build_eapol_key_frame(0x010A, 1, snonce, key_data=_rand(seed + "rsn", 22))
    m = min(mac_ap, mac_sta) + max(mac_ap, mac_sta)
    n = snonce + anonce if snonce[:6] < anonce[:6] else anonce + snonce
    mic = oracle.compute_mic(pmk, 2, m, n, m2_zero)
    m2 = m2_zero[:81] + mic + m2_zero[97:]

    frames = [beacon_frame(mac_ap, essid)]
    frames += [probe_request_frame(_rand(seed + "p", 6), p) for p in probes]
    frames += [
        _dot11_data_eapol(mac_ap, mac_sta, mac_ap, m1, from_ds=True),
        _dot11_data_eapol(mac_sta, mac_ap, mac_ap, m2, from_ds=False),
    ]
    return frames, expected


def make_handshake_capture(psk: bytes, essid: bytes, seed: str = "cap",
                           with_pmkid: bool = True, probes=()) -> tuple:
    """``make_handshake_frames`` in a classic LE pcap container."""
    frames, expected = make_handshake_frames(
        psk, essid, seed=seed, with_pmkid=with_pmkid, probes=probes
    )
    return pcap_bytes(frames), expected
