"""Targeted PSK candidates derived from the hash material itself
(hcxpsktool-equivalent).

The reference client falls back to ``hcxpsktool -c help_crack.hash -o
candidates.txt`` (help_crack/help_crack.py:643-646) to derive candidates
from the ESSID/MAC patterns of the target nets.  This generator covers the
same candidate families from first principles:

- the ESSID itself, case-mangled, and with common suffixes;
- digits embedded in the ESSID (zero-padded to the 8-char minimum);
- BSSID/STA-MAC derived strings: hex tails, decimalized, +/-1 neighbors
  (routers frequently default to a key printed from their own MAC);
- WPS-style 8-digit pins seeded from the MAC tail;
- 10-digit phone-number style candidates when the ESSID embeds one.

Everything is deduped and respects the 8..63-byte PSK constraint.
"""

import re


def _mac_variants(mac: bytes):
    h = mac.hex()
    for s in (h, h.upper(), h[4:], h[4:].upper(), h[6:], h[6:].upper()):
        yield s
    asint = int(h, 16)
    for delta in (-1, 1):
        yield format((asint + delta) & 0xFFFFFFFFFFFF, "012x")
    # decimalized tail (zero-padded into pin-like widths)
    tail = int(h[6:], 16)
    for width in (8, 10):
        yield str(tail % 10**width).zfill(width)


def psk_candidates(essid: bytes, mac_ap: bytes = None, mac_sta: bytes = None):
    """Yield deduped candidate PSKs (8..63 bytes) for one net."""
    seen = set()

    def emit(cand):
        if isinstance(cand, str):
            cand = cand.encode("latin1", "ignore")
        if 8 <= len(cand) <= 63 and cand not in seen:
            seen.add(cand)
            return cand
        return None

    out = []

    def push(c):
        e = emit(c)
        if e is not None:
            out.append(e)

    text = essid.decode("latin1")
    for base in (text, text.lower(), text.upper(), text.capitalize()):
        push(base)
        for suffix in ("1", "123", "1234", "12345", "123456", "2024", "2023", "!"):
            push(base + suffix)
    # digit runs inside the ESSID, raw and zero-padded
    for run in re.findall(r"\d{4,}", text):
        push(run)
        push(run.zfill(8))
        push((run * 3)[:8])
    # 10-digit phone-like content (strip separators first)
    stripped = re.sub(r"[^0-9]", "", text)
    if len(stripped) >= 10:
        push(stripped[-10:])
        push(stripped[:10])
    for mac in (mac_ap, mac_sta):
        if not mac:
            continue
        for v in _mac_variants(mac):
            push(v)
            push(text + v[-4:])
    yield from out
