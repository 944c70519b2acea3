"""IMEI-derived default-PSK candidates (imeigen-equivalent).

The reference client shells out to a local ``imeigen <ssid-prefix>`` binary
for ~70 mobile-hotspot SSID prefixes (help_crack/help_crack.py:667-687) —
many LTE hotspots ship with a default WPA key derived from the device IMEI
(typically its last 8 digits).  IMEIs are 15 digits: an 8-digit TAC (type
allocation code, per device model), a 6-digit serial, and a Luhn check
digit — so given a TAC the candidate space is only 10^6 serials, each
completed with the forced check digit.

This reimplements that as a host generator: TAC (or longer IMEI prefix)
-> enumerate the free digits -> append the Luhn digit -> emit the PSK
substring (default: last 8 digits, the common vendor scheme).
"""


def luhn_check_digit(digits: str) -> int:
    """Check digit making ``digits + d`` pass the Luhn mod-10 test."""
    total = 0
    # positions counted from the right of the final number; the check digit
    # itself is position 0, so digits here start at position 1 (doubled).
    for i, ch in enumerate(reversed(digits)):
        d = int(ch)
        if i % 2 == 0:
            d *= 2
            if d > 9:
                d -= 9
        total += d
    return (10 - total % 10) % 10


def imei_candidates(tac: str, psk_digits: int = 8, serial_range=None):
    """Yield PSK candidates for every valid IMEI with the given prefix.

    ``tac``: 8..14 leading digits of the IMEI.  ``serial_range``: optional
    (start, stop) over the free-digit space to shard the sweep.
    """
    tac = "".join(c for c in tac if c.isdigit())
    if not 8 <= len(tac) <= 14:
        raise ValueError("IMEI prefix must be 8..14 digits")
    free = 14 - len(tac)
    start, stop = serial_range or (0, 10 ** free)
    for serial in range(start, stop):
        body = tac + str(serial).zfill(free)
        imei = body + str(luhn_check_digit(body))
        yield imei[-psk_digits:].encode()
