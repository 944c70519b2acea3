"""ESSID-fingerprint targeted attacks — the DAW client's ``testtarget`` /
``imeigentest`` pass-1 logic (help_crack.py:615-687), redesigned for the
GPU engine.

The reference selects pre-built *dictionaries* per ESSID regex (netgear /
MySpectrum / digit10 / phome / tenda / EE / altice, help_crack.py:622-637)
because a GPU hashcat run wants files; here the same families are
*generators* feeding the device engine directly — an ISP default-key
scheme is a tiny grammar (word-word-digits, digit mask, IMEI tail), and
the engine's throughput makes materializing it to disk pointless.

Each table entry is ``(compiled_regex, family_name, factory)`` where
``factory(match, essid) -> iterable[bytes]``.  Generators are bounded by
``budget`` so pass 1 stays a fixed slice of the work-unit pacing window
(the reference caps the same families by shipping fixed-size dicts).
"""

import itertools
import re

from ..gen.imei import imei_candidates
from ..gen.mask import mask_words
from ..gen.vendors import HOTSPOT_SSID_RE, MAC_TAIL_SSID_RE

# Compact word pools for the word-word-digits ISP schemes (NETGEAR's
# "adjective-noun-number" and Spectrum's similar scheme).  64x64x1000
# ~= 4M candidates — seconds on the engine.
ADJECTIVES = (
    "ancient breezy bright bumpy calm chilly classy cloudy crazy curly "
    "daily dizzy dusty fancy fast fluffy fresh fuzzy gentle giant happy "
    "heavy hungry icy jolly kind large lazy little lively lucky melodic "
    "mighty misty modern narrow noisy odd orange polite proud quaint "
    "quick quiet rapid rocky rough round royal shiny silent silky silly "
    "slow small smooth snowy strong sunny sweet swift tiny vast warm "
    "wild witty young"
).split()
NOUNS = (
    "apple balloon banana bird boat bolt breeze brook butter canoe cloud "
    "comet coral creek daisy deer desert diamond eagle fern field flower "
    "fog forest fox garden gate hill kayak koala lake leaf lion lotus "
    "meadow moon mountain nest ocean onion owl panda peach pearl pine "
    "planet pond prairie rabbit raven river road rose sea shoe sky snake "
    "squash star stream sun tiger trail tree unicorn valley wave zebra"
).split()


def word_word_digits(digits: int = 3, sep: str = ""):
    """NETGEAR/Spectrum-style adjective+noun+number candidates."""
    for a, n in itertools.product(ADJECTIVES, NOUNS):
        base = f"{a}{sep}{n}"
        for d in range(10 ** digits):
            yield f"{base}{d:0{digits}d}".encode()


def _hotspot_imeis(match, essid):
    """IMEI-derived keys for tethering SSIDs (imeigentest equivalent,
    help_crack.py:667-687): sweep common TACs' serial space."""
    from ..gen.vendors import HOTSPOT_TACS

    for tac in HOTSPOT_TACS:
        yield from imei_candidates(tac)


def _word_word_3(m, e):
    return word_word_digits(3)


#: (regex, family, factory) — first match wins, mirroring the reference's
#: if/elif chain (help_crack.py:622-637).  The Tenda/hotspot fingerprints
#: are shared with the server-side keygen dispatch (gen/vendors.py) so
#: client and server target the same SSIDs.
TARGET_TABLE = (
    (re.compile(rb"^NETGEAR\d\d$"), "netgear", _word_word_3),
    (re.compile(rb"^(MySpectrumWiFi|SpectrumSetup)"), "spectrum", _word_word_3),
    (re.compile(rb"^(2WIRE\d+|ATT\w+|CenturyLink\d+)$"), "digit10",
     lambda m, e: mask_words("?d" * 10, limit=10 ** 7)),
    (re.compile(rb"^PLDTHOME"), "phome",
     lambda m, e: (b"PLDTWIFI" + w for w in mask_words("?d" * 5))),
    (MAC_TAIL_SSID_RE, "digit8",
     lambda m, e: mask_words("?d" * 8, limit=10 ** 7)),
    (re.compile(rb"^EE-\w+"), "ee",
     lambda m, e: word_word_digits(2, sep="-")),
    (re.compile(rb"^(MyAltice|altice)"), "altice",
     lambda m, e: (f"{a}{d:04d}".encode()
                   for a, d in itertools.product(ADJECTIVES, range(10000)))),
    (HOTSPOT_SSID_RE, "imei", _hotspot_imeis),
)


def targeted_for_essid(essid: bytes, budget: int = 5_000_000):
    """-> (family_name, bounded candidate iterator) or (None, None)."""
    for rx, family, factory in TARGET_TABLE:
        m = rx.match(essid)
        if m:
            return family, itertools.islice(factory(m, essid), budget)
    return None, None


def targeted_candidates(essids, budget: int = 5_000_000):
    """Yield candidate bytes for every matched ESSID in a work unit.

    Dedup is by *factory* (the keyspace), not family label, so two
    families sharing a scheme (netgear/spectrum) stream it once — the
    PBKDF2 is per (candidate, essid) anyway, so one pass of a keyspace
    serves every matching net in the hash file."""
    from ..obs import default_registry

    matches = default_registry().counter(
        "dwpa_client_targeted_matches_total",
        "ESSID-fingerprint family matches streamed in pass 1")
    seen = set()
    for essid in essids:
        for rx, family, factory in TARGET_TABLE:
            m = rx.match(essid)
            if m and factory not in seen:
                seen.add(factory)
                matches.labels(family=family).inc()
                yield from itertools.islice(factory(m, essid), budget)
                break
