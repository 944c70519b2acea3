"""Deployment-data vendor keygen families (routerkeygen data packs).

routerkeygen-cli bundles ISP-specific constant tables (alice.xml, magic
seeds, serial maps) next to its algorithms; the reference server just
invokes the binary (web/rkg.php:109).  Most routerkeygen families not
implemented natively in ``gen/vendors.py`` differ from an implemented
one only in DATA — a magic string, a charset, a MAC-substring recipe, a
serial table — which this offline build cannot reproduce faithfully
(fabricated constants would emit garbage candidates and waste verify
PBKDF2s).  This module implements the four algorithm ARCHETYPES those
families reduce to, driven entirely by a deployment-supplied JSON pack,
so an operator holding the real tables gets the remaining routerkeygen
surface with zero code changes.  PARITY.md carries the per-family
classification (implemented / needs-data / obsolete).

Pack format — JSON ``{"families": [entry, ...]}``; every entry has:

- ``name``     — algo label recorded in the ``rkg`` table;
- ``ssid_re``  — regex matched (``re.match``) against the SSID bytes;
  capture groups are referenced by hash_map inputs as ``@ssid_group1``…;
- ``kind`` + kind-specific fields:

``fixed``      — ``{"keys": ["...", ...]}``: constant factory keys
  (the Andared-style single-key networks); every key must be a
  non-empty string (validated at load).
``mac_map``    — ``{"slices": [[s, e], ...], "case": "lower"|"upper",
  "prefix": "", "suffix": "", "offsets": [0, 1, -1]}``: the key is a
  concatenation of substrings of the 12-char MAC hex (Megared/Conn/
  InterCable archetype, BSSID neighbourhood swept via ``offsets``).
``hash_map``   — ``{"hash": "md5"|"sha1"|"sha256",
  "input": [token, ...], "skip": 0, "take": N,
  "charset": "hex"|"HEX"|"<alphabet>", "group_bits": 0,
  "offsets": [0]}``: digest over the concatenated input tokens,
  rendered as hex, by indexing an alphabet with each digest byte, or —
  with ``group_bits`` — by consuming the digest as a bitstream in
  N-bit groups (the 5-bit base-32 rendering several ISP schemes use)
  and indexing the alphabet with each group (the Zyxel/Sky/Fastweb/
  Arnet/Meo archetype).  Tokens: a literal string, ``@mac``/``@MAC``
  (hex str), ``@mac_bytes`` (raw 6 bytes), ``@ssid``, ``@ssid_groupN``,
  or ``hex:<bytes in hex>`` for binary magics.
``serial_hash``— ``{"series": {"NN": [{"sn": .., "q": .., "k": ..},
  ...]}, "magic_hex": .., "charset": .., "take": ..}``: the Alice-AGPF
  serial-table scheme (gen/vendors.alice_agpf_keys) with per-pack
  magic/charset overrides — covers the AGPF siblings that reuse the
  structure with different constants.  Its ``ssid_re`` must carry
  EXACTLY one mandatory capture group (the serial digits fed to the
  scheme); optional or alternated groups are rejected at load.

Every candidate is still verified against the real handshake by keygen
precompute (server/jobs.py) before acceptance, so a bad pack costs
wasted PBKDF2s, never a false accept.
"""

import hashlib
import json
import re

try:  # the sre parse tree moved in 3.11+; same structure either way
    from re import _constants as sre_constants, _parser as sre_parse
except ImportError:  # pragma: no cover - 3.10 spelling
    import sre_constants
    import sre_parse

_HASHES = {"md5": hashlib.md5, "sha1": hashlib.sha1, "sha256": hashlib.sha256}


def _mandatory_group_nums(parsed) -> set:
    """Group numbers that participate in EVERY match of the parsed
    pattern: not under a ``{0,n}``/``?``/``*`` repeat and present in all
    branches of every alternation.  A group outside this set can be
    ``None`` on a successful match — the ``AttributeError`` landmine
    ``serial_hash`` validation exists to disarm."""
    out = set()
    for op, av in parsed:
        if op is sre_constants.SUBPATTERN:
            group, _af, _df, sub = av
            if group:
                out.add(group)
            out |= _mandatory_group_nums(sub)
        elif op in (sre_constants.MAX_REPEAT, sre_constants.MIN_REPEAT):
            lo, _hi, sub = av
            if lo >= 1:
                out |= _mandatory_group_nums(sub)
        elif op is sre_constants.BRANCH:
            sets = [_mandatory_group_nums(b) for b in av[1]]
            common = sets[0]
            for s in sets[1:]:
                common = common & s
            out |= common
    return out


def _mac_neighbourhood(bssid: bytes, offsets):
    base = int.from_bytes(bssid, "big")
    for off in offsets:
        yield ((base + off) & 0xFFFFFFFFFFFF).to_bytes(6, "big")


def _resolve_token(tok: str, mac: bytes, ssid: bytes, m) -> bytes:
    if tok == "@mac":
        return mac.hex().encode()
    if tok == "@MAC":
        return mac.hex().upper().encode()
    if tok == "@mac_bytes":
        return mac
    if tok == "@ssid":
        return ssid
    if tok.startswith("@ssid_group"):
        return m.group(int(tok[len("@ssid_group"):]))
    if tok.startswith("hex:"):
        return bytes.fromhex(tok[4:])
    return tok.encode()


class _Family:
    """One compiled pack entry: a ``(bssid, ssid) -> (algo, cand)``
    generator (the ``extra_generators`` shape keygen precompute takes)."""

    #: fields a kind cannot run without — checked at load so a typo'd
    #: pack fails immediately, not silently mid-cron
    _REQUIRED = {"fixed": ("keys",), "mac_map": ("slices",),
                 "hash_map": ("input", "take"), "serial_hash": ("series",)}

    def __init__(self, entry: dict):
        self.name = entry["name"]
        self.ssid_re = re.compile(entry["ssid_re"].encode())
        self.kind = entry["kind"]
        self.entry = entry
        if self.kind not in self._REQUIRED:
            raise ValueError(f"unknown vendor-pack kind {self.kind!r}")
        for field in self._REQUIRED[self.kind]:
            if field not in entry:
                raise KeyError(field)
        # Data validation at LOAD: the smoke run below only executes an
        # entry whose regex happens to match the dummy SSID, so every
        # value that could raise mid-cron is checked here instead.
        if self.kind == "hash_map":
            if entry.get("hash", "md5") not in _HASHES:
                raise ValueError(f"unknown hash {entry.get('hash')!r}")
            groups = re.compile(entry["ssid_re"]).groups
            for tok in entry["input"]:
                if tok.startswith("hex:"):
                    bytes.fromhex(tok[4:])
                elif tok.startswith("@ssid_group"):
                    if int(tok[len("@ssid_group"):]) > groups:
                        raise ValueError(f"{tok}: ssid_re has {groups} groups")
                elif tok.startswith("@") and tok not in (
                        "@mac", "@MAC", "@mac_bytes", "@ssid"):
                    raise ValueError(f"unknown input token {tok!r}")
            if not (0 <= int(entry.get("group_bits", 0)) <= 16):
                raise ValueError("group_bits out of range")
        elif self.kind == "mac_map":
            for s, t in entry["slices"]:
                if not 0 <= int(s) <= int(t) <= 12:
                    raise ValueError(f"mac slice [{s}, {t}] out of range")
        elif self.kind == "fixed":
            # mirror hash_map's eager posture: a non-string (JSON number,
            # null, nested list) or empty key would TypeError on .encode()
            # or emit an empty candidate on the first matching net mid-cron
            if not isinstance(entry["keys"], (list, tuple)) or not entry["keys"]:
                raise ValueError("fixed 'keys' must be a non-empty list")
            for k in entry["keys"]:
                if not isinstance(k, str) or not k:
                    raise ValueError(
                        f"fixed key {k!r} must be a non-empty string")
        elif self.kind == "serial_hash":
            # __call__ feeds m.group(1) to the serial scheme, so the
            # regex must GUARANTEE that group exists on every match — an
            # optional/alternated group would return None and raise
            # AttributeError on .decode() mid-cron instead of at load
            if (self.ssid_re.groups != 1
                    or 1 not in _mandatory_group_nums(
                        sre_parse.parse(entry["ssid_re"]))):
                raise ValueError(
                    "serial_hash ssid_re must have exactly one mandatory "
                    f"capture group (the serial digits): "
                    f"{entry['ssid_re']!r}")
            if "magic_hex" in entry:
                bytes.fromhex(entry["magic_hex"])
            for series in entry["series"].values():
                for cfg in series:
                    cfg["sn"], int(cfg["q"]), int(cfg["k"])

    def __call__(self, bssid: bytes, ssid: bytes):
        m = self.ssid_re.match(ssid)
        if not m:
            return
        e = self.entry
        if self.kind == "fixed":
            for k in e["keys"]:
                yield (self.name, k.encode())
        elif self.kind == "mac_map":
            for mac in _mac_neighbourhood(bssid, e.get("offsets", (0,))):
                h = mac.hex()
                if e.get("case", "lower") == "upper":
                    h = h.upper()
                body = "".join(h[s:t] for s, t in e["slices"])
                yield (self.name,
                       (e.get("prefix", "") + body + e.get("suffix", ""))
                       .encode())
        elif self.kind == "hash_map":
            fn = _HASHES[e.get("hash", "md5")]
            for mac in _mac_neighbourhood(bssid, e.get("offsets", (0,))):
                data = b"".join(
                    _resolve_token(t, mac, ssid, m) for t in e["input"]
                )
                digest = fn(data).digest()[e.get("skip", 0):]
                cs = e.get("charset", "hex")
                gb = int(e.get("group_bits", 0))
                if cs == "hex":
                    key = digest.hex()[: e["take"]]
                elif cs == "HEX":
                    key = digest.hex().upper()[: e["take"]]
                elif gb:
                    # bitstream rendering: successive gb-bit groups
                    # (MSB-first) index the alphabet
                    stream = int.from_bytes(digest, "big")
                    nbits = len(digest) * 8
                    key = "".join(
                        cs[((stream >> (nbits - gb * (i + 1)))
                            & ((1 << gb) - 1)) % len(cs)]
                        for i in range(min(e["take"], nbits // gb))
                    )
                else:
                    key = "".join(cs[b % len(cs)]
                                  for b in digest[: e["take"]])
                yield (self.name, key.encode())
        elif self.kind == "serial_hash":
            from .vendors import alice_agpf_keys

            # the single mandatory capture group (validated at load)
            # carries the serial digits
            digits = m.group(1).decode()
            magic = bytes.fromhex(e["magic_hex"]) if "magic_hex" in e else None
            for key in alice_agpf_keys(
                digits, bssid, configs=e["series"], magic=magic,
                charset=e.get("charset"), take=e.get("take", 24),
            ):
                yield (self.name, key)


def load_vendor_pack(source):
    """``source``: a path to a JSON pack, or an already-parsed dict.
    Returns the list of generator callables, validated eagerly (a typo'd
    pack must fail at load, not silently yield nothing mid-cron)."""
    if isinstance(source, (str, bytes)):
        with open(source) as f:
            source = json.load(f)
    fams = [_Family(e) for e in source.get("families", [])]
    for f in fams:  # eager smoke-validation against a dummy net
        list(f(b"\x00\x11\x22\x33\x44\x55", b"__pack_validation__"))
    return fams
