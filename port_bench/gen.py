"""The general generator: dicts, nets and work units from a seed and data files.

Everything a cell serves is made here from ``--seed`` and the cell's
configuration (``configs/<name>.json``: the ESSID group's nets, which of
them carry a planted PSK, the dict size and count, the batch, the nonce
error corrections) and traffic (``traffic/<name>.json``: how the client
meets its dicts, the pool of dicts the units cycle through, the word
lengths).  A new cell brings data files; this code stays as it is.

A planted PSK is a dict word at a seeded position.  The dicts are made
from the mix's own ``dict_seed``, not from ``--seed``: they are the same
server dicts on every run (the client's packed dict cache stays valid
from one run to the next, as a volunteer's does), and ``--seed`` draws
the ESSIDs, the nets and where the finds lie.  A unit's planted words
lie in two of its batches: one in its last batch, so every unit runs
all its batches on every seed, and the others together in one batch at
a seeded place.  A hit batch costs the client a decode; two a unit keep
that cost near what a unit of mostly uncracked nets pays, while the
seeded one still reaches every batch of a unit over the seeds.  Nets
without a planted PSK carry a random MIC or PMKID.
"""

import gzip
import hashlib
import os
import struct
from concurrent.futures import ThreadPoolExecutor

import numpy as np

from . import reference as ref
from . import rules_ref

HERE = os.path.dirname(os.path.abspath(__file__))

ALPHABET = np.frombuffer(b"abcdefghijklmnopqrstuvwxyz0123456789", np.uint8)
#: The units made for a window of S s hold S x this many PMKs (more than
#: any card runs), or S / MIN_UNIT_S units where that is fewer (no unit
#: is shorter), so the server never runs out.
MAX_PMK_PER_S = 8e6
MIN_UNIT_S = 0.25
BSSID_BYTES = 6


def make_rng(seed: int) -> np.random.Generator:
    """A generator for any whole ``seed`` (negative ones map above 2**63)."""
    return np.random.default_rng(int(seed) % (1 << 64))


def dict_text(rng, n: int, len_weights: dict):
    """``n`` seeded words over [a-z0-9], one a line, their lengths drawn
    from ``len_weights`` ({length: weight}): the text and the offset at
    which each word ends.  A word may repeat, as in a real dict; a repeat
    of a planted word is found at its first place, with the same PSK."""
    lengths = np.array([int(k) for k in len_weights], np.int64)
    p = np.array([float(v) for v in len_weights.values()])
    lens = rng.choice(lengths, n, p=p / p.sum())
    ends = np.cumsum(lens + 1) - 1          # each word's newline
    buf = ALPHABET[rng.integers(0, len(ALPHABET), int(ends[-1]) + 1, dtype=np.uint8)]
    buf[ends] = ord("\n")
    return buf.tobytes(), ends


class Dict:
    """One served dict: its text, its gzip body and md5 (the server's dhash)."""

    def __init__(self, text: bytes, ends):
        self.text, self.ends = text, ends
        self.gz = gzip.compress(text, compresslevel=1, mtime=0)
        self.dhash = hashlib.md5(self.gz).hexdigest()
        self.dpath = f"dict/{self.dhash}.txt.gz"

    def __len__(self):
        return len(self.ends)

    def word(self, i: int) -> bytes:
        return self.text[0 if i == 0 else int(self.ends[i - 1]) + 1:int(self.ends[i])]

    @property
    def words(self) -> list:
        return self.text.split(b"\n")[:-1]


def make_dicts(config: dict, traffic: dict) -> list:
    """The mix's pool of dicts, each from its own generator seeded by the
    mix's ``dict_seed``, made on threads (numpy and zlib release the
    interpreter lock); a mix may set its own ``dict_words`` (a rules
    mix's base dicts)."""
    n = traffic.get("dict_words", config["dict_words"])
    seeds = np.random.default_rng(traffic["dict_seed"]).integers(
        0, 1 << 63, traffic["dict_pool"]).tolist()
    with ThreadPoolExecutor(min(8, len(seeds))) as pool:
        return list(pool.map(
            lambda s: Dict(*dict_text(np.random.default_rng(s), n, traffic["len_weights"])),
            seeds))


def traffic_rules(traffic: dict) -> list:
    """The hashcat rules a mix attaches to its dicts (``rules_file``, beside
    the mix), or []."""
    if not traffic.get("rules_file"):
        return []
    with open(os.path.join(HERE, "traffic", traffic["rules_file"])) as f:
        return rules_ref.rule_lines(f.read())


def _nc_anonce(anonce: bytes, delta: int, endian: str) -> bytes:
    """The AP nonce a router that counts its nonces used: the captured
    one with its last four bytes moved by ``delta`` in ``endian`` order."""
    fmt = "<I" if endian == "LE" else ">I"
    return anonce[:28] + struct.pack(fmt, (struct.unpack_from(fmt, anonce, 28)[0] + delta)
                                     & 0xFFFFFFFF)


def _line(net: dict, target: bytes) -> str:
    if net["kind"] == "pmkid":
        fields = ["01", target.hex(), net["mac_ap"].hex(), net["mac_sta"].hex(),
                  net["essid"].hex(), "", "", "01"]
    else:
        fields = ["02", target.hex(), net["mac_ap"].hex(), net["mac_sta"].hex(),
                  net["essid"].hex(), net["anonce"].hex(), net["eapol"].hex(),
                  f"{net['message_pair']:02x}"]
    return "*".join(["WPA"] + fields)


def _target(net: dict, psk: bytes) -> bytes:
    """The PMKID or MIC that ``psk`` gives ``net`` (the MIC over the AP
    nonce the router really used, its NC-moved one)."""
    key = ref.pmk(psk, net["essid"])
    if net["kind"] == "pmkid":
        return ref.pmkid(key, net["mac_ap"], net["mac_sta"])
    macs, nonces, _ = ref.key_pairs(net["mac_ap"], net["mac_sta"], net["anonce_real"],
                                   net["snonce"])
    return ref.mic(key, net["keyver"], macs, nonces, net["eapol"])


class Unit:
    """One work unit: a fresh ESSID group over its dicts of the pool.

    ``lines`` are its hashlines in the config's order, ``planted`` maps a
    net's BSSID (hex) to its PSK, ``words`` counts the candidates its
    dicts and rules make (the PMKs it derives, one ESSID)."""

    def __init__(self, hkey, essid, lines, planted, dicts, nets, rules=()):
        self.hkey, self.essid, self.lines = hkey, essid, lines
        self.planted, self.dicts, self.nets = planted, dicts, nets
        self.rules = list(rules)
        self.words = sum(len(d) for d in dicts) * max(1, len(self.rules))
        self.by_bssid = {n["mac_ap"].hex(): ln for n, ln in zip(nets, lines)}


def _unit_nets(rng, config, essid):
    nets, bssids = [], set()
    for cls in config["nets"]:
        chosen = set(rng.choice(cls["count"], cls["plant"], replace=False).tolist())
        for i in range(cls["count"]):
            mac_ap = rng.bytes(BSSID_BYTES)
            while mac_ap.hex() in bssids:
                mac_ap = rng.bytes(BSSID_BYTES)
            bssids.add(mac_ap.hex())
            net = {"kind": cls["kind"], "class": cls["name"], "essid": essid,
                   "mac_ap": mac_ap, "mac_sta": rng.bytes(BSSID_BYTES),
                   "planted": i in chosen, "random_target": rng.bytes(16)}
            if cls["kind"] == "eapol":
                net["keyver"] = cls["keyver"]
                net["anonce"], net["snonce"] = rng.bytes(32), rng.bytes(32)
                net["eapol"] = ref.eapol_m2(cls["keyver"], net["snonce"],
                                            rng.bytes(config["key_data_bytes"]))
                net["message_pair"] = 0
                net["anonce_real"] = net["anonce"]
                if cls.get("nc_endian"):
                    lim = config["nc_delta_max"]
                    delta = int(rng.choice([d for d in range(-lim, lim + 1) if d]))
                    net["anonce_real"] = _nc_anonce(net["anonce"], delta, cls["nc_endian"])
                    net["message_pair"] = ref.MP_NC
            nets.append(net)
    return nets


def _plant_rules(rng, d, rules, count):
    """``count`` PSKs ``rule(word)`` of 8-63 bytes at seeded words of dict
    ``d`` and rules."""
    psks = []
    while len(psks) < count:
        psk = rules_ref.apply(rules[int(rng.integers(len(rules)))],
                              d.word(int(rng.integers(len(d)))))
        if 8 <= len(psk) <= 63:
            psks.append(psk)
    return psks


def _plant_words(rng, udicts, batch, count):
    """``count`` PSKs of a unit's dicts: one in the unit's last batch, the
    rest in one batch at a seeded place (the feed frames each dict on
    its own, so a batch never spans two dicts)."""
    batches = [(d, s) for d in udicts for s in range(0, len(d), batch)]
    d, s = batches[-1]
    last = d.word(int(rng.integers(s, len(d))))
    d, s = batches[int(rng.integers(len(batches)))]
    pos = rng.choice(np.arange(s, min(s + batch, len(d))), count - 1, replace=False)
    return [d.word(int(p)) for p in pos.tolist()] + [last]


def make_units(rng, config: dict, traffic: dict, dicts: list, count: int,
               tag: str = "pb", first_dicts: int = None) -> list:
    """``count`` units, each a fresh ESSID with the config's nets and
    planted PSKs over the config's dictcount dicts of the pool (unit
    ``i`` from dict ``i x dictcount`` on, cycling).  The first unit, the
    set-up's warm one, carries only ``first_dicts`` dicts where given:
    the window's shapes in a fraction of the time.  A mix's
    ``uncracked`` nets of those the config plants carry no PSK, drawn by
    seed each unit: a group that never completes runs all its work
    whichever candidate cracks the others (a rules mix: rules that agree
    on a word, such as ``l $1`` and ``$1`` on a lower-case one, would
    otherwise end a unit early)."""
    batch, nd = config["batch_size"], config["dictcount"]
    rules = traffic_rules(traffic)
    plans = []
    for i in range(count):
        essid = b"%s-%s" % (tag.encode(), ALPHABET[rng.integers(0, 36, 12)].tobytes())
        nets = _unit_nets(rng, config, essid)
        udicts = [dicts[(i * nd + k) % len(dicts)] for k in range(nd)]
        if i == 0 and first_dicts:
            udicts = udicts[:first_dicts]
        planted = [n for n in nets if n["planted"]]
        for k in rng.choice(len(planted), traffic.get("uncracked", 0), replace=False).tolist():
            planted[k]["planted"] = False
        planted = [n for n in planted if n["planted"]]
        if not planted:
            psks = []
        elif rules:
            psks = _plant_rules(rng, udicts[-1], rules, len(planted))
        else:
            psks = _plant_words(rng, udicts, batch, len(planted))
        for n, psk in zip(rng.permutation(len(planted)).tolist(), psks):
            planted[n]["psk"] = psk
        plans.append((f"{tag}{i:05d}", essid, nets, udicts))
    todo = [n for _, _, nets, _ in plans for n in nets if n["planted"]]
    with ThreadPoolExecutor(max(1, min(8, os.cpu_count() or 1))) as pool:
        for n, target in zip(todo, pool.map(lambda n: _target(n, n["psk"]), todo)):
            n["target"] = target
    units = []
    for hkey, essid, nets, udicts in plans:
        lines = [_line(n, n.get("target", n["random_target"])) for n in nets]
        planted = {n["mac_ap"].hex(): n["psk"] for n in nets if n["planted"]}
        units.append(Unit(hkey, essid, lines, planted, udicts, nets, rules))
    return units


def window_units(seconds: float, config: dict, traffic: dict, rules: int) -> int:
    """Units made for a window of ``seconds``: more than it can finish."""
    words = (config["dictcount"] * traffic.get("dict_words", config["dict_words"])
             * max(1, rules))
    return int(min(seconds * MAX_PMK_PER_S / words, seconds / MIN_UNIT_S)) + 2
