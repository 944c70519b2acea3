"""The port's candidate generators, dictionary stream, found outbox and
small host modules against the JAX package: same seeded inputs, exact
equality."""

import gzip
import itertools

import numpy as np
import pytest

from dwpa_tpu import gen as jgen
from dwpa_tpu.client import outbox as joutbox
from dwpa_tpu.client import targeted as jtargeted
from dwpa_tpu.gen import vendors as jvendors
from dwpa_tpu_torch import gen as tgen
from dwpa_tpu_torch.client import outbox as toutbox
from dwpa_tpu_torch.client import targeted as ttargeted
from dwpa_tpu_torch.gen import vendors as tvendors
from dwpa_tpu_torch.obs import MetricsRegistry

FIRST = 10_000


def seeded_nets(n=6, seed=21):
    """``n`` seeded (essid, mac_ap, mac_sta) triples."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        essid = bytes(rng.integers(48, 123, int(rng.integers(1, 33)), dtype=np.uint8))
        out.append((essid, bytes(rng.integers(0, 256, 6, dtype=np.uint8)),
                    bytes(rng.integers(0, 256, 6, dtype=np.uint8))))
    out.append((b"NETGEAR42", bytes.fromhex("a0b1c2d3e4f5"), bytes.fromhex("001122334455")))
    out.append((b"Tenda_5A1B2C", bytes.fromhex("c83a35112233"), None))
    return out


@pytest.mark.parametrize("i", range(8))
def test_psk_candidates_match_jax(i):
    essid, ap, sta = seeded_nets()[i]
    assert list(tgen.psk_candidates(essid, ap, sta)) == \
        list(jgen.psk_candidates(essid, ap, sta))


@pytest.mark.parametrize("tac", ["35684610", "86723604", "01234567"])
def test_imei_candidates_match_jax(tac):
    assert list(itertools.islice(tgen.imei_candidates(tac), FIRST)) == \
        list(itertools.islice(jgen.imei_candidates(tac), FIRST))
    assert tgen.luhn_check_digit(tac + "000001") == jgen.luhn_check_digit(tac + "000001")


@pytest.mark.parametrize("mask,custom,skip,limit", [
    ("?d?d?d?d", None, 0, None),
    ("ab?l?u?d", None, 1234, 5000),
    ("?1?1?h?H", {"1": b"xyz"}, 17, 300),
    ("??lit?s", None, 3, 10),
    ("?d" * 10, None, 10 ** 9, 2000),
])
def test_mask_words_match_jax(mask, custom, skip, limit):
    assert tgen.mask_keyspace(mask, custom) == jgen.mask_keyspace(mask, custom)
    got = list(itertools.islice(tgen.mask_words(mask, custom, skip, limit), FIRST))
    assert got == list(itertools.islice(jgen.mask_words(mask, custom, skip, limit), FIRST))


#: one ESSID per TARGET_TABLE family, in table order
FAMILY_ESSIDS = [b"NETGEAR07", b"MySpectrumWiFi3c-2G", b"ATT4k2Jx9", b"PLDTHOMEFIBR1234",
                 b"TP-LINK_1A2B", b"EE-Hub-4xK9", b"MyAltice 3f21", b"AndroidAP_7781"]


@pytest.mark.parametrize("essid", FAMILY_ESSIDS)
def test_targeted_candidates_match_jax(essid):
    family, it = ttargeted.targeted_for_essid(essid)
    jfamily, jit = jtargeted.targeted_for_essid(essid)
    assert family == jfamily is not None
    assert list(itertools.islice(it, FIRST)) == list(itertools.islice(jit, FIRST))
    assert list(itertools.islice(ttargeted.targeted_candidates([essid, b"plain"]), FIRST)) \
        == list(itertools.islice(jtargeted.targeted_candidates([essid, b"plain"]), FIRST))


def test_target_table_families_match_jax():
    assert [(rx.pattern, fam) for rx, fam, _ in ttargeted.TARGET_TABLE] == \
        [(rx.pattern, fam) for rx, fam, _ in jtargeted.TARGET_TABLE]
    assert len(FAMILY_ESSIDS) == len(ttargeted.TARGET_TABLE)
    assert ttargeted.targeted_for_essid(b"HomeNet") == (None, None)


def _dict_bytes(seed=4):
    rng = np.random.default_rng(seed)
    words = [bytes(rng.integers(32, 127, int(k), dtype=np.uint8)) for k in rng.integers(0, 30, 500)]
    text = b""
    for i, w in enumerate(words):
        text += w + (b"\r\n" if i % 3 == 0 else b"\n")
    return text + b"no-newline-tail"


@pytest.mark.parametrize("compress", [False, True])
@pytest.mark.parametrize("skip,limit", [(0, None), (37, None), (5, 100), (1000, 3)])
def test_dict_stream_matches_jax(tmp_path, compress, skip, limit):
    raw = _dict_bytes()
    path = tmp_path / ("d.txt.gz" if compress else "d.txt")
    path.write_bytes(gzip.compress(raw) if compress else raw)
    got = list(tgen.DictStream(str(path), skip=skip, limit=limit))
    assert got == list(jgen.DictStream(str(path), skip=skip, limit=limit))
    assert len(got) > 0 or skip >= 500
    assert tgen.md5_file(str(path)) == jgen.md5_file(str(path))
    assert [list(b) for b in tgen.DictStream(str(path)).batches(64)] == \
        [list(b) for b in jgen.DictStream(str(path)).batches(64)]


@pytest.mark.parametrize("essid,bssid", [
    (b"Belkin.5A1B", "94103e112233"), (b"EasyBox-1A2B3C", "001a2b3c4d5e"),
    (b"Tenda_5A1B2C", "c83a35112233"), (b"TP-LINK_1234", "f4f26d001122"),
    (b"AndroidAP", "020000000001"), (b"ZyXEL1A2B3C", "001349aabbcc"),
    (b"SKY12345", "7c4ca5010203"), (b"WLAN_AB12", "001a2b334455"),
    (b"eircom1234 5678", "000fcc123456"), (b"CVTV-12", "00250a0b0c0d"),
    (b"Thomson1A2B3C", "00147f010203"), (b"plain-net", "001122334455"),
])
def test_vendor_candidates_match_jax(essid, bssid, monkeypatch):
    mac = bytes.fromhex(bssid)
    # without a thomson_kw budget neither package sweeps Thomson serials
    # on a host without an accelerator
    monkeypatch.setattr("torch.cuda.is_available", lambda: False)
    assert list(tvendors.vendor_candidates(mac, essid)) == \
        list(jvendors.vendor_candidates(mac, essid))


def test_thomson_host_search_matches_jax_and_device_routing(monkeypatch):
    serial = tvendors._thomson_serial(8, 22, "AB1")
    sfx, key = tvendors.thomson_key(serial)
    assert (sfx, key) == jvendors.thomson_key(serial)
    kw = dict(years=[8], weeks=[22])
    got = list(tvendors.thomson_candidates(sfx, device=False, **kw))
    assert key in got
    assert got == list(jvendors.thomson_candidates(sfx, device=False, **kw))
    # without a card, device=None takes the hashlib search and device=True
    # refuses; the sweep itself is held to JAX's in test_torch_thomson.py
    monkeypatch.setattr("torch.cuda.is_available", lambda: False)
    assert list(tvendors.thomson_candidates(sfx, **kw)) == got
    with pytest.raises(RuntimeError, match="no CUDA device"):
        list(tvendors.thomson_candidates(sfx, device=True, **kw))
    assert list(tvendors.thomson_candidates(sfx, device="cpu", **kw)) == got


OUTBOX_OPS = [
    ("record", "hk1", [{"k": "a0b1c2d3e4f5", "v": "70736b31"}]),
    ("record", "hk1", [{"k": "a0b1c2d3e4f5", "v": "70736b31"},
                       {"k": "0011223344ff", "v": "70736b32"}]),
    ("ack", "hk1", [{"k": "a0b1c2d3e4f5", "v": "70736b31"}]),
    ("record", "hk2", [{"k": "aabbccddeeff", "v": "cafe"}]),
    ("record", "hk1", [{"k": "a0b1c2d3e4f5", "v": "70736b31"}]),
    ("ack", "hk2", [{"k": "aabbccddeeff", "v": "cafe"}]),
]


def test_outbox_journal_bytes_match_jax(tmp_path):
    boxes = (toutbox.FoundOutbox(str(tmp_path / "t"), registry=MetricsRegistry()),
             joutbox.FoundOutbox(str(tmp_path / "j")))
    outs = ([], [])
    for op, hkey, cand in OUTBOX_OPS:
        for box, out in zip(boxes, outs):
            res = getattr(box, op)(hkey, cand)
            out.append((res, box.pending_count()))
    assert outs[0] == outs[1]
    for box in boxes:
        box.close()
    blobs = [open(b.path, "rb").read() for b in boxes]
    assert blobs[0] == blobs[1] and len(blobs[0]) > 0
    # a reopened port outbox replays the JAX journal to the same state
    reopened = toutbox.FoundOutbox(str(tmp_path / "j"))
    assert reopened.pending() == joutbox.FoundOutbox(str(tmp_path / "j")).pending()
