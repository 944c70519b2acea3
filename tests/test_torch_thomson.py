"""The port's Thomson serial sweep (``dwpa_tpu_torch.gen.vendors``)
against ``dwpa_tpu.gen.vendors`` and the hashlib search.

- ``_thomson_search_device(..., device="cpu")`` against JAX's
  ``_thomson_search_device`` on XLA:CPU (as ``tests/test_vendors.py``
  runs it) and the hashlib search, list for list, over one to three
  (yy, ww) windows with a ``chunk`` smaller than the space, so several
  chunks and a partial last chunk run.  The target is a suffix that
  several serials share, so the order of hits across chunks is checked.
- ``thomson_candidates(device=None)`` routes to the card iff
  ``torch.cuda.is_available()`` (patched here; the sweep itself is
  recorded, never launched on a card that is not there), ``True`` raises
  without one, ``False`` is hashlib.
- ``vendor_candidates`` turns the Thomson family on by default exactly
  when a card is reported.
"""

import collections

import pytest
import torch

from dwpa_tpu.gen import vendors as jvendors
from dwpa_tpu_torch.gen import vendors as tvendors
from dwpa_tpu_torch.parallel.device import resolve_device

CHUNK = 40_000   # < one window's 46,656 serials
WINDOWS = [([9], [12]), ([4, 12], [53]), ([5], [1, 2, 30])]


def shared_suffix(years, weeks):
    """The hashlib-found SSID suffix with the most serials in the space
    (ties broken by first appearance), and its keys in search order."""
    keys = collections.defaultdict(list)
    for yy in years:
        for ww in weeks:
            for a in tvendors._CODE_CHARS:
                for b in tvendors._CODE_CHARS:
                    for c in tvendors._CODE_CHARS:
                        sfx, key = tvendors.thomson_key(tvendors._thomson_serial(yy, ww, a + b + c))
                        keys[sfx].append(key)
    sfx = max(keys, key=lambda s: len(keys[s]))
    return sfx, keys[sfx]


@pytest.mark.parametrize("years,weeks", WINDOWS)
def test_cpu_sweep_matches_jax_and_hashlib(years, weeks):
    sfx, want = shared_suffix(years, weeks)
    assert len(want) >= 2 or len(years) * len(weeks) == 1
    got = list(tvendors._thomson_search_device(sfx, years, weeks, chunk=CHUNK, device="cpu"))
    assert got == want
    assert got == list(jvendors._thomson_search_device(sfx, years, weeks, chunk=CHUNK))
    assert got == list(tvendors.thomson_candidates(sfx.lower(), years=years, weeks=weeks,
                                                   device=False))
    assert got == list(tvendors.thomson_candidates(sfx, years=years, weeks=weeks,
                                                   device=torch.device("cpu")))


def test_cpu_sweep_misses_and_partial_chunks():
    # a suffix no serial of the window has; a chunk that splits the window
    # unevenly; and the default chunk (one partial chunk)
    sfx = "000000"
    assert list(tvendors._thomson_search_device(sfx, [7], [34], chunk=12_345, device="cpu")) == []
    sfx, key = tvendors.thomson_key(tvendors._thomson_serial(7, 34, "ZZZ"))   # the last serial
    assert list(tvendors._thomson_search_device(sfx, [7], [34], device="cpu")) == [key]
    assert list(tvendors._thomson_search_device(sfx, [7], [34], chunk=12_345, device="cpu")) == [key]


@pytest.fixture
def recorded(monkeypatch):
    """Replace the sweep with a recorder of the device it would resolve."""
    calls = []

    def sweep(target, years, weeks, chunk=1 << 20, compress=None, device=None):
        calls.append((target, years, weeks, resolve_device(device)))
        return iter([b"SWEPT00000"])

    monkeypatch.setattr(tvendors, "_thomson_search_device", sweep)
    return calls


def test_device_none_routes_by_cuda_availability(monkeypatch, recorded):
    sfx, key = tvendors.thomson_key(tvendors._thomson_serial(6, 2, "7F0"))
    kw = dict(years=[6], weeks=[2])
    monkeypatch.setattr("torch.cuda.is_available", lambda: True)
    assert list(tvendors.thomson_candidates(sfx.lower(), **kw)) == [b"SWEPT00000"]
    assert list(tvendors.thomson_candidates(sfx, device=True, **kw)) == [b"SWEPT00000"]
    assert recorded == [(sfx, [6], [2], torch.device("cuda", 0))] * 2
    assert list(tvendors.thomson_candidates(sfx, device=False, **kw)) == [key]

    monkeypatch.setattr("torch.cuda.is_available", lambda: False)
    assert list(tvendors.thomson_candidates(sfx, **kw)) == [key]
    assert len(recorded) == 2
    with pytest.raises(RuntimeError, match="no CUDA device"):
        list(tvendors.thomson_candidates(sfx, device=True, **kw))
    assert list(tvendors.thomson_candidates(sfx, device="cpu", **kw)) == [b"SWEPT00000"]
    assert recorded[-1][3] == torch.device("cpu")


@pytest.mark.parametrize("ssid", [b"SpeedTouch1A2B3C", b"Orange-1a2b3c", b"BBox1A2B3C"])
def test_vendor_candidates_sweep_by_default_only_with_a_card(monkeypatch, recorded, ssid):
    mac = bytes.fromhex("00147f010203")
    monkeypatch.setattr("torch.cuda.is_available", lambda: False)
    without = list(tvendors.vendor_candidates(mac, ssid))
    assert without == list(jvendors.vendor_candidates(mac, ssid))   # JAX: no TPU here
    assert not any(algo == "Thomson" for algo, _ in without) and recorded == []

    monkeypatch.setattr("torch.cuda.is_available", lambda: True)
    with_card = list(tvendors.vendor_candidates(mac, ssid))
    assert with_card[0] == ("Thomson", b"SWEPT00000") and with_card[1:] == without
    assert recorded == [(ssid[-6:].decode().upper(), list(range(4, 13)), list(range(1, 54)),
                         torch.device("cuda", 0))]

    # an explicit budget is honoured with or without a card
    monkeypatch.setattr("torch.cuda.is_available", lambda: False)
    kw = {"years": [6], "weeks": [2], "device": False}
    assert list(tvendors.vendor_candidates(mac, ssid, thomson_kw=kw)) == \
        list(jvendors.vendor_candidates(mac, ssid, thomson_kw=kw))


def test_vendor_candidates_planted_thomson_key_on_cpu():
    sfx, key = tvendors.thomson_key(tvendors._thomson_serial(6, 2, "7F0"))
    kw = {"years": [6], "weeks": [2], "device": "cpu"}
    pairs = list(tvendors.vendor_candidates(b"\x00\x01\x02\x03\x04\x05",
                                            b"SpeedTouch" + sfx.encode(), thomson_kw=kw))
    assert ("Thomson", key) in pairs
