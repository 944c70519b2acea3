"""The port's smart-keyspace compiler and scheduler helpers against
``dwpa_tpu.keyspace`` on the patterns of ``tests/test_keyspace.py``:
the same masks, custom charsets and keyspaces, the same loud rejections
(reason and pattern), and the same shard-coverage answers, exact."""

import pytest

from dwpa_tpu import keyspace as jks
from dwpa_tpu.gen.mask import mask_words as jmask_words
from dwpa_tpu_torch import keyspace as tks
from dwpa_tpu_torch.gen.mask import mask_words

COMPILED = [
    r"^wifipass\d{2}$",
    r"TALK[0-9]{2}\d{2}",
    r"^[a-c]{1,3}X$",
    r"net\d{3}|wifi[xy]z",
    r"ab?c?d",
    r"\?\d{2}\\",
    r"[0-9][a-z][A-F0-9]",
    r"pw[_\-.]\d",
    r"a[bc]?[de]?",
    r"\d{4}|[ab]x|net[0-9a-f]{2}",
    r"[0-9][a-z][A-Z][0-9a-f]",
    r"[abc][xy][abc]",
    r"a\?b",
    r"^ab$", r"ab", r"^ab", r"ab$",
    r"a\|b|[x|y]",
]

REJECTED = [
    r"free.*", r"a*", r"a+", r"(ab)c", r"(?=x)y", r"[^abc]", r"[b-a]", r"[]",
    r"[abc", r"a{2,1}", r"a{", r"a{x}", r"{3}", r"a{2}?", r"?a", r"a\w",
    r"a^b", r"", r"a|", r"x?", r"\d{64}", r"a?b?c?d?e?f?g?h?i?", "p€ssword",
    r"[ab][cd][ef][gh][ij]",
]


def _masks(ck):
    return [(m.mask, m.custom, m.keyspace, m.custom_bytes()) for m in ck.masks]


@pytest.mark.parametrize("pattern", COMPILED)
def test_compile_matches_jax(pattern):
    j, t = jks.compile_pass_regex(pattern), tks.compile_pass_regex(pattern)
    assert type(t).__name__ == "CompiledKeyspace"
    assert t.keyspace == j.keyspace
    assert _masks(t) == _masks(j)
    for m in t.masks:
        assert list(mask_words(m.mask, m.custom_bytes())) == list(
            jmask_words(m.mask, m.custom_bytes()))


@pytest.mark.parametrize("pattern", REJECTED)
def test_rejection_matches_jax(pattern):
    with pytest.raises(jks.KeyspaceError) as je:
        jks.compile_pass_regex(pattern)
    with pytest.raises(tks.KeyspaceError) as te:
        tks.compile_pass_regex(pattern)
    assert (te.value.reason, te.value.pattern) == (je.value.reason, je.value.pattern)
    assert str(te.value) == str(je.value)


@pytest.mark.parametrize("rows,ks,span,extra", [
    ([], 100, 40, ()),
    ([{"skip": 0, "span": 40}], 100, 40, ()),
    ([{"skip": 0, "span": 20}, {"skip": 60, "span": 40}], 100, 40, ()),
    ([{"skip": 0, "span": 20}, {"skip": 30, "span": 70}], 100, 40, ()),
    ([], 100, 40, [(0, 40), (40, 40)]),
    ([{"skip": 0, "span": 100}], 100, 40, ()),
])
def test_next_uncovered_matches_jax(rows, ks, span, extra):
    assert tks.next_uncovered(rows, ks, span, extra=extra) == \
        jks.next_uncovered(rows, ks, span, extra=extra)


@pytest.mark.parametrize("ssid", [b"HOME-1234", b"MYNETWORK", b"other",
                                  bytes(range(200, 210))])
def test_ks_matches_matches_jax(ssid):
    rows = [{"ssid_regex": r"^HOME-", "pass_regex": "x"},
            {"ssid_regex": r"NET", "pass_regex": "y"},
            {"ssid_regex": r"([", "pass_regex": "z"}]
    assert tks.ks_matches(rows, ssid) == jks.ks_matches(rows, ssid)


def test_mask_cache_matches_jax():
    out = []
    for mod in (jks, tks):
        cache = mod.MaskCache()
        ck = cache.get(r"^pw\d{2}$")
        out.append((cache.get(r"^pw\d{2}$") is ck, cache.keyspace(r"^pw\d{2}$"),
                    cache.get(r"bad(") is None, cache.keyspace(r"bad("),
                    cache.compiles, _masks(ck)))
    assert out[0] == out[1]
    assert out[1][:5] == (True, 100, True, 0, 1)
