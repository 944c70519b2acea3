"""The plain reference against published vectors and hashlib, and the
generator's hashlines against it (and against the port's own oracle, a
second independent implementation)."""

import hashlib
import hmac

import pytest

from port_bench import gen
from port_bench import reference as ref


def test_pmk_ieee_vector():
    # IEEE 802.11i-2004, H.4.1: "password", SSID "IEEE"
    assert ref.pmk(b"password", b"IEEE").hex() == (
        "f42c6fc52df0ebef9ebb4b90b38a5f902e83fe1b135a70e23aed762e9710a12e")


def test_aes_fips197_vector():
    key = bytes.fromhex("000102030405060708090a0b0c0d0e0f")
    pt = bytes.fromhex("00112233445566778899aabbccddeeff")
    assert ref.aes128_encrypt(key, pt).hex() == "69c4e0d86a7b0430d8cdb78070b4c55a"


@pytest.mark.parametrize("n, mac", [
    (0, "bb1d6929e95937287fa37d129b756746"),
    (16, "070a16b46b4d4144f79bdd9dd04a287c"),
    (40, "dfa66747de9ae63030ca32611497c827"),
    (64, "51f0bebf7e3b9d92fc49741779363cfe"),
])
def test_cmac_rfc4493_vectors(n, mac):
    key = bytes.fromhex("2b7e151628aed2a6abf7158809cf4f3c")
    msg = bytes.fromhex(
        "6bc1bee22e409f96e93d7e117393172aae2d8a571e03ac9c9eb76fac45af8e51"
        "30c81c46a35ce411e5fbc1191a0a52eff69f2445df4f9b17ad2b417be66c3710")[:n]
    assert ref.aes_cmac(key, msg).hex() == mac


def test_pmkid_and_mic_are_hmacs():
    key = ref.pmk(b"12345678", b"net")
    ap, sta = bytes(range(6)), bytes(range(6, 12))
    assert ref.pmkid(key, ap, sta) == hmac.new(key, b"PMK Name" + ap + sta,
                                               hashlib.sha1).digest()[:16]
    eapol = ref.eapol_m2(2, bytes(32), b"")
    kck = hmac.new(key, ref.LABEL_V12 + b"m" * 12 + b"n" * 64 + b"\0", hashlib.sha1).digest()[:16]
    assert ref.mic(key, 2, b"m" * 12, b"n" * 64, eapol) == hmac.new(
        kck, eapol, hashlib.sha1).digest()[:16]


def test_nonce_variants_follow_the_message_pair():
    anonce = bytes(range(32))
    assert len(ref.nonce_variants(anonce, 0, 8)) == 21
    assert len(ref.nonce_variants(anonce, ref.MP_LE, 8)) == 11
    assert len(ref.nonce_variants(anonce, ref.MP_BE | ref.MP_NC, 8)) == 11
    assert ref.nonce_variants(anonce, ref.MP_APLESS, 8) == [anonce]


GROUP = {"batch_size": 4, "dictcount": 1, "nonce_error_corrections": 8, "nc_delta_max": 4,
         "key_data_bytes": 22, "nets": [
             {"name": "kv1", "kind": "eapol", "keyver": 1, "count": 2, "plant": 1},
             {"name": "kv2_le", "kind": "eapol", "keyver": 2, "nc_endian": "LE", "count": 2,
              "plant": 1},
             {"name": "kv2_be", "kind": "eapol", "keyver": 2, "nc_endian": "BE", "count": 2,
              "plant": 1},
             {"name": "kv3", "kind": "eapol", "keyver": 3, "count": 2, "plant": 1},
             {"name": "pmkid", "kind": "pmkid", "count": 2, "plant": 1}]}


def units(seed=5, count=2):
    rng = gen.make_rng(seed)
    dicts = [gen.Dict(*gen.dict_text(rng, 12, {"8": 1, "12": 1, "63": 1}))]
    return gen.make_units(rng, {**GROUP, "dict_words": 12}, {}, dicts, count)


def test_planted_nets_crack_and_the_others_do_not():
    for u in units():
        assert len(u.planted) == 5 and len(u.lines) == 10
        for net, line in zip(u.nets, u.lines):
            psk = u.planted.get(net["mac_ap"].hex())
            assert ref.check_psk(line, psk or b"notthepsk", 8) == (psk is not None)
            if psk and net.get("message_pair") == ref.MP_NC:
                exact = line[:-2] + f"{ref.MP_APLESS:02x}"   # "the nonce is exact"
                assert not ref.check_psk(exact, psk, 8)      # cracks only corrected


def test_one_planted_word_in_the_last_batch():
    for u in units(count=6):
        words = u.dicts[0].words
        at = sorted(words.index(p) for p in u.planted.values())
        assert at[-1] >= len(words) - 4
        assert at[-2] // 4 == at[0] // 4     # the others in one batch


def test_a_unit_over_several_dicts():
    rng = gen.make_rng(6)
    dicts = [gen.Dict(*gen.dict_text(rng, 12, {"8": 1, "12": 1})) for _ in range(3)]
    config = {**GROUP, "dictcount": 3}
    first, *rest = gen.make_units(rng, config, {}, dicts, 4, first_dicts=1)
    assert first.dicts == dicts[:1] and first.words == 12
    for u in rest:
        assert u.dicts == dicts and u.words == 36
        assert any(p in dicts[-1].words[8:] for p in u.planted.values())
        assert all(any(p in d.words for d in dicts) for p in u.planted.values())


def test_dicts_are_the_mix_s_own():
    traffic = {"dict_pool": 2, "dict_seed": 5, "len_weights": {"8": 1, "20": 1}}
    a, b = gen.make_dicts({"dict_words": 50}, traffic), gen.make_dicts({"dict_words": 50}, traffic)
    assert [d.dhash for d in a] == [d.dhash for d in b] and a[0].dhash != a[1].dhash
    assert [a[0].word(i) for i in range(50)] == a[0].words and len(a[0]) == 50


def test_generation_is_a_function_of_the_seed():
    a, b, c = units(9), units(9), units(10)
    assert [u.lines for u in a] == [u.lines for u in b]
    assert [u.lines for u in a] != [u.lines for u in c]


def test_the_port_oracle_agrees():
    from dwpa_tpu_torch.oracle import m22000 as oracle

    for u in units(3):
        for line in u.lines:
            psk = u.planted.get(line.split("*")[3])
            found = oracle.check_key_m22000(line, [psk or b"notthepsk"], nc=8)
            assert (found is not None) == (psk is not None)
