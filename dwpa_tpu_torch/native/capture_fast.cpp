// Bulk pcap/pcapng -> m22000 extraction, C++ fast path.
//
// Native counterpart of dwpa_tpu/server/capture.py (itself the
// hcxpcapngtool equivalent -- the one external C tool the reference
// server cannot run without, web/common.php:481).  The Python parser
// stays the readable specification; this library exists for bulk
// archive re-parses (fill_pr / enrich over years of submissions,
// misc/fill_pr.php:33-71) where Python-loop throughput dominates.
//
// Semantics are kept bit-identical to the Python parser -- same
// container handling, 802.11 walk, EAPOL classification, pairing
// preference order, ordered-map tie-breaks -- enforced by differential
// tests (tests/test_native_capture.py).
//
// C ABI:
//   int  dwpa_extract(const uint8_t* blob, size_t len, int nc_hint,
//                     double eapol_timeout_s, char** out, size_t* out_len);
//       out: malloc'd text, one record per line:
//            "H <m22000 hashline>"  or  "P <hex probe ssid>"
//       returns 0 on success (caller frees with dwpa_free), -1 on error.
//   void dwpa_free(char* p);
//
// Build: g++ -O2 -shared -fPIC -o capture_fast.so capture_fast.cpp

#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <string>
#include <utility>
#include <vector>

namespace {

using Bytes = std::string;  // raw byte strings

uint16_t rd16(const uint8_t* p, bool be) {
    return be ? (p[0] << 8) | p[1] : (p[1] << 8) | p[0];
}
uint32_t rd32(const uint8_t* p, bool be) {
    return be ? ((uint32_t)p[0] << 24) | (p[1] << 16) | (p[2] << 8) | p[3]
              : ((uint32_t)p[3] << 24) | (p[2] << 16) | (p[1] << 8) | p[0];
}
uint64_t rd64be(const uint8_t* p) {
    uint64_t v = 0;
    for (int i = 0; i < 8; i++) v = (v << 8) | p[i];
    return v;
}

std::string hex(const uint8_t* p, size_t n) {
    static const char* d = "0123456789abcdef";
    std::string out;
    out.reserve(2 * n);
    for (size_t i = 0; i < n; i++) {
        out.push_back(d[p[i] >> 4]);
        out.push_back(d[p[i] & 15]);
    }
    return out;
}
std::string hex(const Bytes& b) { return hex((const uint8_t*)b.data(), b.size()); }

struct EapolMsg {
    int num;
    Bytes ap, sta;
    uint64_t replay;
    Bytes nonce;
    Bytes frame;  // full EAPOL, MIC zeroed, truncated to declared length
    Bytes mic;
    std::vector<Bytes> pmkids;
    double ts = 0.0;      // capture timestamp, epoch seconds
    bool has_ts = false;  // pcapng SPBs carry no timestamp
};

struct Frame {
    const uint8_t* p;
    size_t n;
    double ts;
    bool has_ts;
};

// ---- container readers --------------------------------------------------

void pcap_frames(const uint8_t* d, size_t len, std::vector<Frame>& frames,
                 std::vector<uint32_t>& linktypes) {
    if (len < 24) return;
    bool be;
    if (!memcmp(d, "\xd4\xc3\xb2\xa1", 4) || !memcmp(d, "\x4d\x3c\xb2\xa1", 4))
        be = false;
    else if (!memcmp(d, "\xa1\xb2\xc3\xd4", 4) || !memcmp(d, "\xa1\xb2\x3c\x4d", 4))
        be = true;
    else
        return;
    // Nanosecond-resolution magics (a1b23c4d and its byte swap).
    bool nsec = !memcmp(d, "\xa1\xb2\x3c\x4d", 4) || !memcmp(d, "\x4d\x3c\xb2\xa1", 4);
    double frac = nsec ? 1e-9 : 1e-6;
    uint32_t linktype = rd32(d + 20, be) & 0xFFFF;
    size_t off = 24;
    while (off + 16 <= len) {
        uint32_t sec = rd32(d + off, be);
        uint32_t sub = rd32(d + off + 4, be);
        uint32_t caplen = rd32(d + off + 8, be);
        off += 16;
        if (off + caplen > len) break;
        frames.push_back({d + off, caplen, sec + sub * frac, true});
        linktypes.push_back(linktype);
        off += caplen;
    }
}

// seconds per timestamp unit from an IDB's if_tsresol option (code 9)
double idb_tsresol(const uint8_t* body, size_t bodylen, bool be) {
    size_t off = 8;  // linktype(2) + reserved(2) + snaplen(4)
    while (off + 4 <= bodylen) {
        uint16_t code = rd16(body + off, be), ln = rd16(body + off + 2, be);
        if (code == 0) break;  // opt_endofopt
        if (code == 9 && ln >= 1 && off + 4 < bodylen) {
            uint8_t v = body[off + 4];
            double r = 1.0;
            if (v & 0x80) {
                for (int i = 0; i < (v & 0x7F); i++) r /= 2.0;
            } else {
                for (int i = 0; i < (v & 0x7F); i++) r /= 10.0;
            }
            return r;
        }
        off += 4 + ln + ((4 - ln % 4) % 4);
    }
    return 1e-6;
}

void pcapng_frames(const uint8_t* d, size_t len, std::vector<Frame>& frames,
                   std::vector<uint32_t>& linktypes) {
    if (len < 12 || memcmp(d, "\x0a\x0d\x0d\x0a", 4)) return;
    bool be = !(len >= 12 && !memcmp(d + 8, "\x4d\x3c\x2b\x1a", 4));
    size_t off = 0;
    std::vector<std::pair<uint32_t, double>> ifaces;  // (linktype, tsresol)
    while (off + 12 <= len) {
        uint32_t btype = rd32(d + off, be);
        uint32_t blen = rd32(d + off + 4, be);
        if (blen < 12 || off + blen > len) break;
        const uint8_t* body = d + off + 8;
        size_t bodylen = blen - 12;
        if (btype == 0x00000001 && bodylen >= 2) {  // IDB
            ifaces.emplace_back(rd16(body, be), idb_tsresol(body, bodylen, be));
        } else if (btype == 0x00000006 && bodylen >= 20) {  // EPB
            uint32_t iface = rd32(body, be);
            uint32_t tsh = rd32(body + 4, be), tsl = rd32(body + 8, be);
            uint32_t caplen = rd32(body + 12, be);
            if (caplen > bodylen - 20) caplen = bodylen - 20;
            double res = iface < ifaces.size() ? ifaces[iface].second : 1e-6;
            double ts = (double)(((uint64_t)tsh << 32) | tsl) * res;
            frames.push_back({body + 20, caplen, ts, true});
            linktypes.push_back(iface < ifaces.size() ? ifaces[iface].first : 105);
        } else if (btype == 0x00000003 && bodylen >= 4) {  // SPB: no timestamp
            uint32_t caplen = rd32(body, be);
            if (caplen > bodylen - 4) caplen = bodylen - 4;
            frames.push_back({body + 4, caplen, 0.0, false});
            linktypes.push_back(ifaces.empty() ? 105 : ifaces[0].first);
        }
        off += blen;
    }
}

// strip link-layer wrappers; returns empty frame to drop
Frame unwrap(Frame f, uint32_t lt) {
    if (lt == 127 || lt == 192) {  // radiotap / PPI: LE length at offset 2
        if (f.n < 4) return {nullptr, 0, 0.0, false};
        uint16_t hl = rd16(f.p + 2, false);
        if (hl > f.n) return {nullptr, 0, 0.0, false};
        return {f.p + hl, f.n - hl, f.ts, f.has_ts};
    }
    if (lt != 105) return {nullptr, 0, 0.0, false};
    return f;
}

// ---- 802.11 -------------------------------------------------------------

// walk tagged parameters from `off`; SSID tag with 0 < len <= 32, nonzero
bool tagged_ssid(const uint8_t* p, size_t n, size_t off, Bytes& out) {
    while (off + 2 <= n) {
        uint8_t tag = p[off], ln = p[off + 1];
        if (off + 2 + ln > n) return false;
        if (tag == 0) {
            if (ln == 0 || ln > 32) return false;
            bool nz = false;
            for (int i = 0; i < ln; i++) nz |= p[off + 2 + i] != 0;
            if (!nz) return false;
            out.assign((const char*)p + off + 2, ln);
            return true;
        }
        off += 2 + ln;
    }
    return false;
}

bool parse_eapol_key(const Bytes& ap, const Bytes& sta, const uint8_t* e,
                     size_t n, EapolMsg& m) {
    if (n < 99 || e[1] != 3) return false;
    if (e[4] != 2 && e[4] != 254) return false;  // RSN / WPA descriptor
    uint16_t ki = rd16(e + 5, true);
    if (!(ki & 0x0008)) return false;  // pairwise
    m.replay = rd64be(e + 9);
    m.nonce.assign((const char*)e + 17, 32);
    m.mic.assign((const char*)e + 81, 16);
    uint16_t kd_len = rd16(e + 97, true);
    size_t kd_end = 99 + kd_len;
    if (kd_end > n) kd_end = n;

    bool ack = ki & 0x0080, has_mic = ki & 0x0100, secure = ki & 0x0200;
    if (ack && !has_mic) m.num = 1;
    else if (ack && has_mic) m.num = 3;
    else if (has_mic && !secure) m.num = 2;
    else m.num = 4;

    if (m.num == 1 || m.num == 3) {
        size_t off = 99;
        while (off + 2 <= kd_end) {
            uint8_t t = e[off], ln = e[off + 1];
            size_t cend = off + 2 + ln;
            if (cend > kd_end) cend = kd_end;
            if (t == 0xDD && ln >= 20 && cend - (off + 2) >= 20 &&
                !memcmp(e + off + 2, "\x00\x0f\xac\x04", 4)) {
                const uint8_t* pk = e + off + 6;
                bool nz = false, allff = true;
                for (int i = 0; i < 16; i++) {
                    nz |= pk[i] != 0;
                    allff &= pk[i] == 0xFF;
                }
                if (nz && !allff) m.pmkids.emplace_back((const char*)pk, 16);
            }
            off += 2 + ln;
        }
    }

    Bytes zeroed((const char*)e, n);
    memset(&zeroed[81], 0, 16);
    size_t declared = (size_t)rd16(e + 2, true) + 4;
    size_t keep = declared < n ? declared : n;
    if (keep < 95) keep = 95;
    zeroed.resize(keep < n ? keep : n);
    m.frame = std::move(zeroed);
    m.ap = ap;
    m.sta = sta;
    return true;
}

// ---- assembly -----------------------------------------------------------

struct Pairing {
    int sta_num, ap_num, delta, mp;
};
const Pairing PAIRINGS[] = {
    {2, 1, 0, 0x00}, {2, 3, 1, 0x02}, {4, 1, -1, 0x01}, {4, 3, 0, 0x03},
};

// insertion-ordered map: linear scan (captures hold few stations)
template <typename V>
struct OrderedMap {
    std::vector<std::pair<Bytes, V>> items;
    V* find(const Bytes& k) {
        for (auto& it : items)
            if (it.first == k) return &it.second;
        return nullptr;
    }
    V& get(const Bytes& k) {
        if (V* v = find(k)) return *v;
        items.emplace_back(k, V{});
        return items.back().second;
    }
};

std::string serialize(int type, const Bytes& mic, const Bytes& ap,
                      const Bytes& sta, const Bytes& essid,
                      const Bytes& anonce, const Bytes& eapol, int mp) {
    char t[4], mpbuf[4];
    snprintf(t, sizeof t, "%02d", type);
    snprintf(mpbuf, sizeof mpbuf, "%02x", mp);
    return std::string("WPA*") + t + "*" + hex(mic) + "*" + hex(ap) + "*" +
           hex(sta) + "*" + hex(essid) + "*" + hex(anonce) + "*" + hex(eapol) +
           "*" + mpbuf;
}

}  // namespace

extern "C" {

int dwpa_extract(const uint8_t* blob, size_t len, int nc_hint,
                 double eapol_timeout_s, char** out, size_t* out_len) {
    if (!blob || !out || !out_len) return -1;
    std::vector<Frame> raw;
    std::vector<uint32_t> lts;
    if (len >= 4 && !memcmp(blob, "\x0a\x0d\x0d\x0a", 4))
        pcapng_frames(blob, len, raw, lts);
    else
        pcap_frames(blob, len, raw, lts);

    // ap -> [(ssid, count)] in first-seen order (Counter.most_common tie
    // semantics: max count, earliest insertion wins)
    OrderedMap<std::vector<std::pair<Bytes, int>>> essids;
    std::vector<Bytes> probes;
    OrderedMap<std::vector<EapolMsg>> ap_msgs, sta_msgs;  // key: ap||sta
    OrderedMap<std::vector<Bytes>> ap_nonces;             // key: ap
    std::vector<std::pair<Bytes, Bytes>> pmkid_keys;      // dedup keys seen
    struct PmkidRow { Bytes ap, sta, pmkid; };
    std::vector<PmkidRow> pmkid_rows;

    for (size_t fi = 0; fi < raw.size(); fi++) {
        Frame f = unwrap(raw[fi], lts[fi]);
        if (!f.p || f.n < 24) continue;
        const uint8_t* p = f.p;
        uint16_t fc = rd16(p, false);
        int ftype = (fc >> 2) & 3, subtype = (fc >> 4) & 0xF;
        bool to_ds = fc & 0x100, from_ds = fc & 0x200;
        Bytes a1((const char*)p + 4, 6), a2((const char*)p + 10, 6),
            a3((const char*)p + 16, 6);

        if (ftype == 0) {  // management
            Bytes ssid;
            if (subtype == 8 || subtype == 5) {
                if (tagged_ssid(p, f.n, 24 + 12, ssid)) {
                    auto& vec = essids.get(a3);
                    bool hit = false;
                    for (auto& sc : vec)
                        if (sc.first == ssid) { sc.second++; hit = true; break; }
                    if (!hit) vec.emplace_back(ssid, 1);
                }
            } else if (subtype == 4) {
                if (tagged_ssid(p, f.n, 24, ssid)) {
                    bool seen = false;
                    for (auto& pr : probes) seen |= pr == ssid;
                    if (!seen) probes.push_back(ssid);
                }
            } else if (subtype == 0 || subtype == 2) {
                size_t skip = subtype == 0 ? 4 : 10;
                if (tagged_ssid(p, f.n, 24 + skip, ssid)) {
                    auto& vec = essids.get(a3);
                    bool hit = false;
                    for (auto& sc : vec)
                        if (sc.first == ssid) { sc.second++; hit = true; break; }
                    if (!hit) vec.emplace_back(ssid, 1);
                }
            }
            continue;
        }
        if (ftype != 2) continue;  // data only

        size_t hdr = 24;
        if (to_ds && from_ds) hdr += 6;
        if (subtype & 8) hdr += 2;      // QoS
        if (fc & 0x8000) hdr += 4;      // HT control
        if (hdr + 8 > f.n) continue;
        if (memcmp(p + hdr, "\xaa\xaa\x03", 3) ||
            rd16(p + hdr + 6, true) != 0x888E)
            continue;
        const uint8_t* eapol = p + hdr + 8;
        size_t elen = f.n - hdr - 8;
        Bytes ap, sta;
        if (to_ds) { ap = a1; sta = a2; }
        else if (from_ds) { ap = a2; sta = a1; }
        else { ap = a3; sta = a2; }

        EapolMsg m;
        if (!parse_eapol_key(ap, sta, eapol, elen, m)) continue;
        m.ts = f.ts;
        m.has_ts = f.has_ts;
        Bytes key = ap + sta;
        (m.num == 1 || m.num == 3 ? ap_msgs : sta_msgs).get(key).push_back(m);
        if (m.num == 1 || m.num == 3) ap_nonces.get(ap).push_back(m.nonce);
        for (auto& pk : m.pmkids) {
            bool seen = false;
            for (auto& row : pmkid_rows)
                seen |= row.ap == ap && row.sta == sta && row.pmkid == pk;
            if (!seen) pmkid_rows.push_back({ap, sta, pk});
        }
    }

    // Observed nonce-increment endianness -> MP_LE (0x20) / MP_BE (0x40)
    // hint bits, mirroring the Python parser's endian_bits().  Memoized
    // per AP: ap_nonces is immutable by the time the pairing loop runs,
    // and one AP can emit many handshake lines.
    OrderedMap<int> endian_cache;
    auto endian_bits = [&](const Bytes& ap) -> int {
        if (int* hit = endian_cache.find(ap)) return *hit;
        bool le = false, be = false;
        int& slot = endian_cache.get(ap);
        auto* nonces = ap_nonces.find(ap);
        if (!nonces) return slot = 0;
        for (size_t i = 0; i + 1 < nonces->size(); i++) {
            const Bytes& a = (*nonces)[i];
            const Bytes& b = (*nonces)[i + 1];
            if (a == b || a.compare(0, 28, b, 0, 28) != 0) continue;
            const uint8_t* ap4 = (const uint8_t*)a.data() + 28;
            const uint8_t* bp4 = (const uint8_t*)b.data() + 28;
            bool hit = false;
            for (int isle = 1; isle >= 0 && !hit; isle--) {
                uint32_t av = isle ? rd32(ap4, false) : rd32(ap4, true);
                uint32_t bv = isle ? rd32(bp4, false) : rd32(bp4, true);
                int64_t d = (int64_t)(uint32_t)(bv - av);
                if (d >= 0x80000000LL) d -= 0x100000000LL;
                if (d != 0 && (d < 0 ? -d : d) <= 128) {
                    (isle ? le : be) = true;
                    hit = true;
                }
            }
        }
        return slot = (le != be ? (le ? 0x20 : 0x40) : 0);
    };

    auto best_essid = [&](const Bytes& ap, Bytes& out_ssid) {
        auto* vec = essids.find(ap);
        if (!vec || vec->empty()) return false;
        int best = -1;
        for (auto& sc : *vec)
            if (sc.second > best) { best = sc.second; out_ssid = sc.first; }
        return true;
    };

    std::string text;
    for (auto& row : pmkid_rows) {
        Bytes essid;
        if (!best_essid(row.ap, essid)) continue;
        text += "H " +
                serialize(1, row.pmkid, row.ap, row.sta, essid, "", "", 1) +
                "\n";
    }

    for (auto& kv : sta_msgs.items) {
        const Bytes& key = kv.first;
        Bytes ap = key.substr(0, 6);
        Bytes essid;
        if (!best_essid(ap, essid)) continue;
        auto* aps = ap_msgs.find(key);
        bool done = false;
        for (const auto& pr : PAIRINGS) {
            if (done) break;
            for (auto& sm : kv.second) {
                if (done) break;
                if (sm.num != pr.sta_num) continue;
                bool nz = false;
                for (char c : sm.nonce) nz |= c != 0;
                if (!nz) continue;
                if (!aps) continue;
                for (auto& am : *aps) {
                    if (am.num != pr.ap_num) continue;
                    if ((int64_t)(am.replay - sm.replay) != pr.delta) continue;
                    // --eapoltimeout gate (web/common.php:481): messages
                    // captured too far apart are different exchanges.
                    if (am.has_ts && sm.has_ts) {
                        double dt = am.ts - sm.ts;
                        if (dt < 0) dt = -dt;
                        if (dt > eapol_timeout_s) continue;
                    }
                    int mp = pr.mp | (nc_hint ? 0x80 : 0) | endian_bits(ap);
                    text += "H " +
                            serialize(2, sm.mic, ap, sm.sta, essid, am.nonce,
                                      sm.frame, mp) +
                            "\n";
                    done = true;
                    break;
                }
            }
        }
    }

    for (auto& pr : probes) text += "P " + hex(pr) + "\n";

    char* buf = (char*)malloc(text.size() + 1);
    if (!buf) return -1;
    memcpy(buf, text.data(), text.size());
    buf[text.size()] = 0;
    *out = buf;
    *out_len = text.size();
    return 0;
}

void dwpa_free(char* p) { free(p); }

}  // extern "C"
