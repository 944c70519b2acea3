// Candidate packing fast path: a joined candidate blob + per-word
// offsets/lengths -> packed big-endian uint32[n][16] HMAC key blocks.
//
// The native seat of the host feed stage (SURVEY.md §7.3.3 "keeping the
// device fed"): the engine's prepare step — $HEX[...] decode
// (web/common.php:3-25 semantics), PSK length filter (8..63,
// INSTALL.md:83), zero-padded 64-byte key-block packing — fused into
// one pass, so a multi-chip mesh can be fed from a single host core.
// Words are addressed by (offset, length) rather than separators
// because decoded candidates may contain any byte value.
// Differentially tested against the Python pipeline (oracle.hc_unhex +
// bytesops.pack_passwords_be) in tests/test_native_pack.py.
//
// Contract (ctypes, see native/__init__.py):
//   n = dwpa_pack(blob, offs, wlens, count, min_len, max_len,
//                 out_words, out_lens)
// out_words: caller-zeroed capacity [count][16] uint32; out_lens:
// [count] uint8.  Returns the accepted row count (rows are written
// contiguously from 0), or -1 on bad arguments.  A $HEX[...] wrapper
// with valid even-length hex decodes; an invalid one is taken
// literally (hashcat behavior).

#include <cstddef>
#include <cstdint>
#include <cstring>

namespace {

inline int hexval(uint8_t c) {
    if (c >= '0' && c <= '9') return c - '0';
    if (c >= 'a' && c <= 'f') return c - 'a' + 10;
    if (c >= 'A' && c <= 'F') return c - 'A' + 10;
    return -1;
}

// decode $HEX[...] into buf (capacity 64); returns decoded length, or
// -1 if the wrapper is invalid (caller treats the word literally)
inline int try_unhex(const uint8_t* w, size_t len, uint8_t* buf) {
    if (len < 7 || memcmp(w, "$HEX[", 5) != 0 || w[len - 1] != ']')
        return -1;
    size_t ndig = len - 6;
    if (ndig % 2 != 0 || ndig / 2 > 64) return -1;
    for (size_t i = 0; i < ndig; i += 2) {
        int hi = hexval(w[5 + i]), lo = hexval(w[5 + i + 1]);
        if (hi < 0 || lo < 0) return -1;
        buf[i / 2] = (uint8_t)((hi << 4) | lo);
    }
    return (int)(ndig / 2);
}

}  // namespace

extern "C" long dwpa_pack(const uint8_t* blob, const long long* offs,
                          const long long* wlens, long count, int min_len,
                          int max_len, uint32_t* out_words,
                          uint8_t* out_lens) {
    if (!blob || !offs || !wlens || !out_words || !out_lens ||
        min_len < 0 || max_len > 63 || min_len > max_len || count < 0)
        return -1;
    long n = 0;
    uint8_t decoded[64];
    for (long i = 0; i < count; i++) {
        const uint8_t* w = blob + offs[i];
        size_t wlen = (size_t)wlens[i];
        const uint8_t* src = w;
        size_t slen = wlen;
        if (wlen <= 134) {  // $HEX[ + 2*64 + ] — anything longer can't decode
            int dlen = try_unhex(w, wlen, decoded);
            if (dlen >= 0) {
                src = decoded;
                slen = (size_t)dlen;
            }
        }
        if (slen < (size_t)min_len || slen > (size_t)max_len) continue;
        uint32_t* row = out_words + n * 16;
        for (size_t b = 0; b < slen; b++)
            row[b / 4] |= (uint32_t)src[b] << (8 * (3 - (b % 4)));
        out_lens[n] = (uint8_t)slen;
        n++;
    }
    return n;
}
