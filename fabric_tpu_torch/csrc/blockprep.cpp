// Whole-block transaction preparation on the host: the port's copy of
// the JAX package's native block prep (native/blockprep.cpp there), with
// the same semantics.
//
// One C call turns a block's envelope list into flat arrays: protobuf
// wire-format field extraction down the envelope -> payload -> header
// -> transaction -> action -> endorsement chain, SHA-256 digest lanes
// (the creator's payload digest, each endorsement's prp || endorser
// digest; SHA-NI where the host has it), the txid binding check,
// identity deduplication, and DER signature staging through
// batchprep.cpp's batch inversion (ftpu_batch_prep_ptrs). The peer's
// block fast path (fabric_tpu_torch/core/fastvalidate.py
// `signature_phase`) assembles its signature lanes from these arrays and
// hands them to the CUDA provider's `verify_prepared_start`.
//
// SEMANTICS CONTRACT: this parser is *optimistic*. It fully decides a
// transaction only when the envelope chain parses CLEANLY: every field
// is a known number with the expected wire type, singular fields appear
// once, strings are valid UTF-8, nested messages that upb would parse
// eagerly parse here too. Anything else returns BP_NEEDS_PYTHON for that
// tx, and the caller's per-tx path decides it. tests/test_torch_
// fastvalidate.py holds every output array to the JAX package's
// library on valid, tampered, mutated and unusual blocks.
//
// The port binds only ftpu_block_prep: the reference library's
// standalone entries (SHA-256, the block store's txid scan, the UTF-8
// check) have no caller here and are left out.
//
// C++ with the standard library and threads (FTPU_NATIVE_THREADS, at
// most 8 by default). fabric_tpu_torch/native.py builds it together with
// batchprep.cpp into one library with g++ -O3 -shared -fPIC -lpthread.

#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <functional>
#include <thread>
#include <vector>

#if defined(__x86_64__) || defined(__i386__)
#include <cpuid.h>
#include <immintrin.h>
#define FTPU_X86 1
#endif

// from batchprep.cpp
extern "C" void ftpu_batch_prep_ptrs(const uint8_t *const *ptrs,
                                     const int32_t *lens, int32_t n,
                                     uint8_t *r_out, uint8_t *rpn_out,
                                     uint8_t *w_out, uint8_t *ok_out);

namespace {

// ---------------- SHA-256 (FIPS 180-4) ----------------

const uint32_t SHA_K[64] = {
    0x428a2f98, 0x71374491, 0xb5c0fbcf, 0xe9b5dba5, 0x3956c25b,
    0x59f111f1, 0x923f82a4, 0xab1c5ed5, 0xd807aa98, 0x12835b01,
    0x243185be, 0x550c7dc3, 0x72be5d74, 0x80deb1fe, 0x9bdc06a7,
    0xc19bf174, 0xe49b69c1, 0xefbe4786, 0x0fc19dc6, 0x240ca1cc,
    0x2de92c6f, 0x4a7484aa, 0x5cb0a9dc, 0x76f988da, 0x983e5152,
    0xa831c66d, 0xb00327c8, 0xbf597fc7, 0xc6e00bf3, 0xd5a79147,
    0x06ca6351, 0x14292967, 0x27b70a85, 0x2e1b2138, 0x4d2c6dfc,
    0x53380d13, 0x650a7354, 0x766a0abb, 0x81c2c92e, 0x92722c85,
    0xa2bfe8a1, 0xa81a664b, 0xc24b8b70, 0xc76c51a3, 0xd192e819,
    0xd6990624, 0xf40e3585, 0x106aa070, 0x19a4c116, 0x1e376c08,
    0x2748774c, 0x34b0bcb5, 0x391c0cb3, 0x4ed8aa4a, 0x5b9cca4f,
    0x682e6ff3, 0x748f82ee, 0x78a5636f, 0x84c87814, 0x8cc70208,
    0x90befffa, 0xa4506ceb, 0xbef9a3f7, 0xc67178f2};

inline uint32_t rotr(uint32_t x, int k) {
    return (x >> k) | (x << (32 - k));
}

#ifdef FTPU_X86
// SHA-NI block transform (Intel SHA extensions): ~10x the scalar
// schedule. Selected at runtime via __builtin_cpu_supports; the
// digest-lane workload (payload + prp||endorser hashing) is the
// single biggest native cost without it.
__attribute__((target("sha,sse4.1")))
void sha256_transform_ni(uint32_t state[8], const uint8_t *data,
                         size_t nblocks) {
    const __m128i MASK = _mm_set_epi64x(
        (long long)0x0c0d0e0f08090a0bULL,
        (long long)0x0405060700010203ULL);
    __m128i TMP = _mm_loadu_si128((const __m128i *)&state[0]);
    __m128i STATE1 = _mm_loadu_si128((const __m128i *)&state[4]);
    TMP = _mm_shuffle_epi32(TMP, 0xB1);          // CDAB
    STATE1 = _mm_shuffle_epi32(STATE1, 0x1B);    // EFGH
    __m128i STATE0 = _mm_alignr_epi8(TMP, STATE1, 8);  // ABEF
    STATE1 = _mm_blend_epi16(STATE1, TMP, 0xF0);       // CDGH

    while (nblocks--) {
        __m128i ABEF_SAVE = STATE0, CDGH_SAVE = STATE1;
        __m128i MSG, MSG0, MSG1, MSG2, MSG3;

        MSG0 = _mm_shuffle_epi8(
            _mm_loadu_si128((const __m128i *)(data + 0)), MASK);
        MSG = _mm_add_epi32(MSG0, _mm_set_epi64x(
            (long long)0xE9B5DBA5B5C0FBCFULL,
            (long long)0x71374491428A2F98ULL));
        STATE1 = _mm_sha256rnds2_epu32(STATE1, STATE0, MSG);
        MSG = _mm_shuffle_epi32(MSG, 0x0E);
        STATE0 = _mm_sha256rnds2_epu32(STATE0, STATE1, MSG);

        MSG1 = _mm_shuffle_epi8(
            _mm_loadu_si128((const __m128i *)(data + 16)), MASK);
        MSG = _mm_add_epi32(MSG1, _mm_set_epi64x(
            (long long)0xAB1C5ED5923F82A4ULL,
            (long long)0x59F111F13956C25BULL));
        STATE1 = _mm_sha256rnds2_epu32(STATE1, STATE0, MSG);
        MSG = _mm_shuffle_epi32(MSG, 0x0E);
        STATE0 = _mm_sha256rnds2_epu32(STATE0, STATE1, MSG);
        MSG0 = _mm_sha256msg1_epu32(MSG0, MSG1);

        MSG2 = _mm_shuffle_epi8(
            _mm_loadu_si128((const __m128i *)(data + 32)), MASK);
        MSG = _mm_add_epi32(MSG2, _mm_set_epi64x(
            (long long)0x550C7DC3243185BEULL,
            (long long)0x12835B01D807AA98ULL));
        STATE1 = _mm_sha256rnds2_epu32(STATE1, STATE0, MSG);
        MSG = _mm_shuffle_epi32(MSG, 0x0E);
        STATE0 = _mm_sha256rnds2_epu32(STATE0, STATE1, MSG);
        MSG1 = _mm_sha256msg1_epu32(MSG1, MSG2);

        MSG3 = _mm_shuffle_epi8(
            _mm_loadu_si128((const __m128i *)(data + 48)), MASK);
        MSG = _mm_add_epi32(MSG3, _mm_set_epi64x(
            (long long)0xC19BF1749BDC06A7ULL,
            (long long)0x80DEB1FE72BE5D74ULL));
        STATE1 = _mm_sha256rnds2_epu32(STATE1, STATE0, MSG);
        __m128i TMP4 = _mm_alignr_epi8(MSG3, MSG2, 4);
        MSG0 = _mm_add_epi32(MSG0, TMP4);
        MSG0 = _mm_sha256msg2_epu32(MSG0, MSG3);
        MSG = _mm_shuffle_epi32(MSG, 0x0E);
        STATE0 = _mm_sha256rnds2_epu32(STATE0, STATE1, MSG);
        MSG2 = _mm_sha256msg1_epu32(MSG2, MSG3);

        MSG = _mm_add_epi32(MSG0, _mm_set_epi64x(
            (long long)0x240CA1CC0FC19DC6ULL,
            (long long)0xEFBE4786E49B69C1ULL));
        STATE1 = _mm_sha256rnds2_epu32(STATE1, STATE0, MSG);
        TMP4 = _mm_alignr_epi8(MSG0, MSG3, 4);
        MSG1 = _mm_add_epi32(MSG1, TMP4);
        MSG1 = _mm_sha256msg2_epu32(MSG1, MSG0);
        MSG = _mm_shuffle_epi32(MSG, 0x0E);
        STATE0 = _mm_sha256rnds2_epu32(STATE0, STATE1, MSG);
        MSG3 = _mm_sha256msg1_epu32(MSG3, MSG0);

        MSG = _mm_add_epi32(MSG1, _mm_set_epi64x(
            (long long)0x76F988DA5CB0A9DCULL,
            (long long)0x4A7484AA2DE92C6FULL));
        STATE1 = _mm_sha256rnds2_epu32(STATE1, STATE0, MSG);
        TMP4 = _mm_alignr_epi8(MSG1, MSG0, 4);
        MSG2 = _mm_add_epi32(MSG2, TMP4);
        MSG2 = _mm_sha256msg2_epu32(MSG2, MSG1);
        MSG = _mm_shuffle_epi32(MSG, 0x0E);
        STATE0 = _mm_sha256rnds2_epu32(STATE0, STATE1, MSG);
        MSG0 = _mm_sha256msg1_epu32(MSG0, MSG1);

        MSG = _mm_add_epi32(MSG2, _mm_set_epi64x(
            (long long)0xBF597FC7B00327C8ULL,
            (long long)0xA831C66D983E5152ULL));
        STATE1 = _mm_sha256rnds2_epu32(STATE1, STATE0, MSG);
        TMP4 = _mm_alignr_epi8(MSG2, MSG1, 4);
        MSG3 = _mm_add_epi32(MSG3, TMP4);
        MSG3 = _mm_sha256msg2_epu32(MSG3, MSG2);
        MSG = _mm_shuffle_epi32(MSG, 0x0E);
        STATE0 = _mm_sha256rnds2_epu32(STATE0, STATE1, MSG);
        MSG1 = _mm_sha256msg1_epu32(MSG1, MSG2);

        MSG = _mm_add_epi32(MSG3, _mm_set_epi64x(
            (long long)0x1429296706CA6351ULL,
            (long long)0xD5A79147C6E00BF3ULL));
        STATE1 = _mm_sha256rnds2_epu32(STATE1, STATE0, MSG);
        TMP4 = _mm_alignr_epi8(MSG3, MSG2, 4);
        MSG0 = _mm_add_epi32(MSG0, TMP4);
        MSG0 = _mm_sha256msg2_epu32(MSG0, MSG3);
        MSG = _mm_shuffle_epi32(MSG, 0x0E);
        STATE0 = _mm_sha256rnds2_epu32(STATE0, STATE1, MSG);
        MSG2 = _mm_sha256msg1_epu32(MSG2, MSG3);

        MSG = _mm_add_epi32(MSG0, _mm_set_epi64x(
            (long long)0x53380D134D2C6DFCULL,
            (long long)0x2E1B213827B70A85ULL));
        STATE1 = _mm_sha256rnds2_epu32(STATE1, STATE0, MSG);
        TMP4 = _mm_alignr_epi8(MSG0, MSG3, 4);
        MSG1 = _mm_add_epi32(MSG1, TMP4);
        MSG1 = _mm_sha256msg2_epu32(MSG1, MSG0);
        MSG = _mm_shuffle_epi32(MSG, 0x0E);
        STATE0 = _mm_sha256rnds2_epu32(STATE0, STATE1, MSG);
        MSG3 = _mm_sha256msg1_epu32(MSG3, MSG0);

        MSG = _mm_add_epi32(MSG1, _mm_set_epi64x(
            (long long)0x92722C8581C2C92EULL,
            (long long)0x766A0ABB650A7354ULL));
        STATE1 = _mm_sha256rnds2_epu32(STATE1, STATE0, MSG);
        TMP4 = _mm_alignr_epi8(MSG1, MSG0, 4);
        MSG2 = _mm_add_epi32(MSG2, TMP4);
        MSG2 = _mm_sha256msg2_epu32(MSG2, MSG1);
        MSG = _mm_shuffle_epi32(MSG, 0x0E);
        STATE0 = _mm_sha256rnds2_epu32(STATE0, STATE1, MSG);
        MSG0 = _mm_sha256msg1_epu32(MSG0, MSG1);

        MSG = _mm_add_epi32(MSG2, _mm_set_epi64x(
            (long long)0xC76C51A3C24B8B70ULL,
            (long long)0xA81A664BA2BFE8A1ULL));
        STATE1 = _mm_sha256rnds2_epu32(STATE1, STATE0, MSG);
        TMP4 = _mm_alignr_epi8(MSG2, MSG1, 4);
        MSG3 = _mm_add_epi32(MSG3, TMP4);
        MSG3 = _mm_sha256msg2_epu32(MSG3, MSG2);
        MSG = _mm_shuffle_epi32(MSG, 0x0E);
        STATE0 = _mm_sha256rnds2_epu32(STATE0, STATE1, MSG);
        MSG1 = _mm_sha256msg1_epu32(MSG1, MSG2);

        MSG = _mm_add_epi32(MSG3, _mm_set_epi64x(
            (long long)0x106AA070F40E3585ULL,
            (long long)0xD6990624D192E819ULL));
        STATE1 = _mm_sha256rnds2_epu32(STATE1, STATE0, MSG);
        TMP4 = _mm_alignr_epi8(MSG3, MSG2, 4);
        MSG0 = _mm_add_epi32(MSG0, TMP4);
        MSG0 = _mm_sha256msg2_epu32(MSG0, MSG3);
        MSG = _mm_shuffle_epi32(MSG, 0x0E);
        STATE0 = _mm_sha256rnds2_epu32(STATE0, STATE1, MSG);
        MSG2 = _mm_sha256msg1_epu32(MSG2, MSG3);

        MSG = _mm_add_epi32(MSG0, _mm_set_epi64x(
            (long long)0x34B0BCB52748774CULL,
            (long long)0x1E376C0819A4C116ULL));
        STATE1 = _mm_sha256rnds2_epu32(STATE1, STATE0, MSG);
        TMP4 = _mm_alignr_epi8(MSG0, MSG3, 4);
        MSG1 = _mm_add_epi32(MSG1, TMP4);
        MSG1 = _mm_sha256msg2_epu32(MSG1, MSG0);
        MSG = _mm_shuffle_epi32(MSG, 0x0E);
        STATE0 = _mm_sha256rnds2_epu32(STATE0, STATE1, MSG);
        MSG3 = _mm_sha256msg1_epu32(MSG3, MSG0);

        MSG = _mm_add_epi32(MSG1, _mm_set_epi64x(
            (long long)0x682E6FF35B9CCA4FULL,
            (long long)0x4ED8AA4A391C0CB3ULL));
        STATE1 = _mm_sha256rnds2_epu32(STATE1, STATE0, MSG);
        TMP4 = _mm_alignr_epi8(MSG1, MSG0, 4);
        MSG2 = _mm_add_epi32(MSG2, TMP4);
        MSG2 = _mm_sha256msg2_epu32(MSG2, MSG1);
        MSG = _mm_shuffle_epi32(MSG, 0x0E);
        STATE0 = _mm_sha256rnds2_epu32(STATE0, STATE1, MSG);

        MSG = _mm_add_epi32(MSG2, _mm_set_epi64x(
            (long long)0x8CC7020884C87814ULL,
            (long long)0x78A5636F748F82EEULL));
        STATE1 = _mm_sha256rnds2_epu32(STATE1, STATE0, MSG);
        TMP4 = _mm_alignr_epi8(MSG2, MSG1, 4);
        MSG3 = _mm_add_epi32(MSG3, TMP4);
        MSG3 = _mm_sha256msg2_epu32(MSG3, MSG2);
        MSG = _mm_shuffle_epi32(MSG, 0x0E);
        STATE0 = _mm_sha256rnds2_epu32(STATE0, STATE1, MSG);

        MSG = _mm_add_epi32(MSG3, _mm_set_epi64x(
            (long long)0xC67178F2BEF9A3F7ULL,
            (long long)0xA4506CEB90BEFFFAULL));
        STATE1 = _mm_sha256rnds2_epu32(STATE1, STATE0, MSG);
        MSG = _mm_shuffle_epi32(MSG, 0x0E);
        STATE0 = _mm_sha256rnds2_epu32(STATE0, STATE1, MSG);

        STATE0 = _mm_add_epi32(STATE0, ABEF_SAVE);
        STATE1 = _mm_add_epi32(STATE1, CDGH_SAVE);
        data += 64;
    }

    TMP = _mm_shuffle_epi32(STATE0, 0x1B);       // FEBA
    STATE1 = _mm_shuffle_epi32(STATE1, 0xB1);    // DCHG
    STATE0 = _mm_blend_epi16(TMP, STATE1, 0xF0); // DCBA
    STATE1 = _mm_alignr_epi8(STATE1, TMP, 8);    // HGFE
    _mm_storeu_si128((__m128i *)&state[0], STATE0);
    _mm_storeu_si128((__m128i *)&state[4], STATE1);
}

bool sha_ni_supported() {
    // __builtin_cpu_supports("sha") only exists on gcc >= 11; probe
    // CPUID directly (leaf 7 EBX bit 29 = SHA-NI, leaf 1 ECX bit 19 =
    // SSE4.1) so the library still builds on older toolchains —
    // without this the WHOLE native prep layer silently fell back to
    // Python on gcc 10 hosts
    unsigned int eax, ebx, ecx, edx;
    if (!__get_cpuid_count(7, 0, &eax, &ebx, &ecx, &edx))
        return false;
    if (!(ebx & (1u << 29)))
        return false;
    if (!__get_cpuid(1, &eax, &ebx, &ecx, &edx))
        return false;
    return (ecx & (1u << 19)) != 0;
}
#else
bool sha_ni_supported() { return false; }
void sha256_transform_ni(uint32_t *, const uint8_t *, size_t) {}
#endif

const bool USE_SHA_NI = sha_ni_supported();

struct Sha256 {
    uint32_t h[8];
    uint8_t buf[64];
    uint64_t total;
    size_t fill;

    void init() {
        h[0] = 0x6a09e667; h[1] = 0xbb67ae85; h[2] = 0x3c6ef372;
        h[3] = 0xa54ff53a; h[4] = 0x510e527f; h[5] = 0x9b05688c;
        h[6] = 0x1f83d9ab; h[7] = 0x5be0cd19;
        total = 0;
        fill = 0;
    }

    void transform(const uint8_t *p) {
        uint32_t w[64];
        for (int i = 0; i < 16; ++i)
            w[i] = (uint32_t)p[4 * i] << 24 |
                   (uint32_t)p[4 * i + 1] << 16 |
                   (uint32_t)p[4 * i + 2] << 8 | p[4 * i + 3];
        for (int i = 16; i < 64; ++i) {
            uint32_t s0 = rotr(w[i - 15], 7) ^ rotr(w[i - 15], 18) ^
                          (w[i - 15] >> 3);
            uint32_t s1 = rotr(w[i - 2], 17) ^ rotr(w[i - 2], 19) ^
                          (w[i - 2] >> 10);
            w[i] = w[i - 16] + s0 + w[i - 7] + s1;
        }
        uint32_t a = h[0], b = h[1], c = h[2], d = h[3], e = h[4],
                 f = h[5], g = h[6], hh = h[7];
        for (int i = 0; i < 64; ++i) {
            uint32_t S1 = rotr(e, 6) ^ rotr(e, 11) ^ rotr(e, 25);
            uint32_t ch = (e & f) ^ (~e & g);
            uint32_t t1 = hh + S1 + ch + SHA_K[i] + w[i];
            uint32_t S0 = rotr(a, 2) ^ rotr(a, 13) ^ rotr(a, 22);
            uint32_t mj = (a & b) ^ (a & c) ^ (b & c);
            uint32_t t2 = S0 + mj;
            hh = g; g = f; f = e; e = d + t1;
            d = c; c = b; b = a; a = t1 + t2;
        }
        h[0] += a; h[1] += b; h[2] += c; h[3] += d;
        h[4] += e; h[5] += f; h[6] += g; h[7] += hh;
    }

    void transform_blocks(const uint8_t *p, size_t k) {
        if (USE_SHA_NI) {
            sha256_transform_ni(h, p, k);
            return;
        }
        while (k--) {
            transform(p);
            p += 64;
        }
    }

    void update(const uint8_t *p, size_t n) {
        total += n;
        if (fill) {
            size_t take = 64 - fill;
            if (take > n) take = n;
            memcpy(buf + fill, p, take);
            fill += take;
            p += take;
            n -= take;
            if (fill == 64) {
                transform_blocks(buf, 1);
                fill = 0;
            }
        }
        if (n >= 64) {
            size_t k = n / 64;
            transform_blocks(p, k);
            p += k * 64;
            n -= k * 64;
        }
        if (n) {
            memcpy(buf, p, n);
            fill = n;
        }
    }

    void final(uint8_t out[32]) {
        uint64_t bits = total * 8;
        uint8_t pad = 0x80;
        update(&pad, 1);
        uint8_t z = 0;
        while (fill != 56) update(&z, 1);
        uint8_t lenb[8];
        for (int i = 0; i < 8; ++i)
            lenb[i] = (uint8_t)(bits >> (56 - 8 * i));
        update(lenb, 8);
        for (int i = 0; i < 8; ++i) {
            out[4 * i] = (uint8_t)(h[i] >> 24);
            out[4 * i + 1] = (uint8_t)(h[i] >> 16);
            out[4 * i + 2] = (uint8_t)(h[i] >> 8);
            out[4 * i + 3] = (uint8_t)h[i];
        }
    }
};

void sha256_one(const uint8_t *p, size_t n, uint8_t out[32]) {
    Sha256 s;
    s.init();
    s.update(p, n);
    s.final(out);
}

// ---------------- protobuf wire scanning ----------------

struct Slice {
    const uint8_t *p;
    int64_t n;
};

const Slice NIL = {nullptr, 0};

// <= 10 bytes, canonical 64-bit range (10th byte must be 0x01 or the
// encoding exceeds 64 bits -> not clean)
bool read_varint(const Slice &in, int64_t &pos, uint64_t &val) {
    uint64_t v = 0;
    int shift = 0;
    for (int i = 0; i < 10; ++i) {
        if (pos >= in.n) return false;
        uint8_t b = in.p[pos++];
        if (i == 9 && b > 0x01) return false;
        v |= (uint64_t)(b & 0x7F) << shift;
        if (!(b & 0x80)) {
            val = v;
            return true;
        }
        shift += 7;
    }
    return false;
}

bool read_len_delim(const Slice &in, int64_t &pos, Slice &out) {
    uint64_t len;
    if (!read_varint(in, pos, len)) return false;
    if (len > (uint64_t)(in.n - pos)) return false;
    out.p = in.p + pos;
    out.n = (int64_t)len;
    pos += (int64_t)len;
    return true;
}

// strict UTF-8 (what upb enforces on proto3 string fields): no
// overlongs, no surrogates, max U+10FFFF
bool valid_utf8(const Slice &s) {
    int64_t i = 0;
    while (i < s.n) {
        uint8_t c = s.p[i];
        if (c < 0x80) {
            ++i;
        } else if ((c & 0xE0) == 0xC0) {
            if (i + 1 >= s.n || (s.p[i + 1] & 0xC0) != 0x80) return false;
            if (c < 0xC2) return false;  // overlong
            i += 2;
        } else if ((c & 0xF0) == 0xE0) {
            if (i + 2 >= s.n || (s.p[i + 1] & 0xC0) != 0x80 ||
                (s.p[i + 2] & 0xC0) != 0x80)
                return false;
            uint32_t cp = ((uint32_t)(c & 0x0F) << 12) |
                          ((uint32_t)(s.p[i + 1] & 0x3F) << 6) |
                          (s.p[i + 2] & 0x3F);
            if (cp < 0x800 || (cp >= 0xD800 && cp <= 0xDFFF))
                return false;
            i += 3;
        } else if ((c & 0xF8) == 0xF0) {
            if (i + 3 >= s.n || (s.p[i + 1] & 0xC0) != 0x80 ||
                (s.p[i + 2] & 0xC0) != 0x80 ||
                (s.p[i + 3] & 0xC0) != 0x80)
                return false;
            uint32_t cp = ((uint32_t)(c & 0x07) << 18) |
                          ((uint32_t)(s.p[i + 1] & 0x3F) << 12) |
                          ((uint32_t)(s.p[i + 2] & 0x3F) << 6) |
                          (s.p[i + 3] & 0x3F);
            if (cp < 0x10000 || cp > 0x10FFFF) return false;
            i += 4;
        } else {
            return false;
        }
    }
    return true;
}

// Generic clean scan of a message whose fields are all singular.
// kinds[f] for f in 1..maxf: 'v' varint, 'l' length-delimited,
// 's' length-delimited UTF-8 string, 0 = unknown (fail).
// Returns 1 on clean parse; slices/ints indexed by field number.
int scan_msg(const Slice &in, const char *kinds, int maxf,
             Slice *slices, uint64_t *ints) {
    uint32_t seen = 0;
    int64_t pos = 0;
    while (pos < in.n) {
        uint64_t tag;
        if (!read_varint(in, pos, tag)) return 0;
        uint64_t f = tag >> 3;
        uint32_t wt = (uint32_t)(tag & 7);
        if (f < 1 || f > (uint64_t)maxf) return 0;
        char k = kinds[f];
        if (k == 0) return 0;
        if (seen & (1u << f)) return 0;
        seen |= 1u << f;
        if (k == 'v') {
            uint64_t v;
            if (wt != 0 || !read_varint(in, pos, v)) return 0;
            if (ints) ints[f] = v;
        } else {  // 'l' or 's'
            Slice s;
            if (wt != 2 || !read_len_delim(in, pos, s)) return 0;
            if (k == 's' && !valid_utf8(s)) return 0;
            if (slices) slices[f] = s;
        }
    }
    return 1;
}

// ---- message shapes (field kinds indexed by field number) ----
// fabric_tpu/protos/common.proto, transaction.proto, proposal.proto

const char K_ENVELOPE[] = {0, 'l', 'l'};                  // payload, sig
const char K_PAYLOAD[] = {0, 'l', 'l'};                   // header(msg), data
const char K_HEADER[] = {0, 'l', 'l'};                    // chdr, shdr
// type, version, timestamp, channel_id, tx_id, epoch, ext, tls_hash
const char K_CHANNEL_HDR[] = {0, 'v', 'v', 'v', 's', 's', 'v', 'l', 'l'};
const char K_SIG_HDR[] = {0, 'l', 'l'};                   // creator, nonce
const char K_TX_ACTION[] = {0, 'l', 'l'};                 // header, payload
const char K_CAP[] = {0, 'l', 'l'};          // cc_proposal_payload, action(msg)
const char K_ENDORSEMENT[] = {0, 'l', 'l'};               // endorser, sig
const char K_PRP[] = {0, 'l', 'l'};                       // hash, extension
const char K_CC_ACTION[] = {0, 'l', 'l', 'l', 'l'};  // results, events, resp, id
const char K_RESPONSE[] = {0, 'v', 's', 'l'};         // status, message, payload
const char K_CHAINCODE_ID[] = {0, 's', 's', 's'};     // name, version, path

// ---- rwset scanning (fabric_tpu/protos/rwset.proto) ----
//
// Mirrors what the VSCC's extract_write_info touches: upb eagerly
// parses TxReadWriteSet / NsReadWriteSet / CollectionHashedReadWriteSet
// when ChaincodeAction.results is unmarshaled; the per-ns KVRWSet bytes
// are parsed only for the tx's own chaincode namespace. rw_mode output:
//   1 = clean + PLAIN: only non-delete public writes in the matching
//       namespace, no metadata writes, no collections — the written
//       keys are fully captured in the flat key table.
//   2 = clean + RICH: parses fine but has features (deletes, metadata,
//       collections, >MAX_K keys) the Python path must walk.
//   3 = NOT clean: the Python parser decides (and may reject).

const int MAX_K = 16;            // plain written keys per tx

const char K_VERSION[] = {0, 'v', 'v'};
const char K_KVWRITE[] = {0, 's', 'v', 'l'};
const char K_MERKLE[] = {0, 'v', 'v', 0};   // field 3 repeated, custom

int scan_kvread(const Slice &in) {
    int64_t pos = 0;
    bool seen1 = false, seen2 = false;
    while (pos < in.n) {
        uint64_t tag;
        if (!read_varint(in, pos, tag)) return 0;
        uint64_t f = tag >> 3;
        uint32_t wt = (uint32_t)(tag & 7);
        Slice s;
        if (f == 1 && wt == 2) {
            if (seen1) return 0;
            seen1 = true;
            if (!read_len_delim(in, pos, s) || !valid_utf8(s)) return 0;
        } else if (f == 2 && wt == 2) {
            if (seen2) return 0;
            seen2 = true;
            if (!read_len_delim(in, pos, s)) return 0;
            if (!scan_msg(s, K_VERSION, 2, nullptr, nullptr)) return 0;
        } else {
            return 0;
        }
    }
    return 1;
}

int scan_query_reads(const Slice &in) {
    int64_t pos = 0;
    while (pos < in.n) {
        uint64_t tag;
        if (!read_varint(in, pos, tag)) return 0;
        if ((tag >> 3) != 1 || (tag & 7) != 2) return 0;
        Slice s;
        if (!read_len_delim(in, pos, s)) return 0;
        if (!scan_kvread(s)) return 0;
    }
    return 1;
}

int scan_merkle(const Slice &in) {
    int64_t pos = 0;
    bool seen1 = false, seen2 = false;
    while (pos < in.n) {
        uint64_t tag;
        if (!read_varint(in, pos, tag)) return 0;
        uint64_t f = tag >> 3;
        uint32_t wt = (uint32_t)(tag & 7);
        if (f == 1 && wt == 0) {
            if (seen1) return 0;
            seen1 = true;
            uint64_t v;
            if (!read_varint(in, pos, v)) return 0;
        } else if (f == 2 && wt == 0) {
            if (seen2) return 0;
            seen2 = true;
            uint64_t v;
            if (!read_varint(in, pos, v)) return 0;
        } else if (f == 3 && wt == 2) {
            Slice s;
            if (!read_len_delim(in, pos, s)) return 0;
        } else {
            return 0;
        }
    }
    return 1;
}

int scan_range_query(const Slice &in) {
    int64_t pos = 0;
    uint32_t seen = 0;
    while (pos < in.n) {
        uint64_t tag;
        if (!read_varint(in, pos, tag)) return 0;
        uint64_t f = tag >> 3;
        uint32_t wt = (uint32_t)(tag & 7);
        if (f < 1 || f > 5) return 0;
        if (seen & (1u << f)) return 0;
        seen |= 1u << f;
        if (f == 3) {
            uint64_t v;
            if (wt != 0 || !read_varint(in, pos, v)) return 0;
            continue;
        }
        Slice s;
        if (wt != 2 || !read_len_delim(in, pos, s)) return 0;
        if (f <= 2 && !valid_utf8(s)) return 0;
        if (f == 4 && !scan_query_reads(s)) return 0;
        if (f == 5 && !scan_merkle(s)) return 0;
    }
    return 1;
}

// KVMetadataWrite / KVMetadataWriteHash: key/key_hash + entries
int scan_metadata_write(const Slice &in, bool key_is_string) {
    int64_t pos = 0;
    bool seen1 = false;
    while (pos < in.n) {
        uint64_t tag;
        if (!read_varint(in, pos, tag)) return 0;
        uint64_t f = tag >> 3;
        uint32_t wt = (uint32_t)(tag & 7);
        Slice s;
        if (wt != 2 || f < 1 || f > 2) return 0;
        if (f == 1) {
            if (seen1) return 0;
            seen1 = true;
            if (!read_len_delim(in, pos, s)) return 0;
            if (key_is_string && !valid_utf8(s)) return 0;
        } else {
            if (!read_len_delim(in, pos, s)) return 0;
            // KVMetadataEntry {name=1 string, value=2 bytes}
            const char K_ENTRY[] = {0, 's', 'l'};
            if (!scan_msg(s, K_ENTRY, 2, nullptr, nullptr)) return 0;
        }
    }
    return 1;
}

// KVRWSet for the matching namespace. Collects plain write keys;
// flags rich features.
int scan_kvrwset(const Slice &in, std::vector<Slice> &keys,
                 bool &rich) {
    int64_t pos = 0;
    while (pos < in.n) {
        uint64_t tag;
        if (!read_varint(in, pos, tag)) return 0;
        uint64_t f = tag >> 3;
        uint32_t wt = (uint32_t)(tag & 7);
        if (wt != 2 || f < 1 || f > 4) return 0;
        Slice s;
        if (!read_len_delim(in, pos, s)) return 0;
        if (f == 1) {
            if (!scan_kvread(s)) return 0;
        } else if (f == 2) {
            if (!scan_range_query(s)) return 0;
        } else if (f == 3) {
            Slice ws[4] = {NIL, NIL, NIL, NIL};
            uint64_t wi[4] = {0};
            if (!scan_msg(s, K_KVWRITE, 3, ws, wi)) return 0;
            if (wi[2] != 0) rich = true;   // is_delete -> vp_updates
            keys.push_back(ws[1]);
            if ((int)keys.size() > MAX_K) rich = true;
        } else {
            if (!scan_metadata_write(s, true)) return 0;
            rich = true;                   // metadata writes
        }
    }
    return 1;
}

// HashedRWSet (collections of the matching namespace): cleanliness
// only — any hashed content at all is rich.
int scan_hashed_rwset(const Slice &in) {
    int64_t pos = 0;
    while (pos < in.n) {
        uint64_t tag;
        if (!read_varint(in, pos, tag)) return 0;
        uint64_t f = tag >> 3;
        uint32_t wt = (uint32_t)(tag & 7);
        if (wt != 2 || f < 1 || f > 3) return 0;
        Slice s;
        if (!read_len_delim(in, pos, s)) return 0;
        if (f == 1) {
            // KVReadHash {key_hash bytes, version msg}
            int64_t p2 = 0;
            bool sk = false, sv = false;
            while (p2 < s.n) {
                uint64_t t2;
                if (!read_varint(s, p2, t2)) return 0;
                uint64_t f2 = t2 >> 3;
                Slice s2;
                if ((t2 & 7) != 2 || f2 < 1 || f2 > 2) return 0;
                if (!read_len_delim(s, p2, s2)) return 0;
                if (f2 == 1) {
                    if (sk) return 0;
                    sk = true;
                } else {
                    if (sv) return 0;
                    sv = true;
                    if (!scan_msg(s2, K_VERSION, 2, nullptr, nullptr))
                        return 0;
                }
            }
        } else if (f == 2) {
            const char K_WH[] = {0, 'l', 'v', 'l'};
            if (!scan_msg(s, K_WH, 3, nullptr, nullptr)) return 0;
        } else {
            if (!scan_metadata_write(s, false)) return 0;
        }
    }
    return 1;
}

// ChaincodeAction.results: returns rw_mode (1 plain / 2 rich / 3 not
// clean) and fills `keys` for plain txs.
int scan_results(const Slice &results, const Slice &ccname,
                 std::vector<Slice> &keys) {
    bool rich = false;
    int64_t pos = 0;
    bool seen_dm = false;
    while (pos < results.n) {
        uint64_t tag;
        if (!read_varint(results, pos, tag)) return 3;
        uint64_t f = tag >> 3;
        uint32_t wt = (uint32_t)(tag & 7);
        if (f == 1 && wt == 0) {
            if (seen_dm) return 3;
            seen_dm = true;
            uint64_t v;
            if (!read_varint(results, pos, v)) return 3;
        } else if (f == 2 && wt == 2) {
            Slice nsrw;
            if (!read_len_delim(results, pos, nsrw)) return 3;
            // NsReadWriteSet {namespace=1 s, rwset=2 l, colls=3 rep}
            Slice ns = NIL, kvr = NIL;
            std::vector<Slice> colls;
            int64_t p2 = 0;
            bool s1 = false, s2 = false;
            while (p2 < nsrw.n) {
                uint64_t t2;
                if (!read_varint(nsrw, p2, t2)) return 3;
                uint64_t f2 = t2 >> 3;
                Slice sl;
                if ((t2 & 7) != 2 || f2 < 1 || f2 > 3) return 3;
                if (!read_len_delim(nsrw, p2, sl)) return 3;
                if (f2 == 1) {
                    if (s1) return 3;
                    s1 = true;
                    if (!valid_utf8(sl)) return 3;
                    ns = sl;
                } else if (f2 == 2) {
                    if (s2) return 3;
                    s2 = true;
                    kvr = sl;
                } else {
                    // CollectionHashedReadWriteSet {1 s, 2 l, 3 l}
                    const char K_COLL[] = {0, 's', 'l', 'l'};
                    Slice cf[4] = {NIL, NIL, NIL, NIL};
                    if (!scan_msg(sl, K_COLL, 3, cf, nullptr)) return 3;
                    colls.push_back(cf[2]);
                }
            }
            bool match = ns.n == ccname.n &&
                         (ns.n == 0 ||
                          memcmp(ns.p, ccname.p, (size_t)ns.n) == 0);
            if (!match) continue;
            if (!scan_kvrwset(kvr, keys, rich)) return 3;
            for (const Slice &c : colls) {
                if (!scan_hashed_rwset(c)) return 3;
                rich = true;   // any collection content -> python walk
            }
            if (!colls.empty()) rich = true;
        } else {
            return 3;
        }
    }
    return rich ? 2 : 1;
}

// Transaction: repeated actions (field 1). Each action must scan
// cleanly (upb parses every nested TransactionAction eagerly); only
// action[0]'s contents are used downstream (validator semantics).
int scan_transaction(const Slice &in, Slice &action0, int64_t &count) {
    count = 0;
    int64_t pos = 0;
    while (pos < in.n) {
        uint64_t tag;
        if (!read_varint(in, pos, tag)) return 0;
        if ((tag >> 3) != 1 || (tag & 7) != 2) return 0;
        Slice a;
        if (!read_len_delim(in, pos, a)) return 0;
        if (!scan_msg(a, K_TX_ACTION, 2, nullptr, nullptr)) return 0;
        if (count == 0) action0 = a;
        ++count;
    }
    return 1;
}

// ChaincodeEndorsedAction: prp (1, bytes), repeated endorsements (2).
int scan_endorsed_action(const Slice &in, Slice &prp,
                         std::vector<Slice> &endorsers,
                         std::vector<Slice> &esigs) {
    prp = NIL;
    bool seen_prp = false;
    int64_t pos = 0;
    while (pos < in.n) {
        uint64_t tag;
        if (!read_varint(in, pos, tag)) return 0;
        uint64_t f = tag >> 3;
        uint32_t wt = (uint32_t)(tag & 7);
        if (wt != 2) return 0;
        if (f == 1) {
            if (seen_prp) return 0;
            seen_prp = true;
            if (!read_len_delim(in, pos, prp)) return 0;
        } else if (f == 2) {
            Slice e;
            if (!read_len_delim(in, pos, e)) return 0;
            Slice fs[3] = {NIL, NIL, NIL};
            if (!scan_msg(e, K_ENDORSEMENT, 2, fs, nullptr)) return 0;
            endorsers.push_back(fs[1]);
            esigs.push_back(fs[2]);
        } else {
            return 0;
        }
    }
    return 1;
}

// ---------------- status codes ----------------

enum {
    BP_OK_ENDORSER = 0,
    BP_OK_CONFIG = 1,
    BP_NEEDS_PYTHON = 2,
    BP_FAIL_BASE = 100,  // + TxValidationCode
};

// TxValidationCode values (fabric_tpu/protos/transaction.proto)
enum {
    TVC_NIL_ENVELOPE = 1,
    TVC_BAD_COMMON_HEADER = 3,
    TVC_INVALID_ENDORSER = 5,
    TVC_UNSUPPORTED_TX_PAYLOAD = 7,
    TVC_BAD_PROPOSAL_TXID = 8,
    TVC_NIL_TXACTION = 16,
    TVC_BAD_CHANNEL_HEADER = 20,
};

enum {  // common.HeaderType
    HDR_CONFIG = 1,
    HDR_ENDORSER_TRANSACTION = 3,
};

// ---------------- per-tx parse ----------------

struct TxOut {
    int32_t status = BP_NEEDS_PYTHON;
    Slice creator = NIL, csig = NIL, payload = NIL;
    Slice txid = NIL, config = NIL, ccname = NIL, results = NIL;
    Slice prp = NIL;
    uint8_t payload_digest[32] = {0};
    std::vector<Slice> e_ident, e_sig;
    uint64_t creator_hash = 0;
    std::vector<uint64_t> e_hash;
    int32_t rw_mode = 0;
    std::vector<Slice> rw_keys;
};

uint64_t fnv1a(const Slice &s) {
    uint64_t h = 1469598103934665603ull;
    for (int64_t i = 0; i < s.n; ++i) {
        h ^= s.p[i];
        h *= 1099511628211ull;
    }
    return h;
}

const char HEXD[] = "0123456789abcdef";

void parse_tx(const Slice &env, const Slice &channel_id, int32_t max_e,
              TxOut &out) {
    Slice fs[3] = {NIL, NIL, NIL};
    if (!scan_msg(env, K_ENVELOPE, 2, fs, nullptr)) return;  // needs py
    Slice payload = fs[1], sig = fs[2];
    if (payload.n == 0) {
        out.status = BP_FAIL_BASE + TVC_NIL_ENVELOPE;
        return;
    }
    Slice pf[3] = {NIL, NIL, NIL};
    if (!scan_msg(payload, K_PAYLOAD, 2, pf, nullptr)) return;
    Slice header = pf[1], data = pf[2];
    Slice hf[3] = {NIL, NIL, NIL};
    if (!scan_msg(header, K_HEADER, 2, hf, nullptr)) return;
    Slice chf[9] = {NIL, NIL, NIL, NIL, NIL, NIL, NIL, NIL, NIL};
    uint64_t chi[9] = {0};
    if (!scan_msg(hf[1], K_CHANNEL_HDR, 8, chf, chi)) return;
    Slice shf[3] = {NIL, NIL, NIL};
    if (!scan_msg(hf[2], K_SIG_HDR, 2, shf, nullptr)) return;
    int64_t ch_type = (int64_t)(int32_t)chi[1];  // int32 varint
    Slice ch_channel = chf[4], ch_txid = chf[5];
    Slice creator = shf[1], nonce = shf[2];

    // decided structurally from here on (mirrors
    // core/msgvalidation.check_envelope order exactly)
    if (ch_channel.n != channel_id.n ||
        (ch_channel.n &&
         memcmp(ch_channel.p, channel_id.p, ch_channel.n) != 0)) {
        out.status = BP_FAIL_BASE + TVC_BAD_CHANNEL_HEADER;
        return;
    }
    if (creator.n == 0 || nonce.n == 0) {
        out.status = BP_FAIL_BASE + TVC_BAD_COMMON_HEADER;
        return;
    }
    out.creator = creator;
    out.csig = sig;
    out.payload = payload;
    out.txid = ch_txid;

    // creator identity interning must also cover txs that FAIL later
    // stages natively (empty prp / missing chaincode id): in reference
    // order those txs still pass the creator-identity check and claim
    // their txid before INVALID_ENDORSER_TRANSACTION is assigned
    out.creator_hash = fnv1a(creator);

    if (ch_type == HDR_CONFIG) {
        out.config = data;
        // a zero-length Payload.data is still a parseable (empty)
        // ConfigEnvelope downstream; keep parity with python by
        // pointing config at the data slice either way
        sha256_one(payload.p, (size_t)payload.n, out.payload_digest);
        out.status = BP_OK_CONFIG;
        return;
    }
    if (ch_type != HDR_ENDORSER_TRANSACTION) {
        out.status = BP_FAIL_BASE + TVC_UNSUPPORTED_TX_PAYLOAD;
        return;
    }

    // txid binding: hex(sha256(nonce || creator)) must equal tx_id
    uint8_t tid[32];
    {
        Sha256 s;
        s.init();
        s.update(nonce.p, (size_t)nonce.n);
        s.update(creator.p, (size_t)creator.n);
        s.final(tid);
    }
    bool tid_ok = ch_txid.n == 64;
    for (int i = 0; tid_ok && i < 32; ++i) {
        if (ch_txid.p[2 * i] != HEXD[tid[i] >> 4] ||
            ch_txid.p[2 * i + 1] != HEXD[tid[i] & 0xF])
            tid_ok = false;
    }
    if (!tid_ok) {
        out.status = BP_FAIL_BASE + TVC_BAD_PROPOSAL_TXID;
        return;
    }

    Slice action0;
    int64_t n_actions;
    if (!scan_transaction(data, action0, n_actions)) return;
    if (n_actions == 0) {
        out.status = BP_FAIL_BASE + TVC_NIL_TXACTION;
        return;
    }
    Slice af[3] = {NIL, NIL, NIL};
    if (!scan_msg(action0, K_TX_ACTION, 2, af, nullptr)) return;
    // ChaincodeActionPayload (upb parses the nested endorsed action
    // + endorsements eagerly; mirror that before deciding anything)
    Slice capf[3] = {NIL, NIL, NIL};
    if (!scan_msg(af[2], K_CAP, 2, capf, nullptr)) return;
    Slice prp;
    std::vector<Slice> endorsers, esigs;
    if (!scan_endorsed_action(capf[2], prp, endorsers, esigs)) return;
    if ((int32_t)endorsers.size() > max_e) return;  // rare: python path
    if (prp.n == 0) {
        // "no proposal response payload"
        out.status = BP_FAIL_BASE + TVC_INVALID_ENDORSER;
        return;
    }
    Slice prpf[3] = {NIL, NIL, NIL};
    if (!scan_msg(prp, K_PRP, 2, prpf, nullptr)) return;
    Slice ccaf[5] = {NIL, NIL, NIL, NIL, NIL};
    if (!scan_msg(prpf[2], K_CC_ACTION, 4, ccaf, nullptr)) return;
    // nested Response + ChaincodeID must parse (upb eagerness)
    if (!scan_msg(ccaf[3], K_RESPONSE, 3, nullptr, nullptr)) return;
    Slice cidf[4] = {NIL, NIL, NIL, NIL};
    if (!scan_msg(ccaf[4], K_CHAINCODE_ID, 3, cidf, nullptr)) return;
    if (cidf[1].n == 0) {
        // "no chaincode id in chaincode action"
        out.status = BP_FAIL_BASE + TVC_INVALID_ENDORSER;
        return;
    }

    out.ccname = cidf[1];
    out.results = ccaf[1];
    out.prp = prp;
    out.rw_mode = scan_results(ccaf[1], cidf[1], out.rw_keys);
    out.e_ident = std::move(endorsers);
    out.e_sig = std::move(esigs);

    // digest lanes: creator signs the payload bytes; each endorser
    // signs prp || endorser (msp/identities.go:170 semantics, hashed
    // host-side exactly as the sw provider would)
    sha256_one(payload.p, (size_t)payload.n, out.payload_digest);
    out.e_hash.resize(out.e_ident.size());
    for (size_t j = 0; j < out.e_ident.size(); ++j)
        out.e_hash[j] = fnv1a(out.e_ident[j]);
    out.status = BP_OK_ENDORSER;
}

// endorsement digests are computed in the parallel phase too, but need
// the shared output buffer; kept separate from parse_tx
void endorse_digests(const TxOut &t, uint8_t *e_digest, int32_t max_e,
                     int64_t tx_index) {
    for (size_t j = 0; j < t.e_ident.size(); ++j) {
        Sha256 s;
        s.init();
        s.update(t.prp.p, (size_t)t.prp.n);
        s.update(t.e_ident[j].p, (size_t)t.e_ident[j].n);
        s.final(e_digest + (tx_index * max_e + (int64_t)j) * 32);
    }
}

// serial, deterministic identity dedup over precomputed hashes
struct Dedup {
    struct Entry {
        uint64_t h;
        Slice s;
        int32_t id;
    };
    std::vector<std::vector<Entry>> buckets;
    int32_t next_id = 0;

    Dedup() : buckets(1024) {}

    // returns the id; *is_new set when this call created it
    int32_t intern(const Slice &s, uint64_t h, bool *is_new) {
        *is_new = false;
        auto &b = buckets[h & 1023];
        for (const auto &e : b) {
            if (e.h == h && e.s.n == s.n &&
                (s.n == 0 ||
                 memcmp(e.s.p, s.p, (size_t)s.n) == 0))
                return e.id;
        }
        b.push_back({h, s, next_id});
        *is_new = true;
        return next_id++;
    }
};

void parallel_for(int64_t n, int nthreads,
                  const std::function<void(int64_t, int64_t)> &fn) {
    if (nthreads <= 1 || n < 64) {
        fn(0, n);
        return;
    }
    std::vector<std::thread> ts;
    int64_t chunk = (n + nthreads - 1) / nthreads;
    for (int t = 0; t < nthreads; ++t) {
        int64_t lo = t * chunk, hi = lo + chunk;
        if (lo >= n) break;
        if (hi > n) hi = n;
        ts.emplace_back([&fn, lo, hi] { fn(lo, hi); });
    }
    for (auto &t : ts) t.join();
}

int env_threads() {
    const char *e = getenv("FTPU_NATIVE_THREADS");
    if (e && *e) {
        int v = atoi(e);
        if (v >= 1) return v;
    }
    unsigned hc = std::thread::hardware_concurrency();
    if (hc == 0) hc = 1;
    return (int)(hc > 8 ? 8 : hc);
}

}  // namespace

extern "C" {

// One call per block. Inputs: per-envelope pointers + lengths, the
// expected channel id, and max endorsements per tx the flat tables
// hold (beyond it: BP_NEEDS_PYTHON). All offsets in the output arrays
// are LOCAL to that tx's envelope buffer. Identity ids (creator_uid /
// e_uid) index the deduplicated identity table (uid_env, uid_off,
// uid_len — env index + local offset), -1 where absent.
//
// Signature staging (r/rpn/w/ok, 32-byte big-endian scalars) is
// filled for the creator signature ([n,32]) and each endorsement
// ([n,max_e,32]) via the Montgomery batch-inversion path.
//
// Returns the number of unique identities (>= 0), or -1 on invalid
// arguments.
int32_t ftpu_block_prep(
    const uint8_t *const *envs, const int64_t *env_lens, int32_t n,
    const uint8_t *channel_id, int32_t channel_id_len, int32_t max_e,
    // per-tx
    int32_t *status, int64_t *creator_off, int32_t *creator_len,
    int32_t *creator_uid, int64_t *csig_off, int32_t *csig_len,
    uint8_t *payload_digest,                       // [n,32]
    int64_t *txid_off, int32_t *txid_len,          // [n]
    int64_t *config_off, int32_t *config_len,      // [n]
    int64_t *ccname_off, int32_t *ccname_len,      // [n]
    int64_t *results_off, int32_t *results_len,    // [n]
    int64_t *prp_off, int32_t *prp_len,            // [n]
    int32_t *rw_mode, int32_t *rw_nkeys,           // [n]
    int64_t *rw_key_off, int32_t *rw_key_len,      // [n,MAX_K]
    int32_t *e_count,                              // [n]
    int64_t *e_ident_off, int32_t *e_ident_len,    // [n,max_e]
    int32_t *e_uid,                                // [n,max_e]
    int64_t *e_sig_off, int32_t *e_sig_len,        // [n,max_e]
    uint8_t *e_digest,                             // [n,max_e,32]
    // signature staging
    uint8_t *c_r, uint8_t *c_rpn, uint8_t *c_w, uint8_t *c_ok,  // [n,32]/[n]
    uint8_t *e_r, uint8_t *e_rpn, uint8_t *e_w, uint8_t *e_okf, // [n,max_e,..]
    // unique identity table, capacity n*(max_e+1)
    int32_t *uid_env, int64_t *uid_off, int32_t *uid_len) {
    if (n < 0 || max_e <= 0 || max_e > 64) return -1;
    std::vector<TxOut> txs(n);
    Slice chan = {channel_id, channel_id_len};

    parallel_for(n, env_threads(), [&](int64_t lo, int64_t hi) {
        for (int64_t i = lo; i < hi; ++i) {
            Slice env = {envs[i], env_lens[i]};
            parse_tx(env, chan, max_e, txs[i]);
            endorse_digests(txs[i], e_digest, max_e, i);
        }
    });

    // serial phase: dedup identities, flatten offsets, stage sig lanes
    Dedup dd;
    std::vector<const uint8_t *> sig_ptrs;
    std::vector<int32_t> sig_lens, sig_lane;  // lane: tx*(max_e+1)+slot
    auto loc = [&](int64_t i, const Slice &s, int64_t *off_a,
                   int32_t *len_a, int64_t idx) {
        off_a[idx] = s.p ? (int64_t)(s.p - envs[i]) : 0;
        len_a[idx] = (int32_t)s.n;
    };
    for (int64_t i = 0; i < n; ++i) {
        TxOut &t = txs[i];
        status[i] = t.status;
        creator_uid[i] = -1;
        e_count[i] = 0;
        loc(i, t.creator, creator_off, creator_len, i);
        loc(i, t.csig, csig_off, csig_len, i);
        loc(i, t.txid, txid_off, txid_len, i);
        loc(i, t.config, config_off, config_len, i);
        loc(i, t.ccname, ccname_off, ccname_len, i);
        loc(i, t.results, results_off, results_len, i);
        loc(i, t.prp, prp_off, prp_len, i);
        rw_mode[i] = t.rw_mode;
        int32_t nk = t.rw_mode == 1 ? (int32_t)t.rw_keys.size() : 0;
        rw_nkeys[i] = nk;
        for (int32_t kk = 0; kk < nk; ++kk)
            loc(i, t.rw_keys[kk], rw_key_off, rw_key_len,
                i * MAX_K + kk);
        memcpy(payload_digest + 32 * i, t.payload_digest, 32);
        bool ok_status = t.status == BP_OK_ENDORSER ||
                         t.status == BP_OK_CONFIG;
        // native-decided extract failures still intern their creator:
        // the Python phase needs the identity-validity check (which
        // precedes the txid claim) for those txs too
        bool claimer = t.status ==
                       BP_FAIL_BASE + TVC_INVALID_ENDORSER;
        if (!ok_status && !claimer) continue;
        bool fresh;
        int32_t cu = dd.intern(t.creator, t.creator_hash, &fresh);
        creator_uid[i] = cu;
        if (fresh) {
            uid_env[cu] = (int32_t)i;
            uid_off[cu] = t.creator.p - envs[i];
            uid_len[cu] = (int32_t)t.creator.n;
        }
        if (!ok_status) continue;   // no signature lanes for claimers
        sig_ptrs.push_back(t.csig.p);
        sig_lens.push_back((int32_t)t.csig.n);
        sig_lane.push_back((int32_t)(i * (max_e + 1)));
        e_count[i] = (int32_t)t.e_ident.size();
        for (size_t j = 0; j < t.e_ident.size(); ++j) {
            int64_t fj = i * max_e + (int64_t)j;
            loc(i, t.e_ident[j], e_ident_off, e_ident_len, fj);
            loc(i, t.e_sig[j], e_sig_off, e_sig_len, fj);
            int32_t u = dd.intern(t.e_ident[j], t.e_hash[j], &fresh);
            e_uid[fj] = u;
            if (fresh) {
                uid_env[u] = (int32_t)i;
                uid_off[u] = t.e_ident[j].p - envs[i];
                uid_len[u] = (int32_t)t.e_ident[j].n;
            }
            sig_ptrs.push_back(t.e_sig[j].p);
            sig_lens.push_back((int32_t)t.e_sig[j].n);
            sig_lane.push_back((int32_t)(i * (max_e + 1) + 1 + j));
        }
    }

    // DER parse + low-S gates + batched s^-1 for every live signature
    int32_t m = (int32_t)sig_ptrs.size();
    if (m > 0) {
        std::vector<uint8_t> r(m * 32), rpn(m * 32), w(m * 32), ok(m);
        ftpu_batch_prep_ptrs(sig_ptrs.data(), sig_lens.data(), m,
                             r.data(), rpn.data(), w.data(), ok.data());
        for (int32_t s = 0; s < m; ++s) {
            int32_t lane = sig_lane[s];
            int64_t tx = lane / (max_e + 1);
            int32_t slot = lane % (max_e + 1);
            if (slot == 0) {
                memcpy(c_r + 32 * tx, r.data() + 32 * s, 32);
                memcpy(c_rpn + 32 * tx, rpn.data() + 32 * s, 32);
                memcpy(c_w + 32 * tx, w.data() + 32 * s, 32);
                c_ok[tx] = ok[s];
            } else {
                int64_t fj = tx * max_e + (slot - 1);
                memcpy(e_r + 32 * fj, r.data() + 32 * s, 32);
                memcpy(e_rpn + 32 * fj, rpn.data() + 32 * s, 32);
                memcpy(e_w + 32 * fj, w.data() + 32 * s, 32);
                e_okf[fj] = ok[s];
            }
        }
    }
    return dd.next_id;
}

}  // extern "C"
