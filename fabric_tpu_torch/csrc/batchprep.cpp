// Batched ECDSA P-256 verify preparation on the host: the port's copy of
// the JAX package's native batch prep (native/batchprep.cpp there).
//
// Per signature -- strict DER parse, positivity, the low-S policy against
// the P-256 half order, r < n and s < n, the r + n < p probe for rpn --
// then w = s^-1 mod n for the whole batch with one inversion over the
// prefix products (Montgomery's batch-inversion trick). Semantics mirror
// fabric_tpu_torch/bccsp/utils.py (unmarshal_signature, is_low_s) and
// bccsp/cuda.py host_prep_scalars, the plain version that
// tests/test_torch_native.py holds this file to lane for lane.
//
// C++ with the standard library only, no threads. fabric_tpu_torch/native.py
// builds it with g++ -O3 -shared -fPIC at first use and binds it with ctypes.

#include <cstdint>
#include <cstring>
#include <vector>

namespace {

// ---- u256 little-endian 4x64 limbs ----

struct U256 {
    uint64_t v[4];
};

const U256 ZERO = {{0, 0, 0, 0}};

// P-256 group order n and field prime p (big-endian constants folded
// to limbs).
const U256 N = {{0xF3B9CAC2FC632551ULL, 0xBCE6FAADA7179E84ULL,
                 0xFFFFFFFFFFFFFFFFULL, 0xFFFFFFFF00000000ULL}};
const U256 P = {{0xFFFFFFFFFFFFFFFFULL, 0x00000000FFFFFFFFULL,
                 0x0000000000000000ULL, 0xFFFFFFFF00000001ULL}};
// n >> 1 (the low-S boundary)
const U256 HALF_N = {{0x79DCE5617E3192A8ULL, 0xDE737D56D38BCF42ULL,
                      0x7FFFFFFFFFFFFFFFULL, 0x7FFFFFFF80000000ULL}};

int cmp(const U256 &a, const U256 &b) {
    for (int i = 3; i >= 0; --i) {
        if (a.v[i] < b.v[i]) return -1;
        if (a.v[i] > b.v[i]) return 1;
    }
    return 0;
}

bool is_zero(const U256 &a) {
    return (a.v[0] | a.v[1] | a.v[2] | a.v[3]) == 0;
}

// a += b; returns carry-out
uint64_t add(U256 &a, const U256 &b) {
    unsigned __int128 c = 0;
    for (int i = 0; i < 4; ++i) {
        c += (unsigned __int128)a.v[i] + b.v[i];
        a.v[i] = (uint64_t)c;
        c >>= 64;
    }
    return (uint64_t)c;
}

// a -= b (assumes a >= b)
void sub(U256 &a, const U256 &b) {
    unsigned __int128 borrow = 0;
    for (int i = 0; i < 4; ++i) {
        unsigned __int128 d =
            (unsigned __int128)a.v[i] - b.v[i] - borrow;
        a.v[i] = (uint64_t)d;
        borrow = (d >> 64) ? 1 : 0;
    }
}

// a >>= 1 with carry_in as the new top bit
void shr1(U256 &a, uint64_t carry_in) {
    for (int i = 0; i < 4; ++i) {
        uint64_t next = (i < 3) ? (a.v[i + 1] & 1) : carry_in;
        a.v[i] = (a.v[i] >> 1) | (next << 63);
    }
}

// u = u/2 mod n (n odd)
void halve_mod(U256 &u) {
    if (u.v[0] & 1) {
        uint64_t c = add(u, N);
        shr1(u, c);
    } else {
        shr1(u, 0);
    }
}

// a = (a - b) mod n, both < n
void sub_mod(U256 &a, const U256 &b) {
    if (cmp(a, b) >= 0) {
        sub(a, b);
    } else {
        // a + n - b: the carry out of a+n cancels against b > a
        add(a, N);
        sub(a, b);
    }
}

// ---- Montgomery arithmetic mod n (R = 2^256) ----
// N0INV = -n^-1 mod 2^64; RR = R^2 mod n (both precomputed offline)
const uint64_t N0INV = 0xccd1c8aaee00bc4fULL;
const U256 RR = {{0x83244c95be79eea2ULL, 0x4699799c49bd6fa6ULL,
                  0x2845b2392b6bec59ULL, 0x66e12d94f3d95620ULL}};
const U256 ONE_U = {{1, 0, 0, 0}};

// out = a*b*R^-1 mod n (CIOS)
void mont_mul(const U256 &a, const U256 &b, U256 &out) {
    uint64_t t[6] = {0, 0, 0, 0, 0, 0};
    for (int i = 0; i < 4; ++i) {
        unsigned __int128 c = 0;
        for (int j = 0; j < 4; ++j) {
            c += (unsigned __int128)t[j] +
                 (unsigned __int128)a.v[i] * b.v[j];
            t[j] = (uint64_t)c;
            c >>= 64;
        }
        c += t[4];
        t[4] = (uint64_t)c;
        t[5] = (uint64_t)(c >> 64);

        uint64_t m = t[0] * N0INV;
        c = (unsigned __int128)t[0] + (unsigned __int128)m * N.v[0];
        c >>= 64;
        for (int j = 1; j < 4; ++j) {
            c += (unsigned __int128)t[j] +
                 (unsigned __int128)m * N.v[j];
            t[j - 1] = (uint64_t)c;
            c >>= 64;
        }
        c += t[4];
        t[3] = (uint64_t)c;
        t[4] = t[5] + (uint64_t)(c >> 64);
        t[5] = 0;
    }
    U256 res = {{t[0], t[1], t[2], t[3]}};
    if (t[4] || cmp(res, N) >= 0) sub(res, N);
    out = res;
}

// out = in^-1 mod n via binary extended GCD; in must be in (0, n)
void modinv(const U256 &in, U256 &out) {
    U256 a = in, b = N;
    U256 u = {{1, 0, 0, 0}}, w = ZERO;
    while (!is_zero(a)) {
        while (!(a.v[0] & 1)) {
            shr1(a, 0);
            halve_mod(u);
        }
        while (!(b.v[0] & 1)) {
            shr1(b, 0);
            halve_mod(w);
        }
        if (cmp(a, b) >= 0) {
            sub(a, b);
            sub_mod(u, w);
        } else {
            sub(b, a);
            sub_mod(w, u);
        }
    }
    out = w;  // gcd in b == 1 for prime n
}

void store_be(const U256 &a, uint8_t *out32) {
    for (int i = 0; i < 4; ++i) {
        uint64_t limb = a.v[3 - i];
        for (int j = 0; j < 8; ++j)
            out32[i * 8 + j] = (uint8_t)(limb >> (56 - 8 * j));
    }
}

// ---- DER parsing (exact mirror of utils.py _parse_len/_parse_int) ----

struct Parser {
    const uint8_t *raw;
    int32_t len;
    int32_t off;
    bool bad;

    uint8_t byte() { return raw[off]; }
    bool avail(int32_t k) const { return off + k <= len; }
};

// definite length; false on format error
bool parse_len(Parser &p, int64_t &out) {
    if (p.off >= p.len) return false;
    uint8_t b = p.raw[p.off];
    if (b < 0x80) {
        out = b;
        p.off += 1;
        return true;
    }
    int nbytes = b & 0x7F;
    if (nbytes == 0 || nbytes > 4) return false;
    if (p.off + 1 + nbytes > p.len) return false;
    if (p.raw[p.off + 1] == 0) return false;  // superfluous zeros
    int64_t val = 0;
    for (int i = 0; i < nbytes; ++i)
        val = (val << 8) | p.raw[p.off + 1 + i];
    if (val < 0x80) return false;             // non-minimal form
    p.off += 1 + nbytes;
    out = val;
    return true;
}

// INTEGER -> (value as U256 if it fits in 32 bytes, ok flags).
// Returns false on malformed DER; *fits=false when positive but wider
// than 256 bits (caller rejects: >= n anyway); *nonpos=true for
// negative or zero values.
bool parse_int(Parser &p, U256 &out, bool &fits, bool &nonpos) {
    if (p.off >= p.len || p.raw[p.off] != 0x02) return false;
    p.off += 1;
    int64_t length;
    if (!parse_len(p, length)) return false;
    if (length == 0) return false;
    if (p.off + length > p.len) return false;
    const uint8_t *content = p.raw + p.off;
    if (length > 1) {
        if (content[0] == 0x00 && content[1] < 0x80) return false;
        if (content[0] == 0xFF && content[1] >= 0x80) return false;
    }
    nonpos = false;
    fits = true;
    out = ZERO;
    if (content[0] & 0x80) {
        nonpos = true;  // negative (two's complement sign bit)
        p.off += length;
        return true;
    }
    const uint8_t *mag = content;
    int64_t mlen = length;
    while (mlen > 0 && mag[0] == 0x00) {
        ++mag;
        --mlen;
    }
    if (mlen == 0) {
        nonpos = true;  // value == 0
        p.off += length;
        return true;
    }
    if (mlen > 32) {
        fits = false;
        p.off += length;
        return true;
    }
    for (int64_t i = 0; i < mlen; ++i) {
        int64_t bit_index = (mlen - 1 - i);
        out.v[bit_index / 8] |=
            (uint64_t)mag[i] << (8 * (bit_index % 8));
    }
    p.off += length;
    return true;
}

}  // namespace

// Parse + policy gates + r/rpn staging; s returned for the caller to
// invert (singly or via the batched Montgomery trick).
int prep_parse(const uint8_t *der, int32_t der_len, uint8_t *r_out,
               uint8_t *rpn_out, U256 &s_out) {
    Parser p{der, der_len, 0, false};
    if (der_len <= 0 || der[0] != 0x30) return 0;
    p.off = 1;
    int64_t seq_len;
    if (!parse_len(p, seq_len)) return 0;
    if (p.off + seq_len > p.len) return 0;
    int64_t end = p.off + seq_len;
    U256 r, s;
    bool fits_r, nonpos_r, fits_s, nonpos_s;
    if (!parse_int(p, r, fits_r, nonpos_r)) return 0;
    if (!parse_int(p, s, fits_s, nonpos_s)) return 0;
    if (p.off != end) return 0;  // trailing data inside sequence
    // (bytes after `end` tolerated — Go asn1 `rest` semantics)
    if (nonpos_r || nonpos_s) return 0;
    // low-S policy, then scalar range (mirrors check_signature + the
    // provider's r/s < n gate; !fits => >= n)
    if (!fits_s || cmp(s, HALF_N) > 0) return 0;
    if (!fits_r || cmp(r, N) >= 0 || is_zero(r)) return 0;
    if (cmp(s, N) >= 0 || is_zero(s)) return 0;

    U256 rpn = r;
    uint64_t carry = add(rpn, N);
    // r+n used only if it stays below the field prime p (no carry and
    // < p); else fall back to r (tpu.py: rpn = r+N if r+N < P else r)
    if (carry || cmp(rpn, P) >= 0) rpn = r;
    store_be(r, r_out);
    store_be(rpn, rpn_out);
    s_out = s;
    return 1;
}

extern "C" {

// One signature: parse + policy gates + scalar prep.
// Returns 1 and fills r/rpn/w (32-byte big-endian each) on acceptance.
int ftpu_prep_one(const uint8_t *der, int32_t der_len, uint8_t *r_out,
                  uint8_t *rpn_out, uint8_t *w_out) {
    U256 s;
    if (!prep_parse(der, der_len, r_out, rpn_out, s)) return 0;
    U256 w;
    modinv(s, w);
    store_be(w, w_out);
    return 1;
}

// Batch driver over a pointer table (one entry per signature; nullptr
// or len<=0 rejects the lane). The s^-1 mod n for the whole batch
// costs ONE binary-GCD inversion via Montgomery's batch-inversion
// trick (prefix products; ~5 Montgomery muls per accepted signature
// instead of a ~15us GCD each).
void ftpu_batch_prep_ptrs(const uint8_t *const *ptrs,
                          const int32_t *lens, int32_t n,
                          uint8_t *r_out, uint8_t *rpn_out,
                          uint8_t *w_out, uint8_t *ok_out) {
    std::vector<U256> s_mont(n), prefix(n);
    std::vector<int32_t> live(n);
    int32_t k = 0;
    for (int32_t i = 0; i < n; ++i) {
        U256 s;
        ok_out[i] = ptrs[i] != nullptr && (uint8_t)prep_parse(
            ptrs[i], lens[i], r_out + 32 * i, rpn_out + 32 * i, s);
        if (!ok_out[i]) continue;
        mont_mul(s, RR, s_mont[k]);        // to Montgomery domain
        if (k == 0) prefix[0] = s_mont[0];
        else mont_mul(prefix[k - 1], s_mont[k], prefix[k]);
        live[k] = i;
        ++k;
    }
    if (k == 0) return;
    // invert the full prefix product: one real inversion
    U256 pf, ipf, acc;
    mont_mul(prefix[k - 1], ONE_U, pf);    // out of Montgomery domain
    modinv(pf, ipf);
    mont_mul(ipf, RR, acc);                // back into the domain
    for (int32_t j = k - 1; j >= 0; --j) {
        U256 inv_j, w;
        if (j > 0) mont_mul(acc, prefix[j - 1], inv_j);
        else inv_j = acc;
        mont_mul(inv_j, ONE_U, w);         // out of Montgomery domain
        store_be(w, w_out + 32 * live[j]);
        U256 next;
        mont_mul(acc, s_mont[j], next);
        acc = next;
    }
}

}  // extern "C"
