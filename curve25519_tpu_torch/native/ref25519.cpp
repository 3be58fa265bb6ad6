// Native host-side Curve25519/Ed25519 core for curve25519_tpu.
//
// Role: the framework's native runtime component — a low-latency single-op
// host path (the TPU path amortizes over batches; single-key operations on
// the host CPU belong here) and a second, independent implementation used as
// a differential oracle by the test suite. This mirrors the reference
// library's split between its portable C core and its x86-64 assembly core
// (reference: source/curve25519_mehdi.c vs source/asm64/*), re-done for
// modern 64-bit hosts: radix-2^51 field arithmetic with unsigned __int128
// products (a different radix and structure than either reference backend).
//
// Built as a shared library; see bindings.py (ctypes, no pybind needed).
//
// This file is self-contained: field ops, scalar-order ops, SHA-512,
// Montgomery ladder, Edwards ops, and the protocol layer.

#include <cstdint>
#include <cstring>

typedef unsigned __int128 u128;
typedef uint64_t u64;
typedef uint8_t u8;

// ---------------------------------------------------------------------------
// fe25519: radix 2^51, 5 limbs
// ---------------------------------------------------------------------------
struct fe { u64 v[5]; };

static const u64 MASK51 = (1ULL << 51) - 1;

static void fe_zero(fe &r) { for (int i = 0; i < 5; i++) r.v[i] = 0; }
static void fe_one(fe &r) { fe_zero(r); r.v[0] = 1; }
static void fe_copy(fe &r, const fe &a) { r = a; }

static void fe_add(fe &r, const fe &a, const fe &b) {
    for (int i = 0; i < 5; i++) r.v[i] = a.v[i] + b.v[i];
}

// r = a - b, with a 4p limb-wise pad so every limb stays non-negative even
// for weakly-normalized (~2^52.2) operands
static void fe_sub(fe &r, const fe &a, const fe &b) {
    r.v[0] = a.v[0] + ((1ULL << 53) - 76) - b.v[0];
    for (int i = 1; i < 5; i++)
        r.v[i] = a.v[i] + ((1ULL << 53) - 4) - b.v[i];
}

static void fe_carry(fe &r) {
    u64 c;
    for (int i = 0; i < 5; i++) {
        c = r.v[i] >> 51;
        r.v[i] &= MASK51;
        if (i < 4) r.v[i + 1] += c; else r.v[0] += 19 * c;
    }
    c = r.v[0] >> 51; r.v[0] &= MASK51; r.v[1] += c;
}

static void fe_mul(fe &r, const fe &a, const fe &b) {
    const u64 *x = a.v, *y = b.v;
    u128 t0 = (u128)x[0] * y[0] + (u128)(19 * x[1]) * y[4] +
              (u128)(19 * x[2]) * y[3] + (u128)(19 * x[3]) * y[2] +
              (u128)(19 * x[4]) * y[1];
    u128 t1 = (u128)x[0] * y[1] + (u128)x[1] * y[0] +
              (u128)(19 * x[2]) * y[4] + (u128)(19 * x[3]) * y[3] +
              (u128)(19 * x[4]) * y[2];
    u128 t2 = (u128)x[0] * y[2] + (u128)x[1] * y[1] + (u128)x[2] * y[0] +
              (u128)(19 * x[3]) * y[4] + (u128)(19 * x[4]) * y[3];
    u128 t3 = (u128)x[0] * y[3] + (u128)x[1] * y[2] + (u128)x[2] * y[1] +
              (u128)x[3] * y[0] + (u128)(19 * x[4]) * y[4];
    u128 t4 = (u128)x[0] * y[4] + (u128)x[1] * y[3] + (u128)x[2] * y[2] +
              (u128)x[3] * y[1] + (u128)x[4] * y[0];
    u64 c;
    c = (u64)(t0 >> 51); r.v[0] = (u64)t0 & MASK51; t1 += c;
    c = (u64)(t1 >> 51); r.v[1] = (u64)t1 & MASK51; t2 += c;
    c = (u64)(t2 >> 51); r.v[2] = (u64)t2 & MASK51; t3 += c;
    c = (u64)(t3 >> 51); r.v[3] = (u64)t3 & MASK51; t4 += c;
    c = (u64)(t4 >> 51); r.v[4] = (u64)t4 & MASK51;
    r.v[0] += 19 * c;
    c = r.v[0] >> 51; r.v[0] &= MASK51; r.v[1] += c;
}

// dedicated squaring: half the partial products of fe_mul (doubled cross
// terms), same reduction chain — the native analogue of the reference's
// ecp_SqrReduce having its own routine (source/asm64/amd64.gnu/Square.s)
static void fe_sqr(fe &r, const fe &a) {
    const u64 *x = a.v;
    u64 d0 = 2 * x[0], d1 = 2 * x[1];
    u128 t0 = (u128)x[0] * x[0] + (u128)(38 * x[1]) * x[4] +
              (u128)(38 * x[2]) * x[3];
    u128 t1 = (u128)d0 * x[1] + (u128)(38 * x[2]) * x[4] +
              (u128)(19 * x[3]) * x[3];
    u128 t2 = (u128)d0 * x[2] + (u128)x[1] * x[1] +
              (u128)(38 * x[3]) * x[4];
    u128 t3 = (u128)d0 * x[3] + (u128)d1 * x[2] + (u128)(19 * x[4]) * x[4];
    u128 t4 = (u128)d0 * x[4] + (u128)d1 * x[3] + (u128)x[2] * x[2];
    u64 c;
    c = (u64)(t0 >> 51); r.v[0] = (u64)t0 & MASK51; t1 += c;
    c = (u64)(t1 >> 51); r.v[1] = (u64)t1 & MASK51; t2 += c;
    c = (u64)(t2 >> 51); r.v[2] = (u64)t2 & MASK51; t3 += c;
    c = (u64)(t3 >> 51); r.v[3] = (u64)t3 & MASK51; t4 += c;
    c = (u64)(t4 >> 51); r.v[4] = (u64)t4 & MASK51;
    r.v[0] += 19 * c;
    c = r.v[0] >> 51; r.v[0] &= MASK51; r.v[1] += c;
}

static void fe_mul_small(fe &r, const fe &a, u64 s) {
    u128 c = 0;
    for (int i = 0; i < 5; i++) {
        c += (u128)a.v[i] * s;
        r.v[i] = (u64)c & MASK51;
        c >>= 51;
    }
    r.v[0] += 19 * (u64)c;
    u64 cc = r.v[0] >> 51; r.v[0] &= MASK51; r.v[1] += cc;
}

static void fe_freeze(fe &r) {
    static const u64 P51[5] = {0x7FFFFFFFFFFEDULL, MASK51, MASK51, MASK51,
                               MASK51};
    fe_carry(r); fe_carry(r);           // fully normalized, value < 2p
    for (int k = 0; k < 2; k++) {
        bool ge = true;
        for (int i = 4; i >= 0; i--) {
            if (r.v[i] > P51[i]) break;
            if (r.v[i] < P51[i]) { ge = false; break; }
        }
        if (!ge) break;
        u64 br = 0;
        for (int i = 0; i < 5; i++) {
            u64 need = P51[i] + br;
            br = r.v[i] < need;
            r.v[i] = (r.v[i] - need) & MASK51;
        }
    }
}

static void fe_sqr_n(fe &r, const fe &x, int n) {
    r = x;
    for (int i = 0; i < n; i++) fe_sqr(r, r);
}

// shared prefix of the p-2 and (p-5)/8 addition chains: returns
// (x^(2^250 - 1), x^11) — DJB's chain, as in the reference ecp_Inverse
// (source/curve25519_mehdi.c:340); ~254 sqr + 11 mul instead of the ~500
// mults of generic square-and-multiply
static void fe_chain250(fe &t250, fe &x11, const fe &a) {
    fe x2, x9, x31, x10, x50, t, t20, t40, t100, t200;
    fe_sqr(x2, a);                                   // 2
    fe_sqr(t, x2); fe_sqr(t, t); fe_mul(x9, t, a);   // 9
    fe_mul(x11, x9, x2);                             // 11
    fe_sqr(t, x11); fe_mul(x31, t, x9);              // 2^5 - 1
    fe_sqr_n(t, x31, 5); fe_mul(x10, t, x31);        // 2^10 - 1
    fe_sqr_n(t, x10, 10); fe_mul(t20, t, x10);       // 2^20 - 1
    fe_sqr_n(t, t20, 20); fe_mul(t40, t, t20);       // 2^40 - 1
    fe_sqr_n(t, t40, 10); fe_mul(x50, t, x10);       // 2^50 - 1
    fe_sqr_n(t, x50, 50); fe_mul(t100, t, x50);      // 2^100 - 1
    fe_sqr_n(t, t100, 100); fe_mul(t200, t, t100);   // 2^200 - 1
    fe_sqr_n(t, t200, 50); fe_mul(t250, t, x50);     // 2^250 - 1
}

static void fe_inv(fe &r, const fe &a) {
    fe t250, x11, t;
    fe_chain250(t250, x11, a);
    fe_sqr_n(t, t250, 5);                            // p-2 = (2^250-1)*2^5 + 11
    fe_mul(r, t, x11);
}

static void fe_pow2523(fe &r, const fe &a) {
    fe t250, x11, t;
    fe_chain250(t250, x11, a);
    fe_sqr_n(t, t250, 2);                            // (2^252-3) = (2^250-1)*4 + 1
    fe_mul(r, t, a);
}

static void fe_from_bytes(fe &r, const u8 *s) {
    u64 w[4];
    memcpy(w, s, 32);
    r.v[0] = w[0] & MASK51;
    r.v[1] = ((w[0] >> 51) | (w[1] << 13)) & MASK51;
    r.v[2] = ((w[1] >> 38) | (w[2] << 26)) & MASK51;
    r.v[3] = ((w[2] >> 25) | (w[3] << 39)) & MASK51;
    r.v[4] = (w[3] >> 12) & MASK51;
}

static void fe_to_bytes(u8 *s, const fe &a) {
    fe t = a; fe_freeze(t);
    u64 w[4];
    w[0] = t.v[0] | (t.v[1] << 51);
    w[1] = (t.v[1] >> 13) | (t.v[2] << 38);
    w[2] = (t.v[2] >> 26) | (t.v[3] << 25);
    w[3] = (t.v[3] >> 39) | (t.v[4] << 12);
    memcpy(s, w, 32);
}

static int fe_is_zero(const fe &a) {
    fe t = a; fe_freeze(t);
    u64 z = 0;
    for (int i = 0; i < 5; i++) z |= t.v[i];
    return z == 0;
}

static int fe_parity(const fe &a) {
    fe t = a; fe_freeze(t);
    return (int)(t.v[0] & 1);
}

// ---------------------------------------------------------------------------
// SHA-512 (FIPS 180-4)
// ---------------------------------------------------------------------------
static const u64 K512[80] = {
    0x428a2f98d728ae22ULL,0x7137449123ef65cdULL,0xb5c0fbcfec4d3b2fULL,0xe9b5dba58189dbbcULL,
    0x3956c25bf348b538ULL,0x59f111f1b605d019ULL,0x923f82a4af194f9bULL,0xab1c5ed5da6d8118ULL,
    0xd807aa98a3030242ULL,0x12835b0145706fbeULL,0x243185be4ee4b28cULL,0x550c7dc3d5ffb4e2ULL,
    0x72be5d74f27b896fULL,0x80deb1fe3b1696b1ULL,0x9bdc06a725c71235ULL,0xc19bf174cf692694ULL,
    0xe49b69c19ef14ad2ULL,0xefbe4786384f25e3ULL,0x0fc19dc68b8cd5b5ULL,0x240ca1cc77ac9c65ULL,
    0x2de92c6f592b0275ULL,0x4a7484aa6ea6e483ULL,0x5cb0a9dcbd41fbd4ULL,0x76f988da831153b5ULL,
    0x983e5152ee66dfabULL,0xa831c66d2db43210ULL,0xb00327c898fb213fULL,0xbf597fc7beef0ee4ULL,
    0xc6e00bf33da88fc2ULL,0xd5a79147930aa725ULL,0x06ca6351e003826fULL,0x142929670a0e6e70ULL,
    0x27b70a8546d22ffcULL,0x2e1b21385c26c926ULL,0x4d2c6dfc5ac42aedULL,0x53380d139d95b3dfULL,
    0x650a73548baf63deULL,0x766a0abb3c77b2a8ULL,0x81c2c92e47edaee6ULL,0x92722c851482353bULL,
    0xa2bfe8a14cf10364ULL,0xa81a664bbc423001ULL,0xc24b8b70d0f89791ULL,0xc76c51a30654be30ULL,
    0xd192e819d6ef5218ULL,0xd69906245565a910ULL,0xf40e35855771202aULL,0x106aa07032bbd1b8ULL,
    0x19a4c116b8d2d0c8ULL,0x1e376c085141ab53ULL,0x2748774cdf8eeb99ULL,0x34b0bcb5e19b48a8ULL,
    0x391c0cb3c5c95a63ULL,0x4ed8aa4ae3418acbULL,0x5b9cca4f7763e373ULL,0x682e6ff3d6b2b8a3ULL,
    0x748f82ee5defb2fcULL,0x78a5636f43172f60ULL,0x84c87814a1f0ab72ULL,0x8cc702081a6439ecULL,
    0x90befffa23631e28ULL,0xa4506cebde82bde9ULL,0xbef9a3f7b2c67915ULL,0xc67178f2e372532bULL,
    0xca273eceea26619cULL,0xd186b8c721c0c207ULL,0xeada7dd6cde0eb1eULL,0xf57d4f7fee6ed178ULL,
    0x06f067aa72176fbaULL,0x0a637dc5a2c898a6ULL,0x113f9804bef90daeULL,0x1b710b35131c471bULL,
    0x28db77f523047d84ULL,0x32caab7b40c72493ULL,0x3c9ebe0a15c9bebcULL,0x431d67c49c100d4cULL,
    0x4cc5d4becb3e42b6ULL,0x597f299cfc657e2aULL,0x5fcb6fab3ad6faecULL,0x6c44198c4a475817ULL,
};

struct sha512_ctx { u64 h[8]; u8 buf[128]; u64 len; };

static inline u64 rotr64(u64 x, int n) { return (x >> n) | (x << (64 - n)); }

static void sha512_init(sha512_ctx &c) {
    static const u64 H0[8] = {
        0x6a09e667f3bcc908ULL,0xbb67ae8584caa73bULL,0x3c6ef372fe94f82bULL,
        0xa54ff53a5f1d36f1ULL,0x510e527fade682d1ULL,0x9b05688c2b3e6c1fULL,
        0x1f83d9abfb41bd6bULL,0x5be0cd19137e2179ULL};
    memcpy(c.h, H0, sizeof H0);
    c.len = 0;
}

static void sha512_block(sha512_ctx &c, const u8 *p) {
    u64 w[80];
    for (int i = 0; i < 16; i++) {
        w[i] = 0;
        for (int j = 0; j < 8; j++) w[i] = (w[i] << 8) | p[i * 8 + j];
    }
    for (int i = 16; i < 80; i++) {
        u64 s0 = rotr64(w[i-15],1) ^ rotr64(w[i-15],8) ^ (w[i-15] >> 7);
        u64 s1 = rotr64(w[i-2],19) ^ rotr64(w[i-2],61) ^ (w[i-2] >> 6);
        w[i] = w[i-16] + s0 + w[i-7] + s1;
    }
    u64 a=c.h[0],b=c.h[1],d=c.h[3],e=c.h[4],f=c.h[5],g=c.h[6],h=c.h[7],cc=c.h[2];
    for (int i = 0; i < 80; i++) {
        u64 S1 = rotr64(e,14) ^ rotr64(e,18) ^ rotr64(e,41);
        u64 ch = (e & f) ^ (~e & g);
        u64 t1 = h + S1 + ch + K512[i] + w[i];
        u64 S0 = rotr64(a,28) ^ rotr64(a,34) ^ rotr64(a,39);
        u64 mj = (a & b) ^ (a & cc) ^ (b & cc);
        u64 t2 = S0 + mj;
        h=g; g=f; f=e; e=d+t1; d=cc; cc=b; b=a; a=t1+t2;
    }
    c.h[0]+=a; c.h[1]+=b; c.h[2]+=cc; c.h[3]+=d;
    c.h[4]+=e; c.h[5]+=f; c.h[6]+=g; c.h[7]+=h;
}

static void sha512_update(sha512_ctx &c, const u8 *p, u64 n) {
    u64 fill = c.len & 127;
    c.len += n;
    if (fill) {
        u64 take = 128 - fill;
        if (take > n) take = n;
        memcpy(c.buf + fill, p, take);
        p += take; n -= take;
        if (((c.len - n) & 127) == 0) sha512_block(c, c.buf);
        else return;
    }
    while (n >= 128) { sha512_block(c, p); p += 128; n -= 128; }
    if (n) memcpy(c.buf, p, n);
}

static void sha512_final(sha512_ctx &c, u8 *out) {
    u64 fill = c.len & 127;
    u8 pad[256] = {0};
    pad[0] = 0x80;
    u64 padlen = (fill < 112) ? (112 - fill) : (240 - fill);
    u64 bits = c.len * 8;
    u8 lenb[16] = {0};
    for (int i = 0; i < 8; i++) lenb[15 - i] = (u8)(bits >> (8 * i));
    sha512_update(c, pad, padlen);
    sha512_update(c, lenb, 16);
    for (int i = 0; i < 8; i++)
        for (int j = 0; j < 8; j++)
            out[i * 8 + j] = (u8)(c.h[i] >> (56 - 8 * j));
}

// ---------------------------------------------------------------------------
// Scalar arithmetic mod l = 2^252 + delta (4x64 limbs)
// ---------------------------------------------------------------------------
static const u64 L64[4] = {0x5812631a5cf5d3edULL, 0x14def9dea2f79cd6ULL,
                           0, 0x1000000000000000ULL};
// -2^256 mod l (129 bits) = 16*(l - 2^252); matches the reference's minusR
// words (source/curve25519_order.c:65-72) repacked to 64-bit
static const u64 NEGR[3] = {0x812631A5CF5D3ED0ULL, 0x4DEF9DEA2F79CD65ULL, 1};

struct sc { u64 v[4]; };

static u64 adc(u64 &r, u64 a, u64 b, u64 cin) {
    u128 t = (u128)a + b + cin;
    r = (u64)t;
    return (u64)(t >> 64);
}
static u64 sbb(u64 &r, u64 a, u64 b, u64 bin) {
    u128 t = (u128)a - b - bin;
    r = (u64)t;
    return (t >> 64) ? 1 : 0;
}

static void sc_reduce_hi(u64 *x /*5 words in/4 out*/) {
    // y = x[0..3] - x[4]*(-R); add l on borrow (cf. reference eco_ReduceHiWord,
    // source/curve25519_order.c:74-107, re-derived for 64-bit words)
    u64 t[5] = {0,0,0,0,0};
    u128 c = 0;
    for (int i = 0; i < 3; i++) {
        c += (u128)x[4] * NEGR[i];
        t[i] = (u64)c; c >>= 64;
    }
    t[3] = (u64)c;
    u64 br = 0;
    for (int i = 0; i < 4; i++) br = sbb(x[i], x[i], t[i], br);
    if (br) {
        u64 cy = 0;
        for (int i = 0; i < 4; i++) cy = adc(x[i], x[i], L64[i], cy);
    }
}

static void sc_mod(sc &r) {
    // subtract l while >= l (at most a few times for inputs < 2^256)
    for (;;) {
        bool ge = false;
        for (int i = 3; i >= 0; i--) {
            if (r.v[i] > L64[i]) { ge = true; break; }
            if (r.v[i] < L64[i]) break;
            if (i == 0) ge = true;  // equal
        }
        if (!ge) break;
        u64 br = 0;
        for (int i = 0; i < 4; i++) br = sbb(r.v[i], r.v[i], L64[i], br);
    }
}

static void sc_from_bytes64(sc &r, const u8 *s) {
    u64 w[8];
    memcpy(w, s, 64);
    for (int i = 7; i >= 4; i--) {
        u64 x[5] = {w[i-4], w[i-3], w[i-2], w[i-1], w[i]};
        sc_reduce_hi(x);
        w[i-4]=x[0]; w[i-3]=x[1]; w[i-2]=x[2]; w[i-1]=x[3];
    }
    memcpy(r.v, w, 32);
    sc_mod(r);
}

static void sc_from_bytes32(sc &r, const u8 *s) {
    memcpy(r.v, s, 32);
    sc_mod(r);
}

static void sc_add(sc &r, const sc &a, const sc &b) {
    u64 cy = 0;
    for (int i = 0; i < 4; i++) cy = adc(r.v[i], a.v[i], b.v[i], cy);
    u64 x[5] = {r.v[0], r.v[1], r.v[2], r.v[3], cy};
    sc_reduce_hi(x);
    memcpy(r.v, x, 32);
    sc_mod(r);
}

static void sc_mul(sc &r, const sc &a, const sc &b) {
    u64 w[8] = {0};
    for (int i = 0; i < 4; i++) {
        u128 c = 0;
        for (int j = 0; j < 4; j++) {
            c += (u128)a.v[i] * b.v[j] + w[i + j];
            w[i + j] = (u64)c; c >>= 64;
        }
        w[i + 4] = (u64)c;
    }
    for (int i = 7; i >= 4; i--) {
        u64 x[5] = {w[i-4], w[i-3], w[i-2], w[i-1], w[i]};
        sc_reduce_hi(x);
        w[i-4]=x[0]; w[i-3]=x[1]; w[i-2]=x[2]; w[i-1]=x[3];
    }
    memcpy(r.v, w, 32);
    sc_mod(r);
}

static void sc_to_bytes(u8 *s, const sc &a) { memcpy(s, a.v, 32); }

// ---------------------------------------------------------------------------
// Edwards curve ops (extended coordinates)
// ---------------------------------------------------------------------------
struct ext { fe x, y, z, t; };

static const u8 D_BYTES[32] = {
    0xa3,0x78,0x59,0x13,0xca,0x4d,0xeb,0x75,0xab,0xd8,0x41,0x41,0x4d,0x0a,
    0x70,0x00,0x98,0xe8,0x79,0x77,0x79,0x40,0xc7,0x8c,0x73,0xfe,0x6f,0x2b,
    0xee,0x6c,0x03,0x52};
static const u8 BX_BYTES[32] = {
    0x1a,0xd5,0x25,0x8f,0x60,0x2d,0x56,0xc9,0xb2,0xa7,0x25,0x95,0x60,0xc7,
    0x2c,0x69,0x5c,0xdc,0xd6,0xfd,0x31,0xe2,0xa4,0xc0,0xfe,0x53,0x6e,0xcd,
    0xd3,0x36,0x69,0x21};
static const u8 BY_BYTES[32] = {
    0x58,0x66,0x66,0x66,0x66,0x66,0x66,0x66,0x66,0x66,0x66,0x66,0x66,0x66,
    0x66,0x66,0x66,0x66,0x66,0x66,0x66,0x66,0x66,0x66,0x66,0x66,0x66,0x66,
    0x66,0x66,0x66,0x66};
static const u8 SQRTM1_BYTES[32] = {
    0xb0,0xa0,0x0e,0x4a,0x27,0x1b,0xee,0xc4,0x78,0xe4,0x2f,0xad,0x06,0x18,
    0x43,0x2f,0xa7,0xd7,0xfb,0x3d,0x99,0x00,0x4d,0x2b,0x0b,0xdf,0xc1,0x4f,
    0x80,0x24,0x83,0x2b};

static void ed_identity(ext &p) {
    fe_zero(p.x); fe_one(p.y); fe_one(p.z); fe_zero(p.t);
}

static void ed_double(ext &p) {
    // same schedule as the JAX edwards.double (a = -1 curve):
    // A=X^2, B=Y^2, C=2Z^2, D=-A, H=D-B, G=D+B, F=G-C,
    // E=(X+Y)^2+H;  X=E*F, Y=H*G, Z=G*F, T=E*H
    fe a, b, c, d, h, g, f, e, s, z0;
    fe_sqr(a, p.x);
    fe_sqr(b, p.y);
    fe_sqr(c, p.z); fe_add(c, c, c);
    fe_zero(z0);
    fe_sub(d, z0, a);
    fe_sub(h, d, b);
    fe_add(g, d, b);
    fe_sub(f, g, c);
    fe_add(s, p.x, p.y);
    fe_sqr(e, s);
    fe_add(e, e, h);
    fe_mul(p.x, e, f);
    fe_mul(p.y, h, g);
    fe_mul(p.z, g, f);
    fe_mul(p.t, e, h);
}

static void ed_add(ext &r, const ext &p, const ext &q) {
    // unified addition, a = -1, 2d precomputed
    fe a, b, c, d2, e, f, g, h, t1, t2;
    fe D; fe_from_bytes(D, D_BYTES);
    fe_sub(t1, p.y, p.x);
    fe_sub(t2, q.y, q.x);
    fe_mul(a, t1, t2);
    fe_add(t1, p.y, p.x);
    fe_add(t2, q.y, q.x);
    fe_mul(b, t1, t2);
    fe_mul(c, p.t, q.t);
    fe_mul(c, c, D); fe_add(c, c, c);   // C = 2d * T1 * T2
    fe_mul(d2, p.z, q.z); fe_add(d2, d2, d2);
    fe_sub(e, b, a);
    fe_sub(f, d2, c);
    fe_add(g, d2, c);
    fe_add(h, b, a);
    fe_mul(r.x, e, f);
    fe_mul(r.y, g, h);
    fe_mul(r.t, e, h);
    fe_mul(r.z, f, g);
}

// ---------------------------------------------------------------------------
// FOLDING-8 base-point multiply — the native fast path contesting the
// reference's single-op latency records (edp_BasePointMult,
// source/ed25519_sign.c:215-244): a 256-entry precomputed-affine table of
// all subset sums of P_i = 2^(32i)*G, built at first use from the curve
// constants (the reference ships base_folding8.h; we regenerate it), then
// 31 doubles + 32 mixed adds per 256-bit multiply.
// ---------------------------------------------------------------------------
struct pa { fe ypx, ymx, t2d; };

static pa fold8_table[256];
static bool fold8_ready = false;

// r = p + q for precomputed-affine q (7M), the reference edp_AddAffinePoint
// (source/ed25519_sign.c:97-115) on radix-2^51 limbs
static void ed_add_pa(ext &r, const ext &p, const pa &q) {
    fe a, b, c, d, e, f, g, h, t1;
    fe_sub(t1, p.y, p.x); fe_mul(a, t1, q.ymx);
    fe_add(t1, p.y, p.x); fe_mul(b, t1, q.ypx);
    fe_mul(c, p.t, q.t2d);
    fe_add(d, p.z, p.z);
    fe_sub(e, b, a);
    fe_add(h, b, a);
    fe_sub(f, d, c);
    fe_add(g, d, c);
    fe_mul(r.x, e, f);
    fe_mul(r.y, h, g);
    fe_mul(r.z, f, g);
    fe_mul(r.t, e, h);
}

// Montgomery batch inversion: one fe_inv + 3(n-1) muls for n inverses
static void fe_inv_batch(fe *zs, int n) {
    static fe pre[256];
    fe acc; fe_one(acc);
    for (int i = 0; i < n; i++) {
        pre[i] = acc;
        fe_mul(acc, acc, zs[i]);
    }
    fe ainv; fe_inv(ainv, acc);
    for (int i = n - 1; i >= 0; i--) {
        fe t;
        fe_mul(t, ainv, pre[i]);
        fe_mul(ainv, ainv, zs[i]);
        zs[i] = t;
    }
}

static void build_fold8() {
    ext pts[8];
    fe_from_bytes(pts[0].x, BX_BYTES);
    fe_from_bytes(pts[0].y, BY_BYTES);
    fe_one(pts[0].z);
    fe_mul(pts[0].t, pts[0].x, pts[0].y);
    for (int i = 1; i < 8; i++) {
        pts[i] = pts[i - 1];
        for (int d = 0; d < 32; d++) ed_double(pts[i]);
    }
    static ext ent[256];
    ed_identity(ent[0]);
    for (int idx = 1; idx < 256; idx++) {
        int low = idx & -idx;
        int bit = __builtin_ctz(idx);
        if (idx == low) ent[idx] = pts[bit];
        else ed_add(ent[idx], ent[idx & (idx - 1)], pts[bit]);
    }
    static fe zs[256];
    for (int i = 0; i < 256; i++) zs[i] = ent[i].z;
    fe_inv_batch(zs, 256);
    fe D2;
    fe_from_bytes(D2, D_BYTES);
    fe_add(D2, D2, D2);                              // 2d
    for (int i = 0; i < 256; i++) {
        fe x, y, xy;
        fe_mul(x, ent[i].x, zs[i]);
        fe_mul(y, ent[i].y, zs[i]);
        fe_add(fold8_table[i].ypx, y, x); fe_carry(fold8_table[i].ypx);
        fe_sub(fold8_table[i].ymx, y, x); fe_carry(fold8_table[i].ymx);
        fe_mul(xy, x, y);
        fe_mul(fold8_table[i].t2d, xy, D2);
    }
    fold8_ready = true;
}

// cut[c] bit j = scalar bit 32j + 31 - c (reference ecp_8Folds,
// source/curve25519_utils.c:144-153)
static void fold8_cut(u8 *cut, const u8 *k) {
    for (int c = 0; c < 32; c++) {
        int v = 0;
        for (int j = 0; j < 8; j++) {
            int b = 32 * j + 31 - c;
            v |= ((k[b >> 3] >> (b & 7)) & 1) << j;
        }
        cut[c] = (u8)v;
    }
}

static void ed_base_mult_fold8(ext &r, const u8 *k32) {
    if (!fold8_ready) build_fold8();
    u8 cut[32];
    fold8_cut(cut, k32);
    ed_identity(r);
    for (int c = 0; c < 32; c++) {
        if (c) ed_double(r);
        ed_add_pa(r, r, fold8_table[cut[c]]);
    }
}

static void ed_scalar_mult(ext &r, const sc &k, const ext &p) {
    // simple double-and-add (host oracle; not constant-time critical here)
    ext q = p;
    ed_identity(r);
    for (int w = 0; w < 4; w++) {
        u64 bits = k.v[w];
        for (int i = 0; i < 64; i++) {
            if (bits & 1) { ext t; ed_add(t, r, q); r = t; }
            ext t2 = q; ed_double(t2); q = t2;
            bits >>= 1;
        }
    }
}

static void ed_base_mult_raw(ext &r, const u8 *k32) {
    ext base;
    fe_from_bytes(base.x, BX_BYTES);
    fe_from_bytes(base.y, BY_BYTES);
    fe_one(base.z);
    fe_mul(base.t, base.x, base.y);
    ext q = base;
    ed_identity(r);
    for (int i = 0; i < 256; i++) {
        if ((k32[i >> 3] >> (i & 7)) & 1) { ext t; ed_add(t, r, q); r = t; }
        ext t2 = q; ed_double(t2); q = t2;
    }
}

static void ed_compress(u8 *out, const ext &p) {
    fe zi, x, y;
    fe_inv(zi, p.z);
    fe_mul(x, p.x, zi);
    fe_mul(y, p.y, zi);
    fe_to_bytes(out, y);
    out[31] |= (u8)(fe_parity(x) << 7);
}

static int ed_decompress(ext &p, const u8 *in) {
    u8 yb[32];
    memcpy(yb, in, 32);
    int parity = yb[31] >> 7;
    yb[31] &= 0x7f;
    fe y, y2, u, v, D, x, chk;
    fe_from_bytes(y, yb);
    fe_from_bytes(D, D_BYTES);
    fe_sqr(y2, y);
    fe one; fe_one(one);
    fe_sub(u, y2, one);
    fe_mul(v, y2, D); fe_add(v, v, one);
    // x = u v^3 (u v^7)^((p-5)/8)
    fe v2, v3, uv3, uv7, t;
    fe_sqr(v2, v); fe_mul(v3, v2, v);
    fe_mul(uv3, u, v3);
    fe_sqr(t, v2); fe_mul(uv7, uv3, t);
    fe_pow2523(t, uv7);
    fe_mul(x, uv3, t);
    fe_sqr(chk, x); fe_mul(chk, chk, v); fe_sub(chk, chk, u);
    if (!fe_is_zero(chk)) {
        fe sm1; fe_from_bytes(sm1, SQRTM1_BYTES);
        fe_mul(x, x, sm1);
        fe_sqr(chk, x); fe_mul(chk, chk, v); fe_sub(chk, chk, u);
        if (!fe_is_zero(chk)) return 0;
    }
    if (fe_parity(x) != parity) {
        fe z; fe_zero(z);
        fe_sub(x, z, x);
    }
    p.x = x; p.y = y;
    fe_one(p.z);
    fe_mul(p.t, x, y);
    return 1;
}

// ---------------------------------------------------------------------------
// X25519 ladder
// ---------------------------------------------------------------------------
static void clamp(u8 *k) { k[0] &= 0xf8; k[31] = (k[31] | 0x40) & 0x7f; }

extern "C" void c25519_x25519(u8 *out, const u8 *pk, const u8 *sk_in) {
    u8 k[32];
    memcpy(k, sk_in, 32);
    clamp(k);
    u8 ub[32];
    memcpy(ub, pk, 32);
    ub[31] &= 0x7f;
    fe u, x2, z2, x3, z3;
    fe_from_bytes(u, ub);
    fe_one(x2); fe_zero(z2);
    fe_copy(x3, u); fe_one(z3);
    int swap = 0;
    for (int i = 254; i >= 0; i--) {
        int bit = (k[i >> 3] >> (i & 7)) & 1;
        if (swap ^ bit) {
            fe tt;
            tt = x2; x2 = x3; x3 = tt;
            tt = z2; z2 = z3; z3 = tt;
        }
        swap = bit;
        fe a, aa, b, bb, e, c, d, da, cb, t;
        fe_add(a, x2, z2); fe_sqr(aa, a);
        fe_sub(b, x2, z2); fe_sqr(bb, b);
        fe_sub(e, aa, bb);
        fe_add(c, x3, z3);
        fe_sub(d, x3, z3);
        fe_mul(da, d, a);
        fe_mul(cb, c, b);
        fe_add(t, da, cb); fe_sqr(x3, t);
        fe_sub(t, da, cb); fe_sqr(t, t); fe_mul(z3, u, t);
        fe_mul(x2, aa, bb);
        fe_mul_small(t, e, 121665);
        fe_add(t, aa, t);
        fe_mul(z2, e, t);
    }
    if (swap) { x2 = x3; z2 = z3; }
    fe zi, r;
    fe_inv(zi, z2);
    fe_mul(r, x2, zi);
    fe_to_bytes(out, r);
}

extern "C" void c25519_x25519_base(u8 *out, const u8 *sk) {
    u8 nine[32] = {9};
    c25519_x25519(out, nine, sk);
}

// ---------------------------------------------------------------------------
// Ed25519 protocol
// ---------------------------------------------------------------------------
extern "C" void c25519_sha512(u8 *out, const u8 *msg, u64 len) {
    sha512_ctx c;
    sha512_init(c);
    sha512_update(c, msg, len);
    sha512_final(c, out);
}

// Streaming SHA-512 with an opaque caller-held context — the native backend
// of the framework's O(1)-memory Sha512 Update/Final facade (the reference
// API shape, source/sha512.h:85-87; arbitrary-length streams with only
// (state, <128-byte tail, 64-bit length) carried between calls, matching
// source/sha512.c:118-157).
extern "C" u64 c25519_sha512_ctx_size() { return sizeof(sha512_ctx); }

extern "C" void c25519_sha512_init(void *ctx) {
    sha512_init(*(sha512_ctx *)ctx);
}

extern "C" void c25519_sha512_update(void *ctx, const u8 *p, u64 n) {
    sha512_update(*(sha512_ctx *)ctx, p, n);
}

extern "C" void c25519_sha512_final(void *ctx, u8 *out) {
    sha512_final(*(sha512_ctx *)ctx, out);
}

extern "C" void c25519_ed25519_keypair(u8 *pk, u8 *priv, const u8 *sk) {
    u8 md[64];
    c25519_sha512(md, sk, 32);
    clamp(md);
    ext A;
    ed_base_mult_raw(A, md);
    ed_compress(pk, A);
    memcpy(priv, sk, 32);
    memcpy(priv + 32, pk, 32);
}

extern "C" void c25519_ed25519_sign(u8 *sig, const u8 *priv,
                                    const u8 *msg, u64 len) {
    u8 md[64], a_b[64];
    c25519_sha512(a_b, priv, 32);
    clamp(a_b);
    sha512_ctx c;
    sha512_init(c);
    sha512_update(c, a_b + 32, 32);
    sha512_update(c, msg, len);
    sha512_final(c, md);
    sc r; sc_from_bytes64(r, md);
    u8 rb[32]; sc_to_bytes(rb, r);
    u8 rb_full[32] = {0};
    memcpy(rb_full, rb, 32);
    ext R;
    ed_base_mult_raw(R, rb_full);
    ed_compress(sig, R);

    sha512_init(c);
    sha512_update(c, sig, 32);
    sha512_update(c, priv + 32, 32);
    sha512_update(c, msg, len);
    sha512_final(c, md);
    sc h; sc_from_bytes64(h, md);
    sc a; sc_from_bytes32(a, a_b);   // note: a < 2^255, reduced mod l
    sc ha; sc_mul(ha, h, a);
    sc s; sc_add(s, ha, r);
    sc_to_bytes(sig + 32, s);
}

// ---------------------------------------------------------------------------
// Folding-accelerated single-op fast paths. Bit-identical outputs to the
// generic routines above (the slow generic forms stay as the in-library
// differential oracle); these contest the reference's latency records
// (README.md:70-71,86-97: keygen ~14.7 us, sign ~15.8 us, base mult
// ~12.7 us on its record hardware).
// ---------------------------------------------------------------------------
extern "C" void c25519_ed25519_keypair_fast(u8 *pk, u8 *priv, const u8 *sk) {
    u8 md[64];
    c25519_sha512(md, sk, 32);
    clamp(md);
    ext A;
    ed_base_mult_fold8(A, md);
    ed_compress(pk, A);
    memcpy(priv, sk, 32);
    memcpy(priv + 32, pk, 32);
}

extern "C" void c25519_ed25519_sign_fast(u8 *sig, const u8 *priv,
                                         const u8 *msg, u64 len) {
    u8 md[64], a_b[64];
    c25519_sha512(a_b, priv, 32);
    clamp(a_b);
    sha512_ctx c;
    sha512_init(c);
    sha512_update(c, a_b + 32, 32);
    sha512_update(c, msg, len);
    sha512_final(c, md);
    sc r; sc_from_bytes64(r, md);
    u8 rb[32]; sc_to_bytes(rb, r);
    ext R;
    ed_base_mult_fold8(R, rb);
    ed_compress(sig, R);

    sha512_init(c);
    sha512_update(c, sig, 32);
    sha512_update(c, priv + 32, 32);
    sha512_update(c, msg, len);
    sha512_final(c, md);
    sc h; sc_from_bytes64(h, md);
    sc a; sc_from_bytes32(a, a_b);
    sc ha; sc_mul(ha, h, a);
    sc s; sc_add(s, ha, r);
    sc_to_bytes(sig + 32, s);
}

// X25519 public key via the Edwards folding multiply + birational map
// u = (Z+Y)/(Z-Y) — reference curve25519_dh_CalculatePublicKey_fast
// (source/curve25519_dh.c:162-189)
extern "C" void c25519_x25519_base_fast(u8 *out, const u8 *sk_in) {
    u8 k[32];
    memcpy(k, sk_in, 32);
    clamp(k);
    ext S;
    ed_base_mult_fold8(S, k);
    fe num, den, di, u;
    fe_add(num, S.z, S.y);
    fe_sub(den, S.z, S.y);
    fe_inv(di, den);
    fe_mul(u, num, di);
    fe_to_bytes(out, u);
}

extern "C" int c25519_ed25519_verify(const u8 *sig, const u8 *pk,
                                     const u8 *msg, u64 len) {
    ext Q;
    if (!ed_decompress(Q, pk)) return 0;
    // negate Q
    fe z; fe_zero(z);
    fe_sub(Q.x, z, Q.x);
    fe_sub(Q.t, z, Q.t);
    u8 md[64];
    sha512_ctx c;
    sha512_init(c);
    sha512_update(c, sig, 32);
    sha512_update(c, pk, 32);
    sha512_update(c, msg, len);
    sha512_final(c, md);
    sc h; sc_from_bytes64(h, md);
    ext hQ; ed_scalar_mult(hQ, h, Q);
    ext sG; ed_base_mult_raw(sG, sig + 32);
    ext Rp; ed_add(Rp, sG, hQ);
    u8 rb[32];
    ed_compress(rb, Rp);
    return memcmp(rb, sig, 32) == 0;
}
