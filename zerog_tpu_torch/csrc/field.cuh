// BN254 field and Jacobian point arithmetic for one thread.
//
// Stands where the limb-plane bodies of the Pallas field kernels stand
// (zerog_tpu/field/pfield.py: _mul_body, _add_body, _sub_body, _cond_sub_p)
// and the point bodies built on them (zerog_tpu/curve/pscan.py:
// _madd_incomplete, _add_incomplete). An element is 8 little-endian 32-bit
// words (two 16-bit limbs of the tensor form packed into each word), held in
// registers. The product is word-serial Montgomery (CIOS) with R = 2^256 and
// ends fully reduced in [0, p), so its canonical limbs equal those of the
// separated 16-bit form bit for bit.
//
// On the card (__CUDA_ARCH__) the product, add, subtract and conditional
// subtract are PTX carry chains (mad.lo.cc / madc.hi.cc, add.cc, sub.cc);
// for a host compiler the same functions are plain C++ over uint64_t. The
// same header builds for both, and the host build runs the kernels'
// per-thread functions in a loop; the two bodies give the same words.
#pragma once
#include <stdint.h>

#ifdef __CUDACC__
#define ZG_HD __host__ __device__ __forceinline__
#else
#define ZG_HD inline
#endif

#ifdef __CUDA_ARCH__
// ---- PTX carry chains ---------------------------------------------------------
// Each carry chain is one asm statement, so that the compiler can put nothing
// between the instruction that sets the carry flag and the one that reads it.
// Accumulators are read-write operands ("+r").

// d += b over 8 words; the carry out of word 7 is dropped.
__device__ __forceinline__ void zg_add8(uint32_t d[8], const uint32_t b[8]) {
    asm("add.cc.u32 %0, %0, %8;\n\t"
        "addc.cc.u32 %1, %1, %9;\n\t"
        "addc.cc.u32 %2, %2, %10;\n\t"
        "addc.cc.u32 %3, %3, %11;\n\t"
        "addc.cc.u32 %4, %4, %12;\n\t"
        "addc.cc.u32 %5, %5, %13;\n\t"
        "addc.cc.u32 %6, %6, %14;\n\t"
        "addc.u32 %7, %7, %15;"
        : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]),
          "+r"(d[6]), "+r"(d[7])
        : "r"(b[0]), "r"(b[1]), "r"(b[2]), "r"(b[3]), "r"(b[4]), "r"(b[5]), "r"(b[6]),
          "r"(b[7]));
}

// d -= b over 8 words; returns all ones if it borrowed (d < b), else 0.
__device__ __forceinline__ uint32_t zg_sub8(uint32_t d[8], const uint32_t b[8]) {
    uint32_t mask;
    asm("sub.cc.u32 %0, %0, %9;\n\t"
        "subc.cc.u32 %1, %1, %10;\n\t"
        "subc.cc.u32 %2, %2, %11;\n\t"
        "subc.cc.u32 %3, %3, %12;\n\t"
        "subc.cc.u32 %4, %4, %13;\n\t"
        "subc.cc.u32 %5, %5, %14;\n\t"
        "subc.cc.u32 %6, %6, %15;\n\t"
        "subc.cc.u32 %7, %7, %16;\n\t"
        "subc.u32 %8, %17, %17;"
        : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]),
          "+r"(d[6]), "+r"(d[7]), "=r"(mask)
        : "r"(b[0]), "r"(b[1]), "r"(b[2]), "r"(b[3]), "r"(b[4]), "r"(b[5]), "r"(b[6]),
          "r"(b[7]), "r"(0u));
    return mask;
}

// acc += m (a0 + a1 2^64 + a2 2^128 + a3 2^192), the product words of a_k
// going to acc[2k] (low) and acc[2k+1] (high); the carry out of acc[7] is
// added to `top`.
__device__ __forceinline__ void zg_mad4_top(uint32_t acc[8], uint32_t a0, uint32_t a1,
                                            uint32_t a2, uint32_t a3, uint32_t m,
                                            uint32_t& top) {
    asm("mad.lo.cc.u32 %0, %9, %13, %0;\n\t"
        "madc.hi.cc.u32 %1, %9, %13, %1;\n\t"
        "madc.lo.cc.u32 %2, %10, %13, %2;\n\t"
        "madc.hi.cc.u32 %3, %10, %13, %3;\n\t"
        "madc.lo.cc.u32 %4, %11, %13, %4;\n\t"
        "madc.hi.cc.u32 %5, %11, %13, %5;\n\t"
        "madc.lo.cc.u32 %6, %12, %13, %6;\n\t"
        "madc.hi.cc.u32 %7, %12, %13, %7;\n\t"
        "addc.u32 %8, %8, %14;"
        : "+r"(acc[0]), "+r"(acc[1]), "+r"(acc[2]), "+r"(acc[3]), "+r"(acc[4]),
          "+r"(acc[5]), "+r"(acc[6]), "+r"(acc[7]), "+r"(top)
        : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(m), "r"(0u));
}

// As zg_mad4_top, with no carry out of acc[7] (the caller knows it is 0).
__device__ __forceinline__ void zg_mad4(uint32_t acc[8], uint32_t a0, uint32_t a1,
                                        uint32_t a2, uint32_t a3, uint32_t m) {
    asm("mad.lo.cc.u32 %0, %8, %12, %0;\n\t"
        "madc.hi.cc.u32 %1, %8, %12, %1;\n\t"
        "madc.lo.cc.u32 %2, %9, %12, %2;\n\t"
        "madc.hi.cc.u32 %3, %9, %12, %3;\n\t"
        "madc.lo.cc.u32 %4, %10, %12, %4;\n\t"
        "madc.hi.cc.u32 %5, %10, %12, %5;\n\t"
        "madc.lo.cc.u32 %6, %11, %12, %6;\n\t"
        "madc.hi.u32 %7, %11, %12, %7;"
        : "+r"(acc[0]), "+r"(acc[1]), "+r"(acc[2]), "+r"(acc[3]), "+r"(acc[4]),
          "+r"(acc[5]), "+r"(acc[6]), "+r"(acc[7])
        : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(m));
}

// As zg_mad4, after x += y, whose carry enters acc[0].
__device__ __forceinline__ void zg_add_mad4(uint32_t& x, uint32_t y, uint32_t acc[8],
                                            uint32_t a0, uint32_t a1, uint32_t a2,
                                            uint32_t a3, uint32_t m) {
    asm("add.cc.u32 %0, %0, %9;\n\t"
        "madc.lo.cc.u32 %1, %10, %14, %1;\n\t"
        "madc.hi.cc.u32 %2, %10, %14, %2;\n\t"
        "madc.lo.cc.u32 %3, %11, %14, %3;\n\t"
        "madc.hi.cc.u32 %4, %11, %14, %4;\n\t"
        "madc.lo.cc.u32 %5, %12, %14, %5;\n\t"
        "madc.hi.cc.u32 %6, %12, %14, %6;\n\t"
        "madc.lo.cc.u32 %7, %13, %14, %7;\n\t"
        "madc.hi.u32 %8, %13, %14, %8;"
        : "+r"(x), "+r"(acc[0]), "+r"(acc[1]), "+r"(acc[2]), "+r"(acc[3]), "+r"(acc[4]),
          "+r"(acc[5]), "+r"(acc[6]), "+r"(acc[7])
        : "r"(y), "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(m));
}

// t[0..8] += lo(m p_k) at word k for k = 0..7, the carry out of word 7 into
// word 8 (the low halves of m p).
__device__ __forceinline__ void zg_mad8_lo(uint32_t t[9], uint32_t m, const uint32_t p[8]) {
    asm("mad.lo.cc.u32 %0, %9, %10, %0;\n\t"
        "madc.lo.cc.u32 %1, %9, %11, %1;\n\t"
        "madc.lo.cc.u32 %2, %9, %12, %2;\n\t"
        "madc.lo.cc.u32 %3, %9, %13, %3;\n\t"
        "madc.lo.cc.u32 %4, %9, %14, %4;\n\t"
        "madc.lo.cc.u32 %5, %9, %15, %5;\n\t"
        "madc.lo.cc.u32 %6, %9, %16, %6;\n\t"
        "madc.lo.cc.u32 %7, %9, %17, %7;\n\t"
        "addc.u32 %8, %8, %18;"
        : "+r"(t[0]), "+r"(t[1]), "+r"(t[2]), "+r"(t[3]), "+r"(t[4]), "+r"(t[5]),
          "+r"(t[6]), "+r"(t[7]), "+r"(t[8])
        : "r"(m), "r"(p[0]), "r"(p[1]), "r"(p[2]), "r"(p[3]), "r"(p[4]), "r"(p[5]),
          "r"(p[6]), "r"(p[7]), "r"(0u));
}

// t[1..8] += hi(m p_k) at word k + 1 for k = 0..7 (the high halves of m p);
// the carry out of word 8 is dropped (the caller knows it is 0).
__device__ __forceinline__ void zg_mad8_hi(uint32_t t[9], uint32_t m, const uint32_t p[8]) {
    asm("mad.hi.cc.u32 %0, %8, %9, %0;\n\t"
        "madc.hi.cc.u32 %1, %8, %10, %1;\n\t"
        "madc.hi.cc.u32 %2, %8, %11, %2;\n\t"
        "madc.hi.cc.u32 %3, %8, %12, %3;\n\t"
        "madc.hi.cc.u32 %4, %8, %13, %4;\n\t"
        "madc.hi.cc.u32 %5, %8, %14, %5;\n\t"
        "madc.hi.cc.u32 %6, %8, %15, %6;\n\t"
        "madc.hi.u32 %7, %8, %16, %7;"
        : "+r"(t[1]), "+r"(t[2]), "+r"(t[3]), "+r"(t[4]), "+r"(t[5]), "+r"(t[6]),
          "+r"(t[7]), "+r"(t[8])
        : "r"(m), "r"(p[0]), "r"(p[1]), "r"(p[2]), "r"(p[3]), "r"(p[4]), "r"(p[5]),
          "r"(p[6]), "r"(p[7]));
}
// ---- end of PTX carry chains ----------------------------------------------------
#endif

#define ZG_NW 8  // 32-bit words per element

struct Fe {
    uint32_t w[ZG_NW];
};

// Field selector: 0 = Fq (base field, point coordinates), 1 = Fr (scalars).
// Word constants come through switch functions so that, with the loops
// unrolled, each use is an immediate in device code.
template <int F>
ZG_HD uint32_t zg_p(int i) {
    if (F == 0) {
        switch (i) {
            case 0: return 0xd87cfd47u;
            case 1: return 0x3c208c16u;
            case 2: return 0x6871ca8du;
            case 3: return 0x97816a91u;
            case 4: return 0x8181585du;
            case 5: return 0xb85045b6u;
            case 6: return 0xe131a029u;
            default: return 0x30644e72u;
        }
    } else {
        switch (i) {
            case 0: return 0xf0000001u;
            case 1: return 0x43e1f593u;
            case 2: return 0x79b97091u;
            case 3: return 0x2833e848u;
            case 4: return 0x8181585du;
            case 5: return 0xb85045b6u;
            case 6: return 0xe131a029u;
            default: return 0x30644e72u;
        }
    }
}

// R mod p: the Montgomery form of 1.
template <int F>
ZG_HD uint32_t zg_one(int i) {
    if (F == 0) {
        switch (i) {
            case 0: return 0xc58f0d9du;
            case 1: return 0xd35d438du;
            case 2: return 0xf5c70b3du;
            case 3: return 0x0a78eb28u;
            case 4: return 0x7879462cu;
            case 5: return 0x666ea36fu;
            case 6: return 0x9a07df2fu;
            default: return 0x0e0a77c1u;
        }
    } else {
        switch (i) {
            case 0: return 0x4ffffffbu;
            case 1: return 0xac96341cu;
            case 2: return 0x9f60cd29u;
            case 3: return 0x36fc7695u;
            case 4: return 0x7879462eu;
            case 5: return 0x666ea36fu;
            case 6: return 0x9a07df2fu;
            default: return 0x0e0a77c1u;
        }
    }
}

// -p^{-1} mod 2^32
template <int F>
ZG_HD uint32_t zg_n0() {
    return F == 0 ? 0xe4866389u : 0xefffffffu;
}

// ---- element helpers --------------------------------------------------------

ZG_HD Fe fe_zero() {
    Fe r;
#pragma unroll
    for (int i = 0; i < ZG_NW; i++) r.w[i] = 0u;
    return r;
}

template <int F>
ZG_HD Fe fe_one() {
    Fe r;
#pragma unroll
    for (int i = 0; i < ZG_NW; i++) r.w[i] = zg_one<F>(i);
    return r;
}

ZG_HD bool fe_is_zero(const Fe& a) {
    uint32_t acc = 0u;
#pragma unroll
    for (int i = 0; i < ZG_NW; i++) acc |= a.w[i];
    return acc == 0u;
}

ZG_HD Fe fe_select(bool c, const Fe& a, const Fe& b) {
    Fe r;
#pragma unroll
    for (int i = 0; i < ZG_NW; i++) r.w[i] = c ? a.w[i] : b.w[i];
    return r;
}

// r in [0, 2p) -> r mod p
template <int F>
ZG_HD Fe fe_cond_sub_p(const Fe& r) {
    Fe d;
#ifdef __CUDA_ARCH__
    uint32_t p[ZG_NW];
#pragma unroll
    for (int i = 0; i < ZG_NW; i++) {
        d.w[i] = r.w[i];
        p[i] = zg_p<F>(i);
    }
    const uint32_t borrow = zg_sub8(d.w, p);  // all ones where r < p
#pragma unroll
    for (int i = 0; i < ZG_NW; i++) d.w[i] = (r.w[i] & borrow) | (d.w[i] & ~borrow);
    return d;
#else
    uint64_t borrow = 0;
#pragma unroll
    for (int i = 0; i < ZG_NW; i++) {
        uint64_t s = (uint64_t)r.w[i] - (uint64_t)zg_p<F>(i) - borrow;
        d.w[i] = (uint32_t)s;
        borrow = (s >> 32) & 1u;
    }
    return fe_select(borrow == 0, d, r);
#endif
}

template <int F>
ZG_HD Fe fe_add(const Fe& a, const Fe& b) {
    Fe s;
    // a + b < 2p < 2^255: no carry out of the top word
#ifdef __CUDA_ARCH__
    s = a;
    zg_add8(s.w, b.w);
#else
    uint64_t carry = 0;
#pragma unroll
    for (int i = 0; i < ZG_NW; i++) {
        uint64_t t = (uint64_t)a.w[i] + (uint64_t)b.w[i] + carry;
        s.w[i] = (uint32_t)t;
        carry = t >> 32;
    }
#endif
    return fe_cond_sub_p<F>(s);
}

template <int F>
ZG_HD Fe fe_sub(const Fe& a, const Fe& b) {
    Fe d;
#ifdef __CUDA_ARCH__
    // a - b, then p & (all ones where a < b) added back; the wrap past 2^256
    // cancels the borrow
    d = a;
    const uint32_t mask = zg_sub8(d.w, b.w);
    uint32_t pm[ZG_NW];
#pragma unroll
    for (int i = 0; i < ZG_NW; i++) pm[i] = zg_p<F>(i) & mask;
    zg_add8(d.w, pm);
    return d;
#else
    uint64_t borrow = 0;
#pragma unroll
    for (int i = 0; i < ZG_NW; i++) {
        uint64_t s = (uint64_t)a.w[i] - (uint64_t)b.w[i] - borrow;
        d.w[i] = (uint32_t)s;
        borrow = (s >> 32) & 1u;
    }
    // a < b: add p back (the wrap past 2^256 cancels the borrow)
    Fe e;
    uint64_t carry = 0;
#pragma unroll
    for (int i = 0; i < ZG_NW; i++) {
        uint64_t t = (uint64_t)d.w[i] + (uint64_t)zg_p<F>(i) + carry;
        e.w[i] = (uint32_t)t;
        carry = t >> 32;
    }
    return fe_select(borrow != 0, e, d);
#endif
}

#ifdef __CUDA_ARCH__
// One reduction step of the product below: T += m p with m = T[0] (-p^-1),
// which clears word 0. T = e + 2^32 o (e: words 0..7, o: words 1..8). The
// odd words of p go into o and the even ones into e, two independent carry
// chains; e's carry out of word 7 lands in o[7] (word 8). o's carry out of
// word 8 is 0, since T < 2^288 throughout (T < 2p + 2^33 p).
template <int F>
__device__ __forceinline__ void fe_mul_reduce(uint32_t e[ZG_NW], uint32_t o[ZG_NW]) {
    const uint32_t m = e[0] * zg_n0<F>();
    zg_mad4(o, zg_p<F>(1), zg_p<F>(3), zg_p<F>(5), zg_p<F>(7), m);
    zg_mad4_top(e, zg_p<F>(0), zg_p<F>(2), zg_p<F>(4), zg_p<F>(6), m, o[ZG_NW - 1]);
}
#endif

// Montgomery product a * b * 2^-256 mod p, a and b in [0, p).
template <int F>
ZG_HD Fe fe_mul(const Fe& a, const Fe& b) {
#ifdef __CUDA_ARCH__
    // CIOS, one word of b a step, with the accumulator T split as
    // e + 2^32 o: e takes the products of a's even words, o those of its odd
    // words, so that each step runs two carry chains that do not depend on
    // each other, and likewise for m p.
    uint32_t e[ZG_NW], o[ZG_NW];
#pragma unroll
    for (int j = 0; j < ZG_NW; j += 2) {
        e[j] = a.w[j] * b.w[0];
        e[j + 1] = __umulhi(a.w[j], b.w[0]);
        o[j] = a.w[j + 1] * b.w[0];
        o[j + 1] = __umulhi(a.w[j + 1], b.w[0]);
    }
    fe_mul_reduce<F>(e, o);
#pragma unroll
    for (int i = 1; i < ZG_NW; i++) {
        // T / 2^32 (e[0] is 0): the next e is o + e[1] at word 0, its carry
        // into word 1 taken up by the first step of the next o, which is
        // e[2..7] at words 1..6 plus the products of a's odd words; the next
        // e is o[1..7] at words 1..7 plus those of its even words
        const uint32_t bi = b.w[i];
        uint32_t ne[ZG_NW], no[ZG_NW];
#pragma unroll
        for (int j = 0; j < ZG_NW; j++) ne[j] = o[j];
#pragma unroll
        for (int j = 0; j < ZG_NW - 2; j++) no[j] = e[j + 2];
        no[ZG_NW - 2] = no[ZG_NW - 1] = 0u;
        zg_add_mad4(ne[0], e[1], no, a.w[1], a.w[3], a.w[5], a.w[7], bi);
        zg_mad4_top(ne, a.w[0], a.w[2], a.w[4], a.w[6], bi, no[ZG_NW - 1]);
        fe_mul_reduce<F>(ne, no);
#pragma unroll
        for (int j = 0; j < ZG_NW; j++) {
            e[j] = ne[j];
            o[j] = no[j];
        }
    }
    // T / 2^32 < 2p < 2^255 in eight words
    Fe r;
    uint32_t hi[ZG_NW];
#pragma unroll
    for (int j = 0; j < ZG_NW; j++) r.w[j] = o[j];
#pragma unroll
    for (int j = 0; j < ZG_NW - 1; j++) hi[j] = e[j + 1];
    hi[ZG_NW - 1] = 0u;
    zg_add8(r.w, hi);
    return fe_cond_sub_p<F>(r);
#else
    uint32_t t[ZG_NW + 2];
#pragma unroll
    for (int i = 0; i < ZG_NW + 2; i++) t[i] = 0u;
#pragma unroll
    for (int i = 0; i < ZG_NW; i++) {
        uint64_t c = 0;
#pragma unroll
        for (int j = 0; j < ZG_NW; j++) {
            uint64_t s = (uint64_t)a.w[j] * (uint64_t)b.w[i] + (uint64_t)t[j] + c;
            t[j] = (uint32_t)s;
            c = s >> 32;
        }
        uint64_t s = (uint64_t)t[ZG_NW] + c;
        t[ZG_NW] = (uint32_t)s;
        t[ZG_NW + 1] = (uint32_t)(s >> 32);

        uint32_t m = t[0] * zg_n0<F>();
        s = (uint64_t)m * (uint64_t)zg_p<F>(0) + (uint64_t)t[0];
        c = s >> 32;
#pragma unroll
        for (int j = 1; j < ZG_NW; j++) {
            s = (uint64_t)m * (uint64_t)zg_p<F>(j) + (uint64_t)t[j] + c;
            t[j - 1] = (uint32_t)s;
            c = s >> 32;
        }
        s = (uint64_t)t[ZG_NW] + c;
        t[ZG_NW - 1] = (uint32_t)s;
        t[ZG_NW] = t[ZG_NW + 1] + (uint32_t)(s >> 32);
    }
    // t < 2p < 2^255: the ninth word is 0
    Fe r;
#pragma unroll
    for (int i = 0; i < ZG_NW; i++) r.w[i] = t[i];
    return fe_cond_sub_p<F>(r);
#endif
}

// Montgomery reduction of a 9-word value: v[0..7] the low 256 bits, v[8] the
// high word, v[8] < 2^31. Returns v * 2^-256 mod p, canonical ((v + M p) /
// 2^256 < 2^31 + p < 2p before the one conditional subtract).
// Word-serial: each step adds m p with m = t[0] * (-p^-1) mod 2^32, which
// clears the low word, and shifts down by one word. t + m p stays under
// 2^287 + 2^286 < 2^288 (v[8] < 2^31), so nine words hold every intermediate. On the card a step is two PTX carry
// chains, the low halves of m p and then the high halves; the shift is a
// renaming of registers.
template <int F>
ZG_HD Fe fe_redc9(const uint32_t v[ZG_NW + 1]) {
    uint32_t t[ZG_NW + 1];
#pragma unroll
    for (int i = 0; i <= ZG_NW; i++) t[i] = v[i];
#ifdef __CUDA_ARCH__
    uint32_t p[ZG_NW];
#pragma unroll
    for (int i = 0; i < ZG_NW; i++) p[i] = zg_p<F>(i);
#pragma unroll
    for (int i = 0; i < ZG_NW; i++) {
        const uint32_t m = t[0] * zg_n0<F>();
        zg_mad8_lo(t, m, p);
        zg_mad8_hi(t, m, p);
#pragma unroll
        for (int j = 0; j < ZG_NW; j++) t[j] = t[j + 1];
        t[ZG_NW] = 0u;
    }
#else
#pragma unroll
    for (int i = 0; i < ZG_NW; i++) {
        uint32_t m = t[0] * zg_n0<F>();
        uint64_t s = (uint64_t)m * (uint64_t)zg_p<F>(0) + (uint64_t)t[0];
        uint64_t c = s >> 32;
#pragma unroll
        for (int j = 1; j < ZG_NW; j++) {
            s = (uint64_t)m * (uint64_t)zg_p<F>(j) + (uint64_t)t[j] + c;
            t[j - 1] = (uint32_t)s;
            c = s >> 32;
        }
        s = (uint64_t)t[ZG_NW] + c;
        t[ZG_NW - 1] = (uint32_t)s;
        t[ZG_NW] = (uint32_t)(s >> 32);
    }
#endif
    // t < 2p < 2^255: the ninth word is 0
    Fe r;
#pragma unroll
    for (int i = 0; i < ZG_NW; i++) r.w[i] = t[i];
    return fe_cond_sub_p<F>(r);
}

// ---- strided load/store -------------------------------------------------------
// Word planes: element `col` of a row has word k at base[k * stride + col], so
// a warp's 32 columns read 32 neighbouring words for each k.

ZG_HD Fe fe_load(const uint32_t* base, long stride, long col) {
    Fe r;
#pragma unroll
    for (int k = 0; k < ZG_NW; k++) r.w[k] = base[(long)k * stride + col];
    return r;
}

ZG_HD void fe_store(uint32_t* base, long stride, long col, const Fe& a) {
#pragma unroll
    for (int k = 0; k < ZG_NW; k++) base[(long)k * stride + col] = a.w[k];
}

// ---- Jacobian points over Fq ----------------------------------------------------

struct Jac {
    Fe x, y, z;
};

// The identity as the tensor code writes it: (1, 1, 0) in Montgomery form
// (pieces are compared bytewise with the plain version).
ZG_HD Jac jac_infinity() {
    Jac r;
    r.x = fe_one<0>();
    r.y = fe_one<0>();
    r.z = fe_zero();
    return r;
}

ZG_HD Jac jac_select(bool c, const Jac& a, const Jac& b) {
    Jac r;
    r.x = fe_select(c, a.x, b.x);
    r.y = fe_select(c, a.y, b.y);
    r.z = fe_select(c, a.z, b.z);
    return r;
}

// The affine point (qx, qy) as a Jacobian carry: z = 1 if valid, else 0.
ZG_HD Jac jac_from_affine(const Fe& qx, const Fe& qy, bool qvalid) {
    Jac q;
    q.x = qx;
    q.y = qy;
    q.z = qvalid ? fe_one<0>() : fe_zero();
    return q;
}

// Mixed Jacobian + affine incomplete add (8M + 3S); mirrors
// jpoints.jac_madd_incomplete, select order included.
ZG_HD Jac jac_madd_incomplete(const Jac& p, const Fe& qx, const Fe& qy, bool qvalid) {
    Fe z1z1 = fe_mul<0>(p.z, p.z);
    Fe u2 = fe_mul<0>(qx, z1z1);
    Fe s2 = fe_mul<0>(qy, fe_mul<0>(p.z, z1z1));
    Fe h = fe_sub<0>(u2, p.x);
    Fe r = fe_sub<0>(s2, p.y);
    Fe hh = fe_mul<0>(h, h);
    Fe hhh = fe_mul<0>(h, hh);
    Fe v = fe_mul<0>(p.x, hh);
    Fe rr = fe_mul<0>(r, r);
    Jac res;
    res.x = fe_sub<0>(fe_sub<0>(rr, hhh), fe_add<0>(v, v));
    res.y = fe_sub<0>(fe_mul<0>(r, fe_sub<0>(v, res.x)), fe_mul<0>(p.y, hhh));
    res.z = fe_mul<0>(p.z, h);
    res = jac_select(fe_is_zero(p.z), jac_from_affine(qx, qy, qvalid), res);
    return jac_select(qvalid, res, p);
}


// ---- the general incomplete add, its products split over G threads ----------------
// The 16 products of the general Jacobian incomplete add (12M + 4S), in five
// levels; the products of one level do not depend on each other:
//   1: Z1Z1, Z2Z2, Z1 Z2          2: U1, U2, Z2 Z2Z2, Z1 Z1Z1
//   3: S1, S2, HH                 4: HHH, V, RR, Z3
//   5: R (V - X3), S1 HHH
// On the card a group of G neighbouring threads of a warp works on one add:
// in each round of a level, thread j of the group computes the level's next
// product j and the group exchanges them by shuffles; the adds and
// subtracts run in every thread of the group. Every product has the
// operands of jpoints.jac_add_incomplete's and ends canonical, so the limbs
// do not depend on G. G = 1 is the one-thread add; a host compiler always
// computes every product in one thread.
template <int N, int G>
ZG_HD void add_level(int j, const Fe (&a)[N], const Fe (&b)[N], Fe (&r)[N]) {
#ifdef __CUDA_ARCH__
    if (G > 1) {
        const unsigned base = (threadIdx.x & 31u) & ~(unsigned)(G - 1);
        const unsigned mask = ((1u << G) - 1u) << base;
#pragma unroll
        for (int k0 = 0; k0 < N; k0 += G) {
            Fe x = a[k0], y = b[k0];
#pragma unroll
            for (int i = 1; i < G && k0 + i < N; i++) {
                x = fe_select(j == i, a[k0 + i], x);
                y = fe_select(j == i, b[k0 + i], y);
            }
            // threads past the level's last product repeat one nobody reads
            const Fe m = fe_mul<0>(x, y);
#pragma unroll
            for (int i = 0; i < G && k0 + i < N; i++)
#pragma unroll
                for (int w = 0; w < ZG_NW; w++)
                    r[k0 + i].w[w] = __shfl_sync(mask, m.w[w], base + i);
        }
        return;
    }
#endif
    (void)j;
#pragma unroll
    for (int k = 0; k < N; k++) r[k] = fe_mul<0>(a[k], b[k]);
}

// The formulas of the general incomplete add, without its identity selects;
// j is the thread's index in its group of G (0 on a host).
template <int G>
ZG_HD Jac jac_add_formulas(const Jac& p, const Jac& q, int j) {
    Fe l1[3];
    {
        const Fe a[3] = {p.z, q.z, p.z}, b[3] = {p.z, q.z, q.z};
        add_level<3, G>(j, a, b, l1);
    }
    const Fe z1z1 = l1[0], z2z2 = l1[1], z1z2 = l1[2];
    Fe l2[4];
    {
        const Fe a[4] = {p.x, q.x, q.z, p.z}, b[4] = {z2z2, z1z1, z2z2, z1z1};
        add_level<4, G>(j, a, b, l2);
    }
    const Fe u1 = l2[0], u2 = l2[1];
    const Fe h = fe_sub<0>(u2, u1);
    Fe l3[3];
    {
        const Fe a[3] = {p.y, q.y, h}, b[3] = {l2[2], l2[3], h};
        add_level<3, G>(j, a, b, l3);
    }
    const Fe s1 = l3[0], hh = l3[2];
    const Fe r = fe_sub<0>(l3[1], s1);
    Fe l4[4];
    {
        const Fe a[4] = {h, u1, r, z1z2}, b[4] = {hh, hh, r, h};
        add_level<4, G>(j, a, b, l4);
    }
    const Fe hhh = l4[0], v = l4[1];
    Jac res;
    res.x = fe_sub<0>(fe_sub<0>(l4[2], hhh), fe_add<0>(v, v));
    res.z = l4[3];
    Fe l5[2];
    {
        const Fe a[2] = {r, s1}, b[2] = {fe_sub<0>(v, res.x), hhh};
        add_level<2, G>(j, a, b, l5);
    }
    res.y = fe_sub<0>(l5[0], l5[1]);
    return res;
}

// General Jacobian incomplete add; mirrors jpoints.jac_add_incomplete,
// select order included.
ZG_HD Jac jac_add_incomplete(const Jac& p, const Jac& q) {
    Jac res = jac_select(fe_is_zero(p.z), q, jac_add_formulas<1>(p, q, 0));
    return jac_select(fe_is_zero(q.z), p, res);
}

// The same result as jac_add_incomplete, bit for bit, with the identity
// cases taken before any product is computed: its last select returns p
// when q.z = 0, the one before it q when p.z = 0. The threads of a group
// take the same branch.
template <int G>
ZG_HD Jac jac_add_skip(const Jac& p, const Jac& q, int j) {
    if (fe_is_zero(q.z)) return p;
    if (fe_is_zero(p.z)) return q;
    return jac_add_formulas<G>(p, q, j);
}

// The 11 products of the mixed add, in five levels whose products do not
// depend on each other:
//   1: Z1Z1                       2: U2 = qx Z1Z1, Z1 Z1Z1
//   3: S2 = qy (Z1 Z1Z1), HH, Z3  4: HHH, V = X1 HH, RR
//   5: R (V - X3), Y1 HHH
// each with the operands of jac_madd_incomplete's, so every limb equals
// its. Levels 4-5 of the add in flight (h, hh, s2 and z3 = Z1 H from its
// levels 1-3, X1 and Y1 the settled carry's) run beside levels 1-2 of the
// next row's add, whose Z1 is z3: two rounds of four products. Returns the
// finished add's (X3, Y3, z3); u2 = qx Z1Z1 and zz = Z1 Z1Z1 of the next.
// The walks of flush_scan_affine and scan_bisect_madd are built on it.
template <int G>
ZG_HD Jac madd_finish_start(const Jac& carry, const Fe (&half)[4], const Fe& qx, Fe& u2,
                            Fe& zz, int j) {
    const Fe& h = half[0];
    const Fe& hh = half[1];
    const Fe& z3 = half[3];
    const Fe r = fe_sub<0>(half[2], carry.y);
    Fe la[4];
    {
        const Fe a[4] = {h, carry.x, r, z3}, b[4] = {hh, hh, r, z3};
        add_level<4, G>(j, a, b, la);
    }
    const Fe hhh = la[0], v = la[1];
    Jac res;
    res.x = fe_sub<0>(fe_sub<0>(la[2], hhh), fe_add<0>(v, v));
    res.z = z3;
    Fe lb[4];
    {
        const Fe a[4] = {r, carry.y, qx, z3}, b[4] = {fe_sub<0>(v, res.x), hhh, la[3], la[3]};
        add_level<4, G>(j, a, b, lb);
    }
    res.y = fe_sub<0>(lb[0], lb[1]);
    u2 = lb[2];
    zz = lb[3];
    return res;
}

ZG_HD Jac jac_load(const uint32_t* x, const uint32_t* y, const uint32_t* z,
                   long stride, long col) {
    Jac r;
    r.x = fe_load(x, stride, col);
    r.y = fe_load(y, stride, col);
    r.z = fe_load(z, stride, col);
    return r;
}

ZG_HD void jac_store(uint32_t* x, uint32_t* y, uint32_t* z, long stride, long col,
                     const Jac& p) {
    fe_store(x, stride, col, p.x);
    fe_store(y, stride, col, p.y);
    fe_store(z, stride, col, p.z);
}

// ---- launch plumbing shared by the sources ----------------------------------------
// Every exported C function returns cudaGetLastError() after its launch (0 on
// success). In a host build the same name runs the per-column function over
// all columns and returns 0.
#ifdef __CUDACC__
#include <cuda_runtime.h>
#define ZG_COL_INDEX ((long)blockIdx.x * blockDim.x + threadIdx.x)
#define ZG_BLOCKS(n, threads) ((unsigned)(((n) + (threads) - 1) / (threads)))
#endif
