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
// Everything here is plain C++ over uint32_t/uint64_t: the same header builds
// for the card (nvcc) and for a host compiler, which runs the same per-column
// functions in a loop.
#pragma once
#include <stdint.h>

#ifdef __CUDACC__
#define ZG_HD __host__ __device__ __forceinline__
#else
#define ZG_HD inline
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
    uint64_t borrow = 0;
#pragma unroll
    for (int i = 0; i < ZG_NW; i++) {
        uint64_t s = (uint64_t)r.w[i] - (uint64_t)zg_p<F>(i) - borrow;
        d.w[i] = (uint32_t)s;
        borrow = (s >> 32) & 1u;
    }
    return fe_select(borrow == 0, d, r);
}

template <int F>
ZG_HD Fe fe_add(const Fe& a, const Fe& b) {
    Fe s;
    uint64_t carry = 0;
#pragma unroll
    for (int i = 0; i < ZG_NW; i++) {
        uint64_t t = (uint64_t)a.w[i] + (uint64_t)b.w[i] + carry;
        s.w[i] = (uint32_t)t;
        carry = t >> 32;
    }
    // a + b < 2p < 2^255: no carry out of the top word
    return fe_cond_sub_p<F>(s);
}

template <int F>
ZG_HD Fe fe_sub(const Fe& a, const Fe& b) {
    Fe d;
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
}

// Montgomery product a * b * 2^-256 mod p, a and b in [0, p).
template <int F>
ZG_HD Fe fe_mul(const Fe& a, const Fe& b) {
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
}

// Montgomery reduction of a 9-word value: v[0..7] the low 256 bits, v[8] the
// high word. Returns v * 2^-256 mod p, canonical, for v < 2^256 * p (so that
// (v + m p) / 2^256 < 2p before the one conditional subtract).
// Word-serial: each step adds m p with m = t[0] * (-p^-1) mod 2^32, which
// clears the low word, and shifts down by one word. t + m p stays under 2^288,
// so nine words hold every intermediate.
template <int F>
ZG_HD Fe fe_redc9(const uint32_t v[ZG_NW + 1]) {
    uint32_t t[ZG_NW + 1];
#pragma unroll
    for (int i = 0; i <= ZG_NW; i++) t[i] = v[i];
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
    Jac q;
    q.x = qx;
    q.y = qy;
    q.z = qvalid ? fe_one<0>() : fe_zero();
    res = jac_select(fe_is_zero(p.z), q, res);
    return jac_select(qvalid, res, p);
}

// General Jacobian incomplete add (12M + 4S); mirrors
// jpoints.jac_add_incomplete.
ZG_HD Jac jac_add_incomplete(const Jac& p, const Jac& q) {
    Fe z1z1 = fe_mul<0>(p.z, p.z);
    Fe z2z2 = fe_mul<0>(q.z, q.z);
    Fe u1 = fe_mul<0>(p.x, z2z2);
    Fe u2 = fe_mul<0>(q.x, z1z1);
    Fe s1 = fe_mul<0>(p.y, fe_mul<0>(q.z, z2z2));
    Fe s2 = fe_mul<0>(q.y, fe_mul<0>(p.z, z1z1));
    Fe h = fe_sub<0>(u2, u1);
    Fe r = fe_sub<0>(s2, s1);
    Fe hh = fe_mul<0>(h, h);
    Fe hhh = fe_mul<0>(h, hh);
    Fe v = fe_mul<0>(u1, hh);
    Fe rr = fe_mul<0>(r, r);
    Jac res;
    res.x = fe_sub<0>(fe_sub<0>(rr, hhh), fe_add<0>(v, v));
    res.y = fe_sub<0>(fe_mul<0>(r, fe_sub<0>(v, res.x)), fe_mul<0>(s1, hhh));
    res.z = fe_mul<0>(fe_mul<0>(p.z, q.z), h);
    res = jac_select(fe_is_zero(p.z), q, res);
    return jac_select(fe_is_zero(q.z), p, res);
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
