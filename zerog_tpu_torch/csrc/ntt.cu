// Kernels 6 and 7: the two element passes of the int8-DFT NTT engine over Fr.
//
// ntt_epilogue replaces _epilogue_call / _epilogue_kernel_body / _redc_limbs
// of zerog_tpu/poly/pntt.py; ntt_twiddle replaces _twiddle_call of the same
// file. Between them each level runs one int8 product (torch._int_mm) whose
// int32 accumulator is [32 byte columns, t rows, L lanes], row-major.
//
// By the card's peaks both are bound by bytes: per element the epilogue reads
// 128 bytes of accumulator and writes 32 (int8 byte planes or int32 word
// planes) against 64 multiply-adds of one REDC (+128 with the twiddle); the
// twiddle pass moves 64 bytes against the 128 multiply-adds of one product.
// Each byte is read and written once. The -128 offset correction of the product (128
// colsum[lane] + rowc[row]) is added here, not in a separate pass over the
// accumulator.
//
// ntt_epilogue: one thread owns one element, the lane index the fastest
// across threads (each of the 32 plane loads of a warp is one coalesced
// line); the REDC is PTX carry chains. On this card it reaches ~70 % of its
// bytes bound at 2^17 and ~50 % at 2^14 (one partial wave): it also issues
// ~800 instructions an element (the REDC ~40 % of them, the byte carries
// and the addresses of 64 loads and 32 stores the rest). So an element's
// columns split over 4 or 8 threads (more loads in flight, but every thread
// of a group runs the whole REDC) or 2-4 elements a thread (8- or 16-byte
// loads, packed stores) were slower on the card (PERF.md).
// ntt_twiddle: one thread owns one element.
#include "field.cuh"

// Element idx = j * lanes + l of a [32, t, lanes] accumulator.
ZG_HD void ntt_epilogue_column(long idx, const int32_t* acc, const int32_t* colsum,
                               const int32_t* rowc, const uint32_t* tw, void* out,
                               long t, long lanes, int out_bytes) {
    const long plane = t * lanes;
    const long j = idx / lanes;
    const long l = idx - j * lanes;
    const uint32_t col = 128u * (uint32_t)colsum[l];
    // carry the 32 byte columns; the sums are exact in uint32 (the corrected
    // column is < 2^28) and the final carry is the high word (< 2^22)
    uint32_t v9[ZG_NW + 1];
#pragma unroll
    for (int k = 0; k <= ZG_NW; k++) v9[k] = 0u;
    uint32_t carry = 0u;
#pragma unroll
    for (int b = 0; b < 32; b++) {
        uint32_t v = (uint32_t)acc[b * plane + idx] + col
                     + (uint32_t)rowc[b * t + j] + carry;
        v9[b >> 2] |= (v & 0xFFu) << (8 * (b & 3));
        carry = v >> 8;
    }
    v9[ZG_NW] = carry;
    Fe r = fe_redc9<1>(v9);
    if (tw != nullptr) r = fe_mul<1>(r, fe_load(tw, plane, idx));
    if (out_bytes) {
        int8_t* o = (int8_t*)out;
#pragma unroll
        for (int b = 0; b < 32; b++)
            o[b * plane + idx] = (int8_t)(uint8_t)(((r.w[b >> 2] >> (8 * (b & 3))) & 0xFFu) ^ 0x80u);
    } else {
        fe_store((uint32_t*)out, plane, idx, r);
    }
}

// Element idx = j2 * (r * g) + l of [32, s, r * g] byte planes; its twiddle is
// column l / g of row j2 in the compact [8, s, r] word table.
ZG_HD void ntt_twiddle_column(long idx, const int8_t* x, const uint32_t* tw,
                              int8_t* out, long s, long r, long g) {
    const long lanes = r * g;
    const long plane = s * lanes;
    const long j2 = idx / lanes;
    const long i1 = (idx - j2 * lanes) / g;
    Fe a;
#pragma unroll
    for (int k = 0; k < ZG_NW; k++) a.w[k] = 0u;
#pragma unroll
    for (int b = 0; b < 32; b++)
        a.w[b >> 2] |= ((uint32_t)(uint8_t)x[b * plane + idx] ^ 0x80u) << (8 * (b & 3));
    Fe w = fe_load(tw, s * r, j2 * r + i1);
    Fe res = fe_mul<1>(a, w);
#pragma unroll
    for (int b = 0; b < 32; b++)
        out[b * plane + idx] = (int8_t)(uint8_t)(((res.w[b >> 2] >> (8 * (b & 3))) & 0xFFu) ^ 0x80u);
}

#ifdef __CUDACC__
__global__ void ntt_epilogue_kernel(const int32_t* acc, const int32_t* colsum,
                                    const int32_t* rowc, const uint32_t* tw,
                                    void* out, long t, long lanes, int out_bytes) {
    long idx = ZG_COL_INDEX;
    if (idx < t * lanes)
        ntt_epilogue_column(idx, acc, colsum, rowc, tw, out, t, lanes, out_bytes);
}

__global__ void ntt_twiddle_kernel(const int8_t* x, const uint32_t* tw, int8_t* out,
                                   long s, long r, long g) {
    long idx = ZG_COL_INDEX;
    if (idx < s * r * g) ntt_twiddle_column(idx, x, tw, out, s, r, g);
}
#endif

// acc int32[32, t, lanes], colsum int32[lanes], rowc int32[32 t], tw NULL or
// uint32 word planes [8, t, lanes]; out int8[32, t, lanes] (out_bytes) or
// uint32 word planes [8, t, lanes].
extern "C" int zg_ntt_epilogue(const void* acc, const void* colsum, const void* rowc,
                               const void* tw, void* out, long t, long lanes,
                               int out_bytes, void* stream) {
    const int32_t* pa = (const int32_t*)acc;
    const int32_t* pc = (const int32_t*)colsum;
    const int32_t* pr = (const int32_t*)rowc;
    const uint32_t* pt = (const uint32_t*)tw;
    const long n = t * lanes;
#ifdef __CUDACC__
    if (n > 0) {
        const int threads = 128;
        ntt_epilogue_kernel<<<ZG_BLOCKS(n, threads), threads, 0, (cudaStream_t)stream>>>(
            pa, pc, pr, pt, out, t, lanes, out_bytes);
    }
    return (int)cudaGetLastError();
#else
    (void)stream;
    for (long idx = 0; idx < n; idx++)
        ntt_epilogue_column(idx, pa, pc, pr, pt, out, t, lanes, out_bytes);
    return 0;
#endif
}

// x int8[32, s, r g] (byte - 128), tw uint32 word planes [8, s, r] ->
// out int8[32, s, r g].
extern "C" int zg_ntt_twiddle(const void* x, const void* tw, void* out, long s, long r,
                              long g, void* stream) {
    const int8_t* px = (const int8_t*)x;
    const uint32_t* pt = (const uint32_t*)tw;
    int8_t* po = (int8_t*)out;
    const long n = s * r * g;
#ifdef __CUDACC__
    if (n > 0) {
        const int threads = 128;
        ntt_twiddle_kernel<<<ZG_BLOCKS(n, threads), threads, 0, (cudaStream_t)stream>>>(
            px, pt, po, s, r, g);
    }
    return (int)cudaGetLastError();
#else
    (void)stream;
    for (long idx = 0; idx < n; idx++) ntt_twiddle_column(idx, px, pt, po, s, r, g);
    return 0;
#endif
}
