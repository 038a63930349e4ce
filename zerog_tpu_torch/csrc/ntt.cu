// Kernels 6 and 7: the two element passes of the int8-DFT NTT engine over Fr.
//
// ntt_epilogue replaces _epilogue_call / _epilogue_kernel_body / _redc_limbs
// of zerog_tpu/poly/pntt.py; ntt_twiddle replaces _twiddle_call of the same
// file and the regroup (transpose) that follows it in its _run_device. Between
// them each level runs one int8 product (torch._int_mm) whose int32
// accumulator is [32 byte columns, t rows, L lanes], row-major.
//
// By the card's peaks both are bound by bytes: per element the epilogue reads
// 128 bytes of accumulator and writes 32 (int8 byte planes or int32 word
// planes) against 64 multiply-adds of one REDC (+128 with the twiddle); the
// twiddle pass moves 64 bytes against the 128 multiply-adds of one product,
// whose issued instructions (~300 IMAD an element, at half rate) take about
// as long as the bytes at 2^17. Each byte is read and written once. The -128
// offset correction of the product (128 colsum[lane] + rowc[row]) is added in
// the epilogue, not in a separate pass over the accumulator; the column sums
// of an outer level's input come from the twiddle pass that writes it.
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
// ntt_twiddle: tiles staged in shared memory (below).
#include <stdlib.h>
#include <string.h>

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

#ifdef __CUDACC__
__global__ void ntt_epilogue_kernel(const int32_t* acc, const int32_t* colsum,
                                    const int32_t* rowc, const uint32_t* tw,
                                    void* out, long t, long lanes, int out_bytes) {
    long idx = ZG_COL_INDEX;
    if (idx < t * lanes)
        ntt_epilogue_column(idx, acc, colsum, rowc, tw, out, t, lanes, out_bytes);
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


// ---- ntt_twiddle: twiddle, regroup and column sums in one pass ------------------------
// Input x, int8 [32, s, r g]: byte b of element (j2, i1, l) at b P + j2 r g + i1 g + l
// (P = s r g). Output out, int8 [32, r, s g], the outer level's input: the same element
// times omega^(i1 j2) at b P + i1 s g + j2 g + l. colsum[j2 g + l] is the sum of its
// output bytes over i1 and b (the -128 offset correction of the outer product).
//
// A tile holds tj2 x ti1 pairs (j2, i1) with tg lanes l of each pair: all g of them
// (tg = g), or, where g is longer than a tile, a run of tg dividing g (tj2 = 1). In
// plane b its input is tj2 runs of ti1 g bytes (or ti1 runs of tg) and its output ti1
// runs of tj2 tg bytes, so both sides move whole runs at g = 6 (48 and 96 bytes at the
// WNN proof's outer 2^17 level, 16 x 8 pairs). A block stages the tile's 32 planes and
// its twiddle words in shared memory (cp.async, 16 bytes a copy where the shape allows
// it, else 4 or 1), multiplies each element from registers, writes its bytes into
// shared memory in output order, adds each lane's byte sums there, and stores the
// tile's runs and one atomicAdd a lane into the sums, which a memset zeroes first.
//
// On the card (PERF.md) a 2^17 level takes ~2.9x its bytes bound, ~4.3x less than
// the old twiddle kernel followed by the torch regroup copy and sum. Without its
// products the same kernel takes ~70 % of that time (the staged copies, in runs of
// 48-96 bytes), and the products (~13 us a level) do not overlap the copies: a wave of
// blocks loads, multiplies and stores in step. A ring of chunks a block (cp.async two
// or three chunks ahead, lane sums kept over all of r, no memset), more or fewer warps
// an SM, and 96- or 192-byte runs were no faster.
#define ZG_TW_THREADS 256
#define ZG_TW_ELEMS 768       // elements a tile aims at: 3 a thread
#define ZG_TW_MIN_TILES 264   // tiles below which a tile is halved: 2 an SM of an H100
#define ZG_MAX_DEVICES 64     // devices whose shared-memory attribute is tracked

struct TwPlan {
    long s, r, g;
    long tj2, ti1, tg;        // tile
    long nj2, ni1, ng;        // tiles along j2, i1 and l
    int v;                    // bytes a copy: 16, 4 or 1
    int pin, pout;            // bytes a staged input / output run (padded to v)
    int plane_in, plane_out;  // bytes a staged plane
    int rj, ri;               // staged input offset of (j2, i1) steps
    int tw_off, cs_off, smem; // byte offsets of the twiddles, the lane sums; total
};

static long zg_round_up(long x, long m) { return (x + m - 1) / m * m; }

static TwPlan tw_plan(long s, long r, long g, const void* x, const void* out) {
    TwPlan p;
    p.s = s;
    p.r = r;
    p.g = g;
    if (g <= ZG_TW_ELEMS) {
        p.tg = g;
        const long pairs = ZG_TW_ELEMS / g;
        long tj2 = 1;
        while (tj2 * tj2 < pairs) tj2 *= 2;
        if (tj2 > s) tj2 = s;
        long ti1 = pairs / tj2 < 1 ? 1 : pairs / tj2;
        if (ti1 > r) ti1 = r;
        if (tj2 * ti1 < pairs && tj2 < s) tj2 = pairs / ti1 < s ? pairs / ti1 : s;
        while (((s + tj2 - 1) / tj2) * ((r + ti1 - 1) / ti1) < ZG_TW_MIN_TILES &&
               tj2 * ti1 > 1 && tj2 * ti1 * g / 2 >= ZG_TW_THREADS) {
            if (tj2 >= ti1) tj2 = (tj2 + 1) / 2;
            else ti1 = (ti1 + 1) / 2;
        }
        p.tj2 = tj2;
        p.ti1 = ti1;
    } else {
        long d = ZG_TW_ELEMS;
        while (g % d) d--;
        p.tg = d;
        p.tj2 = 1;
        p.ti1 = ZG_TW_ELEMS / d < r ? ZG_TW_ELEMS / d : r;
    }
    p.nj2 = (s + p.tj2 - 1) / p.tj2;
    p.ni1 = (r + p.ti1 - 1) / p.ti1;
    p.ng = g / p.tg;
    // every run start and length a multiple of v: in, rows of r g (or g) bytes from
    // tile offsets of ti1 g (or tg); out, rows of s g bytes from offsets of tj2 g (or tg)
    const bool whole = p.tg == g;
    const long mult[4] = {whole ? r * g : g, s * g, whole ? p.ti1 * g : p.tg,
                          whole ? p.tj2 * g : p.tg};
    p.v = 1;
    for (int v = 16; v > 1; v /= 4) {
        bool ok = (uintptr_t)x % v == 0 && (uintptr_t)out % v == 0;
        for (int k = 0; k < 4; k++) ok = ok && mult[k] % v == 0;
        if (ok) {
            p.v = v;
            break;
        }
    }
    p.pin = (int)zg_round_up(whole ? p.ti1 * g : p.tg, p.v);
    p.plane_in = (int)(whole ? p.tj2 : p.ti1) * p.pin;
    p.rj = whole ? p.pin : 0;
    p.ri = whole ? (int)g : p.pin;
    p.pout = (int)zg_round_up(p.tj2 * p.tg, p.v);
    p.plane_out = (int)p.ti1 * p.pout;
    p.tw_off = (int)zg_round_up(32L * (p.plane_in + p.plane_out), 16);
    p.cs_off = p.tw_off + (int)(4 * 8 * p.tj2 * p.ti1);
    p.smem = p.cs_off + (int)(4 * p.tj2 * p.tg);
    return p;
}

// One tile's place: its first j2, i1, l and its pairs (fewer at the edges).
struct TwTile {
    long j20, i10, l0;
    int tj2, ti1;
};

ZG_HD TwTile tw_tile(const TwPlan& p, long t) {
    TwTile k;
    const long i1t = t % p.ni1;
    const long rest = t / p.ni1;
    k.l0 = (rest % p.ng) * p.tg;
    k.j20 = (rest / p.ng) * p.tj2;
    k.i10 = i1t * p.ti1;
    k.tj2 = (int)(p.s - k.j20 < p.tj2 ? p.s - k.j20 : p.tj2);
    k.ti1 = (int)(p.r - k.i10 < p.ti1 ? p.r - k.i10 : p.ti1);
    return k;
}

// Copy V bytes (V | 16) from src to dst, global to shared (IN) or shared to global.
template <int V, bool IN>
ZG_HD void tw_copy(uint8_t* dst, const uint8_t* src) {
#ifdef __CUDA_ARCH__
    if (IN && V == 16) {
        asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(
                         (uint32_t)__cvta_generic_to_shared(dst)),
                     "l"(src));
    } else if (IN && V == 4) {
        asm volatile("cp.async.ca.shared.global [%0], [%1], 4;" ::"r"(
                         (uint32_t)__cvta_generic_to_shared(dst)),
                     "l"(src));
    } else if (V == 16) {
        *(uint4*)dst = *(const uint4*)src;
    } else if (V == 4) {
        *(uint32_t*)dst = *(const uint32_t*)src;
    } else {
        *dst = *src;
    }
#else
    for (int i = 0; i < V; i++) dst[i] = src[i];
#endif
}

// Rows q * 32 + b (q < nq) of `len` bytes: global at gbase + b P + q gstride, shared at
// sbase + b splane + q spitch. A row's chunks of V bytes go to neighbouring threads, a
// power of two of them a row, so that the indices are shifts and masks.
template <int V, bool IN>
ZG_HD void tw_copy_rows(int tid, int nq, int len, uint8_t* sbase, int splane, int spitch,
                        uint8_t* gbase, long plane, long gstride) {
    const int chunks = len / V;
    int lpr = 1, sh = 0;
    while (lpr < chunks && lpr < ZG_TW_THREADS) {
        lpr *= 2;
        sh++;
    }
    for (int row = tid >> sh; row < nq * 32; row += ZG_TW_THREADS >> sh) {
        const int b = row & 31, q = row >> 5;
        uint8_t* g = gbase + b * plane + q * gstride;
        uint8_t* sm = sbase + b * splane + q * spitch;
        for (int c = tid & (lpr - 1); c < chunks; c += lpr) {
            if (IN) tw_copy<V, true>(sm + c * V, g + c * V);
            else tw_copy<V, false>(g + c * V, sm + c * V);
        }
    }
}

// Stage one tile: its input runs, its twiddle words [8][tj2][ti1], lane sums zeroed.
template <int V>
ZG_HD void tw_stage(int tid, const TwPlan& p, const TwTile& k, const int8_t* x,
                    const uint32_t* tw, uint8_t* sm) {
    const bool whole = p.tg == p.g;
    const long base = k.j20 * p.r * p.g + k.i10 * p.g + k.l0;
    tw_copy_rows<V, true>(tid, whole ? k.tj2 : k.ti1, whole ? (int)(k.ti1 * p.g) : (int)p.tg,
                          sm, p.plane_in, p.pin, (uint8_t*)x + base, p.s * p.r * p.g,
                          whole ? p.r * p.g : p.g);
    uint32_t* stw = (uint32_t*)(sm + p.tw_off);
    const int words = 8 * k.tj2 * k.ti1;
    for (int i = tid; i < words; i += ZG_TW_THREADS) {
        const int row = i / k.ti1, i1 = i - row * k.ti1;
        const int w = row / k.tj2, j2 = row - w * k.tj2;
        tw_copy<4, true>((uint8_t*)(stw + (w * p.tj2 + j2) * p.ti1 + i1),
                         (const uint8_t*)(tw + (w * p.s + k.j20 + j2) * p.r + k.i10 + i1));
    }
    int32_t* cs = (int32_t*)(sm + p.cs_off);
    for (int i = tid; i < k.tj2 * p.tg; i += ZG_TW_THREADS) cs[i] = 0;
}

// The tile's elements, in output order (i1, j2, l), ZG_TW_THREADS apart: bytes to
// words, the product, bytes back into shared memory in output order, byte sums.
ZG_HD void tw_compute(int tid, const TwPlan& p, const TwTile& k, uint8_t* sm) {
    const uint8_t* sin = sm;
    uint8_t* sout = sm + 32 * p.plane_in;
    const uint32_t* stw = (const uint32_t*)(sm + p.tw_off);
    int32_t* cs = (int32_t*)(sm + p.cs_off);
    const int tg = (int)p.tg, tp = (int)(p.tj2 * p.ti1);
    const int wa = k.tj2 * tg;
    // (i1, j2, l) of element tid, and the steps of ZG_TW_THREADS elements
    int i1 = tid / wa, j2 = (tid - i1 * wa) / tg, l = tid - i1 * wa - j2 * tg;
    const int dq = ZG_TW_THREADS / wa, dr = ZG_TW_THREADS - dq * wa;
    const int dj = dr / tg, dl = dr - dj * tg;
    while (i1 < k.ti1) {
        const int in = j2 * p.rj + i1 * p.ri + l;
        Fe a, w;
#pragma unroll
        for (int q = 0; q < ZG_NW; q++) {
            const uint8_t* c = sin + 4 * q * p.plane_in + in;
            a.w[q] = ((uint32_t)c[0] | (uint32_t)c[p.plane_in] << 8 |
                      (uint32_t)c[2 * p.plane_in] << 16 | (uint32_t)c[3 * p.plane_in] << 24) ^
                     0x80808080u;
            w.w[q] = stw[q * tp + j2 * (int)p.ti1 + i1];
        }
        const Fe res = fe_mul<1>(a, w);
        const int o = i1 * p.pout + j2 * tg + l;
        int32_t sum = 0;
#pragma unroll
        for (int q = 0; q < ZG_NW; q++) {
            const uint32_t v = res.w[q] ^ 0x80808080u;
            uint8_t* c = sout + 4 * q * p.plane_out + o;
            c[0] = (uint8_t)v;
            c[p.plane_out] = (uint8_t)(v >> 8);
            c[2 * p.plane_out] = (uint8_t)(v >> 16);
            c[3 * p.plane_out] = (uint8_t)(v >> 24);
#ifdef __CUDA_ARCH__
            sum = __dp4a((int)v, 0x01010101, sum);
#else
            for (int by = 0; by < 4; by++) sum += (int8_t)(uint8_t)(v >> (8 * by));
#endif
        }
#ifdef __CUDA_ARCH__
        atomicAdd(&cs[j2 * tg + l], sum);
#else
        cs[j2 * tg + l] += sum;
#endif
        l += dl;
        j2 += dj;
        if (l >= tg) {
            l -= tg;
            j2++;
        }
        i1 += dq;
        if (j2 >= k.tj2) {
            j2 -= k.tj2;
            i1++;
        }
    }
}

// Store one tile: its output runs and its lanes' sums.
template <int V>
ZG_HD void tw_store(int tid, const TwPlan& p, const TwTile& k, uint8_t* sm, int8_t* out,
                    int32_t* colsum) {
    const long lane0 = k.j20 * p.g + k.l0;
    tw_copy_rows<V, false>(tid, k.ti1, k.tj2 * (int)p.tg, sm + 32 * p.plane_in, p.plane_out,
                           p.pout, (uint8_t*)out + k.i10 * p.s * p.g + lane0,
                           p.s * p.r * p.g, p.s * p.g);
    const int32_t* cs = (const int32_t*)(sm + p.cs_off);
    for (int i = tid; i < k.tj2 * (int)p.tg; i += ZG_TW_THREADS) {
#ifdef __CUDA_ARCH__
        atomicAdd(&colsum[lane0 + i], cs[i]);
#else
        colsum[lane0 + i] += cs[i];
#endif
    }
}

#ifdef __CUDACC__
template <int V>
__global__ void __launch_bounds__(ZG_TW_THREADS, 4)
    ntt_twiddle_kernel(const int8_t* x, const uint32_t* tw, int8_t* out, int32_t* colsum,
                       TwPlan p) {
    extern __shared__ __align__(16) uint8_t tw_smem[];
    const TwTile k = tw_tile(p, blockIdx.x);
    tw_stage<V>(threadIdx.x, p, k, x, tw, tw_smem);
    asm volatile("cp.async.wait_all;" ::: "memory");
    __syncthreads();
    tw_compute(threadIdx.x, p, k, tw_smem);
    __syncthreads();
    tw_store<V>(threadIdx.x, p, k, tw_smem, out, colsum);
}

template <int V>
static int tw_launch(const int8_t* x, const uint32_t* tw, int8_t* out, int32_t* colsum,
                     const TwPlan& p, cudaStream_t stream) {
    // the attribute belongs to the current device's context: set it once on
    // each device that launches
    static bool attr[ZG_MAX_DEVICES] = {};
    int dev = 0;
    cudaError_t e = cudaGetDevice(&dev);
    if (e != cudaSuccess) return (int)e;
    if (dev < 0 || dev >= ZG_MAX_DEVICES) return (int)cudaErrorInvalidDevice;
    if (!attr[dev]) {
        e = cudaFuncSetAttribute(ntt_twiddle_kernel<V>,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 227 * 1024);
        if (e != cudaSuccess) return (int)e;
        attr[dev] = true;
    }
    ntt_twiddle_kernel<V><<<(unsigned)(p.nj2 * p.ni1 * p.ng), ZG_TW_THREADS, p.smem,
                            stream>>>(x, tw, out, colsum, p);
    return (int)cudaGetLastError();
}
#else
template <int V>
static void tw_host(const int8_t* x, const uint32_t* tw, int8_t* out, int32_t* colsum,
                    const TwPlan& p) {
    uint8_t* sm = (uint8_t*)malloc((size_t)p.smem);
    for (long t = 0; t < p.nj2 * p.ni1 * p.ng; t++) {
        const TwTile k = tw_tile(p, t);
        for (int tid = 0; tid < ZG_TW_THREADS; tid++) tw_stage<V>(tid, p, k, x, tw, sm);
        for (int tid = 0; tid < ZG_TW_THREADS; tid++) tw_compute(tid, p, k, sm);
        for (int tid = 0; tid < ZG_TW_THREADS; tid++) tw_store<V>(tid, p, k, sm, out, colsum);
    }
    free(sm);
}
#endif

// x int8[32, s, r g] (byte - 128), tw uint32 word planes [8, s, r] -> out int8
// [32, r, s g] (byte - 128), colsum int32[s g].
extern "C" int zg_ntt_twiddle(const void* x, const void* tw, void* out, void* colsum,
                              long s, long r, long g, void* stream) {
    const int8_t* px = (const int8_t*)x;
    const uint32_t* pt = (const uint32_t*)tw;
    int8_t* po = (int8_t*)out;
    int32_t* pc = (int32_t*)colsum;
    if (s <= 0 || r <= 0 || g <= 0) return 0;
    const TwPlan p = tw_plan(s, r, g, x, out);
#ifdef __CUDACC__
    cudaStream_t st = (cudaStream_t)stream;
    cudaError_t e = cudaMemsetAsync(pc, 0, 4 * (size_t)(s * g), st);
    if (e != cudaSuccess) return (int)e;
    if (p.v == 16) return tw_launch<16>(px, pt, po, pc, p, st);
    if (p.v == 4) return tw_launch<4>(px, pt, po, pc, p, st);
    return tw_launch<1>(px, pt, po, pc, p, st);
#else
    (void)stream;
    memset(pc, 0, 4 * (size_t)(s * g));
    if (p.v == 16) tw_host<16>(px, pt, po, pc, p);
    else if (p.v == 4) tw_host<4>(px, pt, po, pc, p);
    else tw_host<1>(px, pt, po, pc, p);
    return 0;
#endif
}
