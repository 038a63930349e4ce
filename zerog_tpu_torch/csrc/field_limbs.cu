// Kernel 10: JField's add, sub and mul on the int64 limb layout, Fq or Fr.
//
// Replaces no TPU kernel: zerog_tpu/field/jfield.py is plain XLA, which fuses
// its limb ops. The port's JField (zerog_tpu_torch/field/jfield.py) ran each
// op as 30-60 torch launches, and a product through a [..., 256] float64
// outer product and a float64 matrix product. Here one launch reads the
// operands in the layout JField's callers hold, an element being 16 int64
// limbs of 16 bits (128 contiguous bytes), and writes the result in it.
//
// Bound: bytes. An element moves 384 bytes (two operands read, one result
// written; 256 where one operand is one broadcast element) against at most
// one product, 256 IMAD slots: at 2^20 the bytes take ~0.12 ms on the card,
// the products ~0.016 ms.
//
// Addressing: the result is [rows, cols] contiguous elements; operand element
// (r, c) is at base + r * sr + c * sc (int64 words), so a broadcast operand
// is read with a stride of 0 and never copied.
//
// Loads and stores: a warp owns 32 consecutive result elements. In each of 8
// steps its lanes move 4 whole elements, 8 lanes an element and 16 bytes (two
// limbs, one 32-bit word) a lane, so every request is of whole 128-byte
// lines whatever the strides. The words go through shared memory (1 KB a
// warp and operand, swizzled so that neither side of the transpose has a
// bank conflict) to the thread that owns the element, which runs the field
// body of field.cuh on its 8 words in registers; the result goes back the
// same way.
//
// Built by a host compiler, the exported function runs the warps one after
// another with the same three steps (gather, apply, scatter) over all 32
// lanes each, so the addressing, the swizzle and the ragged tail are the
// card's.
#include "field.cuh"

#define ZG_LIMBS_WARPS 4
#define ZG_LIMBS_THREADS (32 * ZG_LIMBS_WARPS)
#define ZG_LIMBS_BUF (32 * ZG_NW)  // words of one operand a warp

// One operand: element (r, c) has its 16 limbs at base + r * sr + c * sc.
struct LimbSrc {
    const int64_t* base;
    long sr, sc;
};

// Where word k of element e (0..31 in its warp) sits in a warp's buffer: the
// two 16-byte halves of an element swap places in every other group of 4
// elements, so that 8 threads reading 16 bytes each, and 32 lanes writing 4
// bytes each, fall in distinct banks.
ZG_HD int limbs_slot(int e, int k) {
    return e * ZG_NW + (k ^ (((e >> 2) & 1) << 2));
}

// Lane `lane` of the warp that owns elements base .. base + 31 reads word
// k = lane % 8 of elements base + lane / 8 + 4 j, j = 0..7, of both operands
// and puts them in the buffers. Elements past `total` read as 0.
ZG_HD void limbs_gather(const LimbSrc& a, const LimbSrc& b, long base, int lane,
                        long total, long cols, uint32_t* sa, uint32_t* sb) {
    const int k = lane & 7;
    const long e0 = base + (lane >> 3);
    long r = e0 / cols;
    long c = e0 - r * cols;
    uint32_t wa[ZG_NW], wb[ZG_NW];
#pragma unroll
    for (int j = 0; j < ZG_NW; j++) {
        wa[j] = wb[j] = 0u;
        if (e0 + 4 * j < total) {
            const int64_t* pa = a.base + r * a.sr + c * a.sc + 2 * k;
            const int64_t* pb = b.base + r * b.sr + c * b.sc + 2 * k;
#ifdef __CUDA_ARCH__
            const longlong2 la = __ldg((const longlong2*)pa);
            const longlong2 lb = __ldg((const longlong2*)pb);
            wa[j] = (uint32_t)la.x | ((uint32_t)la.y << 16);
            wb[j] = (uint32_t)lb.x | ((uint32_t)lb.y << 16);
#else
            wa[j] = (uint32_t)pa[0] | ((uint32_t)pa[1] << 16);
            wb[j] = (uint32_t)pb[0] | ((uint32_t)pb[1] << 16);
#endif
        }
        c += 4;
        while (c >= cols) {
            c -= cols;
            r++;
        }
    }
#pragma unroll
    for (int j = 0; j < ZG_NW; j++) {
        const int s = limbs_slot((lane >> 3) + 4 * j, k);
        sa[s] = wa[j];
        sb[s] = wb[j];
    }
}

#ifdef __CUDA_ARCH__
__device__ __forceinline__ void limbs_words4(uint32_t* w, const uint4 q) {
    w[0] = q.x;
    w[1] = q.y;
    w[2] = q.z;
    w[3] = q.w;
}
#endif

// Thread t of the warp: element t's words from both buffers, the operation,
// the result back into sa in their place.
template <int F, int OP>
ZG_HD void limbs_apply(uint32_t* sa, const uint32_t* sb, int t) {
    Fe x, y;
#ifdef __CUDA_ARCH__
    // words 0-3 and 4-7 are each 16 contiguous bytes
    const int lo = limbs_slot(t, 0), hi = limbs_slot(t, 4);
    limbs_words4(x.w, *(const uint4*)&sa[lo]);
    limbs_words4(x.w + 4, *(const uint4*)&sa[hi]);
    limbs_words4(y.w, *(const uint4*)&sb[lo]);
    limbs_words4(y.w + 4, *(const uint4*)&sb[hi]);
#else
    for (int k = 0; k < ZG_NW; k++) {
        x.w[k] = sa[limbs_slot(t, k)];
        y.w[k] = sb[limbs_slot(t, k)];
    }
#endif
    Fe r;
    if (OP == 0) r = fe_mul<F>(x, y);
    else if (OP == 1) r = fe_add<F>(x, y);
    else r = fe_sub<F>(x, y);
#ifdef __CUDA_ARCH__
    *(uint4*)&sa[lo] = make_uint4(r.w[0], r.w[1], r.w[2], r.w[3]);
    *(uint4*)&sa[hi] = make_uint4(r.w[4], r.w[5], r.w[6], r.w[7]);
#else
    for (int k = 0; k < ZG_NW; k++) sa[limbs_slot(t, k)] = r.w[k];
#endif
}

// Lane `lane`: word k = lane % 8 of elements base + lane / 8 + 4 j from the
// buffer to the contiguous result, as two limbs.
ZG_HD void limbs_scatter(int64_t* out, long base, int lane, long total,
                         const uint32_t* sa) {
    const int k = lane & 7;
#pragma unroll
    for (int j = 0; j < ZG_NW; j++) {
        const int e = (lane >> 3) + 4 * j;
        if (base + e >= total) continue;
        const uint32_t w = sa[limbs_slot(e, k)];
        int64_t* po = out + (base + e) * 2 * ZG_NW + 2 * k;
#ifdef __CUDA_ARCH__
        longlong2 v;
        v.x = (long long)(w & 0xFFFFu);
        v.y = (long long)(w >> 16);
        *(longlong2*)po = v;
#else
        po[0] = (int64_t)(w & 0xFFFFu);
        po[1] = (int64_t)(w >> 16);
#endif
    }
}

#ifdef __CUDACC__
template <int F, int OP>
__global__ void __launch_bounds__(ZG_LIMBS_THREADS)
    field_limbs_kernel(LimbSrc a, LimbSrc b, int64_t* out, long total, long cols) {
    __shared__ __align__(16) uint32_t buf[ZG_LIMBS_WARPS][2][ZG_LIMBS_BUF];
    const int lane = threadIdx.x & 31;
    const int warp = threadIdx.x >> 5;
    const long base = ((long)blockIdx.x * ZG_LIMBS_WARPS + warp) * 32;
    if (base >= total) return;  // the whole warp
    uint32_t* sa = buf[warp][0];
    uint32_t* sb = buf[warp][1];
    limbs_gather(a, b, base, lane, total, cols, sa, sb);
    __syncwarp();
    limbs_apply<F, OP>(sa, sb, lane);
    __syncwarp();
    limbs_scatter(out, base, lane, total, sa);
}
#endif

template <int F, int OP>
static int limbs_run(const LimbSrc& a, const LimbSrc& b, int64_t* out, long total,
                     long cols, void* stream) {
#ifdef __CUDACC__
    field_limbs_kernel<F, OP><<<ZG_BLOCKS(total, ZG_LIMBS_THREADS), ZG_LIMBS_THREADS, 0,
                                (cudaStream_t)stream>>>(a, b, out, total, cols);
    return (int)cudaGetLastError();
#else
    (void)stream;
    uint32_t sa[ZG_LIMBS_BUF], sb[ZG_LIMBS_BUF];
    for (long base = 0; base < total; base += 32) {
        for (int lane = 0; lane < 32; lane++)
            limbs_gather(a, b, base, lane, total, cols, sa, sb);
        for (int t = 0; t < 32; t++) limbs_apply<F, OP>(sa, sb, t);
        for (int lane = 0; lane < 32; lane++) limbs_scatter(out, base, lane, total, sa);
    }
    return 0;
#endif
}

template <int F>
static int limbs_op(int op, const LimbSrc& a, const LimbSrc& b, int64_t* out,
                    long total, long cols, void* stream) {
    if (op == 0) return limbs_run<F, 0>(a, b, out, total, cols, stream);
    if (op == 1) return limbs_run<F, 1>(a, b, out, total, cols, stream);
    return limbs_run<F, 2>(a, b, out, total, cols, stream);
}

// out[r, c] = a[r, c] (op) b[r, c] over rows x cols elements; a and b 16-byte
// aligned with even strides (in int64 words), out contiguous. field: 0 = Fq,
// 1 = Fr; op: 0 = mul (Montgomery), 1 = add, 2 = sub.
extern "C" int zg_field_limbs(const void* a, long a_sr, long a_sc, const void* b,
                              long b_sr, long b_sc, void* out, long rows, long cols,
                              int field, int op, void* stream) {
    if (field < 0 || field > 1 || op < 0 || op > 2 || rows < 0 || cols < 0) return -1;
    if (rows == 0 || cols == 0) return 0;
    const LimbSrc sa = {(const int64_t*)a, a_sr, a_sc};
    const LimbSrc sb = {(const int64_t*)b, b_sr, b_sc};
    const long total = rows * cols;
    int64_t* po = (int64_t*)out;
    return field == 0 ? limbs_op<0>(op, sa, sb, po, total, cols, stream)
                      : limbs_op<1>(op, sa, sb, po, total, cols, stream);
}
