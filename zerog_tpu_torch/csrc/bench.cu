// Kernels 8 and 9: the fused chain of field products and the flush-scan
// bisection, two measuring kernels.
//
// zg_field_chain replaces fused16 (scripts/bench_pallas_field.py, body
// `kernel`): x <- x * b (Montgomery) k times an element in one launch, so
// that no word goes to device memory between the products. One thread an
// element over word planes uint32[8, n]. An element reads 64 bytes, writes
// 32 and does 128 k multiply-adds; at k = 16 the operations bound it (0.032
// ms at n = 2^18 against 0.0075 ms of bytes). The design is the plainest
// one that reaches that bound if the card can: every thread independent,
// coalesced planes, the chain in registers. Its time at full occupancy
// against the latency of one dependent chain says what a product costs the
// card when it is full.
//
// zg_scan_bisect replaces the four bodies of bench_pscan_bisect.py (`run`:
// k_trivial, k_mul, k_mul_reg, k_madd), which bisect the TPU flush scan.
// What is bisected here is the first design of the port's kernel 2 (one
// thread a column walking the rows): that structure, with growing bodies.
// One thread a column, one warp a block, the R rows walked in order; the
// stream is word planes uint32[R, 8, C], the flags one byte each [R, C];
// every row writes the carry's x to out [R, 8, C]. Bodies, one kernel each:
//   trivial   the carry is the running sum of the rows, word by word mod 2^32
//             (bound by bytes: 64 R C). Its own design: a running sum mod
//             2^32 is exact in any grouping, so one thread owns a word lane
//             (8 C of them) and chunks of 32 rows are loaded together and
//             joined by a prefix of the chunk totals in shared memory: the
//             rows are in flight together, not one round trip a row. It
//             reads the memory floor of a scan over this layout;
//   mul_smem  carry <- carry * x_r (Fq), the carry written to shared memory
//             and read back every row, the counterpart of the TPU's scratch;
//   mul_reg   the same product, the carry in registers;
//   madd      carry <- jac_madd_incomplete(carry, x_r, y_r, flag_r != 0),
//             starting from (x_0, y_0, 0): kernel 2's add (11 products a row,
//             bound by operations: 11 * 128 R C multiply-adds).
// The loop of the other bodies is serial down a column by construction:
// they measure how far a chain of dependent work, with only a few thousand
// columns in flight, keeps the card from its bound. Comparing the bodies,
// and the same bodies at 8x the columns, tells whether such a scan waits on
// memory or on its chain of products.
#include "field.cuh"

#define ZG_BISECT_THREADS 32  // one warp a block, as flush_scan_affine

template <int F>
ZG_HD void field_chain_column(long col, const uint32_t* a, const uint32_t* b,
                              uint32_t* out, long n, int k) {
    Fe x = fe_load(a, n, col);
    const Fe y = fe_load(b, n, col);
#pragma unroll 1
    for (int i = 0; i < k; i++) x = fe_mul<F>(x, y);
    fe_store(out, n, col, x);
}

enum { ZG_BISECT_TRIVIAL = 0, ZG_BISECT_MUL_SMEM, ZG_BISECT_MUL_REG, ZG_BISECT_MADD };

// One column of the bisection. `scratch` holds the carry of mul_smem, word k
// at scratch[k * sstride] (shared memory on the card).
template <int BODY>
ZG_HD void scan_bisect_column(long col, const uint32_t* sx, const uint32_t* sy,
                              const uint8_t* flags, uint32_t* out, long rows,
                              long ncols, volatile uint32_t* scratch, int sstride) {
    if (rows <= 0) return;
    const long row_words = (long)ZG_NW * ncols;
    if (BODY == ZG_BISECT_MUL_SMEM) {
        const Fe x0 = fe_load(sx, ncols, col);
#pragma unroll
        for (int k = 0; k < ZG_NW; k++) scratch[k * sstride] = x0.w[k];
#pragma unroll 1
        for (long r = 0; r < rows; r++) {
            const long off = r * row_words;
            Fe carry;
#pragma unroll
            for (int k = 0; k < ZG_NW; k++) carry.w[k] = scratch[k * sstride];
            const Fe m = fe_mul<0>(carry, fe_load(sx + off, ncols, col));
#pragma unroll
            for (int k = 0; k < ZG_NW; k++) scratch[k * sstride] = m.w[k];
            fe_store(out + off, ncols, col, m);
        }
    } else if (BODY == ZG_BISECT_MUL_REG) {
        Fe carry = fe_load(sx, ncols, col);
#pragma unroll 1
        for (long r = 0; r < rows; r++) {
            const long off = r * row_words;
            carry = fe_mul<0>(carry, fe_load(sx + off, ncols, col));
            fe_store(out + off, ncols, col, carry);
        }
    } else {
        Jac carry;
        carry.x = fe_load(sx, ncols, col);
        carry.y = fe_load(sy, ncols, col);
        carry.z = fe_zero();
#pragma unroll 1
        for (long r = 0; r < rows; r++) {
            const long off = r * row_words;
            carry = jac_madd_incomplete(carry, fe_load(sx + off, ncols, col),
                                        fe_load(sy + off, ncols, col),
                                        flags[r * ncols + col] != 0);
            fe_store(out + off, ncols, col, carry.x);
        }
    }
}

// trivial: the word planes [R, 8, C] are a matrix [R, 8 C] of independent
// word lanes (lane k C + c: word k of column c). The rows are cut into
// tiles of ZG_TRIVIAL_WARPS chunks of ZG_TRIVIAL_CHUNK rows. A chunk's rows
// of a lane are loaded together into registers and summed; then each chunk
// writes its running sums from the lane's carry into the tile plus the
// totals of the tile's earlier chunks. Sums mod 2^32 are exact in any
// grouping, so the words equal the row-by-row sum.
#define ZG_TRIVIAL_CHUNK 32  // rows of one lane a thread holds in registers
#define ZG_TRIVIAL_WARPS 16  // chunks of a tile, one warp each

// Rows [r0, r0 + n) of `lane` into v (n <= ZG_TRIVIAL_CHUNK); returns their
// sum mod 2^32.
ZG_HD uint32_t trivial_chunk_load(const uint32_t* sx, long lanes, long lane, long r0,
                                  long n, uint32_t (&v)[ZG_TRIVIAL_CHUNK]) {
    uint32_t total = 0u;
#pragma unroll
    for (int i = 0; i < ZG_TRIVIAL_CHUNK; i++) {
        v[i] = i < n ? sx[(r0 + i) * lanes + lane] : 0u;
        total += v[i];
    }
    return total;
}

// Running sums of v from `acc` into rows [r0, r0 + n) of `lane`.
ZG_HD void trivial_chunk_store(uint32_t* out, long lanes, long lane, long r0, long n,
                               const uint32_t (&v)[ZG_TRIVIAL_CHUNK], uint32_t acc) {
#pragma unroll
    for (int i = 0; i < ZG_TRIVIAL_CHUNK; i++) {
        acc += v[i];
        if (i < n) out[(r0 + i) * lanes + lane] = acc;
    }
}

// Rows of chunk w of the tile that starts at row `tile`.
ZG_HD long trivial_chunk_rows(long rows, long tile, int w, long& r0) {
    r0 = tile + (long)w * ZG_TRIVIAL_CHUNK;
    const long n = rows - r0;
    return n < 0 ? 0 : n < ZG_TRIVIAL_CHUNK ? n : ZG_TRIVIAL_CHUNK;
}

#ifdef __CUDACC__
template <int F>
__global__ void field_chain_kernel(const uint32_t* a, const uint32_t* b, uint32_t* out,
                                   long n, int k) {
    const long col = ZG_COL_INDEX;
    if (col < n) field_chain_column<F>(col, a, b, out, n, k);
}

// One kernel a body, each with its own name (ptxas reports them apart).
#define ZG_BISECT_KERNEL(NAME, BODY)                                                   \
    __global__ void NAME(const uint32_t* sx, const uint32_t* sy, const uint8_t* flags, \
                         uint32_t* out, long rows, long ncols) {                       \
        __shared__ uint32_t scratch[ZG_NW * ZG_BISECT_THREADS];                        \
        const long col = ZG_COL_INDEX;                                                 \
        if (col < ncols)                                                               \
            scan_bisect_column<BODY>(col, sx, sy, flags, out, rows, ncols,             \
                                     scratch + threadIdx.x, ZG_BISECT_THREADS);        \
    }
ZG_BISECT_KERNEL(scan_bisect_mul_smem_kernel, ZG_BISECT_MUL_SMEM)
ZG_BISECT_KERNEL(scan_bisect_mul_reg_kernel, ZG_BISECT_MUL_REG)
ZG_BISECT_KERNEL(scan_bisect_madd_kernel, ZG_BISECT_MADD)

// Block: 32 lanes x ZG_TRIVIAL_WARPS warps, one chunk a warp; it walks the
// tiles down its lanes.
__global__ void __launch_bounds__(32 * ZG_TRIVIAL_WARPS)
scan_bisect_trivial_kernel(const uint32_t* sx, uint32_t* out, long rows,
                                           long lanes) {
    __shared__ uint32_t totals[ZG_TRIVIAL_WARPS][32];
    const int x = threadIdx.x, w = threadIdx.y;
    const long lane = (long)blockIdx.x * 32 + x;
    uint32_t carry = 0u;
#pragma unroll 1
    for (long tile = 0; tile < rows; tile += ZG_TRIVIAL_WARPS * ZG_TRIVIAL_CHUNK) {
        long r0;
        long n = trivial_chunk_rows(rows, tile, w, r0);
        if (lane >= lanes) n = 0;
        uint32_t v[ZG_TRIVIAL_CHUNK];
        totals[w][x] = trivial_chunk_load(sx, lanes, lane, r0, n, v);
        __syncthreads();
        uint32_t acc = carry;
#pragma unroll
        for (int i = 0; i < ZG_TRIVIAL_WARPS; i++) {
            const uint32_t t = totals[i][x];
            if (i < w) acc += t;
            carry += t;
        }
        trivial_chunk_store(out, lanes, lane, r0, n, v, acc);
        __syncthreads();
    }
}
#endif

extern "C" int zg_field_chain(const void* a, const void* b, void* out, long n,
                              int field, int k, void* stream) {
    if (field < 0 || field > 1 || k < 0) return -1;
    const uint32_t* pa = (const uint32_t*)a;
    const uint32_t* pb = (const uint32_t*)b;
    uint32_t* po = (uint32_t*)out;
#ifdef __CUDACC__
    if (n > 0) {
        const int threads = 128;
        if (field == 0)
            field_chain_kernel<0><<<ZG_BLOCKS(n, threads), threads, 0,
                                    (cudaStream_t)stream>>>(pa, pb, po, n, k);
        else
            field_chain_kernel<1><<<ZG_BLOCKS(n, threads), threads, 0,
                                    (cudaStream_t)stream>>>(pa, pb, po, n, k);
    }
    return (int)cudaGetLastError();
#else
    (void)stream;
    for (long col = 0; col < n; col++) {
        if (field == 0) field_chain_column<0>(col, pa, pb, po, n, k);
        else field_chain_column<1>(col, pa, pb, po, n, k);
    }
    return 0;
#endif
}

#ifndef __CUDACC__
// The device's tiles and chunks, one lane at a time: chunk totals, then the
// running sums from each chunk's offset.
static void scan_bisect_trivial_host(const uint32_t* sx, uint32_t* out, long rows,
                                     long lanes) {
    uint32_t v[ZG_TRIVIAL_CHUNK];
    for (long lane = 0; lane < lanes; lane++) {
        uint32_t carry = 0u;
        for (long tile = 0; tile < rows; tile += ZG_TRIVIAL_WARPS * ZG_TRIVIAL_CHUNK) {
            uint32_t totals[ZG_TRIVIAL_WARPS];
            long r0;
            for (int w = 0; w < ZG_TRIVIAL_WARPS; w++) {
                const long n = trivial_chunk_rows(rows, tile, w, r0);
                totals[w] = trivial_chunk_load(sx, lanes, lane, r0, n, v);
            }
            for (int w = 0; w < ZG_TRIVIAL_WARPS; w++) {
                const long n = trivial_chunk_rows(rows, tile, w, r0);
                trivial_chunk_load(sx, lanes, lane, r0, n, v);
                trivial_chunk_store(out, lanes, lane, r0, n, v, carry);
                carry += totals[w];
            }
        }
    }
}

template <int BODY>
static void scan_bisect_host(const uint32_t* sx, const uint32_t* sy,
                             const uint8_t* flags, uint32_t* out, long rows,
                             long ncols) {
    uint32_t scratch[ZG_NW];
    for (long col = 0; col < ncols; col++)
        scan_bisect_column<BODY>(col, sx, sy, flags, out, rows, ncols, scratch, 1);
}
#endif

// body: 0 = trivial, 1 = mul_smem, 2 = mul_reg, 3 = madd
extern "C" int zg_scan_bisect(int body, const void* sx, const void* sy,
                              const void* flags, void* out, long rows, long ncols,
                              void* stream) {
    if (body < ZG_BISECT_TRIVIAL || body > ZG_BISECT_MADD) return -1;
    const uint32_t* px = (const uint32_t*)sx;
    const uint32_t* py = (const uint32_t*)sy;
    const uint8_t* pf = (const uint8_t*)flags;
    uint32_t* po = (uint32_t*)out;
#ifdef __CUDACC__
    if (ncols > 0 && body == ZG_BISECT_TRIVIAL) {
        const dim3 block(32, ZG_TRIVIAL_WARPS);
        scan_bisect_trivial_kernel<<<ZG_BLOCKS(ZG_NW * ncols, 32), block, 0,
                                     (cudaStream_t)stream>>>(px, po, rows, ZG_NW * ncols);
    } else if (ncols > 0) {
        void (*kernel)(const uint32_t*, const uint32_t*, const uint8_t*, uint32_t*, long,
                       long) =
            body == ZG_BISECT_MUL_SMEM  ? scan_bisect_mul_smem_kernel
            : body == ZG_BISECT_MUL_REG ? scan_bisect_mul_reg_kernel
                                        : scan_bisect_madd_kernel;
        kernel<<<ZG_BLOCKS(ncols, ZG_BISECT_THREADS), ZG_BISECT_THREADS, 0,
                 (cudaStream_t)stream>>>(px, py, pf, po, rows, ncols);
    }
    return (int)cudaGetLastError();
#else
    (void)stream;
    if (body == ZG_BISECT_TRIVIAL)
        scan_bisect_trivial_host(px, po, rows, ZG_NW * ncols);
    else if (body == ZG_BISECT_MUL_SMEM)
        scan_bisect_host<ZG_BISECT_MUL_SMEM>(px, py, pf, po, rows, ncols);
    else if (body == ZG_BISECT_MUL_REG)
        scan_bisect_host<ZG_BISECT_MUL_REG>(px, py, pf, po, rows, ncols);
    else
        scan_bisect_host<ZG_BISECT_MADD>(px, py, pf, po, rows, ncols);
    return 0;
#endif
}
