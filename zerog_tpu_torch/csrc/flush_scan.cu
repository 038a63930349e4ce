// Kernels 2 and 3: the MSM flush scan over an affine and over a Jacobian
// point stream.
//
// Replace _scan_kernel_affine and _scan_kernel_jac (zerog_tpu/curve/pscan.py).
// The stream is word planes uint32[R, 8, C]: row r, word k, column c at
// [(r * 8 + k) * C + c]; valid and flags are one byte per entry, [R, C].
// Per column, per row: the carry is written as a piece where the flush flag
// is set (zeros elsewhere), then restarts from the row's point (flag) or
// takes the point in by an incomplete add. The final carry goes to its own
// [8, C] planes. The column index is the fastest axis, so the loads and
// stores of a warp's neighbouring columns coalesce.
//
// Both scans cut a column at its flags into segments that do not depend on
// each other: the one that starts at a flagged row starts from that row's
// point bit for bit (affine: (x, y, valid ? 1 : 0); Jacobian: even
// (0, 0, 0)), the column's first one from the identity (1, 1, 0). A group
// of ZG_SCAN_GROUP threads owns a slice of ZG_SCAN_SLICE rows of one column
// and folds every segment that starts in its slice (the column's first one
// in slice 0), past the slice's end if need be, up to the flag that ends
// it, where it writes the piece, or to the column's end, where it writes the
// final carry. Rows before a slice's first flag belong to an earlier
// slice's segment. A 2-D grid: column blocks x slices.
//
// Affine scan: a row adds its point by the mixed add of
// jac_madd_incomplete (8M + 3S), whose 11 products fall in five levels
// (madd_finish_start). The carry's z is ready after level 3 and its x after
// level 4, so the group runs a row's levels 1-2 beside the row before's
// levels 4-5: every row is three rounds of at most four products, one
// product a thread a round, exchanged by shuffles (add_level).
// The group's rows come 32 at a time into shared memory by cp.async, one
// round trip a block. Every row runs its three rounds, whatever it needs,
// so that the eight groups of a warp stay in step; the selects of
// jac_madd_incomplete keep the carry of an invalid row and turn a carry
// whose z is 0 into (qx, qy, 1). The pieces of unflagged rows are zeros
// written before the launch. On the card (H100) the kernel is bound by the
// longest chain: a segment of L rows takes L steps of three dependent
// products plus the adds and subtracts between them (~2.4 us a row against
// 3 x 0.45 us of products), and a proof's streams hold segments of all
// 1,024 rows; where segments are short, the warps wait for the longest of
// their eight groups.
//
// Jacobian scan: a row with a zero z leaves the carry as it is and a carry
// with a zero z becomes the row's point: the selects of jac_add_incomplete,
// taken before any product is computed (jac_add_skip). The threads of a
// group share each add, one product of a level each (jac_add_formulas),
// which cuts an add's latency to about five products. The group writes the
// zero pieces of its slice's unflagged rows. So the kernel is bounded by
// the longest chain of adds one segment really needs (on a proof's
// compaction round, one bucket's pieces, up to ~320), not by R full adds a
// column.
#include "field.cuh"

#define ZG_SCAN_SLICE 32  // rows a thread group starts segments in
static_assert(ZG_SCAN_SLICE <= 32, "a staged block's flags are the bits of one word");
#define ZG_SCAN_GROUP 4   // threads that share one (slice, column) and its adds
#define ZG_SCAN_THREADS 64  // a block of either scan: two warps, 16 groups

// The carry after the Jacobian stream's row r (not flagged): unchanged if
// the row's point is the identity (only its z words are read then).
ZG_HD Jac scan_jac_step(const Jac& carry, const uint32_t* sx, const uint32_t* sy,
                        const uint32_t* sz, long off, long ncols, long col, int j) {
    Jac q;
    q.z = fe_load(sz + off, ncols, col);
    if (fe_is_zero(q.z)) return carry;
    q.x = fe_load(sx + off, ncols, col);
    q.y = fe_load(sy + off, ncols, col);
    return jac_add_skip<ZG_SCAN_GROUP>(carry, q, j);
}

// ---- the affine scan ------------------------------------------------------------

#define ZG_ROW_WORDS (2 * ZG_NW)  // x and y words of one row
// a group's staged block of rows, one word more so that the groups of a warp
// read other banks
#define ZG_STAGE_WORDS (ZG_SCAN_SLICE * ZG_ROW_WORDS + 1)

#ifdef __CUDACC__
// cp.async: 4 bytes from device memory to shared memory, without a register
__device__ __forceinline__ void zg_cp_async4(uint32_t* smem, const uint32_t* gmem) {
#ifdef __CUDA_ARCH__
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;" ::"r"(
                     (unsigned)__cvta_generic_to_shared(smem)),
                 "l"(gmem)
                 : "memory");
#endif
}

// Waits for all of this thread's cp.async copies.
__device__ __forceinline__ void zg_cp_async_wait_all() {
#ifdef __CUDA_ARCH__
    asm volatile("cp.async.wait_all;" ::: "memory");
#endif
}
#endif

// One block of ZG_SCAN_SLICE rows of a column, staged for its group: the x
// and y words of row i at w[16 i ..], its valid and flag bytes as bits i of
// `valid` and `flag`. On the card each thread of the group copies every
// G-th row by cp.async into the group's shared memory and loads that row's
// two bytes, all in flight together, and the group ORs its bits: a block
// costs one round trip to device memory, not one a row.
struct AffineStage {
    uint32_t* w;
    uint32_t valid, flag;
};

template <int G>
ZG_HD void affine_stage(AffineStage& st, const uint32_t* sx, const uint32_t* sy,
                        const uint8_t* valid, const uint8_t* flags, long r0, long rows,
                        long ncols, long col, int j) {
#ifdef __CUDA_ARCH__
    const unsigned base = (threadIdx.x & 31u) & ~(unsigned)(G - 1);
    const unsigned mask = ((1u << G) - 1u) << base;
    __syncwarp(mask);  // the group has read the block before this one
#endif
    const long row_words = (long)ZG_NW * ncols;
    uint32_t vb = 0u, fb = 0u;
#pragma unroll
    for (int t = 0; t < ZG_SCAN_SLICE / G; t++) {
        const int i = j + t * G;
        const long r = r0 + i;
        if (r >= rows) continue;
        const uint32_t* px = sx + r * row_words + col;
        const uint32_t* py = sy + r * row_words + col;
        uint32_t* w = st.w + i * ZG_ROW_WORDS;
#pragma unroll
        for (int k = 0; k < ZG_NW; k++) {
#ifdef __CUDA_ARCH__
            zg_cp_async4(w + k, px + (long)k * ncols);
            zg_cp_async4(w + ZG_NW + k, py + (long)k * ncols);
#else
            w[k] = px[(long)k * ncols];
            w[ZG_NW + k] = py[(long)k * ncols];
#endif
        }
        vb |= (uint32_t)(valid[r * ncols + col] != 0) << i;
        fb |= (uint32_t)(flags[r * ncols + col] != 0) << i;
    }
#ifdef __CUDA_ARCH__
    zg_cp_async_wait_all();
#pragma unroll
    for (int d = 1; d < G; d *= 2) {
        vb |= __shfl_xor_sync(mask, vb, d);
        fb |= __shfl_xor_sync(mask, fb, d);
    }
    __syncwarp(mask);  // every thread's copies are seen by the group
#endif
    st.valid = vb;
    st.flag = fb;
}

// One row of the affine stream: x, y, valid, flag.
struct AffineRow {
    Fe x, y;
    bool valid, flag;
};

// Row r0 + i of the staged block.
ZG_HD AffineRow affine_row(const AffineStage& st, int i) {
    AffineRow q;
#pragma unroll
    for (int k = 0; k < ZG_NW; k++) {
        q.x.w[k] = st.w[i * ZG_ROW_WORDS + k];
        q.y.w[k] = st.w[i * ZG_ROW_WORDS + ZG_NW + k];
    }
    q.valid = (st.valid >> i) & 1u;
    q.flag = (st.flag >> i) & 1u;
    return q;
}

// A group's walk through the segments that start in its slice.
struct AffineWalk {
    bool open;      // the carry is this group's (from slice 0, or a flag)
    bool inflight;  // an add to the carry has run levels 1-3: half
    Jac carry;
    Fe half[4];     // h, hh, s2 and z3 = Z1 H of the add in flight
};

// Stores thread j's share of a piece: every G-th of its 24 words.
template <int G>
ZG_HD void jac_store_part(uint32_t* x, uint32_t* y, uint32_t* z, long stride, long col,
                          const Jac& p, int j) {
#pragma unroll
    for (int k = 0; k < ZG_NW; k++) {
        if (k % G != j) continue;
        x[(long)k * stride + col] = p.x.w[k];
        y[(long)k * stride + col] = p.y.w[k];
        z[(long)k * stride + col] = p.z.w[k];
    }
}

// One row of the walk: row r of column col, whose operands are q (r ==
// rows: the column's end, a flush into the final carry). The group runs
// levels 4-5 of the add in flight beside levels 1-2 of this row's, then
// level 3 of this row's: 3 rounds a row, whatever the row asks for, so that
// the groups of a warp stay in step. The selects of jac_madd_incomplete
// decide what is kept: an invalid row leaves the carry as it is, a carry
// whose z is 0 becomes (qx, qy, 1), a flag flushes the carry as the row's
// piece and restarts it from the row's point. Returns false once the walk
// has flushed at or past `end`, or at the column's end.
template <int G>
ZG_HD bool affine_step(AffineWalk& wk, const AffineRow& q, long r, long end, long col,
                       uint32_t* ox, uint32_t* oy, uint32_t* oz, uint32_t* cx, uint32_t* cy,
                       uint32_t* cz, long rows, long ncols, int j) {
    const bool last = r == rows;
    const bool flush = last || q.flag;
    // the z of the carry before this row, known three levels into an add
    const Fe zc = fe_select(wk.inflight, wk.half[3], wk.carry.z);
    const bool add = !flush && q.valid && !fe_is_zero(zc);
    Fe u2, zz;
    {
        const Fe half[4] = {wk.half[0], wk.half[1], wk.half[2], zc};
        const Jac done = madd_finish_start<G>(wk.carry, half, q.x, u2, zz, j);
        if (wk.inflight && (flush || add)) {
            wk.carry = done;
            wk.inflight = false;
        }
    }
    const Fe h = fe_sub<0>(u2, wk.carry.x);
    Fe lc[3];
    {
        const Fe a[3] = {q.y, h, wk.carry.z}, b[3] = {zz, h, h};
        add_level<3, G>(j, a, b, lc);
    }
    if (flush) {
        if (wk.open) {
            const long off = last ? 0 : r * (long)ZG_NW * ncols;
            jac_store_part<G>(last ? cx : ox + off, last ? cy : oy + off,
                              last ? cz : oz + off, ncols, col, wk.carry, j);
        }
        wk.carry = jac_from_affine(q.x, q.y, q.valid);
        wk.inflight = false;
        wk.open = true;
        return !last && r < end;
    }
    if (add) {
        wk.half[0] = h;
        wk.half[1] = lc[1];
        wk.half[2] = lc[0];
        wk.half[3] = lc[2];
        wk.inflight = true;
    } else if (q.valid) {
        wk.carry = jac_from_affine(q.x, q.y, true);
        wk.inflight = false;
    }
    return true;
}

// Thread j of the group of G threads that owns rows [slice S, slice S + S)
// of column col (S = ZG_SCAN_SLICE), `stage` its ZG_STAGE_WORDS words. It
// folds every segment that starts in the slice (the column's first one in
// slice 0), past the slice's end if need be, up to the flag that ends it,
// where it writes the piece, or to the column's end, where it writes the
// final carry. Rows before the slice's first flag belong to an earlier
// slice's segment. The pieces of unflagged rows are the zeros written
// before the launch.
template <int G>
ZG_HD void flush_scan_affine_slice(long col, int j, long slice, uint32_t* stage,
                                   const uint32_t* sx, const uint32_t* sy,
                                   const uint8_t* valid, const uint8_t* flags,
                                   uint32_t* ox, uint32_t* oy, uint32_t* oz, uint32_t* cx,
                                   uint32_t* cy, uint32_t* cz, long rows, long ncols) {
    const long begin = slice * ZG_SCAN_SLICE;
    const long end = begin + ZG_SCAN_SLICE < rows ? begin + ZG_SCAN_SLICE : rows;
    AffineWalk wk;
    wk.open = slice == 0;
    wk.inflight = false;
    wk.carry = jac_infinity();
#pragma unroll
    for (int k = 0; k < 4; k++) wk.half[k] = fe_zero();
    AffineStage st;
    st.w = stage;
    st.valid = st.flag = 0u;
#pragma unroll 1
    for (long r = begin; r <= rows; r++) {
        const int i = (int)(r % ZG_SCAN_SLICE);
        if (r < rows && i == 0) {
            if (r >= end && !wk.open) return;
            affine_stage<G>(st, sx, sy, valid, flags, r, rows, ncols, col, j);
        }
        AffineRow q;
        if (r < rows) {
            q = affine_row(st, i);
        } else {
            q.x = q.y = fe_zero();
            q.valid = q.flag = false;
        }
        if (!wk.open && !q.flag) {
            if (r >= end) return;
            continue;
        }
        if (!affine_step<G>(wk, q, r, end, col, ox, oy, oz, cx, cy, cz, rows, ncols, j))
            return;
    }
}

// Thread j of the group of (slice, col); the one with j = 0 stores.
ZG_HD void flush_scan_jac_slice(long col, int j, long slice, const uint32_t* sx,
                                const uint32_t* sy, const uint32_t* sz,
                                const uint8_t* flags, uint32_t* ox, uint32_t* oy,
                                uint32_t* oz, uint32_t* cx, uint32_t* cy,
                                uint32_t* cz, long rows, long ncols) {
    Jac zero;
    zero.x = fe_zero();
    zero.y = fe_zero();
    zero.z = fe_zero();
    const bool store = j == 0;
    const long row_words = (long)ZG_NW * ncols;
    const long begin = slice * ZG_SCAN_SLICE;
    const long end = begin + ZG_SCAN_SLICE < rows ? begin + ZG_SCAN_SLICE : rows;
    // a segment this thread folds is open; the column's first starts here
    bool open = slice == 0;
    Jac carry = jac_infinity();
#pragma unroll 1
    for (long r = begin; r < rows; r++) {
        const bool mine = r < end;
        if (!mine && !open) return;
        const long off = r * row_words;
        if (flags[r * ncols + col] != 0) {
            if (open && store) jac_store(ox + off, oy + off, oz + off, ncols, col, carry);
            if (!mine) return;
            carry = jac_load(sx + off, sy + off, sz + off, ncols, col);
            open = true;
        } else {
            if (mine && store) jac_store(ox + off, oy + off, oz + off, ncols, col, zero);
            if (open) carry = scan_jac_step(carry, sx, sy, sz, off, ncols, col, j);
        }
    }
    if (open && store) jac_store(cx, cy, cz, ncols, col, carry);
}

#ifdef __CUDACC__
__global__ void flush_scan_affine_kernel(const uint32_t* sx, const uint32_t* sy,
                                         const uint8_t* valid, const uint8_t* flags,
                                         uint32_t* ox, uint32_t* oy, uint32_t* oz,
                                         uint32_t* cx, uint32_t* cy, uint32_t* cz,
                                         long rows, long ncols) {
    __shared__ uint32_t stage[ZG_SCAN_THREADS / ZG_SCAN_GROUP][ZG_STAGE_WORDS];
    const long t = ZG_COL_INDEX;
    const long col = t / ZG_SCAN_GROUP;
    if (col < ncols)
        flush_scan_affine_slice<ZG_SCAN_GROUP>(col, (int)(t % ZG_SCAN_GROUP), blockIdx.y,
                                               stage[threadIdx.x / ZG_SCAN_GROUP], sx, sy,
                                               valid, flags, ox, oy, oz, cx, cy, cz, rows,
                                               ncols);
}

__global__ void flush_scan_jac_kernel(const uint32_t* sx, const uint32_t* sy,
                                      const uint32_t* sz, const uint8_t* flags,
                                      uint32_t* ox, uint32_t* oy, uint32_t* oz,
                                      uint32_t* cx, uint32_t* cy, uint32_t* cz,
                                      long rows, long ncols) {
    const long t = ZG_COL_INDEX;
    const long col = t / ZG_SCAN_GROUP;
    if (col < ncols)
        flush_scan_jac_slice(col, (int)(t % ZG_SCAN_GROUP), blockIdx.y, sx, sy, sz, flags,
                             ox, oy, oz, cx, cy, cz, rows, ncols);
}
#endif

// Slices of one column: with no rows, slice 0 still writes the final carries
// (the identity).
static long scan_slices(long rows) {
    return rows > 0 ? (rows + ZG_SCAN_SLICE - 1) / ZG_SCAN_SLICE : 1;
}

extern "C" int zg_flush_scan_affine(const void* sx, const void* sy, const void* valid,
                                    const void* flags, void* ox, void* oy, void* oz,
                                    void* cx, void* cy, void* cz, long rows,
                                    long ncols, void* stream) {
    const long slices = scan_slices(rows);
    // the pieces of unflagged rows are zeros; the kernel writes the others
    void* pieces[3] = {ox, oy, oz};
    const long piece_words = rows * ZG_NW * ncols;
#ifdef __CUDACC__
    if (ncols > 0) {
        for (int i = 0; i < 3; i++) {
            const cudaError_t e = cudaMemsetAsync(pieces[i], 0, piece_words * 4,
                                                  (cudaStream_t)stream);
            if (e != cudaSuccess) return (int)e;
        }
        dim3 grid(ZG_BLOCKS(ncols * ZG_SCAN_GROUP, ZG_SCAN_THREADS), (unsigned)slices);
        flush_scan_affine_kernel<<<grid, ZG_SCAN_THREADS, 0, (cudaStream_t)stream>>>(
            (const uint32_t*)sx, (const uint32_t*)sy, (const uint8_t*)valid,
            (const uint8_t*)flags, (uint32_t*)ox, (uint32_t*)oy, (uint32_t*)oz,
            (uint32_t*)cx, (uint32_t*)cy, (uint32_t*)cz, rows, ncols);
    }
    return (int)cudaGetLastError();
#else
    (void)stream;
    for (int i = 0; i < 3; i++)
        for (long w = 0; w < piece_words; w++) ((uint32_t*)pieces[i])[w] = 0u;
    uint32_t stage[ZG_STAGE_WORDS];
    for (long slice = 0; slice < slices; slice++)
        for (long col = 0; col < ncols; col++)
            flush_scan_affine_slice<1>(col, 0, slice, stage, (const uint32_t*)sx,
                                       (const uint32_t*)sy, (const uint8_t*)valid,
                                       (const uint8_t*)flags, (uint32_t*)ox, (uint32_t*)oy,
                                       (uint32_t*)oz, (uint32_t*)cx, (uint32_t*)cy,
                                       (uint32_t*)cz, rows, ncols);
    return 0;
#endif
}

extern "C" int zg_flush_scan_jac(const void* sx, const void* sy, const void* sz,
                                 const void* flags, void* ox, void* oy, void* oz,
                                 void* cx, void* cy, void* cz, long rows, long ncols,
                                 void* stream) {
    const long slices = scan_slices(rows);
#ifdef __CUDACC__
    if (ncols > 0) {
        dim3 grid(ZG_BLOCKS(ncols * ZG_SCAN_GROUP, ZG_SCAN_THREADS), (unsigned)slices);
        flush_scan_jac_kernel<<<grid, ZG_SCAN_THREADS, 0, (cudaStream_t)stream>>>(
            (const uint32_t*)sx, (const uint32_t*)sy, (const uint32_t*)sz,
            (const uint8_t*)flags, (uint32_t*)ox, (uint32_t*)oy, (uint32_t*)oz,
            (uint32_t*)cx, (uint32_t*)cy, (uint32_t*)cz, rows, ncols);
    }
    return (int)cudaGetLastError();
#else
    (void)stream;
    for (long slice = 0; slice < slices; slice++)
        for (long col = 0; col < ncols; col++)
            flush_scan_jac_slice(col, 0, slice, (const uint32_t*)sx, (const uint32_t*)sy,
                                 (const uint32_t*)sz, (const uint8_t*)flags,
                                 (uint32_t*)ox, (uint32_t*)oy, (uint32_t*)oz,
                                 (uint32_t*)cx, (uint32_t*)cy, (uint32_t*)cz, rows,
                                 ncols);
    return 0;
#endif
}
