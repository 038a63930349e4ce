// Kernels 2 and 3: the MSM flush scan over an affine and over a Jacobian
// point stream.
//
// Replace _scan_kernel_affine and _scan_kernel_jac (zerog_tpu/curve/pscan.py).
// The stream is word planes uint32[R, 8, C]: row r, word k, column c at
// [(r * 8 + k) * C + c]; valid and flags are one byte per entry, [R, C].
// Per column, per row: the carry is written as a piece where the flush flag
// is set (zeros elsewhere), then restarts from the row's point (flag) or
// takes the point in by an incomplete add. The final carry goes to its own
// [8, C] planes. The column index is the fastest axis, so a warp's loads and
// stores coalesce.
//
// Affine scan: one thread owns one column and walks all R rows with the carry
// in registers; bounded by the chain of dependent products down a column,
// with only a few thousand columns in flight.
//
// Jacobian scan: a flag cuts a column into segments that do not depend on
// each other: the one that starts at a flagged row starts from that row's
// point bit for bit (even (0, 0, 0)), the first one from the identity
// (1, 1, 0). A group of ZG_SCAN_GROUP threads owns a slice of ZG_SCAN_SLICE
// rows of one column: it writes the zero pieces of its slice's unflagged
// rows and folds every segment that starts in its slice (the column's first
// one in slice 0), past the slice's end if need be, up to the flag that ends
// it, where it writes the piece, or to the column's end, where it writes the
// final carry. Rows before a slice's first flag belong to an earlier slice's
// segment. A row with a zero z leaves the carry as it is and a carry with a
// zero z becomes the row's point: the selects of jac_add_incomplete, taken
// before any product is computed (jac_add_skip). The threads of a group
// share each add, one product of a level each (jac_add_formulas), which
// cuts an add's latency to about five products. So the kernel is bounded by
// the longest chain of adds one segment really needs (on a proof's
// compaction round, one bucket's pieces, up to ~320), not by R full adds a
// column.
#include "field.cuh"

ZG_HD void flush_scan_affine_column(long col, const uint32_t* sx, const uint32_t* sy,
                                    const uint8_t* valid, const uint8_t* flags,
                                    uint32_t* ox, uint32_t* oy, uint32_t* oz,
                                    uint32_t* cx, uint32_t* cy, uint32_t* cz,
                                    long rows, long ncols) {
    Jac carry = jac_infinity();
    Jac zero;
    zero.x = fe_zero();
    zero.y = fe_zero();
    zero.z = fe_zero();
    const long row_words = (long)ZG_NW * ncols;
#pragma unroll 1
    for (long r = 0; r < rows; r++) {
        const long off = r * row_words;
        Fe qx = fe_load(sx + off, ncols, col);
        Fe qy = fe_load(sy + off, ncols, col);
        bool qv = valid[r * ncols + col] != 0;
        bool flag = flags[r * ncols + col] != 0;
        jac_store(ox + off, oy + off, oz + off, ncols, col,
                  jac_select(flag, carry, zero));
        Jac added = jac_madd_incomplete(carry, qx, qy, qv);
        Jac fresh;
        fresh.x = qx;
        fresh.y = qy;
        fresh.z = qv ? fe_one<0>() : fe_zero();
        carry = jac_select(flag, fresh, added);
    }
    jac_store(cx, cy, cz, ncols, col, carry);
}

#define ZG_SCAN_SLICE 32  // rows a thread group of the Jacobian scan starts segments in
#define ZG_SCAN_GROUP 4   // threads that share one (slice, column) and its adds

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
    long col = ZG_COL_INDEX;
    if (col < ncols)
        flush_scan_affine_column(col, sx, sy, valid, flags, ox, oy, oz, cx, cy, cz,
                                 rows, ncols);
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

// Affine scan: one warp a block, so that its few thousand columns spread
// over as many multiprocessors as there are. Jacobian scan: two warps a
// block (16 columns), R / 32 blocks down each column block.
#define ZG_SCAN_THREADS 32
#define ZG_SCAN_JAC_THREADS 64

extern "C" int zg_flush_scan_affine(const void* sx, const void* sy, const void* valid,
                                    const void* flags, void* ox, void* oy, void* oz,
                                    void* cx, void* cy, void* cz, long rows,
                                    long ncols, void* stream) {
#ifdef __CUDACC__
    if (ncols > 0)
        flush_scan_affine_kernel<<<ZG_BLOCKS(ncols, ZG_SCAN_THREADS), ZG_SCAN_THREADS,
                                   0, (cudaStream_t)stream>>>(
            (const uint32_t*)sx, (const uint32_t*)sy, (const uint8_t*)valid,
            (const uint8_t*)flags, (uint32_t*)ox, (uint32_t*)oy, (uint32_t*)oz,
            (uint32_t*)cx, (uint32_t*)cy, (uint32_t*)cz, rows, ncols);
    return (int)cudaGetLastError();
#else
    (void)stream;
    for (long col = 0; col < ncols; col++)
        flush_scan_affine_column(col, (const uint32_t*)sx, (const uint32_t*)sy,
                                 (const uint8_t*)valid, (const uint8_t*)flags,
                                 (uint32_t*)ox, (uint32_t*)oy, (uint32_t*)oz,
                                 (uint32_t*)cx, (uint32_t*)cy, (uint32_t*)cz, rows,
                                 ncols);
    return 0;
#endif
}

extern "C" int zg_flush_scan_jac(const void* sx, const void* sy, const void* sz,
                                 const void* flags, void* ox, void* oy, void* oz,
                                 void* cx, void* cy, void* cz, long rows, long ncols,
                                 void* stream) {
    // with no rows, slice 0 still writes the final carries (the identity)
    const long slices = rows > 0 ? (rows + ZG_SCAN_SLICE - 1) / ZG_SCAN_SLICE : 1;
#ifdef __CUDACC__
    if (ncols > 0) {
        dim3 grid(ZG_BLOCKS(ncols * ZG_SCAN_GROUP, ZG_SCAN_JAC_THREADS), (unsigned)slices);
        flush_scan_jac_kernel<<<grid, ZG_SCAN_JAC_THREADS, 0, (cudaStream_t)stream>>>(
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
