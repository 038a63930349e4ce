// Kernels 4 and 5: the MSM bucket folds.
//
// Replace _sum_rows_call and _weighted_call (zerog_tpu/curve/pfold.py). Rows
// are word planes uint32[L, 8, C] (row l, word k, lane c at
// [(l * 8 + k) * C + c]); results and the bias are [8, C]. One thread owns one
// lane and folds all rows in order with its accumulators in registers, so the
// add order, and with it every limb of the result, equals the plain fold's.
//
// sum_rows:  acc <- infinity; for each row: acc <- acc + row.
// weighted:  a1 <- infinity, a2 <- bias; for each row (k = K-1 .. 0):
//            a2 <- a2 + a1, then a1 <- a1 + row. Returns a2 = bias + sum k*row_k.
// Any number of rows is taken: there is no chunking, so no padded row ever
// repeats the a2 += a1 step.
//
// sum_rows takes one or two folds (jobs) in one launch, the longer first, so
// that the two fold shapes of an MSM batch run side by side; a group of
// ZG_FOLD_GROUP threads shares each lane's adds, one product of a level each
// (jac_add_formulas), and one warp a block spreads the groups over the
// multiprocessors. Its time is the longest lane's chain of adds: a row
// whose z is 0 leaves the accumulator as it is, and an accumulator whose z
// is 0 becomes the row, with no product computed (jac_add_skip, the selects
// of jac_add_incomplete), so a lane costs one add for each non-identity row
// after its first. Most bucket slots of an MSM are empty (slot 1 nearly
// always, and most buckets of a witness column of small values).
#include "field.cuh"

#define ZG_FOLD_GROUP 4  // threads that share one lane of sum_rows and its adds

// Lane `col` of one fold; j: the thread's index in the lane's group of
// ZG_FOLD_GROUP threads on the card (0 on a host), the one with j = 0 stores.
ZG_HD void sum_rows_lane(long col, int j, const uint32_t* x, const uint32_t* y,
                         const uint32_t* z, uint32_t* ox, uint32_t* oy, uint32_t* oz,
                         long rows, long ncols) {
    Jac acc = jac_infinity();
    const long row_words = (long)ZG_NW * ncols;
#pragma unroll 1
    for (long r = 0; r < rows; r++) {
        const long off = r * row_words;
        Jac q;
        q.z = fe_load(z + off, ncols, col);
        if (fe_is_zero(q.z)) continue;
        q.x = fe_load(x + off, ncols, col);
        q.y = fe_load(y + off, ncols, col);
        acc = jac_add_skip<ZG_FOLD_GROUP>(acc, q, j);
    }
    if (j == 0) jac_store(ox, oy, oz, ncols, col, acc);
}

// One fold of a sum_rows launch: its planes, rows and lanes, and the first
// block of the launch that works on it. A launch takes the two fold shapes of
// an MSM batch (pippenger.py) or one fold.
#define ZG_FOLD_MAX_JOBS 2
struct FoldJob {
    const uint32_t *x, *y, *z;
    uint32_t *ox, *oy, *oz;
    long rows, ncols, block0;
};
struct FoldJobs {
    FoldJob job[ZG_FOLD_MAX_JOBS];
    int n;
};

ZG_HD void weighted_fold_column(long col, const uint32_t* x, const uint32_t* y,
                                const uint32_t* z, const uint32_t* bx,
                                const uint32_t* by, const uint32_t* bz, uint32_t* ox,
                                uint32_t* oy, uint32_t* oz, long rows, long ncols) {
    Jac a1 = jac_infinity();
    Jac a2 = jac_load(bx, by, bz, ncols, col);
    const long row_words = (long)ZG_NW * ncols;
#pragma unroll 1
    for (long r = 0; r < rows; r++) {
        const long off = r * row_words;
        a2 = jac_add_incomplete(a2, a1);
        a1 = jac_add_incomplete(a1, jac_load(x + off, y + off, z + off, ncols, col));
    }
    jac_store(ox, oy, oz, ncols, col, a2);
}

#ifdef __CUDACC__
__global__ void sum_rows_kernel(FoldJobs jobs) {
    int j = 0;
    while (j + 1 < jobs.n && (long)blockIdx.x >= jobs.job[j + 1].block0) j++;
    const FoldJob& jb = jobs.job[j];
    const long t = ((long)blockIdx.x - jb.block0) * blockDim.x + threadIdx.x;
    const long col = t / ZG_FOLD_GROUP;
    if (col < jb.ncols)
        sum_rows_lane(col, (int)(t % ZG_FOLD_GROUP), jb.x, jb.y, jb.z, jb.ox, jb.oy, jb.oz,
                      jb.rows, jb.ncols);
}

__global__ void weighted_fold_kernel(const uint32_t* x, const uint32_t* y,
                                     const uint32_t* z, const uint32_t* bx,
                                     const uint32_t* by, const uint32_t* bz,
                                     uint32_t* ox, uint32_t* oy, uint32_t* oz,
                                     long rows, long ncols) {
    long col = ZG_COL_INDEX;
    if (col < ncols)
        weighted_fold_column(col, x, y, z, bx, by, bz, ox, oy, oz, rows, ncols);
}
#endif

#define ZG_FOLD_THREADS 32

// planes: for each of the njobs folds, its x, y, z rows and its ox, oy, oz
// results (six pointers a job); rows[j], ncols[j] its shape. Returns 1
// (cudaErrorInvalidValue) unless there are one or two jobs.
extern "C" int zg_sum_rows(const void* const* planes, const long* rows,
                           const long* ncols, int njobs, void* stream) {
    if (njobs < 1 || njobs > ZG_FOLD_MAX_JOBS) return 1;
    FoldJobs jobs;
    jobs.n = 0;
    long blocks = 0;
    // the longer fold first, so that its blocks start first
    const int first = (njobs == 2 && rows[1] > rows[0]) ? 1 : 0;
    for (int k = 0; k < njobs; k++) {
        const int pick = k == 0 ? first : 1 - first;
        if (ncols[pick] <= 0) continue;
        FoldJob& jb = jobs.job[jobs.n++];
        const void* const* p = planes + 6 * pick;
        jb.x = (const uint32_t*)p[0];
        jb.y = (const uint32_t*)p[1];
        jb.z = (const uint32_t*)p[2];
        jb.ox = (uint32_t*)p[3];
        jb.oy = (uint32_t*)p[4];
        jb.oz = (uint32_t*)p[5];
        jb.rows = rows[pick];
        jb.ncols = ncols[pick];
        jb.block0 = blocks;
        blocks += (ncols[pick] * ZG_FOLD_GROUP + ZG_FOLD_THREADS - 1) / ZG_FOLD_THREADS;
    }
#ifdef __CUDACC__
    if (blocks > 0)
        sum_rows_kernel<<<(unsigned)blocks, ZG_FOLD_THREADS, 0, (cudaStream_t)stream>>>(
            jobs);
    return (int)cudaGetLastError();
#else
    (void)stream;
    for (int j = 0; j < jobs.n; j++) {
        const FoldJob& jb = jobs.job[j];
        for (long col = 0; col < jb.ncols; col++)
            sum_rows_lane(col, 0, jb.x, jb.y, jb.z, jb.ox, jb.oy, jb.oz, jb.rows,
                          jb.ncols);
    }
    return 0;
#endif
}

extern "C" int zg_weighted_fold(const void* x, const void* y, const void* z,
                                const void* bx, const void* by, const void* bz,
                                void* ox, void* oy, void* oz, long rows, long ncols,
                                void* stream) {
#ifdef __CUDACC__
    if (ncols > 0)
        weighted_fold_kernel<<<ZG_BLOCKS(ncols, ZG_FOLD_THREADS), ZG_FOLD_THREADS, 0,
                               (cudaStream_t)stream>>>(
            (const uint32_t*)x, (const uint32_t*)y, (const uint32_t*)z,
            (const uint32_t*)bx, (const uint32_t*)by, (const uint32_t*)bz,
            (uint32_t*)ox, (uint32_t*)oy, (uint32_t*)oz, rows, ncols);
    return (int)cudaGetLastError();
#else
    (void)stream;
    for (long col = 0; col < ncols; col++)
        weighted_fold_column(col, (const uint32_t*)x, (const uint32_t*)y,
                             (const uint32_t*)z, (const uint32_t*)bx,
                             (const uint32_t*)by, (const uint32_t*)bz, (uint32_t*)ox,
                             (uint32_t*)oy, (uint32_t*)oz, rows, ncols);
    return 0;
#endif
}
