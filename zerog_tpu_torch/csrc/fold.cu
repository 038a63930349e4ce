// Kernels 4 and 5: the MSM bucket folds.
//
// Replace _sum_rows_call and _weighted_call (zerog_tpu/curve/pfold.py). Rows
// are word planes uint32[L, 8, C] (row l, word k, lane c at
// [(l * 8 + k) * C + c]); results and the bias are [8, C]. A lane's rows are
// folded in order with its accumulators in registers, so the add order, and
// with it every limb of the result, equals the plain fold's.
//
// sum_rows:  acc <- infinity; for each row: acc <- acc + row.
// weighted:  a1 <- infinity, a2 <- bias; for each row (k = K-1 .. 0):
//            a2 <- a2 + a1, then a1 <- a1 + row. Returns a2 = bias + sum k*row_k.
// Any number of rows is taken: there is no chunking, so no padded row ever
// repeats the a2 += a1 step.
//
// Both are a chain of dependent adds (16 products each, in five levels,
// jac_add_formulas) over few lanes, so what bounds them on this card is the
// latency of that chain, not bytes or the product rate. A group of
// ZG_FOLD_GROUP threads shares each add, one product of a level each, and an
// add with an identity operand (z = 0) takes the incomplete add's selects
// without a product (jac_add_skip): a row whose z is 0 leaves the
// accumulator as it is, and an accumulator whose z is 0 becomes the row.
//
// sum_rows takes one or two folds (jobs) in one launch, the longer first, so
// that the two fold shapes of an MSM batch run side by side, and one warp a
// block spreads the groups over the multiprocessors. Its time is the longest
// lane's chain: one add for each non-identity row after its first. Most
// bucket slots of an MSM are empty (slot 1 nearly always, and most buckets of
// a witness column of small values).
//
// weighted_fold (16 lanes of 128 rows at the MSM's shape) runs a row's two
// adds side by side, 8 threads a lane, one lane a block, and loads the next
// row while a row is added: a row costs one add's five rounds. Its a2 is a
// chain of K adds whatever the rows hold, so identity rows save time only
// before a lane's first row that is not the identity. A log-depth tree over
// the rows (suffix sums, then a tree sum) would shorten the chain to ~14
// adds, but it gives other Jacobian limbs than zerog_tpu's _pipv2_weighted,
// and its partial sums meet structurally equal operands wherever rows are the
// identity, where the incomplete add is wrong (the bias exists for that,
// zerog_tpu/curve/pippenger.py:174-179); so the rows stay in order.
#include "field.cuh"

#define ZG_FOLD_GROUP 4  // threads that share one add

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

// weighted_fold: a lane's two adds of a row, a2 + a1 and a1 + row, both read
// the a1 of the row before, so on the card they run side by side, each in a
// group of ZG_FOLD_GROUP threads (the outer group, jj < ZG_FOLD_GROUP, owns
// a2); after the row the inner group's new a1 goes to both by shuffles. The
// two groups may branch apart (an add skipped in one only): each group's
// shuffles name its own threads, and the lane's shuffle all eight.
#define ZG_WF_LANE (2 * ZG_FOLD_GROUP)  // threads a lane of weighted_fold, a block

#ifdef __CUDA_ARCH__
// Point p of lane `src` of the warp, to every thread of `mask`.
__device__ __forceinline__ Jac jac_shfl(unsigned mask, const Jac& p, unsigned src) {
    Jac r;
#pragma unroll
    for (int k = 0; k < ZG_NW; k++) {
        r.x.w[k] = __shfl_sync(mask, p.x.w[k], src);
        r.y.w[k] = __shfl_sync(mask, p.y.w[k], src);
        r.z.w[k] = __shfl_sync(mask, p.z.w[k], src);
    }
    return r;
}
#endif

// Lane `col` of a weighted fold; jj: the thread's index among the lane's
// ZG_WF_LANE threads on the card (0 on a host, which runs both adds in one
// thread), the one with jj = 0 stores. Row r + 1 is loaded while row r is
// added. An add with an identity operand (z = 0) takes the incomplete add's
// selects without a product (jac_add_skip): a1 is the identity until the
// first row that is not, so a lane's leading identity rows cost no product.
ZG_HD void weighted_fold_lane(long col, int jj, const uint32_t* x, const uint32_t* y,
                              const uint32_t* z, const uint32_t* bx, const uint32_t* by,
                              const uint32_t* bz, uint32_t* ox, uint32_t* oy,
                              uint32_t* oz, long rows, long ncols) {
    Jac a1 = jac_infinity();
    Jac a2 = jac_load(bx, by, bz, ncols, col);
    const long row_words = (long)ZG_NW * ncols;
#ifdef __CUDA_ARCH__
    // the lane's threads are its block's, lanes 0 .. ZG_WF_LANE - 1 of a warp
    const bool outer = jj < ZG_FOLD_GROUP;
    const int j = jj % ZG_FOLD_GROUP;
    const unsigned mask = (1u << ZG_WF_LANE) - 1u;
    const unsigned inner = ZG_FOLD_GROUP + j;  // thread j of the inner group
#endif
    Jac next = a1;
    if (rows > 0) next = jac_load(x, y, z, ncols, col);
#pragma unroll 1
    for (long r = 0; r < rows; r++) {
        const Jac row = next;
        if (r + 1 < rows) {
            const long off = (r + 1) * row_words;
            next = jac_load(x + off, y + off, z + off, ncols, col);
        }
#ifdef __CUDA_ARCH__
        const Jac s = jac_add_skip<ZG_FOLD_GROUP>(jac_select(outer, a2, a1),
                                                  jac_select(outer, a1, row), j);
        a1 = jac_shfl(mask, s, inner);
        if (outer) a2 = s;
#else
        (void)jj;
        a2 = jac_add_skip<1>(a2, a1, 0);
        a1 = jac_add_skip<1>(a1, row, 0);
#endif
    }
    if (jj == 0) jac_store(ox, oy, oz, ncols, col, a2);
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
    weighted_fold_lane(blockIdx.x, (int)threadIdx.x, x, y, z, bx, by, bz, ox, oy, oz,
                       rows, ncols);
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
    // one lane a block: four lanes a warp ran 1-1.5 % slower (PERF.md)
    if (ncols > 0)
        weighted_fold_kernel<<<(unsigned)ncols, ZG_WF_LANE, 0, (cudaStream_t)stream>>>(
            (const uint32_t*)x, (const uint32_t*)y, (const uint32_t*)z,
            (const uint32_t*)bx, (const uint32_t*)by, (const uint32_t*)bz,
            (uint32_t*)ox, (uint32_t*)oy, (uint32_t*)oz, rows, ncols);
    return (int)cudaGetLastError();
#else
    (void)stream;
    for (long col = 0; col < ncols; col++)
        weighted_fold_lane(col, 0, (const uint32_t*)x, (const uint32_t*)y,
                           (const uint32_t*)z, (const uint32_t*)bx, (const uint32_t*)by,
                           (const uint32_t*)bz, (uint32_t*)ox, (uint32_t*)oy,
                           (uint32_t*)oz, rows, ncols);
    return 0;
#endif
}
