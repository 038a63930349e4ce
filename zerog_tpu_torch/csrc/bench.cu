// Kernels 8 and 9: the fused chain of field products and the flush-scan
// bisection, two measuring kernels.
//
// zg_field_chain replaces fused16 (scripts/bench_pallas_field.py, body
// `kernel`): x <- x * b (Montgomery) k times an element in one launch, so
// that no word goes to device memory between the products. One thread an
// element over word planes uint32[8, n]. An element reads 64 bytes, writes
// 32 and does k products of 256 multiply-add pipe slots each (its SASS:
// 119 IMAD.WIDE of two slots, 18 IMAD of one); at k = 16 the operations
// bound it (0.064 ms at n = 2^18 against 0.0075 ms of bytes), and its loop is
// where the count of a product is read. The design is the plainest
// one that reaches that bound if the card can: every thread independent,
// coalesced planes, the chain in registers. Its time at full occupancy
// against the latency of one dependent chain says what a product costs the
// card when it is full.
//
// zg_scan_bisect replaces the four bodies of bench_pscan_bisect.py (`run`:
// k_trivial, k_mul, k_mul_reg, k_madd), which bisect the TPU flush scan. The
// stream is word planes uint32[R, 8, C], the flags one byte each [R, C];
// every row writes the carry's x to out [R, 8, C]. Bodies, one kernel each:
//   trivial   the carry is the running sum of the rows, word by word mod 2^32
//             (bound by bytes: 64 R C). A running sum mod 2^32 is exact in
//             any grouping, so one thread owns a word lane (8 C of them) and
//             chunks of 32 rows are loaded together and joined by a prefix of
//             the chunk totals in shared memory: the rows are in flight
//             together, not one round trip a row;
//   mul_smem  carry <- carry * x_r (Fq) from x_0: a chunked scan whose chunk
//             results meet in shared memory (see its note below);
//   mul_reg   the same function as a chunked scan whose chunk results meet
//             in registers, by warp shuffles (see its note below);
//   madd      carry <- jac_madd_incomplete(carry, x_r, y_r, flag_r != 0) from
//             (x_0, y_0, 0), kernel 2's mixed add: only the valid rows cost
//             products (see its note below).
#include "field.cuh"

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

// ---- mul_smem: the prefix product as a chunked scan ------------------------------
// Replaces k_mul (bench_pscan_bisect.py:87): carry <- carry * x_r from
// carry = x_0, the carry after every row written. Bound on the card by bytes
// (64 R C: a row of x read, the carry written; its R C products take a
// third of that at the card's integer peak). Walked in order, a column is a
// chain of R dependent products (~0.43 us each), which at C = 2,560 leaves
// the card nearly idle. The Montgomery product is exact on canonical
// operands, so it is associative: mont(mont(a, b), c) = a b c R^-2 =
// mont(a, mont(b, c)) mod q, and the prefix may be regrouped with every word
// unchanged. The design cuts a column's rows into K chunks of
// L = ceil(R / K) rows. Neighbouring threads own neighbouring columns of one
// chunk, so every word plane's loads and stores coalesce; a block of
// ZG_MUL_THREADS holds all K chunks of ZG_MUL_THREADS / K columns. Pass 1:
// chunk 0 walks its rows from x_0 and writes them; chunk c > 0 reduces its
// rows to their product T_c. The results meet in shared memory (the carry in
// shared memory that the body's name stands for) and are joined by a
// log-depth prefix (log2 K rounds of one product a thread); chunk c then
// walks its rows again from the product of the results before it (reading x
// a second time, from L2) and writes them. That is about 2 R C products with
// a chain of 2 L + log2 K, against R C products with a chain of R. A chain
// of products runs at full rate only with ~20 warps an SM in flight, so K is
// the least power of two that puts ZG_MUL_FILL threads in flight (at most
// ZG_MUL_MAX_CHUNKS, chunks of at least ZG_MUL_MIN_ROWS rows): 32 at
// C = 2,560, 8 at 20,480. Rows are loaded ZG_MUL_AHEAD ahead of their
// product.
#define ZG_MUL_THREADS 256    // a block: K chunks of ZG_MUL_THREADS / K columns
#define ZG_MUL_MAX_CHUNKS 32  // so that a chunk spans >= 8 columns, whole 32-byte sectors
#define ZG_MUL_MIN_ROWS 8     // rows of a chunk, at least
#define ZG_MUL_FILL 131072    // threads in flight that fill the card
#define ZG_MUL_AHEAD 2        // rows loaded ahead of their product

// K, the chunks of a column: a power of two.
ZG_HD int mul_chunks(long rows, long ncols) {
    int k = 1;
    while (k < ZG_MUL_MAX_CHUNKS && (long)k * ncols < ZG_MUL_FILL &&
           2L * k * ZG_MUL_MIN_ROWS <= rows)
        k *= 2;
    return k;
}

// Rows [r0, r1) of chunk c of k; empty past the last row.
ZG_HD void mul_chunk_rows(long rows, int k, int c, long& r0, long& r1) {
    const long len = (rows + k - 1) / k;
    r0 = c * len;
    r1 = r0 + len < rows ? r0 + len : rows;
}

// carry * x_r for the rows r of [r0, r1) in order, each written to out if
// `store`; returns the last carry.
ZG_HD Fe mul_walk(Fe carry, const uint32_t* sx, uint32_t* out, long r0, long r1,
                  long ncols, long col, bool store) {
    const long row_words = (long)ZG_NW * ncols;
    Fe ahead[ZG_MUL_AHEAD];
#pragma unroll
    for (int a = 0; a < ZG_MUL_AHEAD; a++)
        ahead[a] = r0 + a < r1 ? fe_load(sx + (r0 + a) * row_words, ncols, col) : fe_zero();
#pragma unroll 1
    for (long r = r0; r < r1; r++) {
        const Fe x = ahead[0];
#pragma unroll
        for (int a = 0; a + 1 < ZG_MUL_AHEAD; a++) ahead[a] = ahead[a + 1];
        const long rn = r + ZG_MUL_AHEAD;
        ahead[ZG_MUL_AHEAD - 1] =
            rn < r1 ? fe_load(sx + rn * row_words, ncols, col) : fe_zero();
        carry = fe_mul<0>(carry, x);
        if (store) fe_store(out + r * row_words, ncols, col, carry);
    }
    return carry;
}

// Pass 1 of chunk c, rows [r0, r1): chunk 0 walks its rows from x_0 and
// writes them, another chunk reduces its rows to their product. Returns the
// chunk's result (chunk 0: its last carry; no rows: the Montgomery one,
// which leaves a product as it is).
ZG_HD Fe mul_chunk_first(int c, const uint32_t* sx, uint32_t* out, long r0, long r1,
                         long ncols, long col) {
    if (r0 >= r1) return fe_one<0>();
    const Fe first = fe_load(sx + r0 * ZG_NW * ncols, ncols, col);
    return c == 0 ? mul_walk(first, sx, out, r0, r1, ncols, col, true)
                  : mul_walk(first, sx, out, r0 + 1, r1, ncols, col, false);
}

// ---- mul_reg: the prefix product as a chunked scan joined in registers ------------
// Replaces k_mul_reg (bench_pscan_bisect.py:104), the register-carry variant
// of k_mul: the same function as mul_smem, whose bound and regrouping hold
// here too. The chunk results of a column meet inside one warp, by
// __shfl_up_sync of their 8 words: no shared memory, no block barrier. A
// warp owns ZG_MULREG_SPAN neighbouring columns, and lane group g (lanes
// 8 g .. 8 g + 7, one column each) owns chunks g J .. g J + J - 1 of its
// column (J = ZG_MULREG_CHAINS), K = 4 J = 8 chunks of L = ceil(R / 8) rows
// (mul_chunk_rows). The eight lanes of a group load the same row of the same
// word plane for eight neighbouring columns: whole 32-byte sectors. A thread
// walks its J chunks side by side, J independent carries, each step's J
// products in one basic block; each step's rows are loaded during the step
// before, and the planes are __restrict__, so that no load waits on an
// earlier store. Pass 1: chunk 0 walks its rows from x_0 and writes them,
// every other chunk reduces its rows to their product. The join: each
// thread's prefix of its J results (J - 1 products), an inclusive scan of the
// threads' totals over the four groups (two rounds of a shuffle and a
// product), the total of the groups before g by one more shuffle, and the
// start of each chunk (one product). Pass 2: chunk c > 0 walks its rows again
// from its start (reading x a second time) and writes them. About 2 R C
// products (a thread 2 R / 4), a chain of 2 L + J + 2. At C = 2,560 there are
// only C / 8 = 320 warps, one to a warp scheduler, each issuing its products
// alone: ptxas stalls a warp 4 cycles after each IMAD.WIDE, ~760 cycles a
// product, against the multiply-add pipe's 512. J = 4 chains, the J products
// interleaved step by step in the source, 16-column warps (K = 4), one-warp
// blocks, rows loaded two steps ahead or unconditionally, and x read once
// from registers (8-row chunks, 226 registers) were all measured slower on
// the card at 2,560 or 20,480 columns, or both.
#define ZG_MULREG_SPAN 8      // columns of a warp: a 32-byte sector a row and word plane
#define ZG_MULREG_GROUPS 4    // lane groups of a warp, 32 / ZG_MULREG_SPAN
#define ZG_MULREG_CHAINS 2    // J: the chunks a thread walks side by side
#define ZG_MULREG_CHUNKS (ZG_MULREG_GROUPS * ZG_MULREG_CHAINS)  // K, a column's chunks
#define ZG_MULREG_THREADS 128 // a block: four warps

// J chains side by side: step i multiplies carry j by row s_j + i while that
// row is below e_j, and writes the carry there if bit j of `store` is set.
// The J products of a step are computed whatever the rows, and kept where
// the row is one of the chain's, so that they share one basic block.
ZG_HD void mul_reg_walk(Fe (&carry)[ZG_MULREG_CHAINS], const long (&s)[ZG_MULREG_CHAINS],
                        const long (&e)[ZG_MULREG_CHAINS], unsigned store, long steps,
                        const uint32_t* __restrict__ sx, uint32_t* __restrict__ out,
                        long ncols, long col) {
    const long row_words = (long)ZG_NW * ncols;
    Fe x[ZG_MULREG_CHAINS];
#pragma unroll
    for (int j = 0; j < ZG_MULREG_CHAINS; j++)
        x[j] = s[j] < e[j] ? fe_load(sx + s[j] * row_words, ncols, col) : fe_zero();
#pragma unroll 1
    for (long i = 0; i < steps; i++) {
        Fe nx[ZG_MULREG_CHAINS], p[ZG_MULREG_CHAINS];
#pragma unroll
        for (int j = 0; j < ZG_MULREG_CHAINS; j++) {
            const long r = s[j] + i + 1;
            nx[j] = r < e[j] ? fe_load(sx + r * row_words, ncols, col) : fe_zero();
        }
#pragma unroll
        for (int j = 0; j < ZG_MULREG_CHAINS; j++) p[j] = fe_mul<0>(carry[j], x[j]);
#pragma unroll
        for (int j = 0; j < ZG_MULREG_CHAINS; j++) {
            const long r = s[j] + i;
            if (r < e[j]) {
                carry[j] = p[j];
                if ((store >> j) & 1u) fe_store(out + r * row_words, ncols, col, carry[j]);
            }
            x[j] = nx[j];
        }
    }
}

// Pass 1 of lane group g's chunks: t[j] is chunk g J + j's result (chunk 0:
// its last carry, written row by row; another chunk: the product of its rows;
// no rows, or a column past the last: the Montgomery one).
ZG_HD void mul_reg_first(int g, bool live, const uint32_t* __restrict__ sx,
                         uint32_t* __restrict__ out, long rows, long ncols, long col,
                         Fe (&t)[ZG_MULREG_CHAINS]) {
    long s[ZG_MULREG_CHAINS], e[ZG_MULREG_CHAINS];
#pragma unroll
    for (int j = 0; j < ZG_MULREG_CHAINS; j++) {
        const int c = g * ZG_MULREG_CHAINS + j;
        long r0, r1;
        mul_chunk_rows(rows, ZG_MULREG_CHUNKS, c, r0, r1);
        if (!live || r0 >= r1) {
            t[j] = fe_one<0>();
            s[j] = e[j] = 0;
        } else {
            t[j] = fe_load(sx + r0 * ZG_NW * ncols, ncols, col);
            s[j] = c == 0 ? r0 : r0 + 1;
            e[j] = r1;
        }
    }
    mul_reg_walk(t, s, e, g == 0 ? 1u : 0u, (rows + ZG_MULREG_CHUNKS - 1) / ZG_MULREG_CHUNKS,
                 sx, out, ncols, col);
}

// q[j] = t[0] t[1] .. t[j], the thread's inclusive prefix.
ZG_HD void mul_reg_prefix(const Fe (&t)[ZG_MULREG_CHAINS], Fe (&q)[ZG_MULREG_CHAINS]) {
    q[0] = t[0];
#pragma unroll
    for (int j = 1; j < ZG_MULREG_CHAINS; j++) q[j] = fe_mul<0>(q[j - 1], t[j]);
}

// Pass 2 of lane group g's chunks from `before`, the product of the results
// of the groups before g (group 0: the Montgomery one): chunk g J + j starts
// from before q[j - 1] (j > 0) or `before` (j = 0) and writes its rows.
// Chunk 0 was written in pass 1.
ZG_HD void mul_reg_second(int g, bool live, const Fe& before,
                          const Fe (&q)[ZG_MULREG_CHAINS], const uint32_t* __restrict__ sx,
                          uint32_t* __restrict__ out, long rows, long ncols, long col) {
    Fe carry[ZG_MULREG_CHAINS];
    long s[ZG_MULREG_CHAINS], e[ZG_MULREG_CHAINS];
#pragma unroll
    for (int j = 0; j < ZG_MULREG_CHAINS; j++) {
        const int c = g * ZG_MULREG_CHAINS + j;
        mul_chunk_rows(rows, ZG_MULREG_CHUNKS, c, s[j], e[j]);
        if (!live || c == 0) s[j] = e[j] = 0;
        carry[j] = j == 0 ? before : fe_mul<0>(before, q[j - 1]);
    }
    mul_reg_walk(carry, s, e, (1u << ZG_MULREG_CHAINS) - 1u,
                 (rows + ZG_MULREG_CHUNKS - 1) / ZG_MULREG_CHUNKS, sx, out, ncols, col);
}

// ---- madd: a chain of mixed adds that skips what changes nothing ---------------
// Replaces k_madd (bench_pscan_bisect.py:121). The flag is the valid bit, and
// for an invalid row jac_madd_incomplete returns the carry as it is, so only
// the valid rows cost products. What they need (11 products each after the
// column's first; x and y of the valid rows read, x of every row written)
// would take the card ~0.03 ms. What bounds the design is the chain: the
// column with the most valid rows takes one dependent mixed add after
// another. So the add's latency is shared: a group of ZG_MADD_GROUP threads
// owns a column and runs kernel 2's levels (madd_finish_start, add_level), a
// valid row's levels 1-2 beside levels 4-5 of the valid row before, so that
// a step is three rounds of at most four products, exchanged by shuffles.
// The walk goes from one valid row to the next by the set bits of a word,
// the valid bytes of a block of 32 rows loaded a block ahead, and the next
// valid row's x and y are loaded into registers during the step before
// (6 % faster on the card than staging them into shared memory by
// cp.async). A step writes the x of the add it finishes at that add's row
// only. The rows in between get it once the block's 32 columns have been
// walked: the block fills them from there (x_0 before the first valid row),
// a warp on 32 neighbouring columns of one word, so that every store writes
// a whole 128-byte line (a fill by the 8 columns of one walking warp writes
// 32-byte pieces of lines: 25 % slower at 20,480 columns). Every group of a
// warp steps until the longest of its eight columns ends, and a block fills
// after its longest of 32: accepted, since the card's time is its longest
// column's.
#define ZG_MADD_GROUP 4      // threads that share a column's adds
#define ZG_MADD_THREADS 128  // a block: four warps, 32 columns
#define ZG_FLAG_ROWS 32      // a block of rows whose valid bytes make one word

ZG_HD int zg_ctz(uint32_t x) {
#ifdef __CUDA_ARCH__
    return __ffs(x) - 1;
#else
    return __builtin_ctz(x);
#endif
}

// Thread j of a group of G loads the valid bytes of rows r0 + j + G t
// (t < 32 / G) of column col; the loads stay in flight until madd_flag_bits
// reads them.
template <int G>
ZG_HD void madd_flag_loads(uint32_t (&f)[ZG_FLAG_ROWS / G], const uint8_t* flags, long r0,
                           long rows, long ncols, long col, int j) {
#pragma unroll
    for (int t = 0; t < ZG_FLAG_ROWS / G; t++) {
        const long r = r0 + j + (long)t * G;
        f[t] = r < rows ? flags[r * ncols + col] : 0u;
    }
}

// The block's valid rows as the bits of one word, the same in every thread
// of the group.
template <int G>
ZG_HD uint32_t madd_flag_bits(const uint32_t (&f)[ZG_FLAG_ROWS / G], int j) {
    uint32_t b = 0u;
#pragma unroll
    for (int t = 0; t < ZG_FLAG_ROWS / G; t++) b |= (uint32_t)(f[t] != 0u) << (j + t * G);
#ifdef __CUDA_ARCH__
    const unsigned base = (threadIdx.x & 31u) & ~(unsigned)(G - 1);
    const unsigned mask = ((1u << G) - 1u) << base;
#pragma unroll
    for (int d = 1; d < G; d *= 2) b |= __shfl_xor_sync(mask, b, d);
#endif
    return b;
}

// Where a column's walk stands in its valid bytes.
template <int G>
struct MaddFlags {
    long r0;                           // the first row of the block of `bits`
    uint32_t bits;                     // its valid rows not taken yet
    uint32_t ahead[ZG_FLAG_ROWS / G];  // the next block's bytes, in flight
};

// The column's next valid row, or `rows` past its last. Entering a block
// reads the bytes loaded a block ahead and loads the next block's.
template <int G>
ZG_HD long madd_next_valid(MaddFlags<G>& fl, const uint8_t* flags, long rows, long ncols,
                           long col, int j) {
    while (fl.bits == 0u) {
        if (fl.r0 + ZG_FLAG_ROWS >= rows) return rows;
        fl.r0 += ZG_FLAG_ROWS;
        fl.bits = madd_flag_bits<G>(fl.ahead, j);
        madd_flag_loads<G>(fl.ahead, flags, fl.r0 + ZG_FLAG_ROWS, rows, ncols, col, j);
    }
    const int i = zg_ctz(fl.bits);
    fl.bits &= fl.bits - 1u;
    return fl.r0 + i;
}

// A column's walk through its valid rows.
struct MaddWalk {
    Jac carry;      // the carry after the last add finished
    bool inflight;  // an add to it has run levels 1-3: half
    Fe half[4];     // h, hh, s2 and z3 = Z1 H of the add in flight
    long pend;      // the valid row last taken, whose x is not written yet (-1: none)
};

// One step of the walk: levels 4-5 of the add in flight beside levels 1-2 of
// valid row v's add (qx, qy), then level 3 of v's: three rounds, whatever the
// step needs, so that the groups of a warp stay in step. The finished add's
// x is written to its row, `pend` (thread j: words j + G m). v < 0: the
// column's end, where the add in flight finishes and none starts. The
// selects of jac_madd_incomplete decide what is kept: a carry whose z is 0
// becomes (qx, qy, 1).
template <int G>
ZG_HD void madd_walk_step(MaddWalk& wk, const Fe& qx, const Fe& qy, long v, uint32_t* out,
                          long ncols, long col, int j) {
    // the z of the carry before row v, known three levels into an add
    const Fe zc = fe_select(wk.inflight, wk.half[3], wk.carry.z);
    Fe u2, zz;
    {
        const Fe half[4] = {wk.half[0], wk.half[1], wk.half[2], zc};
        const Jac done = madd_finish_start<G>(wk.carry, half, qx, u2, zz, j);
        if (wk.inflight) wk.carry = done;
    }
    if (wk.pend >= 0) {
        uint32_t* o = out + wk.pend * ZG_NW * ncols + col;
#pragma unroll
        for (int k = 0; k < ZG_NW; k++)
            if (k % G == j) o[(long)k * ncols] = wk.carry.x.w[k];
    }
    wk.inflight = false;
    wk.pend = v;
    if (v < 0) return;
    const Fe h = fe_sub<0>(u2, wk.carry.x);
    Fe lc[3];
    {
        const Fe a[3] = {qy, h, wk.carry.z}, b[3] = {zz, h, h};
        add_level<3, G>(j, a, b, lc);
    }
    if (fe_is_zero(zc)) {
        wk.carry = jac_from_affine(qx, qy, true);
    } else {
        wk.half[0] = h;
        wk.half[1] = lc[1];
        wk.half[2] = lc[0];
        wk.half[3] = lc[2];
        wk.inflight = true;
    }
}

// The valid rows' words (j + P m) of the block of 32 rows at o (bit i of
// `bits`: row i), loaded together; 0 for the others.
template <int P>
ZG_HD void madd_fill_load(uint32_t (&xv)[ZG_FLAG_ROWS][ZG_NW / P], const uint32_t* o,
                          uint32_t bits, long row_words, long ncols, int j) {
#pragma unroll
    for (int i = 0; i < ZG_FLAG_ROWS; i++)
#pragma unroll
        for (int m = 0; m < ZG_NW / P; m++)
            xv[i][m] = (bits >> i) & 1u ? o[i * row_words + (long)(j + m * P) * ncols] : 0u;
}

// Words j + P m of every row of column col: the x that the walk wrote at
// each valid row, carried down the rows after it, x_0 before the first. A
// block of 32 rows is written while the next block's valid words are in
// flight, its valid bytes loaded a block earlier still. On the card the
// threads of a warp fill 32 neighbouring columns, so that every store
// writes a whole 128-byte line.
template <int P>
ZG_HD void madd_fill(long col, int j, const uint32_t* sx, const uint8_t* flags,
                     uint32_t* out, long rows, long ncols) {
    const long row_words = (long)ZG_NW * ncols;
    uint32_t cur[ZG_NW / P];
#pragma unroll
    for (int m = 0; m < ZG_NW / P; m++) cur[m] = sx[(long)(j + m * P) * ncols + col];
    uint32_t f[ZG_FLAG_ROWS];
    madd_flag_loads<1>(f, flags, 0, rows, ncols, col, 0);
    uint32_t bits = madd_flag_bits<1>(f, 0);
    madd_flag_loads<1>(f, flags, ZG_FLAG_ROWS, rows, ncols, col, 0);
    uint32_t xv[ZG_FLAG_ROWS][ZG_NW / P];
    madd_fill_load<P>(xv, out + col, bits, row_words, ncols, j);
#pragma unroll 1
    for (long r0 = 0; r0 < rows; r0 += ZG_FLAG_ROWS) {
        const uint32_t nbits = madd_flag_bits<1>(f, 0);
        madd_flag_loads<1>(f, flags, r0 + 2 * ZG_FLAG_ROWS, rows, ncols, col, 0);
        uint32_t nxv[ZG_FLAG_ROWS][ZG_NW / P];
        madd_fill_load<P>(nxv, out + (r0 + ZG_FLAG_ROWS) * row_words + col, nbits, row_words,
                          ncols, j);
        uint32_t* o = out + r0 * row_words + col;
#pragma unroll
        for (int i = 0; i < ZG_FLAG_ROWS; i++) {
            if (r0 + i >= rows) break;
#pragma unroll
            for (int m = 0; m < ZG_NW / P; m++) {
                if ((bits >> i) & 1u) cur[m] = xv[i][m];
                o[i * row_words + (long)(j + m * P) * ncols] = cur[m];
            }
        }
        bits = nbits;
#pragma unroll
        for (int i = 0; i < ZG_FLAG_ROWS; i++)
#pragma unroll
            for (int m = 0; m < ZG_NW / P; m++) xv[i][m] = nxv[i][m];
    }
}

// Thread j of the group of G threads that owns column col. The walk takes
// the valid rows in order, the next one's x and y loaded while the group
// steps through the one before; it writes the x of every valid row
// (madd_fill writes the others).
template <int G>
ZG_HD void madd_walk(long col, int j, const uint32_t* sx, const uint32_t* sy,
                     const uint8_t* flags, uint32_t* out, long rows, long ncols) {
    if (rows <= 0) return;
    MaddWalk wk;
    wk.carry.x = fe_load(sx, ncols, col);
    wk.carry.y = fe_load(sy, ncols, col);
    wk.carry.z = fe_zero();
    wk.inflight = false;
#pragma unroll
    for (int k = 0; k < 4; k++) wk.half[k] = fe_zero();
    wk.pend = -1;
    MaddFlags<G> fl;
    fl.r0 = -ZG_FLAG_ROWS;
    fl.bits = 0u;
    madd_flag_loads<G>(fl.ahead, flags, 0, rows, ncols, col, j);
    long v = madd_next_valid<G>(fl, flags, rows, ncols, col, j);
    const long row_words = (long)ZG_NW * ncols;
    Fe qx = fe_zero(), qy = fe_zero();
    if (v < rows) {
        qx = fe_load(sx + v * row_words, ncols, col);
        qy = fe_load(sy + v * row_words, ncols, col);
    }
#pragma unroll 1
    for (;;) {
        // the next valid row's x and y, in flight during this step
        const long nv = v < rows ? madd_next_valid<G>(fl, flags, rows, ncols, col, j) : rows;
        Fe nqx = fe_zero(), nqy = fe_zero();
        if (nv < rows) {
            nqx = fe_load(sx + nv * row_words, ncols, col);
            nqy = fe_load(sy + nv * row_words, ncols, col);
        }
        madd_walk_step<G>(wk, qx, qy, v < rows ? v : -1, out, ncols, col, j);
        qx = nqx;
        qy = nqy;
        if (v >= rows) break;
        v = nv;
    }
}

#ifdef __CUDACC__
template <int F>
__global__ void field_chain_kernel(const uint32_t* a, const uint32_t* b, uint32_t* out,
                                   long n, int k) {
    const long col = ZG_COL_INDEX;
    if (col < n) field_chain_column<F>(col, a, b, out, n, k);
}

__device__ __forceinline__ Fe fe_shfl_up(const Fe& a, unsigned delta) {
    Fe r;
#pragma unroll
    for (int k = 0; k < ZG_NW; k++) r.w[k] = __shfl_up_sync(0xffffffffu, a.w[k], delta);
    return r;
}

// Warp w owns columns ZG_MULREG_SPAN w ..; lane group g owns chunks
// g J .. g J + J - 1 of its column. Every lane takes part in the shuffles, a
// column past the last with the Montgomery one.
__global__ void __launch_bounds__(ZG_MULREG_THREADS)
scan_bisect_mul_reg_kernel(const uint32_t* __restrict__ sx, uint32_t* __restrict__ out,
                           long rows, long ncols) {
    const int lane = threadIdx.x % 32;
    const int g = lane / ZG_MULREG_SPAN;
    const long col = ZG_COL_INDEX / 32 * ZG_MULREG_SPAN + lane % ZG_MULREG_SPAN;
    const bool live = col < ncols;
    Fe t[ZG_MULREG_CHAINS], q[ZG_MULREG_CHAINS];
    mul_reg_first(g, live, sx, out, rows, ncols, col, t);
    mul_reg_prefix(t, q);
    // inclusive scan of the threads' totals over the groups (Hillis-Steele)
    Fe s = q[ZG_MULREG_CHAINS - 1];
#pragma unroll
    for (int d = 1; d < ZG_MULREG_GROUPS; d *= 2) {
        const Fe m = fe_mul<0>(fe_shfl_up(s, d * ZG_MULREG_SPAN), s);
        s = fe_select(g >= d, m, s);
    }
    const Fe before = fe_select(g > 0, fe_shfl_up(s, ZG_MULREG_SPAN), fe_one<0>());
    mul_reg_second(g, live, before, q, sx, out, rows, ncols, col);
}

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
// Block: ZG_MUL_THREADS threads, `chunks` chunks of ZG_MUL_THREADS / chunks
// neighbouring columns; word k of thread t's prefix at
// tot[k * ZG_MUL_THREADS + t]. Every thread takes part in the prefix, a
// column past the last or a chunk without rows with the Montgomery one.
__global__ void __launch_bounds__(ZG_MUL_THREADS)
scan_bisect_mul_smem_kernel(const uint32_t* sx, uint32_t* out, long rows, long ncols,
                            int chunks) {
    __shared__ uint32_t tot[ZG_NW * ZG_MUL_THREADS];
    const int t = threadIdx.x;
    const int span = ZG_MUL_THREADS / chunks;
    const int c = t / span;
    const long col = (long)blockIdx.x * span + t % span;
    long r0, r1;
    mul_chunk_rows(rows, chunks, c, r0, r1);
    const bool live = col < ncols && r0 < r1;
    Fe s = live ? mul_chunk_first(c, sx, out, r0, r1, ncols, col) : fe_one<0>();
    fe_store(tot, ZG_MUL_THREADS, t, s);
    __syncthreads();
    // inclusive prefix of the chunk results over c (Hillis-Steele)
#pragma unroll 1
    for (int d = 1; d < chunks; d *= 2) {
        Fe before;
        if (c >= d) before = fe_load(tot + t - d * span, ZG_MUL_THREADS, 0);
        __syncthreads();
        if (c >= d) {
            s = fe_mul<0>(before, s);
            fe_store(tot, ZG_MUL_THREADS, t, s);
        }
        __syncthreads();
    }
    if (live && c > 0)
        mul_walk(fe_load(tot + t - span, ZG_MUL_THREADS, 0), sx, out, r0, r1, ncols, col,
                 true);
}

// Block: ZG_MADD_THREADS / ZG_MADD_GROUP columns. Each group walks its
// column; once the block's walks are done (their writes seen by the block),
// warp w fills words w + 4 m of the block's columns, a column a lane.
__global__ void __launch_bounds__(ZG_MADD_THREADS)
scan_bisect_madd_kernel(const uint32_t* sx, const uint32_t* sy, const uint8_t* flags,
                        uint32_t* out, long rows, long ncols) {
    const long col0 = (long)blockIdx.x * (ZG_MADD_THREADS / ZG_MADD_GROUP);
    const int t = threadIdx.x;
    if (col0 + t / ZG_MADD_GROUP < ncols)
        madd_walk<ZG_MADD_GROUP>(col0 + t / ZG_MADD_GROUP, t % ZG_MADD_GROUP, sx, sy, flags,
                                 out, rows, ncols);
    __syncthreads();
    if (col0 + t % 32 < ncols)
        madd_fill<ZG_MADD_THREADS / 32>(col0 + t % 32, t / 32, sx, flags, out, rows, ncols);
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


// The device's chunks one after another: pass 1 of every chunk, the prefix
// of their results in the device's rounds, then pass 2.
static void scan_bisect_mul_smem_host(const uint32_t* sx, uint32_t* out, long rows,
                                      long ncols) {
    const int k = mul_chunks(rows, ncols);
    Fe s[ZG_MUL_MAX_CHUNKS];
    for (long col = 0; col < ncols; col++) {
        long r0, r1;
        for (int c = 0; c < k; c++) {
            mul_chunk_rows(rows, k, c, r0, r1);
            s[c] = mul_chunk_first(c, sx, out, r0, r1, ncols, col);
        }
        for (int d = 1; d < k; d *= 2)
            for (int c = k - 1; c >= d; c--) s[c] = fe_mul<0>(s[c - d], s[c]);
        for (int c = 1; c < k; c++) {
            mul_chunk_rows(rows, k, c, r0, r1);
            if (r0 < r1) mul_walk(s[c - 1], sx, out, r0, r1, ncols, col, true);
        }
    }
}

// The device's plan one column at a time: pass 1 of the four lane groups'
// chunks, each group's prefix, the scan over the groups in the device's
// rounds, then pass 2.
static void scan_bisect_mul_reg_host(const uint32_t* sx, uint32_t* out, long rows,
                                     long ncols) {
    Fe t[ZG_MULREG_GROUPS][ZG_MULREG_CHAINS], q[ZG_MULREG_GROUPS][ZG_MULREG_CHAINS];
    Fe s[ZG_MULREG_GROUPS];
    for (long col = 0; col < ncols; col++) {
        for (int g = 0; g < ZG_MULREG_GROUPS; g++) {
            mul_reg_first(g, true, sx, out, rows, ncols, col, t[g]);
            mul_reg_prefix(t[g], q[g]);
            s[g] = q[g][ZG_MULREG_CHAINS - 1];
        }
        for (int d = 1; d < ZG_MULREG_GROUPS; d *= 2)
            for (int g = ZG_MULREG_GROUPS - 1; g >= d; g--) s[g] = fe_mul<0>(s[g - d], s[g]);
        for (int g = 0; g < ZG_MULREG_GROUPS; g++)
            mul_reg_second(g, true, g > 0 ? s[g - 1] : fe_one<0>(), q[g], sx, out, rows,
                           ncols, col);
    }
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
    cudaStream_t st = (cudaStream_t)stream;
    if (ncols > 0 && body == ZG_BISECT_TRIVIAL) {
        const dim3 block(32, ZG_TRIVIAL_WARPS);
        scan_bisect_trivial_kernel<<<ZG_BLOCKS(ZG_NW * ncols, 32), block, 0, st>>>(
            px, po, rows, ZG_NW * ncols);
    } else if (ncols > 0 && body == ZG_BISECT_MUL_SMEM) {
        const int chunks = mul_chunks(rows, ncols);
        scan_bisect_mul_smem_kernel<<<ZG_BLOCKS(ncols, ZG_MUL_THREADS / chunks),
                                      ZG_MUL_THREADS, 0, st>>>(px, po, rows, ncols, chunks);
    } else if (ncols > 0 && body == ZG_BISECT_MUL_REG) {
        scan_bisect_mul_reg_kernel<<<ZG_BLOCKS(ncols, ZG_MULREG_SPAN * ZG_MULREG_THREADS / 32),
                                     ZG_MULREG_THREADS, 0, st>>>(px, po, rows, ncols);
    } else if (ncols > 0) {
        scan_bisect_madd_kernel<<<ZG_BLOCKS(ncols * ZG_MADD_GROUP, ZG_MADD_THREADS),
                                  ZG_MADD_THREADS, 0, st>>>(px, py, pf, po, rows, ncols);
    }
    return (int)cudaGetLastError();
#else
    (void)stream;
    if (body == ZG_BISECT_TRIVIAL) {
        scan_bisect_trivial_host(px, po, rows, ZG_NW * ncols);
    } else if (body == ZG_BISECT_MUL_SMEM) {
        scan_bisect_mul_smem_host(px, po, rows, ncols);
    } else if (body == ZG_BISECT_MUL_REG) {
        scan_bisect_mul_reg_host(px, po, rows, ncols);
    } else {
        for (long col = 0; col < ncols; col++) {
            madd_walk<1>(col, 0, px, py, pf, po, rows, ncols);
            madd_fill<1>(col, 0, px, pf, po, rows, ncols);
        }
    }
    return 0;
#endif
}
