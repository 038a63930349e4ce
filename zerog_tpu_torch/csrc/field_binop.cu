// Kernel 1: elementwise Montgomery product, modular add and sub over Fq or Fr.
//
// Replaces PField._binary_kernel (zerog_tpu/field/pfield.py), the standalone
// call of the field bodies. Operands are word planes uint32[8, n]: word k of
// element i at [k * n + i]. An element moves 96 bytes against at most 128
// multiply-adds (a product), so on this card every operation is bound by
// bytes; the product's issued instructions come close to that bound too.
//
// The field and the operation are template parameters, so that each launch
// runs one branch-free body. One thread owns one element: its 16 loads (one
// coalesced word a plane and operand) are issued before the product, and a
// grid of one wave of 128-thread blocks keeps ~48 warps an SM at 40
// registers, whose loads overlap the other warps' products. Two or four
// elements a thread (8- or 16-byte loads, 54-150 registers) and a grid of
// the card's size striding with the next element's loads issued ahead were
// each slower on the card (PERF.md).
#include "field.cuh"

#define ZG_BINOP_THREADS 128

// op: 0 = mul, 1 = add, 2 = sub
template <int F, int OP>
ZG_HD void field_binop_column(long col, const uint32_t* a, const uint32_t* b,
                              uint32_t* out, long n) {
    const Fe x = fe_load(a, n, col);
    const Fe y = fe_load(b, n, col);
    Fe r;
    if (OP == 0) r = fe_mul<F>(x, y);
    else if (OP == 1) r = fe_add<F>(x, y);
    else r = fe_sub<F>(x, y);
    fe_store(out, n, col, r);
}

#ifdef __CUDACC__
template <int F, int OP>
__global__ void __launch_bounds__(ZG_BINOP_THREADS)
    field_binop_kernel(const uint32_t* a, const uint32_t* b, uint32_t* out, long n) {
    const long col = ZG_COL_INDEX;
    if (col < n) field_binop_column<F, OP>(col, a, b, out, n);
}
#endif

template <int F, int OP>
static int binop_run(const uint32_t* a, const uint32_t* b, uint32_t* out, long n,
                     void* stream) {
#ifdef __CUDACC__
    field_binop_kernel<F, OP><<<ZG_BLOCKS(n, ZG_BINOP_THREADS), ZG_BINOP_THREADS, 0,
                                (cudaStream_t)stream>>>(a, b, out, n);
    return (int)cudaGetLastError();
#else
    (void)stream;
    for (long col = 0; col < n; col++) field_binop_column<F, OP>(col, a, b, out, n);
    return 0;
#endif
}

template <int F>
static int binop_op(int op, const uint32_t* a, const uint32_t* b, uint32_t* out, long n,
                    void* stream) {
    if (op == 0) return binop_run<F, 0>(a, b, out, n, stream);
    if (op == 1) return binop_run<F, 1>(a, b, out, n, stream);
    return binop_run<F, 2>(a, b, out, n, stream);
}

extern "C" int zg_field_binop(const void* a, const void* b, void* out, long n,
                              int field, int op, void* stream) {
    if (field < 0 || field > 1 || op < 0 || op > 2) return -1;
    if (n <= 0) return 0;
    const uint32_t* pa = (const uint32_t*)a;
    const uint32_t* pb = (const uint32_t*)b;
    uint32_t* po = (uint32_t*)out;
    return field == 0 ? binop_op<0>(op, pa, pb, po, n, stream)
                      : binop_op<1>(op, pa, pb, po, n, stream);
}
