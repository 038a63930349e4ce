/* limbcodec — host codec between Python ints and 16-bit limb arrays.
 *
 * The host keeps field elements as Python ints; the device side of the
 * module boundary is uint32[..., 16]: 16 little-endian 16-bit limbs an
 * element (see field/limbs.py). This extension converts a whole column in
 * one C loop, where the numpy object-array path makes a Python object for
 * every limb:
 *
 *   - ints_to_limbs(list, out_u32_buffer, ctx_or_None)
 *   - limbs_to_ints(in_u32_buffer, count, ctx_or_None) -> list
 *
 * With a ctx the values move into (ints_to_limbs) or out of (limbs_to_ints)
 * Montgomery form, R = 2^256, by one 4 x 64-bit CIOS REDC an element. The
 * field is chosen per call: ctx = (p as 32 bytes little-endian,
 * -p^-1 mod 2^64, R^2 mod p as 32 bytes little-endian), computed by the
 * Python wrapper, so one library serves Fr and Fq.
 *
 * ints_to_limbs refuses what is not a Python int (TypeError) and ints that
 * are negative or >= 2^256 (OverflowError); the caller takes its exact
 * numpy path for those. Plain host C on the CPython API.
 */

#define PY_SSIZE_T_CLEAN
#include <Python.h>
#include <stdint.h>
#include <string.h>

typedef unsigned __int128 u128;

/* ---- 4x64 Montgomery arithmetic ---------------------------------------- */

typedef struct {
    uint64_t p[4];
    uint64_t inv;    /* -p^-1 mod 2^64 */
    uint64_t r2[4];  /* R^2 mod p, R = 2^256 */
} mont_ctx;

static int geq_p(const uint64_t a[4], const uint64_t p[4]) {
    for (int i = 3; i >= 0; i--) {
        if (a[i] > p[i]) return 1;
        if (a[i] < p[i]) return 0;
    }
    return 1;
}

static void sub_p(uint64_t a[4], const uint64_t p[4]) {
    u128 borrow = 0;
    for (int i = 0; i < 4; i++) {
        u128 d = (u128)a[i] - p[i] - (uint64_t)borrow;
        a[i] = (uint64_t)d;
        borrow = (d >> 64) ? 1 : 0;
    }
}

/* out = REDC(a * b) = a b R^-1 mod p (CIOS). With a < 2^256 and b < p the
 * result before the final subtraction is below 2p, so one subtraction makes
 * it canonical. */
static void mont_mul(uint64_t out[4], const uint64_t a[4], const uint64_t b[4],
                     const mont_ctx *ctx) {
    uint64_t t[6] = {0, 0, 0, 0, 0, 0};
    for (int i = 0; i < 4; i++) {
        u128 carry = 0;
        for (int j = 0; j < 4; j++) {
            u128 cur = (u128)a[j] * b[i] + t[j] + (uint64_t)carry;
            t[j] = (uint64_t)cur;
            carry = cur >> 64;
        }
        u128 cur = (u128)t[4] + (uint64_t)carry;
        t[4] = (uint64_t)cur;
        t[5] = (uint64_t)(cur >> 64);

        uint64_t m = t[0] * ctx->inv;
        u128 c0 = (u128)m * ctx->p[0] + t[0];
        carry = c0 >> 64;
        for (int j = 1; j < 4; j++) {
            u128 c = (u128)m * ctx->p[j] + t[j] + (uint64_t)carry;
            t[j - 1] = (uint64_t)c;
            carry = c >> 64;
        }
        u128 c4 = (u128)t[4] + (uint64_t)carry;
        t[3] = (uint64_t)c4;
        t[4] = t[5] + (uint64_t)(c4 >> 64);
        t[5] = 0;
    }
    if (t[4] || geq_p(t, ctx->p)) sub_p(t, ctx->p);
    memcpy(out, t, 32);
}

/* ---- packing helpers ---------------------------------------------------- */

static void bytes_to_u64(const unsigned char b[32], uint64_t w[4]) {
    for (int i = 0; i < 4; i++) {
        uint64_t v = 0;
        for (int j = 7; j >= 0; j--) v = (v << 8) | b[8 * i + j];
        w[i] = v;
    }
}

static void u64_to_bytes(const uint64_t w[4], unsigned char b[32]) {
    for (int i = 0; i < 4; i++)
        for (int j = 0; j < 8; j++) b[8 * i + j] = (unsigned char)(w[i] >> (8 * j));
}

/* 32 little-endian bytes of a non-negative int below 2^256; -1 with an
 * exception set otherwise. */
static int int_to_bytes32(PyObject *item, unsigned char bytes[32]) {
    if (!PyLong_Check(item)) {
        PyErr_Format(PyExc_TypeError, "expected an int, got %.100s",
                     Py_TYPE(item)->tp_name);
        return -1;
    }
#if PY_VERSION_HEX >= 0x030D0000
    return _PyLong_AsByteArray((PyLongObject *)item, bytes, 32, 1, 0, 1);
#else
    return _PyLong_AsByteArray((PyLongObject *)item, bytes, 32, 1, 0);
#endif
}

static int parse_ctx(PyObject *ctx_tuple, mont_ctx *ctx) {
    /* (p_bytes32_le, inv_u64, r2_bytes32_le) */
    const char *pb, *r2b;
    Py_ssize_t pl, r2l;
    unsigned long long inv;
    if (!PyArg_ParseTuple(ctx_tuple, "y#Ky#", &pb, &pl, &inv, &r2b, &r2l))
        return 0;
    if (pl != 32 || r2l != 32) {
        PyErr_SetString(PyExc_ValueError, "ctx byte strings must be 32 bytes");
        return 0;
    }
    bytes_to_u64((const unsigned char *)pb, ctx->p);
    bytes_to_u64((const unsigned char *)r2b, ctx->r2);
    ctx->inv = (uint64_t)inv;
    return 1;
}

/* ---- entry points -------------------------------------------------------- */

static PyObject *ints_to_limbs(PyObject *self, PyObject *args) {
    PyObject *seq, *ctx_or_none, *fast = NULL, *ret = NULL;
    Py_buffer out;
    mont_ctx ctx;
    if (!PyArg_ParseTuple(args, "Ow*O", &seq, &out, &ctx_or_none))
        return NULL;
    const int do_mont = ctx_or_none != Py_None;
    if (do_mont && !parse_ctx(ctx_or_none, &ctx))
        goto done;
    fast = PySequence_Fast(seq, "expected a sequence");
    if (!fast)
        goto done;
    const Py_ssize_t n = PySequence_Fast_GET_SIZE(fast);
    if (out.len < n * 16 * (Py_ssize_t)sizeof(uint32_t)) {
        PyErr_SetString(PyExc_ValueError, "output buffer too small");
        goto done;
    }
    uint32_t *dst = (uint32_t *)out.buf;
    for (Py_ssize_t i = 0; i < n; i++) {
        unsigned char bytes[32];
        if (int_to_bytes32(PySequence_Fast_GET_ITEM(fast, i), bytes) < 0)
            goto done;
        if (do_mont) {
            uint64_t w[4], m[4];
            bytes_to_u64(bytes, w);
            mont_mul(m, w, ctx.r2, &ctx); /* REDC(v R^2) = v R mod p */
            u64_to_bytes(m, bytes);
        }
        for (int j = 0; j < 16; j++)
            dst[i * 16 + j] =
                (uint32_t)bytes[2 * j] | ((uint32_t)bytes[2 * j + 1] << 8);
    }
    ret = Py_None;
    Py_INCREF(ret);
done:
    Py_XDECREF(fast);
    PyBuffer_Release(&out);
    return ret;
}

static PyObject *limbs_to_ints(PyObject *self, PyObject *args) {
    PyObject *ctx_or_none, *list = NULL;
    Py_buffer in;
    Py_ssize_t n;
    mont_ctx ctx;
    if (!PyArg_ParseTuple(args, "y*nO", &in, &n, &ctx_or_none))
        return NULL;
    const int do_mont = ctx_or_none != Py_None;
    if (do_mont && !parse_ctx(ctx_or_none, &ctx))
        goto done;
    if (n < 0 || in.len < n * 16 * (Py_ssize_t)sizeof(uint32_t)) {
        PyErr_SetString(PyExc_ValueError, "input buffer too small");
        goto done;
    }
    list = PyList_New(n);
    if (!list)
        goto done;
    static const uint64_t one[4] = {1, 0, 0, 0};
    const uint32_t *src = (const uint32_t *)in.buf;
    for (Py_ssize_t i = 0; i < n; i++) {
        unsigned char bytes[32];
        for (int j = 0; j < 16; j++) {
            const uint32_t limb = src[i * 16 + j];
            bytes[2 * j] = (unsigned char)limb;
            bytes[2 * j + 1] = (unsigned char)(limb >> 8);
        }
        if (do_mont) {
            uint64_t w[4], m[4];
            bytes_to_u64(bytes, w);
            mont_mul(m, w, one, &ctx); /* REDC(v) = v R^-1 mod p */
            u64_to_bytes(m, bytes);
        }
        PyObject *v = _PyLong_FromByteArray(bytes, 32, 1, 0);
        if (!v) {
            Py_CLEAR(list);
            goto done;
        }
        PyList_SET_ITEM(list, i, v);
    }
done:
    PyBuffer_Release(&in);
    return list;
}

static PyMethodDef methods[] = {
    {"ints_to_limbs", ints_to_limbs, METH_VARARGS,
     "ints_to_limbs(seq, out_u32_buffer, mont_ctx_or_None)"},
    {"limbs_to_ints", limbs_to_ints, METH_VARARGS,
     "limbs_to_ints(u32_buffer, count, mont_ctx_or_None) -> list[int]"},
    {NULL, NULL, 0, NULL}};

static struct PyModuleDef module = {PyModuleDef_HEAD_INIT, "_limbcodec",
                                    NULL, -1, methods};

PyMODINIT_FUNC PyInit__limbcodec(void) { return PyModule_Create(&module); }
