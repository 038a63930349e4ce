"""The benchmark's frozen yardstick against the program-side functions it was
copied from, and its work counts against a direct count on small inputs."""

import random

import numpy as np
import pytest
import torch

import chip_smoke
from harness import yardstick as ys
from zerog_tpu_torch import bench as prog_bench
from zerog_tpu_torch.field import FR, to_limbs


def test_constants_are_the_programs_at_definition():
    assert ys.PEAK_BYTES_PER_S == prog_bench.PEAK_BYTES_PER_S
    assert ys.PEAK_INT32_MAD_PER_S == prog_bench.PEAK_INT32_MAD_PER_S
    assert ys.IMAD_SLOTS_PER_MUL == 256 == prog_bench.IMAD_SLOTS_PER_MUL
    assert ys.MULS_ADD == chip_smoke.MULS_ADD
    assert ys.FR_P == FR.p


@pytest.mark.parametrize("nbytes,slots", [(1e6, 1e3), (1e3, 1e9), (0, 0), (5e8, 7e10)])
def test_bound_equals_the_programs(nbytes, slots):
    s, by = ys.bound(nbytes, slots)
    ms, by_p = prog_bench.bound(nbytes, slots)
    assert (s * 1e3, by) == pytest.approx((ms, by_p))


def test_mixed_add_cost_is_flush_scan_affine_bounds():
    # one row, one add: the products of flush_scan_affine_bound's add
    _, by = prog_bench.flush_scan_affine_bound(1, 1, 0, 10 ** 9)
    assert by == "operations"
    ms = prog_bench.flush_scan_affine_bound(1, 1, 0, 10 ** 9)[0]
    assert ms / 1e3 == pytest.approx(
        10 ** 9 * ys.MULS_MIXED_ADD * ys.IMAD_SLOTS_PER_MUL / ys.PEAK_INT32_MAD_PER_S)


@pytest.mark.parametrize("seed", range(3))
def test_segment_adds_equals_chip_smoke(seed):
    g = torch.Generator().manual_seed(seed)
    nz = torch.rand(37, 5, generator=g) < 0.6
    flags = (torch.rand(37, 5, generator=g) < 0.2).to(torch.uint8)
    for a, b in zip(ys.segment_adds(nz, flags), chip_smoke._segment_adds(nz, flags)):
        assert torch.equal(a, b)


def _direct(cols, n, c):
    w = (254 + c - 1) // c
    mixed = general = 0
    pairs = set()
    for col in cols:
        digits = [((int(v) >> (c * j)) & ((1 << c) - 1), j, i)
                  for i, v in enumerate(col) for j in range(w)]
        live = [(d, j, i) for d, j, i in digits if d]
        buckets = {d for d, _, _ in live}
        mixed += len(live) - len(buckets)
        general += 2 * max(len(buckets) - 1, 0)
        pairs |= {(j, i) for _, j, i in live}
    return mixed, general, len(pairs)


@pytest.mark.parametrize("n,bits", [(64, 254), (64, 9), (4096, 254), (256, 0)])
def test_msm_work_equals_a_direct_count(n, bits):
    rnd = random.Random(n + bits)
    cols = [[rnd.getrandbits(bits) % FR.p if bits else 0 for _ in range(n)]
            for _ in range(3)]
    cols[1][: n // 2] = [0] * (n // 2)
    work = ys.msm_work(ys.scalars_to_words(cols), n)
    mixed, general, pairs = _direct(cols, n, ys.msm_window(n))
    assert (work["mixed_adds"], work["general_adds"]) == (mixed, general)
    assert work["bytes"] == 3 * n * 32 + pairs * 64 + 3 * 64
    assert work["least_s"] > 0


def test_window_is_the_programs_at_definition():
    from zerog_tpu_torch.curve.pippenger import default_fixed_window

    for k in range(10, 21):
        assert ys.msm_window(1 << k) == default_fixed_window(1 << k)


def test_scalars_from_montgomery_limbs_equal_the_ints():
    rnd = random.Random(7)
    vals = [[rnd.randrange(FR.p) for _ in range(32)] for _ in range(2)]
    mont = torch.from_numpy(np.stack([to_limbs(v, FR, mont=True) for v in vals]).astype(np.int64))
    assert np.array_equal(ys.scalars_to_words(mont), ys.scalars_to_words(vals))
    one = ys.scalars_to_words(vals[0])
    assert np.array_equal(one[0], ys.scalars_to_words(vals)[0])


def test_ntt_work_counts_each_value_in_and_out_once():
    w = ys.ntt_work((6, 1 << 14, 16))
    assert w["bytes"] == 2 * 32 * 6 * (1 << 14)
    assert w["least_s"] == pytest.approx(w["bytes"] / ys.PEAK_BYTES_PER_S)
