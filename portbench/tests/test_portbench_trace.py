"""The traced run's reduction, on a profile made by hand: the device's busy
time is the union of its activities in the window, a kernel belongs to the
MSM or NTT call whose range held the op that launched it, and the idle gaps
are named by the host's innermost range."""

import pytest
import torch

from harness.trace import CallLog, TraceSummary

CPU, CUDA = torch.autograd.DeviceType.CPU, torch.autograd.DeviceType.CUDA


class Ev:
    def __init__(self, name, dev, start, dur, corr=0, linked=0, tid=1):
        self._v = (name, dev, start, dur, corr, linked, tid)

    def name(self):
        return self._v[0]

    def device_type(self):
        return self._v[1]

    def start_ns(self):
        return self._v[2]

    def duration_ns(self):
        return self._v[3]

    def correlation_id(self):
        return self._v[4]

    def linked_correlation_id(self):
        return self._v[5]

    def start_thread_id(self):
        return self._v[6]


US = 1000     # the profile's times are nanoseconds


@pytest.fixture
def summary():
    log = CallLog()
    assert log.new("msm", inputs=None, n_points=8) == 0
    assert log.new("ntt", shape=(1, 8, 16)) == 1
    events = [
        Ev("portbench.window", CPU, 0, 1000 * US, corr=1, tid=1),
        Ev("portbench.phase.proof", CPU, 5 * US, 995 * US, corr=2, tid=2),
        Ev("portbench.msm#0", CPU, 100 * US, 200 * US, corr=3, tid=2),
        Ev("aten::add", CPU, 150 * US, 10 * US, corr=5, tid=2),
        Ev("portbench.ntt#1", CPU, 400 * US, 100 * US, corr=4, tid=2),
        Ev("aten::mul", CPU, 450 * US, 10 * US, corr=6, tid=2),
        Ev("portbench.phase.synthesize", CPU, 550 * US, 300 * US, corr=8, tid=2),
        Ev("aten::sum", CPU, 600 * US, 10 * US, corr=7, tid=2),
        Ev("add_kernel", CUDA, 200 * US, 60 * US, linked=5),
        Ev("portbench.msm#0", CUDA, 200 * US, 60 * US, linked=3),  # its device copy
        Ev("mul_kernel", CUDA, 460 * US, 20 * US, linked=6),
        Ev("sum_kernel", CUDA, 600 * US, 100 * US, linked=7),
        Ev("Memcpy HtoD", CUDA, 705 * US, 25 * US, linked=7),      # 5 us after
        Ev("late_kernel", CUDA, 990 * US, 50 * US, linked=7),
    ]
    return TraceSummary.of(events, log)


def test_busy_is_the_union_inside_the_window(summary):
    assert summary.window_s == pytest.approx(1000e-6)
    assert summary.busy_s == pytest.approx((60 + 20 + 100 + 25 + 10) * 1e-6)


def test_kernels_are_counted_without_copies(summary):
    assert summary.kernels == 4


def test_each_call_gets_the_kernels_launched_inside_it(summary):
    calls = {c["number"]: c for c in summary.calls}
    assert summary.attributed
    assert calls[0]["device_s"] == pytest.approx(60e-6)
    assert calls[1]["device_s"] == pytest.approx(20e-6)
    assert calls[0]["n_points"] == 8 and calls[1]["shape"] == (1, 8, 16)


def test_idle_gaps_are_named_by_the_host_phase(summary):
    idle = dict(summary.idle_gaps)
    assert sum(idle.values()) == pytest.approx(summary.window_s - summary.busy_s)
    # [0, 200): mid 100 in msm#0; [260, 460): mid 360 in proof; [480, 600):
    # mid 540 in proof; [700, 705): short; [730, 990): mid 860 in proof
    assert idle["msm#0"] == pytest.approx(200e-6)
    assert idle["phase.proof"] == pytest.approx((200 + 120 + 260) * 1e-6)
    assert idle["between kernels (< 10 us)"] == pytest.approx(5e-6)
    assert dict(summary.device_ops)["sum_kernel"] == pytest.approx(100e-6)


def test_a_call_the_program_no_longer_has_is_left_unwrapped(monkeypatch, capsys):
    from zerog_tpu_torch.curve.srs import Srs
    from zerog_tpu_torch.plonk import prover

    from harness.trace import Tracer

    monkeypatch.delattr(prover, "_hc_fold")
    monkeypatch.delattr(Srs, "commit_dev")
    commit = Srs.commit
    tracer = Tracer()
    tracer.install()
    try:
        assert Srs.commit is not commit
        assert not hasattr(Srs, "commit_dev") and not hasattr(prover, "_hc_fold")
    finally:
        tracer.uninstall()
    assert Srs.commit is commit
    err = capsys.readouterr().err
    assert "_hc_fold not found" in err and "commit_dev not found" in err
