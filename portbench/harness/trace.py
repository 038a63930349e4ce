"""The traced run: ranges around the program's calls, the profiler over the
window, and the reduction of its records to what the per-layer metrics read.

The program is not edited. For the traced run only, the harness wraps, from
its own code:

- the MSM calls (``Srs.commit``, ``commit_lagrange``, ``commit_dev``,
  ``commit_lagrange_dev``) and the NTT calls (``NttPlan.ntt``, ``intt``), each
  in a ``torch.profiler.record_function`` range ``portbench.<kind>#<call>``,
  with the call's inputs kept for the yardstick;
- a few phases of a proof, in ranges that name the host's work in the idle
  gaps of the device (``portbench.phase.<name>``); these name the breakdown
  only, and no metric reads them.

A call or phase that the program no longer has is left unwrapped: its
metrics read nothing (their readers return None) and its idle gaps go to the
range around it, and the traced run goes on.

The device's busy time is the union of the intervals of every device
activity (kernels, copies, fills) in the window. A device activity belongs to
an MSM or NTT call when the host op that launched it ran inside the call's
range on the same thread.
"""

from __future__ import annotations

import bisect
import collections
import re
import sys
import time

import torch

_RANGE = re.compile(r"^portbench\.(msm|ntt)#(\d+)$")
_PHASE = "portbench.phase."
WINDOW = "portbench.window"
# kernel names are cut to this length in the breakdown (torch's run to
# thousands of characters of template arguments)
NAME_CHARS = 160
# idle gaps shorter than this are the launch gaps between kernels: summed, not
# named by the host's phase
SHORT_GAP_NS = 10_000
SHORT_GAPS = "between kernels (< 10 us)"


class CallLog:
    """The wrapped calls of the window, by call number."""

    def __init__(self):
        self.calls = {}             # number -> dict(kind, inputs or shape, ...)

    def new(self, kind: str, **info) -> int:
        i = len(self.calls)
        self.calls[i] = dict(kind=kind, **info)
        return i


def _call(kind, log, inputs):
    """Wraps a method in a numbered range of `kind`, its inputs logged."""
    def wrap(orig):
        def wrapped(self, arg, *a, **kw):
            i = log.new(kind, **inputs(self, arg))
            with torch.profiler.record_function(f"portbench.{kind}#{i}"):
                return orig(self, arg, *a, **kw)
        return wrapped
    return wrap


def _phase(name):
    """Wraps a function in the range of the phase `name`."""
    def wrap(orig):
        def wrapped(*a, **kw):
            with torch.profiler.record_function(_PHASE + name):
                return orig(*a, **kw)
        return wrapped
    return wrap


class Tracer:
    """Wraps the program's calls while it is installed, and profiles the
    window between ``start`` and ``stop``."""

    def __init__(self):
        self.log = CallLog()
        self._saved = []
        self.prof = None

    def install(self):
        from zerog_tpu_torch.curve.srs import Srs
        from zerog_tpu_torch.gadgets.wnn_circuit import WnnCircuit
        from zerog_tpu_torch.models.wnn import Wnn
        from zerog_tpu_torch.plonk import gwc, prover
        from zerog_tpu_torch.poly.ntt import NttPlan

        log = self.log
        msm = _call("msm", log, lambda srs, v: dict(inputs=v, n_points=srs.n))
        for attr in ("commit", "commit_lagrange", "commit_dev", "commit_lagrange_dev"):
            self._replace(Srs, attr, msm)
        ntt = _call("ntt", log, lambda plan, v: dict(shape=tuple(v.shape)))
        for attr in ("ntt", "intt"):
            self._replace(NttPlan, attr, ntt)
        for owner, attr, name in (
                (Wnn, "proof", "proof"), (Wnn, "predict", "predict"),
                (WnnCircuit, "synthesize", "synthesize"),
                (prover, "commit_permuted", "lookup_permute"),
                (prover, "grand_products", "grand_products"),
                (prover, "grand_product", "grand_products"),
                (prover, "_to_dev_lagrange", "to_limbs"),
                (prover, "_eval_quotient", "quotient_eval"),
                (prover, "_hc_fold", "quotient_fold"),
                (gwc, "multiopen_prove_device", "multiopen")):
            self._replace(owner, attr, _phase(name))

    def _replace(self, owner, attr, wrap):
        """Puts `wrap(owner.attr)` in its place, where the program has it."""
        orig = getattr(owner, attr, None)
        if orig is None:
            print(f"trace: {owner.__name__}.{attr} not found, left unwrapped",
                  file=sys.stderr)
            return
        setattr(owner, attr, wrap(orig))
        self._saved.append((owner, attr, orig))

    def uninstall(self):
        for owner, attr, orig in reversed(self._saved):
            setattr(owner, attr, orig)
        self._saved = []

    def start(self):
        from torch.profiler import ProfilerActivity, profile

        self.prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
        self.prof.__enter__()

    def stop(self):
        self.prof.__exit__(None, None, None)

    def summary(self):
        """Reduce the profile to a :class:`TraceSummary` of the window: the
        range ``portbench.window`` that the harness opens around it."""
        t = time.perf_counter()
        events = self.prof.profiler.kineto_results.events()
        print(f"trace: {len(events)} events read in {time.perf_counter() - t:.1f} s",
              file=sys.stderr)
        return TraceSummary.of(events, self.log)


class TraceSummary:
    """What the per-layer metrics read of the traced window."""

    @classmethod
    def of(cls, events, log):
        s = cls()
        cpu = torch.autograd.DeviceType.CPU
        cpu_by_corr = {}
        ranges = collections.defaultdict(list)    # thread -> [(start, end, name)]
        device = []
        for e in events:
            name = e.name()
            if e.device_type() != cpu:
                # a device activity; the device-side copies of the harness's
                # ranges (user annotations spanning their kernels) are not
                if not name.startswith("portbench."):
                    st = e.start_ns()
                    device.append((st, st + e.duration_ns(), name,
                                   e.linked_correlation_id()))
                continue
            st = e.start_ns()
            tid = e.start_thread_id()
            cpu_by_corr[e.correlation_id()] = (tid, st)
            if name.startswith("portbench."):
                ranges[tid].append((st, st + e.duration_ns(), name))
        for v in ranges.values():
            v.sort()
        device.sort()
        t0, t1 = next((st, en) for rs in ranges.values() for st, en, name in rs
                      if name == WINDOW)

        # busy: the union of the device's intervals inside the window
        busy, gaps, cur_s, cur_e = 0, [], None, None
        for st, en, _, _ in device:
            st, en = max(st, t0), min(en, t1)
            if en <= st:
                continue
            if cur_e is None or st > cur_e:
                if cur_e is not None:
                    busy += cur_e - cur_s
                    gaps.append((cur_e, st))
                elif st > t0:
                    gaps.append((t0, st))
                cur_s, cur_e = st, en
            else:
                cur_e = max(cur_e, en)
        if cur_e is not None:
            busy += cur_e - cur_s
            if cur_e < t1:
                gaps.append((cur_e, t1))
        s.window_s = (t1 - t0) / 1e9
        s.busy_s = busy / 1e9

        # device time of each wrapped call, and by kernel name
        by_name = collections.Counter()
        call_device_ns = collections.Counter()
        s.kernels = 0
        # the call ranges of each thread (calls do not nest), by start
        calls = {tid: sorted((st, en, int(_RANGE.match(name).group(2)))
                             for st, en, name in rs if _RANGE.match(name))
                 for tid, rs in ranges.items()}
        starts = {tid: [c[0] for c in cs] for tid, cs in calls.items()}
        for st, en, name, linked in device:
            by_name[name] += en - st
            if not name.startswith(("Memcpy", "Memset")):
                s.kernels += 1
            launch = cpu_by_corr.get(linked)
            if launch is None or launch[0] not in calls:
                continue
            i = bisect.bisect_right(starts[launch[0]], launch[1]) - 1
            if i >= 0 and launch[1] < calls[launch[0]][i][1]:
                call_device_ns[calls[launch[0]][i][2]] += en - st
        s.device_ops = [[n[:NAME_CHARS], v / 1e9] for n, v in by_name.most_common(10)]

        # the host's work in the device's idle gaps, by phase: the innermost
        # range open at a gap's middle, of the thread that opened one last
        # (the window's own range only where no thread has another open)
        # the many gaps between back-to-back kernels are summed unnamed
        idle = collections.Counter()
        named = []
        for a, b in gaps:
            if b - a < SHORT_GAP_NS:
                idle[SHORT_GAPS] += b - a
            else:
                named.append((a, b))
        mids = [(a + b) // 2 for a, b in named]
        best = [((False, -1), "no phase")] * len(named)
        for rs in ranges.values():
            for g, inner in enumerate(_locate(rs, mids)):
                if inner is None:
                    continue
                key = (inner[1] != WINDOW, inner[0])
                if key > best[g][0]:
                    best[g] = (key, inner[1][len("portbench."):])
        for (a, b), (_, name) in zip(named, best):
            idle[name] += b - a
        s.idle_gaps = [[n, v / 1e9] for n, v in idle.most_common(10)]

        s.calls = [dict(c, number=i, device_s=call_device_ns.get(i, 0) / 1e9)
                   for i, c in sorted(log.calls.items())]
        s.attributed = sum(call_device_ns.values()) > 0
        return s


def _locate(rs, times):
    """For each time of `times`: (start, name) of the innermost range of `rs`
    (one thread's ranges, sorted by start, properly nested) open then, or
    None. One sweep over both, in time order."""
    out = [None] * len(times)
    stack, j = [], 0
    for q in sorted(range(len(times)), key=times.__getitem__):
        t = times[q]
        while j < len(rs) and rs[j][0] <= t:
            while stack and stack[-1][1] <= rs[j][0]:
                stack.pop()
            stack.append(rs[j])
            j += 1
        while stack and stack[-1][1] <= t:
            stack.pop()
        if stack:
            out[q] = (stack[-1][0], stack[-1][2])
    return out
