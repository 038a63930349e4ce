"""What a run hands to the metrics, and its end-to-end metrics.

End-to-end metrics are taken by the harness itself, on the host's clock, over
the whole window and all of its work:

- ``setup_s``: from the start of the process to the start of the window;
- ``proof_s``: the window's seconds over the proofs finished in it;
- ``peak_device_gib``: the most device memory the process held at once, over
  set-up and window.

The window runs from its start to the end of the last proof that started
inside ``--seconds``, so a stall counts. Per-layer metrics are small readers
of their own (``portbench/metrics``), each handed the :class:`Run`.
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass
class Run:
    requests: list          # the window's finished requests, in order of start
    window_s: float
    setup: dict             # seconds of set-up's parts, and setup_s
    trace: object           # TraceSummary of a traced run, else None
    memory_peak_bytes: int

    @property
    def proofs(self) -> int:
        return len(self.requests)

    def mark(self, *names):
        """The per-proof mean of the program's marks `names`, summed, over
        every proof of the traced window; None without marks."""
        if not self.requests or self.requests[0].timings is None:
            return None
        return sum(sum(r.timings.get(n, 0.0) for n in names)
                   for r in self.requests) / self.proofs

    def calls(self, kind: str) -> list:
        """The traced window's wrapped calls of `kind` ("msm" or "ntt")."""
        return [c for c in self.trace.calls if c["kind"] == kind]

    def device_s(self, kind: str):
        """Device seconds of the kernels that the profile ties to the wrapped
        calls of `kind`. None without such calls, or where the profile tied
        no kernel to any call."""
        calls = self.calls(kind)
        if not calls or not self.trace.attributed:
            return None
        return sum(c["device_s"] for c in calls)


def end_to_end(run: Run, entries) -> dict:
    values = dict(setup_s=run.setup["setup_s"],
                  proof_s=run.window_s / run.proofs if run.proofs else None,
                  peak_device_gib=run.memory_peak_bytes / 2 ** 30)
    return {m["name"]: dict(value=values[m["name"]], unit=m["unit"])
            for m in entries if values.get(m["name"]) is not None}
