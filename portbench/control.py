"""The readings that the limits of ``correct`` were set from, on the card.

    python3 portbench/control.py --workload <cell> --seeds <n> [<n> ...] \
        --seconds <s> --fault-seconds <s>

One set-up of the cell and, for each seed, at the cell's own load:

- ``sound``: a window of the program as it is, judged as a run judges it:
  the lower readings;
- ``control``: the same requests with the public scores worked out by the
  reference in float64, the precision below the exact integers the model
  states (the MishMash cube of a 28- or 49-bit input overflows the 53-bit
  mantissa): the upper readings;
- one window of ``--fault-seconds`` under each fault a cell can have,
  planted in the program: a
  proof altered where it is produced (``altered_proof``), a score altered
  where it is produced (``altered_score``), and every other request, the
  first among them, never answered (``half_lost``).

Prints one JSON line per seed and case: the numbers compared, ``failed`` and
``correct``. The benchmark's own runs do not run this.
"""

import argparse
import contextlib
import json
import sys

import run  # sets the caches and the import path  # noqa: F401

from harness import check, serve
from harness.cells import Benchmark
from reference.wnn import make_synthetic_wnn


@contextlib.contextmanager
def fault(name):
    """Plants one fault in the program's timed path while active."""
    from zerog_tpu_torch.models.wnn import Wnn

    orig = Wnn.proof
    calls = [0]

    def altered_proof(self, *a, **kw):
        proof, scores = orig(self, *a, **kw)
        b = bytearray(proof)
        b[len(b) // 2] ^= 1
        return bytes(b), scores

    def altered_score(self, *a, **kw):
        proof, scores = orig(self, *a, **kw)
        return proof, [scores[0] + 1] + list(scores[1:])

    def half_lost(self, *a, **kw):
        calls[0] += 1
        if calls[0] % 2:
            raise RuntimeError("request lost")
        return orig(self, *a, **kw)

    Wnn.proof = dict(altered_proof=altered_proof, altered_score=altered_score,
                     half_lost=half_lost)[name]
    try:
        yield
    finally:
        Wnn.proof = orig


FAULTS = ("altered_proof", "altered_score", "half_lost")


def readings(cell, seeds, seconds: float, fault_seconds: float):
    """{(seed, case): (numbers, failed, correct)} of a :class:`Cell`, all
    seeds on one set-up."""
    model = make_synthetic_wnn(**cell.config["model"])
    service = serve.Service(cell.config, cell.traffic, model, seeds[0])
    key = check.reference_key(model, cell.config)
    out = {}
    for seed in seeds:
        service.seed = seed

        def judge(name, requests, scores_of=None):
            failed = sum(r.error is not None for r in requests)
            judged = check.sample(requests, seed)
            numbers = check.judge(model, cell.config, judged, scores_of, key)
            out[seed, name] = (numbers, failed,
                               check.verdict(numbers, failed, len(judged)))

        requests, _ = service.window(seconds, traced=False)
        judge("sound", requests)
        judge("control", requests, lambda r: model.predict_float64(r.image))
        for name in FAULTS:
            with fault(name):
                faulty, _ = service.window(fault_seconds, traced=False)
            judge(name, faulty)
    service.close()
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--seconds", type=float, required=True,
                    help="the window of the sound run and the control: a run's")
    ap.add_argument("--fault-seconds", type=float, required=True)
    args = ap.parse_args(argv)
    cell = Benchmark().cell(args.workload)
    for (seed, case), (numbers, failed, correct) in readings(
            cell, args.seeds, args.seconds, args.fault_seconds).items():
        print(json.dumps(dict(workload=args.workload, seed=seed, case=case,
                              failed=failed, correct=correct, **numbers)),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
