"""The system under test, set up and driven: a WNN model's prover answering
one client's requests, each a proof of inference on one image.

Set-up builds what a proving service holds before its first request: the SRS
(read from the checkout's cache, made from the configuration's seed on the
first run), both window tables (the program's table cache, kept in the
checkout), the proving key, and one warm proof. The window then runs the
traffic mix's closed loop on the calling thread and the default stream, as a
user calls ``Wnn.proof``: the next request goes out when the last proof is
back, until ``--seconds`` have passed; the window closes at the end of the
last proof that started inside it.
"""

from __future__ import annotations

import dataclasses
import os
import sys
import time
import traceback

import numpy as np
import torch

from . import traffic
from .trace import WINDOW

CACHE = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), ".cache")


@dataclasses.dataclass
class Request:
    index: int
    image: np.ndarray
    start: float = 0.0
    end: float = 0.0
    proof: bytes | None = None
    scores: list | None = None
    error: str | None = None
    timings: dict | None = None


def program_model(model):
    """The program's model, made from the benchmark's arrays."""
    from zerog_tpu_torch.models.wnn import Wnn

    return Wnn(**{f.name: getattr(model, f.name) for f in dataclasses.fields(Wnn)})


def _timed(fn):
    torch.cuda.synchronize()
    t = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t


class Service:
    device = torch.device("cuda", 0)

    def __init__(self, config: dict, mix: dict, model, seed: int):
        from zerog_tpu_torch.curve import srs as srs_module

        traffic.check_mix(mix)
        self.config, self.mix, self.seed = config, mix, seed
        srs_module.CACHE_DIR = os.path.join(CACHE, "wtables")
        self.setup_s = {}
        self.srs, self.setup_s["srs_s"] = _timed(self._srs)
        _, self.setup_s["tables_s"] = _timed(
            lambda: [self.srs.window_table(b) for b in ("lagrange", "monomial")])
        self.wnn = program_model(model)
        self.pk, self.setup_s["keygen_s"] = _timed(
            lambda: self.wnn.generate_proving_key(self.srs))
        # the first proof builds the program's lazy device caches
        _, self.setup_s["warmup_s"] = _timed(lambda: self._prove(Request(
            traffic.WARMUP, traffic.image(mix, seed, traffic.WARMUP))))

    def _srs(self):
        from zerog_tpu_torch.curve.srs import Srs

        k = int(self.config["k"])
        seed = self.config["srs_seed"]
        path = os.path.join(CACHE, "srs", f"k{k}_{seed}.bin")
        if os.path.exists(path):
            return Srs.read(path, device=self.device)
        srs = Srs.setup(k, seed=seed.encode(), device=self.device)
        os.makedirs(os.path.dirname(path), exist_ok=True)
        tmp = f"{path}.tmp"
        srs.write(tmp)
        os.replace(tmp, path)
        return srs

    def _prove(self, req: Request, timings=None):
        return self.wnn.proof(self.pk, self.srs, req.image,
                              rng_seed=traffic.rng_seed(self.seed, req.index),
                              timings=timings)

    def window(self, seconds: float, traced: bool):
        """Runs the closed loop for `seconds`. Returns (requests, window
        seconds): every request sent, in order."""
        done = []
        t0 = time.perf_counter()
        deadline = t0 + seconds
        with torch.profiler.record_function(WINDOW):
            while time.perf_counter() < deadline:
                req = Request(len(done), traffic.image(self.mix, self.seed, len(done)))
                req.timings = {} if traced else None
                req.start = time.perf_counter()
                try:
                    req.proof, req.scores = self._prove(req, req.timings)
                except Exception:  # the request fails; the client goes on
                    req.error = traceback.format_exc()
                    print(req.error, file=sys.stderr)
                torch.cuda.synchronize()
                req.end = time.perf_counter()
                done.append(req)
        return done, done[-1].end - t0

    def close(self):
        """Frees the program's state on the device."""
        self.pk = self.srs = self.wnn = None
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
