"""Runs one cell of the benchmark once and prints its result line.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout on a machine with the cards the cell asks for.
With ``--trace 0`` the result's metrics are the cell's end-to-end metrics,
with ``--trace 1`` its per-layer metrics, read from a profile of the window.
The last line of standard output is the result, a JSON object; the numbers
that decided ``correct`` are the last lines of standard error and the last
key of the result. Exits non-zero, with no result, without the cards, or if
JAX or the JAX package was loaded.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
CACHE = os.path.join(HERE, ".cache")
# every build and kernel cache inside the checkout, at a fixed path
for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                 ("TRITON_CACHE_DIR", "triton"), ("CUDA_CACHE_PATH", "nv")):
    os.environ[var] = os.path.join(CACHE, sub)
# the prover's transient float64 products take ~28 GiB in one block at k = 17,
# and with fixed segments the cache around them fragments until such a block
# no longer fits (an out-of-memory error in ~1 of 35 runs): segments that grow
# in place let the cache serve it
os.environ.setdefault("PYTORCH_CUDA_ALLOC_CONF", "expandable_segments:True")
sys.path.insert(0, HERE)
sys.path.insert(1, os.path.dirname(HERE))

# top-level module names that may not be loaded in a run, compared whole
FORBIDDEN = ("jax", "jaxlib", "flax", "zerog_tpu")


def forbidden_modules():
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def parse(argv):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def main(argv=None) -> int:
    args = parse(argv)
    import torch

    from harness import check, serve
    from harness.cells import Benchmark
    from harness.metrics import Run, end_to_end
    from reference.wnn import make_synthetic_wnn

    cell = Benchmark().cell(args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"{args.workload}: needs {cell.chips} CUDA card(s), found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    model = make_synthetic_wnn(**cell.config["model"])
    service = serve.Service(cell.config, cell.traffic, model, args.seed)
    tracer = None
    if args.trace:
        from harness.trace import Tracer

        tracer = Tracer()
        tracer.install()
    setup_s = time.perf_counter() - T_START
    if tracer:
        tracer.start()
    requests, window_s = service.window(args.seconds, traced=bool(args.trace))
    summary = None
    if tracer:
        t = [time.perf_counter()]
        tracer.stop()
        t.append(time.perf_counter())
        summary = tracer.summary()
        t.append(time.perf_counter())
        tracer.uninstall()
        print(f"trace: profiler stop {t[1] - t[0]:.1f} s, reduction {t[2] - t[1]:.1f} s",
              file=sys.stderr)
    dev = service.device
    memory_peak = torch.cuda.max_memory_allocated(dev)
    device = dict(platform="gpu", kind=torch.cuda.get_device_name(dev),
                  count=cell.chips, memory_peak_bytes=memory_peak)
    service.close()

    failed = sum(r.error is not None for r in requests)
    judged = check.sample(requests, args.seed)
    t_check = time.perf_counter()
    numbers = check.judge(model, cell.config, judged)
    correct = check.verdict(numbers, failed, len(judged))
    print(f"set-up {json.dumps(service.setup_s)}, window {window_s:.3f} s, "
          f"check {time.perf_counter() - t_check:.3f} s", file=sys.stderr)

    run = Run(requests=[r for r in requests if r.error is None], window_s=window_s,
              setup=dict(service.setup_s, setup_s=setup_s), trace=summary,
              memory_peak_bytes=memory_peak)
    if args.trace:
        bench = Benchmark()
        metrics = {}
        t_read = time.perf_counter()
        for m in cell.per_layer:
            v = bench.reader(m["name"])(run)
            if v is not None:
                metrics[m["name"]] = dict(value=v, unit=m["unit"])
        device.update(busy_s=summary.busy_s, window_s=summary.window_s)
        print(f"trace: readers {time.perf_counter() - t_read:.1f} s", file=sys.stderr)
    else:
        metrics = end_to_end(run, cell.end_to_end)

    found = forbidden_modules()
    if found:
        print(f"forbidden modules loaded: {', '.join(found)}", file=sys.stderr)
        return 3
    checks = {k: dict(value=v, limit=check.LIMITS[k]) for k, v in numbers.items()}
    result = dict(correct=correct, attempted=len(requests), failed=failed,
                  metrics=metrics, device=device)
    if summary is not None:
        result["breakdown"] = dict(device_ops=summary.device_ops,
                                   idle_gaps=summary.idle_gaps)
    result["checks"] = checks
    print(json.dumps(result), flush=True)
    print(f"judged {len(judged)} of {len(requests)} requests, {failed} failed",
          file=sys.stderr)
    for k, c in checks.items():
        print(f"{k} {c['value']} limit {c['limit']}", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
