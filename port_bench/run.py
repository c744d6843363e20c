"""Run one cell of the port's benchmark once.

    python3 port_bench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout. Set-up (building the kernels, generating the
cell's inputs from the seed, warming every shape the cell uses) counts as
``setup_s``; then the window measures for ``--seconds``; then the output
check runs the plain reference (``reference/``) on a sample of what the
window produced. The last line of standard output is one JSON object:
``correct``, ``attempted``, ``failed``, ``metrics`` (the cell's end-to-end
metrics with ``--trace 0``, its per-layer metrics with ``--trace 1``),
``device``, with ``--trace 1`` also ``breakdown``, and last ``checks``: each
number compared, with its limit. The checks are also the last lines of
standard error.

Exits 3 without enough CUDA devices, 4 if the JAX stack or the JAX package
was loaded, 1 on any other failure; none of these prints a result.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import shutil  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


class Context:
    """What a driver gets: the cell, the seed, the window's length, the
    device, a scratch directory under TMPDIR, and the trace switch."""

    def __init__(self, cell, seed, seconds, trace, device, tmp):
        self.cell = cell
        self.cfg = cell.config
        self.traffic = cell.traffic
        self.seed = seed
        self.seconds = seconds
        self.trace = trace
        self.device = device
        self.tmp = tmp

    def sync(self):
        import torch

        if self.device.type == "cuda":
            torch.cuda.synchronize()


def _card():
    import torch

    out = {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": 1}
    try:
        q = subprocess.run(["nvidia-smi", "--query-gpu=power.limit", "--format=csv,noheader", "-i", "0"],
                           capture_output=True, text=True, timeout=20)
        out["power_limit"] = q.stdout.strip()
    except (OSError, subprocess.TimeoutExpired):
        out["power_limit"] = "unknown"
    return out


def main(argv=None, device=None, root=ROOT) -> int:
    """One run; ``device`` "cpu" skips the look for a card (the tests drive
    the rest of a run that way)."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    build = os.path.join(root, "build")
    os.environ.setdefault("TORCH_EXTENSIONS_DIR", os.path.join(build, "torch_extensions"))
    os.environ.setdefault("TRITON_CACHE_DIR", os.path.join(build, "triton"))
    os.environ.setdefault("USE_FLAX", "0")

    from port_bench import bench

    cell = bench.load_cell(root, args.workload)
    import torch

    if device is None:
        if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
            print(f"{args.workload} needs {cell.chips} CUDA device(s); "
                  f"{torch.cuda.device_count() if torch.cuda.is_available() else 0} visible", file=sys.stderr)
            return 3
        device = "cuda"
    dev = torch.device(device)
    if args.trace and dev.type != "cuda":
        raise SystemExit("--trace 1 reads the CUDA profiler")

    tmp = tempfile.mkdtemp(prefix="port_bench_")
    try:
        ctx = Context(cell, args.seed, args.seconds, bool(args.trace), dev, tmp)
        state = cell.driver.setup(ctx)
        ctx.sync()
        setup_s = time.perf_counter() - T_START
        out = cell.driver.window(ctx, state)
        peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
        numbers = cell.driver.check(ctx, state, out)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    correct, rows = bench.judge(numbers, cell.limits)

    metrics = {}
    if args.trace:
        for m in cell.per_layer:
            v = bench.reader(root, m["name"])(out.record)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    else:
        values = dict(out.metrics, setup_s=setup_s)
        for m in cell.end_to_end:
            metrics[m["name"]] = {"value": values[m["name"]], "unit": m["unit"]}

    loaded = bench.forbidden_loaded()
    if loaded:
        print(f"forbidden modules loaded: {', '.join(loaded)}", file=sys.stderr)
        return 4
    result = {"correct": bool(correct), "attempted": out.attempted, "failed": out.failed, "metrics": metrics}
    result["device"] = _card() if dev.type == "cuda" else {"platform": "cpu", "kind": "cpu", "count": 1}
    result["device"]["memory_peak_bytes"] = int(peak)
    if args.trace:
        result["device"]["busy_s"] = out.record["summary"]["busy_s"]
        result["device"]["window_s"] = out.record["summary"]["length_s"]
        result["breakdown"] = {"device_ops": out.record["summary"]["top_ops"],
                               "idle_gaps": out.record["summary"]["gaps"]}
    result["checks"] = {name: {"value": v, "limit": lim} for name, v, lim in rows}
    for name, v in numbers.items():
        print(f"reading {name} = {v!r}", file=sys.stderr)
    for name, v, lim in rows:
        print(f"check {name} = {v!r} (limit {lim!r})", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
