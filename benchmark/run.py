#!/usr/bin/env python3
"""Run one cell of the benchmark of ``versband_tpu_torch`` and print its
result as the last line of standard output.

    python3 benchmark/run.py --workload accomp_band.serve --seed 1234 \\
        --seconds 45 --trace 0

from the root of a checkout. The cell, its configuration, traffic, driver
and per-layer metrics are found by name (``benchmark/lib/cells.py``). The
run needs as many CUDA devices as the cell asks for and fails without
them. Its kernel caches stay under ``build/`` in the checkout; anything
else it writes goes under ``TMPDIR``.
"""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FORBIDDEN = ("jax", "jaxlib", "flax", "versband_tpu")


def forbidden_modules() -> list:
    """Loaded modules whose top-level name, compared whole, is JAX's or the
    JAX package's (``versband_tpu_torch`` is neither)."""
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


def power_limit() -> str:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=30)
        return out.stdout.strip().splitlines()[0] if out.returncode == 0 else "unknown"
    except (OSError, subprocess.SubprocessError, IndexError):
        return "unknown"


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)

    build = os.path.join(ROOT, "build")
    os.environ["TRITON_CACHE_DIR"] = os.path.join(build, "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(build, "torch_extensions")
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_TF"] = "0"
    sys.path.insert(0, ROOT)

    from benchmark.lib import cells, compare

    bench = cells.benchmark(ROOT)
    cell = cells.cell(args.workload)
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell["chips"]:
        print(f"{args.workload} needs {cell['chips']} CUDA device(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 3
    device = torch.device("cuda", 0)
    from versband_tpu_torch.device import resolve_device

    resolve_device(device)  # TF32 off: float32 means float32
    result = cells.driver(cell["driver"]).run(cell, args.seed, args.seconds, bool(args.trace),
                                              T0, device)
    for note in result.get("notes", []):
        print(f"[{args.workload}] {note}", file=sys.stderr)

    metrics = {}
    if args.trace:
        summary = result.get("trace")
        for m in cells.per_layer_for(bench, args.workload):
            value = None if summary is None else cells.metric_reader(m["name"])(summary)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        for m in cells.end_to_end_for(bench, args.workload):
            metrics[m["name"]] = {"value": result["end_to_end"][m["name"]], "unit": m["unit"]}

    bad = forbidden_modules()
    if bad:
        print(f"modules of JAX or the JAX package were loaded: {bad}", file=sys.stderr)
        return 4
    correct, lines = compare.judge(result["checks"], cell.get("limits", {}))
    device_info = {"platform": "gpu", "kind": torch.cuda.get_device_name(device),
                   "count": cell["chips"], "memory_peak_bytes": int(result["peak_bytes"]),
                   "power_limit": power_limit()}
    line = {"correct": correct, "attempted": result["attempted"], "failed": result["failed"],
            "metrics": metrics, "device": device_info}
    if args.trace:
        summary = result.get("trace")
        if summary is not None:
            device_info.update(busy_s=summary["busy_s"], window_s=summary["window_s"])
            line["breakdown"] = summary["breakdown"]
    line["checks"] = {k: {"value": v, "limit": cell.get("limits", {}).get(k)}
                      for k, v in result["checks"].items()}
    for text in lines:
        print(text, file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
