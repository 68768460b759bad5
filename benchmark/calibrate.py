#!/usr/bin/env python3
"""Readings that a cell's correctness limits are set from, taken in one
process on the card (the benchmark's own runs never run this).

A serve cell:

* the program: for each seed of ``--seeds``, the checked requests of a run
  served at the cell's load (the closed loop over the first
  ``checked_from_first`` requests), each stage's widest gap to the float32
  reference;
* the controls: for each seed of ``--control-seeds``, the reference computed
  with its products in float8 (e4m3) put in the program's place, against the
  float32 reference (``fp8``, the bfloat16 stages' control); and the
  reference's caption tower with its products in TF32 against the float32
  tower (``tf32_tower``, the float32 tower's control, read by ``cond_gap``).

A train cell (either stage):

* the program: for each seed, its three checked steps against the float32
  reference's (loss, first gradient and update gaps);
* the control: for each control seed, the reference in TF32 against the
  reference in float32 on the same batches; and the fault of half of each
  batch left out (the reference on the first half of the rows).

    python3 benchmark/calibrate.py --workload accomp_band.serve \\
        --seeds 11,12,13 --control-seeds 21,22,23

Prints one JSON line per seed and a last line with the largest program
reading and the smallest control reading of each number.
"""

import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", default="")
    p.add_argument("--control-seeds", default="")
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    os.environ["TRITON_CACHE_DIR"] = os.path.join(ROOT, "build", "triton")
    sys.path.insert(0, ROOT)

    import numpy as np
    import torch

    from benchmark.drivers import serve
    from benchmark.lib import cells
    from benchmark.lib.trace import Tracer
    from benchmark.lib.traffic import Clips
    from versband_tpu_torch.device import resolve_device

    cell = cells.cell(args.workload)
    config, mix = cell["config_data"], cell["traffic_data"]
    device = resolve_device(args.device)
    seeds = [int(s) for s in args.seeds.split(",") if s]
    controls = [int(s) for s in args.control_seeds.split(",") if s]
    if cell["driver"] == "train":
        return calibrate_train(cell, seeds, controls, device)
    prog = None
    low = dict.fromkeys(serve.STAGES, 0.0)
    high = dict.fromkeys(serve.STAGES, float("inf"))
    tower_high = float("inf")
    for seed in dict.fromkeys(seeds + controls):
        t0 = time.perf_counter()
        clips = Clips(mix, seed)
        keep_rng = np.random.default_rng([clips.seed, 7])
        first_n = mix["checked_from_first"]
        keep = set(int(i) for i in keep_rng.choice(first_n, mix["checked_requests"],
                                                   replace=False))
        row = {"seed": seed}
        if seed in seeds:
            if prog is None:
                prog = serve.Program(config, mix, seed, device)
            else:
                prog.reseed(seed)
            records = serve.Loop(prog, mix, clips, Tracer(False)).run(
                0, lambda n: n < first_n, keep)
            kept = [r for r in records if "kept" in r]
            row["program"] = serve.reference_check(config, mix, prog.specs, seed, kept, clips,
                                                   device)
            for k, v in row["program"].items():
                low[k] = max(low[k], v)
        if seed in controls:
            specs = prog.specs if prog is not None else serve.Program(
                config, mix, seed, device).specs
            W = serve.reference_weights(specs, seed, device)
            gaps = dict.fromkeys(serve.STAGES, 0.0)
            for i in sorted(keep):
                req = clips[i]
                want = serve.reference_outputs(config, mix, W, req, clips.T, device)
                got = serve.reference_outputs(config, mix, W, req, clips.T, device, "fp8")
                for k, v in serve.stage_gaps(got, want).items():
                    gaps[k] = max(gaps[k], v)
            row["control"] = gaps
            for k, v in gaps.items():
                high[k] = min(high[k], v)
            tower = max(serve.tower_control_gap(config, W, clips[i], device) for i in sorted(keep))
            row["control_tf32_tower"] = {"cond_gap": tower}
            tower_high = min(tower_high, tower)
            del W
        row["seconds"] = time.perf_counter() - t0
        print(json.dumps(row), flush=True)
    print(json.dumps({"workload": args.workload, "program_max": low, "control_min": high,
                      "control_tf32_tower_min": {"cond_gap": tower_high},
                      "device": torch.cuda.get_device_name() if device.type == "cuda" else "cpu"}),
          flush=True)
    return 0


def _half(batch):
    """The first half of a batch's rows."""
    n = len(batch["image"]) // 2
    out = {k: batch[k][:n] for k in ("image", "name") if k in batch}
    if "caption" in batch:
        ac = batch["caption"]["acoustic"]
        out["caption"] = {"caption": batch["caption"]["caption"][:n],
                          "acoustic": {k: v[:n] for k, v in ac.items()}}
    return out


def calibrate_train(cell, seeds, controls, device) -> int:
    import shutil

    import torch

    from benchmark.drivers import train

    low, high = {}, {}
    for seed in dict.fromkeys(seeds + controls):
        t0 = time.perf_counter()
        cb, specs, data = train.drive(cell, seed, 0.0, False, device, checked_only=True)
        prog = {"losses": cb.losses, "grad1": cb.grad1, "delta": cb.delta}
        batches = cb.batches
        del cb
        train.free(device)
        want = train.reference(cell, seed, specs, batches, device)
        row = {"seed": seed, "program": {**train.compare_steps(prog, want), "loader_mismatch":
                                         float(train.check_rows(batches, data,
                                                                cell["traffic_data"]))}}
        if seed in seeds:
            for k, v in row["program"].items():
                low[k] = max(low.get(k, 0.0), v)
        if seed in controls:
            row["control_tf32"] = train.compare_steps(
                train.reference(cell, seed, specs, batches, device, use_tf32=True), want)
            row["fault_half_batch"] = train.compare_steps(
                train.reference(cell, seed, specs, [_half(b) for b in batches], device), want)
            for kind in ("control_tf32", "fault_half_batch"):
                for k, v in row[kind].items():
                    high.setdefault(kind, {})[k] = min(high.get(kind, {}).get(k, float("inf")), v)
        shutil.rmtree(data["root"], ignore_errors=True)
        row["seconds"] = time.perf_counter() - t0
        print(json.dumps(row), flush=True)
    print(json.dumps({"workload": cell["name"], "program_max": low, "control_min": high,
                      "device": torch.cuda.get_device_name() if device.type == "cuda" else "cpu"}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
