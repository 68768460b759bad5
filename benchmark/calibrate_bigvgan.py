#!/usr/bin/env python3
"""Readings that a ``serve_bigvgan`` cell's correctness limits are set from,
taken in one process on the card (the benchmark's own runs never run this;
``calibrate_vocoder.py`` does the same for the ``serve_vocoder`` driver).

* the program: for each seed of ``--seeds``, the checked requests of a run
  served at the cell's load (the closed loop over the first
  ``checked_from_first`` requests), each stage's widest gap to the float32
  reference, ``voc_gap`` included, and the requests with a clip off its
  target loudness;
* the controls: for each seed of ``--control-seeds``, on the same requests,
  the reference with the stages before the vocoder in float8 products (the
  bfloat16 stages' control, as ``calibrate.py`` takes it) and the vocoder's
  convolutions in single-pass TF32 (the float32 vocoder's control), against
  the float32 reference; ``voc_gap`` of the control is the TF32 BigVGAN
  against the float32 one on the float32 reference's mel;
* the fault: for each control seed, the program with its vocoder in
  bfloat16 (K4's bf16 path, bf16 convolutions) where the configuration says
  float32, checked as a run checks it;
* the published initialisation: for each seed of ``--published-seeds``, the
  program with the vocoder's weights by ``vocoder_weights``' ``published``
  rule, checked as a run checks it (its ``failed_requests`` are the takes
  that rule leaves off -23 LUFS).

    python3 benchmark/calibrate_bigvgan.py --workload accomp_band_bigvgan.serve \\
        --seeds 11,12,13 --control-seeds 21,22,23 --published-seeds 31

Prints one JSON line per seed and a last line with the largest program
reading and the smallest control and fault reading of each number.
"""

import argparse
import copy
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _seeds(text: str) -> list:
    return [int(s) for s in text.split(",") if s]


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", default="")
    p.add_argument("--control-seeds", default="")
    p.add_argument("--published-seeds", default="")
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    os.environ["TRITON_CACHE_DIR"] = os.path.join(ROOT, "build", "triton")
    sys.path.insert(0, ROOT)

    import numpy as np
    import torch

    from benchmark.drivers import serve, serve_bigvgan as sb
    from benchmark.lib import cells, compare
    from benchmark.lib.trace import Tracer
    from benchmark.lib.traffic import Clips
    from benchmark.reference import bigvgan as ref_voc
    from versband_tpu_torch.device import resolve_device

    cell = cells.cell(args.workload)
    if cell["driver"] != "serve_bigvgan":
        raise SystemExit(f"{args.workload} is not a serve_bigvgan cell")
    config, mix = cell["config_data"], cell["traffic_data"]
    faulty = copy.deepcopy(config)
    faulty["vocoder"]["dtype"] = "bfloat16"
    published = copy.deepcopy(config)
    published["vocoder"]["init"] = "published"
    device = resolve_device(args.device)
    seeds, controls = _seeds(args.seeds), _seeds(args.control_seeds)
    firsts = _seeds(args.published_seeds)
    progs = {}

    def served(conf, seed, clips, keep):
        """The checked requests' gaps of the program under ``conf``."""
        key = conf["vocoder"]["dtype"]
        if key in progs:
            progs[key].init = conf["vocoder"]["init"]
            progs[key].reseed(seed)
        else:
            progs[key] = sb.Program(conf, mix, seed, device)
        prog = progs[key]
        records = sb.Loop(prog, mix, clips, Tracer(False)).run(
            0, lambda n: n < mix["checked_from_first"], keep)
        kept = [r for r in records if "kept" in r]
        return {**sb.reference_check(conf, mix, prog.specs, seed, kept, clips, device),
                "failed_requests": float(serve._lufs_failed(records, mix))}

    low = dict.fromkeys(sb.STAGES + ("failed_requests",), 0.0)
    high = dict.fromkeys(sb.STAGES, float("inf"))
    fault = dict.fromkeys(sb.STAGES + ("failed_requests",), float("inf"))
    first_failed = 0.0
    for seed in dict.fromkeys(seeds + controls + firsts):
        t0 = time.perf_counter()
        clips = Clips(mix, seed)
        keep_rng = np.random.default_rng([clips.seed, 7])
        keep = set(int(i) for i in keep_rng.choice(mix["checked_from_first"],
                                                   mix["checked_requests"], replace=False))
        row = {"seed": seed}
        if seed in seeds:
            row["program"] = served(config, seed, clips, keep)
            for k, v in row["program"].items():
                low[k] = max(low[k], v)
        if seed in firsts:
            row["published_init"] = served(published, seed, clips, keep)
            first_failed += row["published_init"]["failed_requests"]
        if seed in controls:
            row["fault_bf16_vocoder"] = served(faulty, seed, clips, keep)
            for k, v in row["fault_bf16_vocoder"].items():
                fault[k] = min(fault[k], v)
            specs = next(iter(progs.values())).specs
            W = sb.reference_weights(config, specs, seed, device)
            gaps = dict.fromkeys(sb.STAGES, 0.0)
            gen = config["vocoder"]["generator"]
            for i in sorted(keep):
                req = clips[i]
                want = sb.reference_outputs(config, mix, W, req, clips.T, device)
                got = sb.reference_outputs(config, mix, W, req, clips.T, device, "fp8", "tf32")
                found = serve.stage_gaps(got, want)
                tf32 = ref_voc.vocode(W["voc"], gen, want["mel"], ref_voc.Precision("tf32"))
                found["voc_gap"] = compare.rel_l2(tf32, want["wav"])
                for k, v in found.items():
                    gaps[k] = max(gaps[k], v)
            row["control"] = gaps
            for k, v in gaps.items():
                high[k] = min(high[k], v)
            del W
        row["seconds"] = time.perf_counter() - t0
        print(json.dumps(row), flush=True)
    print(json.dumps({"workload": args.workload, "program_max": low, "control_min": high,
                      "fault_bf16_vocoder_min": fault,
                      "published_init_failed_requests": first_failed,
                      "published_init_requests": len(firsts) * mix["checked_from_first"],
                      "device": torch.cuda.get_device_name() if device.type == "cuda" else "cpu"}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
