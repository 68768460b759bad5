"""Serving driver for a configuration whose vocoder is not HiFi-GAN: the
closed loop of ``serve.py`` (one client through ``PipelinedGenerator``; the
T5 tower, the sampler, ``decode_first_stage``, each take vocoded in its own
call as ``versband_tpu_torch.cli.generate`` vocodes, -23 LUFS on the host),
with the vocoder built from the configuration's ``vocoder.family``,
``vocoder.dtype`` and ``vocoder.generator``. Only ``pwg`` (Parallel WaveGAN,
K5) has a reference here; another family raises.

It differs from ``serve.py`` in what the vocoder needs:

* the vocoder stage is the driver span ``vocoder.pwg``;
* a forward pre-hook on the generator keeps each checked take's exact
  vocoder inputs (the noise the wrapper drew and the padded mel), so the
  check can hold the waveform stage alone: ``voc_gap`` is the program's
  waveform against the plain PWG (``benchmark/reference/pwg.py``) run on
  those inputs, float32 against float32; ``wave_gap`` is the program's
  waveform against the reference end to end (its own mel, the same noise);
* the vocoder's weights are drawn as the published implementation
  initialises the generator (``vocoder_weights``);
* a traced run turns on the program's own spans and counters
  (``versband_tpu_torch/utils/profiling.py``) for the window and reduces
  them with ``benchmark/lib/program_trace.py``; the summary carries
  ``k5_bound_ms``, the bound of a request's residual layers
  (``benchmark/lib/wavenet.py``), beside ``flops`` and ``peak_flops``.
"""

from __future__ import annotations

import gc
import math
import time
from typing import Any, Dict, List

import numpy as np
import torch

from benchmark.drivers import serve
from benchmark.lib import arith, compare, flops, program_trace, wavenet, weights
from benchmark.lib.trace import WINDOW, Tracer
from benchmark.lib.traffic import Clips

STAGES = serve.STAGES + ("voc_gap",)
FAMILIES = ("pwg",)  # the families with a reference in benchmark/reference/


def build_vocoder(vocoder: Dict[str, Any], device):
    """The runtime wrapper ``cli.generate`` serves for ``vocoder["family"]``
    (``ParallelWaveGAN``), at ``vocoder["generator"]``'s widths in
    ``vocoder["dtype"]``."""
    family = vocoder["family"]
    if family not in FAMILIES:
        raise ValueError(f"serve_vocoder has no reference for vocoder family {family!r} "
                         f"(it has {FAMILIES})")
    from versband_tpu_torch.vocoder.pwg import ParallelWaveGAN

    return ParallelWaveGAN(None, device=device, dtype=getattr(torch, vocoder["dtype"]),
                           **vocoder["generator"])


def vocoder_weights(spec, seed: int, device) -> Dict[str, torch.Tensor]:
    """The vocoder's float32 weights under ``seed``, as the published
    implementation (``parallel_wavegan``) initialises a generator, from
    ``benchmark/lib/weights.py``'s standard-normal draw: every convolution
    Kaiming-normal for ReLU, N(0, 2 / fan_in), every bias 0, each smoothing
    stencil flat at 1 / (2s + 1). ``weights.py``'s own rule (N(0, 1 / fan_in),
    N(0, 0.01) biases, random stencils) leaves an offset and a drift below
    50 Hz in the waveform that the loudness meter does not count, so some
    takes could not reach their target under the peak limit."""
    W = weights.make(spec, seed, "voc", device)
    for name, w in W.items():
        if ".up_layers." in name:
            W[name] = torch.full_like(w, 1.0 / w.shape[-1])
        elif w.ndim >= 2:
            W[name] = w * math.sqrt(2.0)
        else:
            W[name] = torch.zeros_like(w)
    return W


def reference_weights(specs, seed: int, device) -> Dict[str, Dict[str, torch.Tensor]]:
    """Every model's weights under ``seed``, the vocoder's by ``vocoder_weights``."""
    W = {name: weights.make(specs[name], seed, name, device) for name in serve.MODELS
         if name != "voc"}
    W["voc"] = vocoder_weights(specs["voc"], seed, device)
    return W


class Program(serve.Program):
    """``serve.Program`` with the configuration's vocoder, its weights by
    ``vocoder_weights``."""

    def __init__(self, config: Dict[str, Any], mix: Dict[str, Any], seed: int, device):
        from versband_tpu_torch.models.cfm import CFMSampler
        from versband_tpu_torch.utils.config import instantiate_from_config

        self.device = device
        self.dtype = getattr(torch, config["serve_dtype"])
        self.cfm = instantiate_from_config(config["model"], device=device, dtype=self.dtype)
        self.sampler = CFMSampler(self.cfm, num_timesteps=mix["timesteps"])
        self.vocoder = build_vocoder(config["vocoder"], device)
        self.specs = {}
        self.reseed(seed)

    def reseed(self, seed: int) -> None:
        for name, module in self.modules().items():
            spec = self.specs.setdefault(name, weights.spec_of(module))
            if name != "voc":
                weights.fill(module, spec, seed, name, self.device)
        W = vocoder_weights(self.specs["voc"], seed, self.device)
        with torch.no_grad():
            for name, p in self.vocoder.model.named_parameters():
                p.copy_(W[name])


class Loop(serve.Loop):
    """``serve.Loop`` with the vocoder's span and its inputs kept."""

    def __init__(self, prog: Program, mix: Dict[str, Any], clips: Clips, tracer: Tracer):
        super().__init__(prog, mix, clips, tracer)
        self._inputs = None
        prog.vocoder.model.register_forward_pre_hook(self._keep_inputs)

    def _keep_inputs(self, _module, args) -> None:
        if self._inputs is not None:
            self._inputs.append(args[:2])

    def _vocode(self, mel):
        kept = self._rec.get("kept")
        self._inputs = [] if kept is not None else None
        with self.tracer.span("vocoder.pwg"):
            wav = torch.cat([self.prog.vocoder.waveform(m[None]) for m in mel])
        if kept is not None:
            kept["noise"] = torch.cat([n for n, _ in self._inputs])
            kept["cpad"] = torch.cat([c for _, c in self._inputs])
        self._inputs = None
        return wav


@torch.no_grad()
def reference_outputs(config, mix, W, req: Dict[str, Any], T: int, noise: torch.Tensor, device,
                      precision: str = "fp32", voc_precision: str = "fp32"
                      ) -> Dict[str, torch.Tensor]:
    """What the plain reference serves for request ``req`` at ``T`` mel
    frames, each take's waveform from ``noise`` ``[takes, 1, samples]``:
    the caption's and ""'s tower states, the latent, the mel and the
    waveform. ``precision`` is the stages before the vocoder's,
    ``voc_precision`` the vocoder's."""
    from benchmark.reference import models as ref
    from benchmark.reference import pwg

    P = ref.Precision(precision)
    model = config["model"]["params"]
    dit_cfg, vae_cfg = model["unet_config"]["params"], model["first_stage_config"]["params"]
    t5_params = model["cond_stage_config"]["params"]
    t5_cfg = t5_params["fallback_config"]
    B = mix["takes"]
    ids = torch.from_numpy(ref.hash_ids([req["caption"], ""], t5_cfg["vocab_size"],
                                        t5_params["max_length"])).to(device)
    cap = ref.t5_encode(W["t5"], t5_cfg, ids, P)
    midi = torch.from_numpy(np.repeat(req["midi"][None], B, 0)).to(device)
    beats = torch.from_numpy(np.repeat(req["beats"][None], B, 0)).to(device)
    cond = {"caption": cap[:1].expand(B, -1, -1), "midi": midi, "beats": beats}
    uncond = {"caption": cap[1:].expand(B, -1, -1), "midi": midi, "beats": beats}
    g = torch.Generator(device=device).manual_seed(req["noise_seed"])
    x0 = torch.randn((B, dit_cfg["in_channels"], (T + 1) // 2), generator=g, device=device,
                     dtype=torch.float32)
    z = ref.sample_cfg(W["dit"], dit_cfg, x0, cond, uncond, mix["cfg_scale"], mix["timesteps"],
                       P)
    mel = ref.vae_decode(W["vae"], vae_cfg["ddconfig"], z / float(model.get("scale_factor", 1.0)),
                         P)
    gen, V = config["vocoder"]["generator"], pwg.Precision(voc_precision)
    noise = noise.to(device)
    wav = torch.cat([pwg.vocode(W["voc"], gen, mel[i:i + 1], noise[i:i + 1], V)
                     for i in range(B)])
    return {"caption": cap[:1], "uncaption": cap[1:], "z": z, "mel": mel, "wav": wav}


@torch.no_grad()
def vocoder_gap(config, W, got_wav, noise, cpad, device, precision: str = "fp32") -> float:
    """``voc_gap``: a waveform ``[takes, samples]`` against the plain PWG at
    ``precision`` run take by take on the vocoder inputs that made it."""
    from benchmark.reference import pwg

    gen, P = config["vocoder"]["generator"], pwg.Precision(precision)
    want = torch.cat([pwg.generator(W["voc"], gen, noise[i:i + 1].to(device),
                                    cpad[i:i + 1].to(device), P) for i in range(len(noise))])
    return compare.rel_l2(got_wav, want)


def reference_check(config, mix, specs, seed, kept: List[Dict[str, Any]], clips: Clips,
                    device) -> Dict[str, float]:
    """The widest gap of each stage over the kept requests between their
    served outputs and the float32 reference's."""
    W = reference_weights(specs, seed, device)
    gaps = dict.fromkeys(STAGES, 0.0)
    for rec in kept:
        got = rec["kept"]
        want = reference_outputs(config, mix, W, clips[rec["index"]], clips.T, got["noise"],
                                 device)
        found = {**serve.stage_gaps(got, want),
                 "voc_gap": vocoder_gap(config, W, got["wav"], got["noise"], got["cpad"],
                                        device)}
        for k, v in found.items():
            gaps[k] = max(gaps[k], v)
    return gaps


def request_flops(config, mix, T: int) -> float:
    """Model FLOPs of one request at ``T`` mel frames: ``serve.py``'s count
    with the configuration's vocoder in HiFi-GAN's place."""
    model = config["model"]["params"]
    dit, B = model["unet_config"]["params"], mix["takes"]
    t5p = model["cond_stage_config"]["params"]
    L = t5p["max_length"]
    vae = model["first_stage_config"]["params"]
    t_lat = (T + 1) // 2
    f = 2 * flops.t5_encoder(t5p["fallback_config"], B, L)
    f += flops.dit_encode(dit, 2 * B, T, L)
    f += (mix["timesteps"] - 1) * flops.dit_forward(dit, 2 * B, t_lat, L)
    f += flops.vae_decode(vae["ddconfig"], vae["embed_dim"], B, t_lat)
    return f + B * wavenet.generator_flops(config["vocoder"]["generator"], 1, T)


def run(cell: Dict[str, Any], seed: int, seconds: float, trace: bool, t0: float,
        device: torch.device) -> Dict[str, Any]:
    from versband_tpu_torch.ops import fused_wavenet as fw
    from versband_tpu_torch.ops import flash_attention as fa
    from versband_tpu_torch.utils import profiling

    config, mix = cell["config_data"], cell["traffic_data"]
    clips = Clips(mix, seed)
    tracer = Tracer(False)
    prog = Program(config, mix, seed, device)
    loop = Loop(prog, mix, clips, tracer)

    # warm-up: every shape the timed requests use, the pipeline filled and drained
    loop.run(serve.WARMUP_OFFSET, lambda n: n < mix["warmup_requests"], set())
    serve._sync(device)

    keep_rng = np.random.default_rng([clips.seed, 7])
    first_n = mix["traced_requests"] if trace else mix["checked_from_first"]
    n_keep = min(mix["checked_requests"], first_n)
    keep = set(int(i) for i in keep_rng.choice(first_n, n_keep, replace=False))
    k1_before, k5_before = fa.LAUNCHES, fw.LAUNCHES
    prof = drained = None
    if trace:
        from torch.profiler import ProfilerActivity, profile

        tracer.enabled = True
        prof = profile(activities=[ProfilerActivity.CUDA if device.type == "cuda"
                                   else ProfilerActivity.CPU])
        prof.__enter__()
        profiling.spans_on()
        start = time.perf_counter()
        with tracer.span(WINDOW):
            records = loop.run(0, lambda n: n < first_n, keep)
            serve._sync(device)
            profiling.spans_off()
            drained = profiling.drain()
        end = time.perf_counter()
        prof.__exit__(None, None, None)
        tracer.enabled = False
    else:
        start = time.perf_counter()
        stop_at = start + seconds
        # as serve.py: no request is handed once the time is up, those sent
        # are waited for, and the clock is read after that wait
        records = loop.run(0, lambda n: time.perf_counter() < stop_at, keep)
        serve._sync(device)
        end = time.perf_counter()
    window = end - start
    setup_s = start - t0
    n = max(1, len(records))
    k1_launches, k5_launches = fa.LAUNCHES - k1_before, fw.LAUNCHES - k5_before
    peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0

    latencies = [r["done"] - r["handed"] for r in records]
    takes = mix["takes"]
    out: Dict[str, Any] = {
        "attempted": len(records),
        "peak_bytes": peak,
        "setup_s": setup_s,
        "notes": [f"{len(records)} requests handed and done in {window:.3f} s; "
                  f"K1 launches {k1_launches} ({k1_launches / n:.1f} a request); "
                  f"K5 launches {k5_launches} ({k5_launches / n:.1f} a request)"],
    }
    if not trace:
        out["end_to_end"] = {
            "clips_per_s": arith.rate(len(records) * takes, window),
            "clip_p90_ms": arith.percentile(latencies, 90) * 1e3,
            "peak_mem_gib": peak / 2 ** 30,
            "setup_s": setup_s,
        }
    else:
        summary = program_trace.summarize(prof, tracer.spans, *drained)
        del prof
        if summary is not None:
            out["notes"] += program_trace.notes(summary)
            summary.update(requests=len(records), takes=takes,
                           flops=request_flops(config, mix, clips.T) * len(records),
                           k1_bound_ms=serve.k1_bound_ms_per_request(config, mix, clips.T),
                           k5_bound_ms=wavenet.request_bound_ms(
                               config["vocoder"]["generator"], takes, clips.T,
                               config["vocoder"]["dtype"]),
                           peak_flops=config["mfu_peak_flops"])
        out["trace"] = summary

    # the program's state goes before the reference runs
    kept = [r for r in records if "kept" in r]
    specs = prog.specs
    for r in kept:
        r["kept"] = {k: (v.float().cpu() if torch.is_tensor(v) else v)
                     for k, v in r["kept"].items()}
    del loop, prog
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    out["failed"] = serve._lufs_failed(records, mix)
    missing = len(keep) - len(kept)
    gaps = reference_check(config, mix, specs, seed, kept, clips, device)
    out["checks"] = {**gaps, "missing_requests": float(missing),
                     "failed_requests": float(out["failed"])}
    return out
