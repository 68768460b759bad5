"""Serving driver for a configuration vocoded by BigVGAN: the closed loop of
``serve.py`` (one client through ``PipelinedGenerator``; the T5 tower, the
sampler, ``decode_first_stage``, each take vocoded in its own call as
``versband_tpu_torch.cli.generate`` vocodes, -23 LUFS on the host), with
the vocoder built by ``cli.generate.build_vocoder("bigvgan", ...)`` at the
configuration's ``vocoder.generator`` widths in ``vocoder.dtype``.

It takes from ``serve_vocoder.py`` (the PWG cell's driver) what BigVGAN
shares with it, and differs where BigVGAN differs:

* the vocoder stage is the driver span ``vocoder.bigvgan``;
* a forward pre-hook on the generator keeps each checked take's exact
  vocoder input (the decoded mel as the generator receives it), so the check
  can hold the waveform stage alone: ``voc_gap`` is the program's waveform
  against the plain BigVGAN (``benchmark/reference/bigvgan.py``) run on
  that mel, float32 against float32; ``wave_gap`` is the program's
  waveform against the reference end to end;
* the vocoder's weights follow the configuration's ``vocoder.init``
  (``vocoder_weights``);
* a traced run turns on the program's own spans and counters for the
  window; the summary carries ``k4_bound_ms``, the bound of a request's
  alias-free activations from the counter ``vocoder.bigvgan.act_samples``
  (``benchmark/lib/bigvgan.py``), beside ``flops`` and ``peak_flops``.
"""

from __future__ import annotations

import gc
import math
import time
from typing import Any, Dict, List

import numpy as np
import torch

from benchmark.drivers import serve, serve_vocoder
from benchmark.lib import arith, bigvgan, compare, flops, program_trace, weights
from benchmark.lib.trace import WINDOW, Tracer
from benchmark.lib.traffic import Clips

STAGES = serve_vocoder.STAGES
INITS = ("published", "fan_in")


def build_vocoder(vocoder: Dict[str, Any], device):
    """``cli.generate.build_vocoder("bigvgan")`` (``VocoderBigVGAN``) at
    ``vocoder["generator"]``'s widths in ``vocoder["dtype"]``."""
    from versband_tpu_torch.cli.generate import build_vocoder as cli_build

    if vocoder["family"] != "bigvgan":
        raise ValueError(f"serve_bigvgan serves the bigvgan family, not {vocoder['family']!r}")
    return cli_build("bigvgan", device=device, dtype=getattr(torch, vocoder["dtype"]),
                     **vocoder["generator"])


def vocoder_weights(spec, seed: int, device, init: str) -> Dict[str, torch.Tensor]:
    """The vocoder's float32 weights under ``seed`` from ``benchmark/lib/weights.py``'s
    standard-normal draw, by rule ``init``; log-alpha and log-beta are 0 in both:

    * ``published``: as the published code initialises the generator:
      ``init_weights``' N(0, 0.01) on every upsampler, AMP convolution and
      ``conv_post``; ``conv_pre`` and every bias at torch's default
      variance, 1 / (3 fan_in);
    * ``fan_in``: every convolution N(0, 1 / fan_in) (``weights.py``'s
      draw as it is), every bias 0.
    """
    if init not in INITS:
        raise ValueError(f"unknown vocoder init {init!r} (have {INITS})")
    W = weights.make(spec, seed, "voc", device)
    shapes = dict(spec)
    for name, w in W.items():
        if name.endswith((".alpha", ".beta")):
            W[name] = torch.zeros_like(w)
        elif init == "fan_in":
            W[name] = w if w.ndim >= 2 else torch.zeros_like(w)
        elif w.ndim >= 2:
            fan_in = math.prod(w.shape[1:])
            W[name] = w * (math.sqrt(1 / 3) if name.startswith("conv_pre.")
                           else 0.01 * math.sqrt(fan_in))
        else:  # a bias: weights.py drew it N(0, 0.01)
            fan_in = math.prod(shapes[name[:-len("bias")] + "weight"][1:])
            W[name] = w * 10.0 / math.sqrt(3 * fan_in)
    return W


def reference_weights(config, specs, seed: int, device) -> Dict[str, Dict[str, torch.Tensor]]:
    """Every model's weights under ``seed``, the vocoder's by ``vocoder_weights``."""
    W = {name: weights.make(specs[name], seed, name, device) for name in serve.MODELS
         if name != "voc"}
    W["voc"] = vocoder_weights(specs["voc"], seed, device, config["vocoder"]["init"])
    return W


class Program(serve.Program):
    """``serve.Program`` with the configuration's BigVGAN, its weights by
    ``vocoder_weights``."""

    def __init__(self, config: Dict[str, Any], mix: Dict[str, Any], seed: int, device):
        from versband_tpu_torch.models.cfm import CFMSampler
        from versband_tpu_torch.utils.config import instantiate_from_config

        self.device = device
        self.dtype = getattr(torch, config["serve_dtype"])
        self.cfm = instantiate_from_config(config["model"], device=device, dtype=self.dtype)
        self.sampler = CFMSampler(self.cfm, num_timesteps=mix["timesteps"])
        self.vocoder = build_vocoder(config["vocoder"], device)
        self.init = config["vocoder"]["init"]
        self.specs = {}
        self.reseed(seed)

    def reseed(self, seed: int) -> None:
        for name, module in self.modules().items():
            spec = self.specs.setdefault(name, weights.spec_of(module))
            if name != "voc":
                weights.fill(module, spec, seed, name, self.device)
        W = vocoder_weights(self.specs["voc"], seed, self.device, self.init)
        with torch.no_grad():
            for name, p in self.vocoder.model.named_parameters():
                p.copy_(W[name])


class Loop(serve_vocoder.Loop):
    """``serve_vocoder.Loop`` (its pre-hook keeps the generator's inputs)
    with BigVGAN's span and its one input, the mel."""

    def _vocode(self, mel):
        kept = self._rec.get("kept")
        self._inputs = [] if kept is not None else None
        with self.tracer.span("vocoder.bigvgan"):
            wav = torch.cat([self.prog.vocoder.waveform(m[None]) for m in mel])
        if kept is not None:
            kept["voc_mel"] = torch.cat([a[0] for a in self._inputs])
        self._inputs = None
        return wav


@torch.no_grad()
def reference_outputs(config, mix, W, req: Dict[str, Any], T: int, device,
                      precision: str = "fp32", voc_precision: str = "fp32"
                      ) -> Dict[str, torch.Tensor]:
    """What the plain reference serves for request ``req`` at ``T`` mel
    frames: the caption's and ""'s tower states, the latent, the mel and
    the waveform of each take. ``precision`` is the stages before the
    vocoder's, ``voc_precision`` the vocoder's."""
    from benchmark.reference import bigvgan as ref_voc
    from benchmark.reference import models as ref

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
    wav = ref_voc.vocode(W["voc"], config["vocoder"]["generator"], mel,
                         ref_voc.Precision(voc_precision))
    return {"caption": cap[:1], "uncaption": cap[1:], "z": z, "mel": mel, "wav": wav}


@torch.no_grad()
def vocoder_gap(config, W, got_wav, voc_mel, device, precision: str = "fp32") -> float:
    """``voc_gap``: a waveform ``[takes, samples]`` against the plain BigVGAN
    at ``precision`` run take by take on the mels the generator was given."""
    from benchmark.reference import bigvgan as ref_voc

    want = ref_voc.vocode(W["voc"], config["vocoder"]["generator"], voc_mel.to(device),
                          ref_voc.Precision(precision))
    return compare.rel_l2(got_wav, want)


def reference_check(config, mix, specs, seed, kept: List[Dict[str, Any]], clips: Clips,
                    device) -> Dict[str, float]:
    """The widest gap of each stage over the kept requests between their
    served outputs and the float32 reference's."""
    W = reference_weights(config, specs, seed, device)
    gaps = dict.fromkeys(STAGES, 0.0)
    for rec in kept:
        got = rec["kept"]
        want = reference_outputs(config, mix, W, clips[rec["index"]], clips.T, device)
        found = {**serve.stage_gaps(got, want),
                 "voc_gap": vocoder_gap(config, W, got["wav"], got["voc_mel"], device)}
        for k, v in found.items():
            gaps[k] = max(gaps[k], v)
    return gaps


def request_flops(config, mix, T: int) -> float:
    """Model FLOPs of one request at ``T`` mel frames: ``serve.py``'s count
    with BigVGAN in HiFi-GAN's place."""
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
    return f + B * bigvgan.generator_flops(config["vocoder"]["generator"], 1, T)


def run(cell: Dict[str, Any], seed: int, seconds: float, trace: bool, t0: float,
        device: torch.device) -> Dict[str, Any]:
    from versband_tpu_torch.ops import flash_attention as fa
    from versband_tpu_torch.ops import fused_act1d as fa1
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
    k1_before, k4_before = fa.LAUNCHES, fa1.LAUNCHES
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
    k1_launches, k4_launches = fa.LAUNCHES - k1_before, fa1.LAUNCHES - k4_before
    peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0

    latencies = [r["done"] - r["handed"] for r in records]
    takes = mix["takes"]
    out: Dict[str, Any] = {
        "attempted": len(records),
        "peak_bytes": peak,
        "setup_s": setup_s,
        "notes": [f"{len(records)} requests handed and done in {window:.3f} s; "
                  f"K1 launches {k1_launches} ({k1_launches / n:.1f} a request); "
                  f"K4 launches {k4_launches} ({k4_launches / n:.1f} a request)"],
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
                           peak_flops=config["mfu_peak_flops"])
            samples = summary["counters"].get("vocoder.bigvgan.act_samples")
            if samples:
                bound, _ = bigvgan.act_bound_ms(samples, config["vocoder"]["dtype"])
                summary["k4_bound_ms"] = bound / n
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
