"""Serving driver: one client in a closed loop through the port's
``PipelinedGenerator``, each request a clip (or several takes of it) as
``versband_tpu_torch.cli.generate`` composes it:

1. ``cfm.get_learned_conditioning`` on the caption and on ``""`` (CFG);
2. ``start_noise`` and ``CFMSampler.sample_cfg`` (the Band-MoE DiT, K1);
3. ``cfm.decode_first_stage``;
4. the ``HifiGAN`` wrapper on each take's mel;
5. ``dsp.loudness.normalize_loudness`` to the target on the host.

A request is timed from when the pipeline takes it to when its last take is
normalised on the host. Once the window has closed and the program is freed,
the plain reference (``benchmark/reference``) serves the checked requests
again from the same seed-made weights and inputs in float32, and each stage's
output is compared with the program's.
"""

from __future__ import annotations

import gc
import time
from typing import Any, Callable, Dict, List, Optional

import numpy as np
import torch

from benchmark.lib import arith, compare, flops, weights
from benchmark.lib.trace import WINDOW, Tracer, summarize
from benchmark.lib.traffic import Clips

WARMUP_OFFSET = 1 << 40  # warm-up requests are drawn from indices no timed request uses
MODELS = ("dit", "vae", "t5", "voc")


class Program:
    """The port's serving objects for a configuration, its weights made from
    ``seed`` on ``device``."""

    def __init__(self, config: Dict[str, Any], mix: Dict[str, Any], seed: int, device):
        from versband_tpu_torch.cli.generate import build_vocoder
        from versband_tpu_torch.models.cfm import CFMSampler
        from versband_tpu_torch.utils.config import instantiate_from_config

        self.device = device
        self.dtype = getattr(torch, config["serve_dtype"])
        self.cfm = instantiate_from_config(config["model"], device=device, dtype=self.dtype)
        self.sampler = CFMSampler(self.cfm, num_timesteps=mix["timesteps"])
        self.vocoder = build_vocoder(config["vocoder"]["family"], device=device, dtype=self.dtype)
        self.specs = {}
        self.reseed(seed)

    def modules(self) -> Dict[str, torch.nn.Module]:
        return {"dit": self.cfm.model, "vae": self.cfm.first_stage,
                "t5": self.cfm.cond_stage.tower.model, "voc": self.vocoder.model}

    def reseed(self, seed: int) -> None:
        for name, module in self.modules().items():
            spec = self.specs.setdefault(name, weights.spec_of(module))
            weights.fill(module, spec, seed, name, self.device)


STAGES = ("cond_gap", "latent_gap", "mel_gap", "wave_gap")


def reference_weights(specs, seed, device) -> Dict[str, Dict[str, torch.Tensor]]:
    return {name: weights.make(specs[name], seed, name, device) for name in MODELS}


@torch.no_grad()
def reference_outputs(config, mix, W, req: Dict[str, Any], T: int, device,
                      precision: str = "fp32") -> Dict[str, torch.Tensor]:
    """What the plain reference serves for request ``req`` at ``T`` mel
    frames: the caption's and ""'s tower states, the latent, the mel and
    the waveform of each take."""
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
    return {"caption": cap[:1], "uncaption": cap[1:], "z": z, "mel": mel,
            "wav": ref.hifigan(W["voc"], config["vocoder"]["generator"], mel, P)}


@torch.no_grad()
def tower_control_gap(config, W, req: Dict[str, Any], device, precision: str = "tf32") -> float:
    """``cond_gap`` of the reference's caption tower computed at
    ``precision`` in the program's place (the tower's control: the float32
    tower's next precision down), against the float32 tower."""
    from benchmark.reference import models as ref

    t5_params = config["model"]["params"]["cond_stage_config"]["params"]
    t5_cfg = t5_params["fallback_config"]
    ids = torch.from_numpy(ref.hash_ids([req["caption"], ""], t5_cfg["vocab_size"],
                                        t5_params["max_length"])).to(device)
    want = ref.t5_encode(W["t5"], t5_cfg, ids, ref.Precision("fp32"))
    got = ref.t5_encode(W["t5"], t5_cfg, ids, ref.Precision(precision))
    return max(compare.rel_l2(got[i], want[i]) for i in range(2))


def stage_gaps(got: Dict[str, Any], want: Dict[str, torch.Tensor]) -> Dict[str, float]:
    """Relative L2 gap of each stage of one request."""
    return {"cond_gap": max(compare.rel_l2(got["caption"], want["caption"]),
                            compare.rel_l2(got["uncaption"], want["uncaption"])),
            "latent_gap": compare.rel_l2(got["z"], want["z"]),
            "mel_gap": compare.rel_l2(got["mel"], want["mel"]),
            "wave_gap": compare.rel_l2(got["wav"], want["wav"])}


def reference_check(config, mix, specs, seed, kept: List[Dict[str, Any]], clips: Clips,
                    device) -> Dict[str, float]:
    """The widest gap of each stage over the kept requests between their
    served outputs and the float32 reference's."""
    W = reference_weights(specs, seed, device)
    gaps = dict.fromkeys(STAGES, 0.0)
    for rec in kept:
        want = reference_outputs(config, mix, W, clips[rec["index"]], clips.T, device)
        for k, v in stage_gaps(rec["kept"], want).items():
            gaps[k] = max(gaps[k], v)
    return gaps


def _sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class Loop:
    """The closed loop of one client over the program."""

    def __init__(self, prog: Program, mix: Dict[str, Any], clips: Clips, tracer: Tracer):
        from versband_tpu_torch.cli.generate import start_noise
        from versband_tpu_torch.dsp.loudness import normalize_loudness
        from versband_tpu_torch.sample.pipeline import PipelinedGenerator

        self.prog, self.mix, self.clips, self.tracer = prog, mix, clips, tracer
        self.start_noise, self.normalize = start_noise, normalize_loudness
        self.pipe = PipelinedGenerator(self._sample, self._decode, self._vocode,
                                       depth=mix["depth"])
        self._rec: Optional[Dict[str, Any]] = None
        # the tower's float32 states as it produced them, before the cast to
        # the serving dtype, for the checked requests
        self._states: Optional[List[torch.Tensor]] = None
        prog.cfm.cond_stage.tower.register_forward_hook(self._keep_states)

    def _keep_states(self, _module, _args, out) -> None:
        if self._states is not None:
            self._states.append(out)

    def _cond(self, req, caption: str) -> Dict[str, Any]:
        d, B = self.prog.device, self.mix["takes"]
        acoustic = {"acoustic": torch.from_numpy(np.repeat(req["vocal"][None], B, 0)).to(d),
                    "midi": torch.from_numpy(np.repeat(req["midi"][None], B, 0)).to(d),
                    "beats": torch.from_numpy(np.repeat(req["beats"][None], B, 0)).to(d)}
        return {"caption": [caption] * B, "acoustic": acoustic, "name": [str(req["index"])] * B}

    def _sample(self, item, _generator):
        req, rec = item
        self._rec = rec
        cfm, B, span = self.prog.cfm, self.mix["takes"], self.tracer.span
        self._states = [] if "kept" in rec else None
        with span("text.t5"):
            c = cfm.get_learned_conditioning(self._cond(req, req["caption"]))
            uc = cfm.get_learned_conditioning(self._cond(req, ""))
        states, self._states = self._states, None
        with span("models.cfm.sampler"):
            g = torch.Generator(device=self.prog.device).manual_seed(req["noise_seed"])
            shape = (B, cfm.mel_dim, cfm.latent_length(self.clips.T))
            x0 = self.start_noise(g, shape, self.prog.device)
            z = self.prog.sampler.sample_cfg(c, self.mix["cfg_scale"], uc, batch_size=B,
                                             x_latent=x0)
        if "kept" in rec:
            rec["kept"].update(caption=states[0][:1], uncaption=states[1][:1], z=z)
        return z

    def _decode(self, z):
        with self.tracer.span("models.autoencoder.decode"):
            mel = self.prog.cfm.decode_first_stage(z)
        if "kept" in self._rec:
            self._rec["kept"]["mel"] = mel
        return mel

    def _vocode(self, mel):
        with self.tracer.span("vocoder.hifigan"):
            return torch.cat([self.prog.vocoder.waveform(m[None]) for m in mel])

    def run(self, first: int, more: Callable[[int], bool], keep: set) -> List[Dict[str, Any]]:
        """Requests ``first, first + 1, ...`` while ``more(count handed)``;
        the records in request order, with the outputs of ``keep``."""
        records: List[Dict[str, Any]] = []

        def requests():
            while more(len(records)):
                i = first + len(records)
                rec = {"index": i}
                if i in keep:
                    rec["kept"] = {}
                records.append(rec)
                req = self.clips[i]
                rec["handed"] = time.perf_counter()
                yield (req, rec), None

        span = self.tracer.span
        target = self.mix["target_lufs"]
        it = self.pipe.generate(requests())
        done = 0
        while True:
            with span("sample.pipeline.next"):
                try:
                    wavs = next(it)
                except StopIteration:
                    break
            rec = records[done]
            with span("dsp.loudness"):
                rec["out"] = [self.normalize(w, target) for w in wavs]
            rec["done"] = time.perf_counter()
            if "kept" in rec:
                rec["kept"]["wav"] = wavs
            done += 1
        return records


def _lufs_failed(records, mix) -> int:
    from benchmark.reference.loudness import integrated_loudness

    bad = 0
    for rec in records:
        ok = all(np.isfinite(o).all() and abs(integrated_loudness(o, 24000) - mix["target_lufs"])
                 <= mix["lufs_tolerance"] for o in rec["out"])
        bad += not ok
    return bad


def request_flops(config, mix, T: int) -> float:
    """Model FLOPs of one request at ``T`` mel frames."""
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
    return f + B * flops.hifigan(config["vocoder"]["generator"], 1, T)


def k1_bound_ms_per_request(config, mix, T: int) -> float:
    """Bound of the DiT's self-attention over a request's calls."""
    dit = config["model"]["params"]["unet_config"]["params"]
    t_lat, H = (T + 1) // 2, dit["num_heads"]
    per_call, _ = arith.k1_bound_ms(2 * mix["takes"], t_lat, t_lat, H, dit["hidden_size"] // H,
                                    config["serve_dtype"])
    return per_call * (mix["timesteps"] - 1) * dit["depth"]


def run(cell: Dict[str, Any], seed: int, seconds: float, trace: bool, t0: float,
        device: torch.device) -> Dict[str, Any]:
    config, mix = cell["config_data"], cell["traffic_data"]
    clips = Clips(mix, seed)
    tracer = Tracer(False)
    prog = Program(config, mix, seed, device)
    loop = Loop(prog, mix, clips, tracer)
    from versband_tpu_torch.ops import flash_attention as fa

    # warm-up: every shape the timed requests use, the pipeline filled and drained
    loop.run(WARMUP_OFFSET, lambda n: n < mix["warmup_requests"], set())
    _sync(device)

    keep_rng = np.random.default_rng([clips.seed, 7])
    first_n = mix["traced_requests"] if trace else mix["checked_from_first"]
    n_keep = min(mix["checked_requests"], first_n)
    keep = set(int(i) for i in keep_rng.choice(first_n, n_keep, replace=False))
    k1_before = fa.LAUNCHES
    prof = None
    if trace:
        from torch.profiler import ProfilerActivity, profile

        tracer.enabled = True
        prof = profile(activities=[ProfilerActivity.CUDA if device.type == "cuda"
                                   else ProfilerActivity.CPU])
        prof.__enter__()
        start = time.perf_counter()
        with tracer.span(WINDOW):
            records = loop.run(0, lambda n: n < first_n, keep)
            _sync(device)
        end = time.perf_counter()
        prof.__exit__(None, None, None)
        tracer.enabled = False
        window = end - start
    else:
        start = time.perf_counter()
        stop_at = start + seconds
        # the pipeline holds up to ``depth`` requests in flight: once the time
        # is up none more is handed, those sent are waited for, and the clock
        # is read after that wait, so all of that work counts over all of it
        records = loop.run(0, lambda n: time.perf_counter() < stop_at, keep)
        _sync(device)
        end = time.perf_counter()
        window = end - start
    setup_s = start - t0
    k1_launches = fa.LAUNCHES - k1_before
    peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0

    latencies = [r["done"] - r["handed"] for r in records]
    takes = mix["takes"]
    out: Dict[str, Any] = {
        "attempted": len(records),
        "peak_bytes": peak,
        "setup_s": setup_s,
        "notes": [f"{len(records)} requests handed and done in {window:.3f} s; "
                  f"K1 launches {k1_launches} "
                  f"({k1_launches / max(1, len(records)):.1f} a request)"],
    }
    if not trace:
        out["end_to_end"] = {
            "clips_per_s": arith.rate(len(records) * takes, window),
            "clip_p90_ms": arith.percentile(latencies, 90) * 1e3,
            "peak_mem_gib": peak / 2 ** 30,
            "setup_s": setup_s,
        }
    else:
        summary = summarize(prof, tracer.spans)
        del prof
        if summary is not None:
            out["notes"].append(f"traced: {summary['linked_share']:.4f} of the device "
                                f"operations linked to a span")
            summary.update(requests=len(records), takes=takes,
                           flops=request_flops(config, mix, clips.T) * len(records),
                           k1_bound_ms=k1_bound_ms_per_request(config, mix, clips.T),
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
    out["failed"] = _lufs_failed(records, mix)
    missing = len(keep) - len(kept)
    gaps = reference_check(config, mix, specs, seed, kept, clips, device)
    out["checks"] = {**gaps, "missing_requests": float(missing),
                     "failed_requests": float(out["failed"])}
    return out
