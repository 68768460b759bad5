"""Training driver: a stage of AccompBand as ``versband_tpu_torch.cli.train``
runs it, from a manifest the driver writes from the seed into ``TMPDIR``:
stage 2 (the CFM, ``CFMTrainer``) or stage 1 (the VAE-GAN, ``VAETrainer``),
as the configuration says.

``cli.train.main(argv, run=hook)`` builds the data module, the models and
the trainer and hands them to the hook before ``fit``: the hook puts the
seed-made weights into every model (stage 2: the DiT, the frozen VAE and the
caption tower; stage 1: the VAE and the loss module with its PatchGAN), and
adds the benchmark's callback. ``fit`` then drives the one trainer through
its first steps (set-up: the first three are the checked steps), and on
through the window; the callback ends the run when the window closes.

The plain reference (``benchmark/reference/train.py``, ``vae_gan.py``)
follows the three checked steps from the batches the trainer fed (the
loader's crops and captions come from threads whose order no seed fixes, so
the reference takes the batches, and the driver checks each row against the
raw files it wrote) and from the seed of the trainer's draws.
"""

from __future__ import annotations

import copy
import gc
import os
import shutil
import statistics
import time
from typing import Any, Dict, List

import numpy as np
import torch

from benchmark.lib import arith, flops, weights
from benchmark.lib.trace import WINDOW, Tracer, summarize
from versband_tpu_torch.train.callbacks import Callback

CHECKED_STEPS = 3


class WindowClosed(Exception):
    """Raised by the callback to end ``fit`` once the window has closed."""


class _Hook(dict):
    """``cli.train.main``'s ``run`` dict: sees the trainer before ``fit``."""

    def __init__(self, on_trainer):
        super().__init__()
        self.on_trainer = on_trainer

    def update(self, *args, **kw):
        super().update(*args, **kw)
        if "trainer" in self:
            self.on_trainer(self["trainer"])


def write_data(mix: Dict[str, Any], seed: int, root: str) -> Dict[str, Any]:
    """``mix["songs"]`` songs (accompaniment and vocal mels, MIDI, beats) of
    lengths uniform in ``song_s``, and a manifest of ``mix["rows"]`` rows
    over them, round-robin, each with its own caption fields."""
    from versband_tpu_torch.data.manifests import write_tsv

    rng = np.random.default_rng([int(seed) % (1 << 63), 11])
    os.makedirs(os.path.join(root, "manifests"), exist_ok=True)
    fps = mix["frames_per_s"]
    songs = []
    for i in range(mix["songs"]):
        T = int(rng.uniform(*mix["song_s"]) * fps)
        mel, voc = os.path.join(root, f"s{i}_mel.npy"), os.path.join(root, f"s{i}_vocal.npy")
        np.save(mel, rng.standard_normal((80, T), np.float32) * 0.5 - 2.0)
        np.save(voc, rng.standard_normal((80, T), np.float32) * 0.5 - 2.0)
        midi = np.zeros(T, np.uint8)
        pos = 0
        while pos < T:
            n = max(1, int(rng.uniform(*mix["note_s"]) * fps))
            midi[pos:pos + n] = 0 if rng.random() < mix["rest_share"] else \
                rng.integers(mix["midi_range"][0], mix["midi_range"][1] + 1)
            pos += n
        period = 60.0 * fps / rng.uniform(*mix["tempo_bpm"])
        beats = np.zeros(T, np.uint8)
        beats[np.round(np.arange(rng.uniform(0, period), T, period)).astype(np.int64)
              .clip(0, T - 1)] = 1
        songs.append(dict(mel=mel, vocal=voc, T=T, midi=midi, beats=beats))
    n, styles, fill = mix["rows"], mix["styles"], mix["fill"]
    keys, emotions = fill["[Key]"], fill["[emotional characteristics]"]
    # every row's draws in a few bulk calls: two distinct styles, a key, an emotion
    pick = rng.random((n, len(styles))).argsort(1)[:, :2]
    key = rng.integers(len(keys), size=n)
    key_conf, avg_pitch = rng.uniform(0.5, 1.0, n), rng.uniform(50, 80, n)
    tempo, tempo_conf = rng.uniform(*mix["tempo_bpm"], n), rng.uniform(0.5, 1.0, n)
    emotion = rng.integers(len(emotions), size=n)
    rows, midi_d, beats_d = [], {}, {}
    for j in range(n):
        s = songs[j % len(songs)]
        name = f"row{j}"
        midi_d[name], beats_d[name] = s["midi"], s["beats"]
        sec = s["T"] / fps
        rows.append(dict(
            name=name, dataset="bench", mel_path=s["mel"], vocal_mel_path=s["vocal"],
            duration=sec, caption="<psep>".join(styles[k] for k in pick[j]),
            key=keys[key[j]], key_confidence=float(key_conf[j]),
            avg_pitch=float(avg_pitch[j]), tempo=float(tempo[j]),
            tempo_confidence=float(tempo_conf[j]), emotion=str([emotions[emotion[j]]]),
            wav_len=sec, audio_path=""))
    write_tsv(os.path.join(root, "manifests", "music.tsv"), list(rows[0]), rows)
    midi_path = os.path.join(root, "midi.npy")
    np.save(midi_path, midi_d, allow_pickle=True)
    np.save(os.path.join(root, "beats.npy"), beats_d, allow_pickle=True)
    return {"manifest": os.path.join(root, "manifests"), "midi": midi_path, "songs": songs}


def run_config(config: Dict[str, Any], mix: Dict[str, Any], data: Dict[str, Any]) -> dict:
    """The YAML the CLI is given: the configuration with the data paths."""
    cfg = copy.deepcopy({k: config[k] for k in ("model", "data", "lightning")})
    p = cfg["data"]["params"]
    p.update(batch_size=mix["batch_size"], spec_crop_len=mix["crop_frames"])
    if stage1(config):
        p.update(spec_dir_path=data["manifest"], spec_len=mix["crop_frames"])
    else:
        p.update(main_spec_dir_path=data["manifest"], other_condition=data["midi"])
    return cfg


def stage1(config) -> bool:
    """Whether the configuration trains the VAE-GAN (stage 1)."""
    return config["model"]["target"].endswith("AutoencoderKL")


def lr_of(config, mix) -> float:
    """The CLI's LR: accumulate x devices x batch x base."""
    return 1 * 1 * mix["batch_size"] * float(config["model"]["base_learning_rate"])


def schedule_of(config) -> dict:
    p = config["model"]["params"]["scheduler_config"]["params"]
    return {"warm_up": int(p["warm_up_steps"][0]), "f_start": float(p["f_start"][0]),
            "f_max": float(p["f_max"][0])}


def step_flops(config, mix) -> float:
    """Model FLOPs of a step. Stage 2: the DiT's forward and backward (every
    expert: training routing is soft), the frozen VAE encode and the tower
    forward. Stage 1: the VAE's forward and backward, and the PatchGAN's
    forward and backward on the reconstruction and on the input (the R1
    penalty's double backward left out)."""
    model = config["model"]["params"]
    if stage1(config):
        dd, B, T = model["ddconfig"], mix["batch_size"], mix["padded_frames"]
        vae = flops.vae_encode(dd, model["embed_dim"], B, T)
        vae += flops.vae_decode(dd, model["embed_dim"], B, T // 2)
        return 3 * vae + 6 * flops.patchgan(B, dd["out_ch"], T)
    dit = model["unet_config"]["params"]
    B, T = mix["batch_size"], mix["padded_frames"]
    t5p = model["cond_stage_config"]["params"]
    L = t5p["max_length"]
    vae = model["first_stage_config"]["params"]
    f = 3 * (flops.dit_encode(dit, B, T, L) + flops.dit_forward(dit, B, T // 2, L, dense=True))
    f += flops.vae_encode(vae["ddconfig"], vae["embed_dim"], B, T)
    return f + flops.t5_encoder(t5p["fallback_config"], B, L)


def attn_bound_ms_per_step(config, mix) -> float:
    """Bound of the DiT's self-attention forward and backward over a step."""
    dit = config["model"]["params"]["unet_config"]["params"]
    B, T, H = mix["batch_size"], mix["padded_frames"] // 2, dit["num_heads"]
    D = dit["hidden_size"] // H
    one = arith.k1_bound_ms(B, T, T, H, D, "float32")[0]
    one += arith.bwd_bound_ms(B, T, T, H, D, "float32", "dq")[0]
    one += arith.bwd_bound_ms(B, T, T, H, D, "float32", "dkv")[0]
    return one * dit["depth"]


def _windows(raw: np.ndarray, mel: np.ndarray) -> List[int]:
    """The starts at which ``mel`` is a window of ``raw``."""
    n = mel.shape[1]
    hits = np.flatnonzero(raw[0, : raw.shape[1] - n + 1] == mel[0, 0])
    return [s for s in hits if np.array_equal(raw[:, s:s + n], mel)]


def check_rows(batches: List[Dict[str, Any]], data: Dict[str, Any], mix) -> int:
    """Rows of the checked batches that are not a crop of the raw files the
    driver wrote (the loader stage the reference does not follow): the mel
    crop must be a window of the row's song (of some song, for stage 1's
    rows, which carry no name), and its MIDI and beats that window of the
    song's, or their pad values where the loader dropped them."""
    bad = 0
    n = mix["crop_frames"]
    for batch in batches:
        if "name" not in batch:
            for mel in batch["image"]:
                bad += not any(_windows(np.load(s["mel"], mmap_mode="r"), mel[:, :n])
                               for s in data["songs"])
            continue
        for r, name in enumerate(batch["name"]):
            song = data["songs"][int(name[3:]) % len(data["songs"])]
            starts = _windows(np.load(song["mel"], mmap_mode="r"), batch["image"][r, :, :n])
            ac = batch["caption"]["acoustic"]
            midi, beats = ac["midi"][r, 0, :n], ac["beats"][r, 0, :n]
            ok = False
            for s in starts:
                ok |= bool((np.array_equal(midi, song["midi"][s:s + n])
                            and np.array_equal(beats, song["beats"][s:s + n]))
                           or ((midi == 128).all() and (beats == 2).all()))
            bad += not ok
    return bad


def _leaf_gap(got: Dict[str, float], want: Dict[str, float], counted) -> float:
    """The widest gap between the programs's and the reference's norm of a
    leaf, over the larger of that leaf's reference norm and the median's."""
    med = statistics.median(want[k] for k in counted)
    return max(abs(got[k] - want[k]) / max(want[k], med) for k in counted)


def counted_leaves(ref: Dict[str, Any]) -> List[str]:
    """The leaves compared: those whose reference gradient is at least a
    thousandth of the median leaf's (the others move by round-off alone
    under Adam)."""
    med = statistics.median(ref["grad1"].values())
    return [k for k, v in ref["grad1"].items() if v >= 1e-3 * med]


def compare_steps(prog: Dict[str, Any], ref: Dict[str, Any]) -> Dict[str, float]:
    """Loss, first-gradient and update gaps over the counted leaves."""
    counted = counted_leaves(ref)
    return {
        "loss_gap": max(abs(a - b) / abs(b) for a, b in zip(prog["losses"], ref["losses"])),
        "grad_gap": _leaf_gap(prog["grad1"], ref["grad1"], counted),
        "update_gap": _leaf_gap(prog["delta"], ref["delta"], counted),
    }


def models(trainer) -> Dict[str, torch.nn.Module]:
    """Every model a trainer holds, by the name its weights are made under."""
    if hasattr(trainer, "cfm"):
        cfm = trainer.cfm
        return {"dit": cfm.model, "vae": cfm.first_stage, "t5": cfm.cond_stage.tower.model}
    return {"vae": trainer.vae, "gan": trainer.loss}


def trained(trainer) -> Dict[str, tuple]:
    """The models a trainer trains, each with its optimizer."""
    if hasattr(trainer, "cfm"):
        return {"dit": (trainer.cfm.model, trainer.state.optimizer)}
    return {"vae": (trainer.vae, trainer.gen_state.optimizer),
            "gan": (trainer.loss, trainer.disc_state.optimizer)}


def step_losses(trainer, metrics) -> list:
    """A step's losses: the CFM loss, or the VAE's and the discriminator's."""
    if hasattr(trainer, "cfm"):
        return [metrics["loss"]]
    return [metrics["aeloss"], metrics["discloss"]]


class _Bench(Callback):
    """The run's callback: captures the checked steps, times the window."""

    def __init__(self, mix, seconds: float, trace: bool, device, seed: int, specs,
                 checked_only: bool = False):
        self.mix, self.seconds, self.trace, self.device = mix, seconds, trace, device
        self.seed, self.specs, self.checked_only = seed, specs, checked_only
        self.batches: List[Dict[str, Any]] = []
        self.losses: List[float] = []
        self.grad1: Dict[str, float] = {}
        self.delta: Dict[str, float] = {}
        self.bad = None
        self.tracer = Tracer(False)
        self.prof = None
        self.start_step = CHECKED_STEPS + mix["warmup_steps"]
        self.t_start = None

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def on_epoch_end(self, trainer, epoch):
        raise RuntimeError("an epoch ended before the window closed: too few rows")

    def on_train_batch_end(self, trainer, batch, metrics, step: int):
        players = trained(trainer)
        if step <= CHECKED_STEPS:
            self.batches.append(copy.deepcopy({k: batch[k] for k in ("image", "caption", "name")
                                               if k in batch}))
            self.losses += [float(v) for v in step_losses(trainer, metrics)]
            if step == 1:
                for name, (module, opt) in players.items():
                    beta1 = opt.param_groups[0]["betas"][0]
                    # a leaf the optimizer never stepped reads no gradient
                    self.grad1.update({
                        f"{name}.{k}": float(opt.state[p]["exp_avg"].norm()) / (1 - beta1)
                        if "exp_avg" in opt.state.get(p, {}) else 0.0
                        for k, p in module.named_parameters()})
            if step == CHECKED_STEPS:
                for name, (module, _) in players.items():
                    start = weights.make(self.specs[name], self.seed, name, self.device)
                    self.delta.update({f"{name}.{k}": float((p.detach() - start[k]).norm())
                                       for k, p in module.named_parameters()})
                del start
                if self.checked_only:
                    raise WindowClosed
        elif step == self.start_step:
            self._sync()
            self.bad = torch.zeros((), device=self.device)
            self.first = step
            if self.trace:
                from torch.profiler import ProfilerActivity, profile

                self.prof = profile(activities=[ProfilerActivity.CUDA
                                                if self.device.type == "cuda"
                                                else ProfilerActivity.CPU])
                self.prof.__enter__()
                self.tracer.enabled = True
                self.window_span = self.tracer.span(WINDOW)
                self.window_span.__enter__()
            self.t_start = time.perf_counter()
        elif step > self.start_step:
            self.bad += (~torch.isfinite(sum(step_losses(trainer, metrics)))).float()
            done = (step - self.first >= self.mix["traced_steps"]) if self.trace else \
                time.perf_counter() >= self.t_start + self.seconds
            if done:
                self._sync()
                self.t_end = time.perf_counter()
                self.steps = step - self.first
                if self.trace:
                    self.window_span.__exit__(None, None, None)
                    self.prof.__exit__(None, None, None)
                    self.tracer.enabled = False
                raise WindowClosed


def drive(cell: Dict[str, Any], seed: int, seconds: float, trace: bool, device,
          checked_only: bool = False):
    """``cli.train.main`` on the cell's data until the callback ends it:
    the callback, the specs of the trainer's models, and the data written."""
    from versband_tpu_torch.cli import train as cli_train
    from versband_tpu_torch.utils import yaml_subset

    config, mix = cell["config_data"], cell["traffic_data"]
    root = os.path.join(os.environ.get("TMPDIR", "/tmp"), "versband_bench", cell["name"])
    shutil.rmtree(root, ignore_errors=True)
    data = write_data(mix, seed, root)
    data["root"] = root
    cfg_path = os.path.join(root, "run.yaml")
    with open(cfg_path, "w") as f:
        f.write(yaml_subset.dumps(run_config(config, mix, data)))
    got = {}

    def on_trainer(trainer):
        modules = models(trainer)
        specs = {name: weights.spec_of(m) for name, m in modules.items()}
        for name, module in modules.items():
            weights.fill(module, specs[name], seed, name, device)
        got["cb"] = _Bench(mix, seconds, trace, device, seed, specs, checked_only)
        got["specs"] = specs
        trainer.callbacks.append(got["cb"])

    argv = ["--base", cfg_path, "-t", "--no-test", "-s", str(trainer_seed(seed)),
            "-l", os.path.join(root, "logs"), "--name", "bench"]
    if device.type == "cpu":
        argv += ["--platform", "cpu"]
    hook = _Hook(on_trainer)
    try:
        cli_train.main(argv, run=hook)
        raise RuntimeError("training ended before the window closed")
    except WindowClosed:
        pass
    hook.clear()
    return got["cb"], got["specs"], data


def trainer_seed(seed: int) -> int:
    return int(seed) % (1 << 31)


def reference(cell, seed, specs, batches, device, **kw) -> Dict[str, Any]:
    from benchmark.reference import train as ref_train
    from benchmark.reference import vae_gan

    config, mix = cell["config_data"], cell["traffic_data"]
    W = {name: weights.make(specs[name], seed, name, device) for name in specs}
    if stage1(config):
        return vae_gan.vaegan_steps(W, config["model"], batches, trainer_seed(seed),
                                    lr_of(config, mix), device, **kw)
    return ref_train.cfm_steps(W, config["model"]["params"], batches, trainer_seed(seed),
                               lr_of(config, mix), schedule_of(config), device, **kw)


def free(device) -> None:
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()


def run(cell: Dict[str, Any], seed: int, seconds: float, trace: bool, t0: float,
        device: torch.device) -> Dict[str, Any]:
    config, mix = cell["config_data"], cell["traffic_data"]
    cb, specs, data = drive(cell, seed, seconds, trace, device)
    peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0
    elapsed = cb.t_end - cb.t_start
    out: Dict[str, Any] = {
        "attempted": cb.steps,
        "failed": int(float(cb.bad)),
        "peak_bytes": peak,
        "setup_s": cb.t_start - t0,
        "notes": [f"{cb.steps} steps of {mix['batch_size']} in {elapsed:.3f} s after "
                  f"{cb.first} steps of set-up"],
    }
    if trace:
        summary = summarize(cb.prof, cb.tracer.spans)
        cb.prof = None
        if summary is not None:
            summary.update(steps=cb.steps, flops=step_flops(config, mix) * cb.steps,
                           peak_flops=config["mfu_peak_flops_train"])
            if not stage1(config):
                summary["attn_bound_ms"] = attn_bound_ms_per_step(config, mix)
        out["trace"] = summary
    else:
        out["end_to_end"] = {
            cell["metric"]: cb.steps * mix["batch_size"] / elapsed,
            "peak_mem_gib": peak / 2 ** 30,
            "setup_s": cb.t_start - t0,
        }
    prog = {"losses": cb.losses, "grad1": cb.grad1, "delta": cb.delta}
    batches = cb.batches
    del cb
    free(device)
    want = reference(cell, seed, specs, batches, device)
    out["notes"].append(f"{len(counted_leaves(want))} of {len(want['grad1'])} leaves compared")
    out["checks"] = {**compare_steps(prog, want),
                     "loader_mismatch": float(check_rows(batches, data, mix)),
                     "failed_steps": float(out["failed"])}
    shutil.rmtree(data["root"], ignore_errors=True)
    return out
