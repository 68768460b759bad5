"""The program's spans and counters (``versband_tpu_torch/utils/profiling.py``)
on the CPU: off they record nothing and cost a flag check; on they keep
nesting, threads, tags and counters until drained, on the profiler's clock;
a tiny stage-2 and stage-1 fit and a tiny pipelined serve record every span
the port places at its layer boundaries."""

import threading

import numpy as np
import pytest
import torch

from versband_tpu_torch.data.datamodule import DataLoader
from versband_tpu_torch.data.sampler import IndexBatchSampler
from versband_tpu_torch.dsp.loudness import normalize_loudness
from versband_tpu_torch.models.autoencoder import AutoencoderKL
from versband_tpu_torch.models.cfm import CFM, CFMSampler
from versband_tpu_torch.sample.pipeline import PipelinedGenerator
from versband_tpu_torch.train.gan_losses import VAEGANLoss
from versband_tpu_torch.train.trainer import CFMTrainer, VAETrainer
from versband_tpu_torch.utils import profiling
from versband_tpu_torch.vocoder.hifigan import HifiGAN
from torch_port_helpers import (DIT_TINY, VAE_GAN_DD, VAE_GAN_DISC, VAE_TINY, VOC_TINY,
                                perturb_zero_init)

TOWER = dict(d_model=12, d_ff=24, d_kv=6, num_heads=2, num_layers=1, vocab_size=64)
STEP_SPANS = {"train.step", "train.step.vae_encode", "train.step.forward",
              "train.step.backward", "train.step.optimizer"}
TRAINER_SPANS = {"data.loader.next", "train.log_metrics", "train.callbacks"}
SERVE_SPANS = {"text.tower", "models.cfm.dit_encode", "models.cfm.euler_step",
               "models.autoencoder.decode_first_stage", "vocoder.waveform",
               "sample.pipeline.collect", "dsp.normalize_loudness"}


@pytest.fixture(autouse=True)
def clean():
    profiling.spans_off()
    profiling.drain()
    yield
    profiling.spans_off()
    profiling.drain()


def _names(spans):
    return {s.name for s in spans}


def test_off_records_nothing_and_returns_the_shared_null_context():
    assert profiling.annotate("a") is profiling.annotate("b") is profiling._NULL
    assert profiling.tag(3) is profiling._NULL
    with profiling.tag(1), profiling.annotate("a"):
        with profiling.annotate("b"):
            profiling.count("c")
    assert profiling.drain() == ([], {})


def test_on_keeps_nesting_threads_tags_and_counters_until_drained():
    profiling.spans_on()
    with profiling.tag(7):
        with profiling.annotate("outer"):
            with profiling.annotate("inner"):
                profiling.count("c")
                profiling.count("c", 2)
            with profiling.tag(8), profiling.annotate("retagged"):
                pass

    def work():
        with profiling.annotate("worker"):
            with profiling.annotate("worker.inner"):
                pass

    t = threading.Thread(target=work, name="spans-worker")
    t.start()
    t.join(timeout=30)
    assert not t.is_alive()
    with profiling.annotate("open"):
        spans, counts = profiling.drain()
    assert counts == {"c": 3}
    by = {s.name: s for s in spans}
    assert set(by) == {"outer", "inner", "retagged", "worker", "worker.inner"}
    assert [s.start_ns for s in spans] == sorted(s.start_ns for s in spans)
    main = threading.get_native_id()
    assert by["outer"].parent == -1 and spans[by["inner"].parent].name == "outer"
    assert spans[by["retagged"].parent].name == "outer"
    assert (by["outer"].id, by["inner"].id, by["retagged"].id) == (7, 7, 8)
    assert by["outer"].start_ns <= by["inner"].start_ns <= by["inner"].end_ns \
        <= by["outer"].end_ns
    assert by["outer"].tid == main and by["outer"].thread == threading.current_thread().name
    assert by["outer"].ident == threading.get_ident() != by["worker"].ident
    assert by["worker"].tid != main and by["worker"].thread == "spans-worker"
    assert by["worker"].id is None and by["worker"].parent == -1
    assert spans[by["worker.inner"].parent].name == "worker"
    # the drain cleared everything; the span open at the drain comes with the next one
    spans, counts = profiling.drain()
    assert [s.name for s in spans] == ["open"] and counts == {}
    profiling.spans_off()
    with profiling.annotate("late"):
        pass
    assert profiling.drain() == ([], {})


def test_a_span_that_raises_is_recorded_and_the_error_passes():
    profiling.spans_on()
    with pytest.raises(KeyError):
        with profiling.annotate("outer"):
            with profiling.annotate("raises"):
                raise KeyError("x")
    with profiling.annotate("after"):
        pass
    spans, _ = profiling.drain()
    assert [s.name for s in spans] == ["outer", "raises", "after"]
    assert spans[2].parent == -1


def test_spans_share_the_profilers_clock():
    from torch.profiler import ProfilerActivity, profile

    profiling.spans_on()
    a = torch.ones(96, 96)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with profiling.annotate("mm"):
            a @ a
    spans, _ = profiling.drain()
    (span,) = spans
    ops = [e for e in prof.profiler.kineto_results.events() if e.name() == "aten::mm"]
    assert ops
    for e in ops:
        assert span.start_ns <= e.start_ns() <= e.start_ns() + e.duration_ns() <= span.end_ns


def test_trace_turns_spans_on_for_its_block_only(tmp_path):
    with profiling.trace(str(tmp_path)):
        with profiling.annotate("traced"):
            torch.ones(8) + 1
    with profiling.annotate("after"):
        pass
    spans, _ = profiling.drain()
    assert [s.name for s in spans] == ["traced"]
    assert (tmp_path / "trace.json").exists()


def _cfm(seed: int = 0) -> CFM:
    torch.manual_seed(seed)
    cond = dict(target="versband_tpu.text.embedders.TextVocalEmbedder",
                params=dict(version="no-such-dir", max_length=6, fallback_config=TOWER))
    cfm = CFM(unet_config=dict(target="versband_tpu.models.dit.BandMoeDiT", params=DIT_TINY),
              first_stage_config=dict(target="versband_tpu.models.autoencoder.AutoencoderKL",
                                      params=VAE_TINY),
              cond_stage_config=cond, mel_dim=4, device="cpu")
    perturb_zero_init(cfm.model, seed)
    return cfm


class _Songs:
    """Rows of stage 2's batch layout (a mel, a caption, MIDI and beats)."""

    def __init__(self, n: int, T: int):
        self.n, self.T = n, T

    def __len__(self):
        return self.n

    def __getitem__(self, i):
        rng = np.random.default_rng(i)
        return {"image": rng.standard_normal((80, self.T)).astype(np.float32),
                "caption": f"song {i % 3}", "midi": rng.integers(0, 128, (1, self.T)),
                "beats": rng.integers(0, 2, (1, self.T))}

    def collater(self, items):
        return {"image": np.stack([it["image"] for it in items]),
                "caption": {"caption": [it["caption"] for it in items],
                            "acoustic": {"midi": np.stack([it["midi"] for it in items]),
                                         "beats": np.stack([it["beats"] for it in items])}}}


class _Module:
    def __init__(self, loader):
        self.loader = loader

    def train_dataloader(self):
        return self.loader

    def val_dataloader(self):
        raise RuntimeError("no validation split")


def _loader(ds, B=2):
    return DataLoader(ds, IndexBatchSampler(list(range(len(ds))), B, num_replicas=1, rank=0,
                                            seed=0), num_workers=1, prefetch=1)


def test_a_stage2_fit_records_its_spans_and_counters(tmp_path):
    steps = 3
    cfm = _cfm()
    tr = CFMTrainer(cfm, cfm.cond_stage, learning_rate=1e-3, logdir=str(tmp_path),
                    max_steps=steps, max_epochs=1, time_bucket=16, use_tensorboard=False,
                    seed=0, prefetch_groups=1)
    profiling.spans_on()
    tr.fit(_Module(_loader(_Songs(8, 40))))
    spans, counts = profiling.drain()
    names = _names(spans)
    assert STEP_SPANS | TRAINER_SPANS | {"train.assemble", "train.prefetch.wait",
                                         "text.tower"} <= names
    main = threading.get_native_id()
    for s in spans:
        on_worker = s.name in ("train.assemble", "text.tower")
        assert (s.tid != main) == on_worker, s
        assert s.thread.startswith("cfm-xfer") == on_worker, s
        if s.name == "text.tower":
            assert spans[s.parent].name == "train.assemble"
    step = [s for s in spans if s.name == "train.step"]
    assert [s.id for s in step] == list(range(steps))
    for s in spans:
        if s.name in STEP_SPANS - {"train.step"}:
            assert spans[s.parent].name == "train.step" and s.id == spans[s.parent].id
    assert sum(s.name == "data.loader.next" for s in spans) == steps
    assert counts["data.loader.batches"] == steps
    assert 0 <= counts.get("data.loader.waited", 0) <= steps


class _Mels:
    def __init__(self, n: int, T: int):
        self.n, self.T = n, T

    def __len__(self):
        return self.n

    def __getitem__(self, i):
        return {"image": np.random.default_rng(i).standard_normal((80, self.T))
                .astype(np.float32)}

    def collater(self, items):
        return {"image": np.stack([it["image"] for it in items])}


def test_a_stage1_fit_records_its_spans(tmp_path):
    torch.manual_seed(0)
    tr = VAETrainer(AutoencoderKL(embed_dim=4, ddconfig=VAE_GAN_DD),
                    VAEGANLoss(disc_start=0, **VAE_GAN_DISC), learning_rate=1e-4,
                    logdir=str(tmp_path), max_steps=2, max_epochs=1, time_bucket=16,
                    use_tensorboard=False, seed=0)
    profiling.spans_on()
    tr.fit(_Module(_loader(_Mels(4, 32))))
    spans, counts = profiling.drain()
    assert TRAINER_SPANS | {"train.vae_step", "train.vae_step.generator",
                            "train.vae_step.discriminator"} <= _names(spans)
    step = [s for s in spans if s.name == "train.vae_step"]
    assert [s.id for s in step] == [0, 1]
    halves = [s for s in spans if s.name.startswith("train.vae_step.")]
    assert len(halves) == 4 and all(spans[s.parent].name == "train.vae_step" for s in halves)
    assert counts["data.loader.batches"] == 2


def test_a_pipelined_serve_records_its_spans_per_request():
    cfm = _cfm()
    steps, requests, B = 4, 3, 2
    sampler = CFMSampler(cfm, num_timesteps=steps + 1)
    voc = HifiGAN(device="cpu", audio_num_mel_bins=80, **VOC_TINY)

    def sample(i, _generator):
        rng = np.random.default_rng(i)
        ac = {"midi": torch.from_numpy(rng.integers(0, 128, (B, 1, 24))),
              "beats": torch.from_numpy(rng.integers(0, 2, (B, 1, 24)))}
        c = cfm.get_learned_conditioning({"caption": [f"take {i}"] * B, "acoustic": ac})
        uc = cfm.get_learned_conditioning({"caption": [""] * B, "acoustic": ac})
        return sampler.sample_cfg(c, 2.0, uc, torch.Generator().manual_seed(i), batch_size=B)

    pipe = PipelinedGenerator(sample, cfm.decode_first_stage, voc.waveform, depth=2)
    profiling.spans_on()
    for wav in pipe.generate((i, None) for i in range(requests)):
        for w in wav:
            normalize_loudness(w)
    spans, _ = profiling.drain()
    assert SERVE_SPANS <= _names(spans)
    euler = [s for s in spans if s.name == "models.cfm.euler_step"]
    assert len(euler) == steps * requests
    assert sorted(s.id for s in euler) == sorted(list(range(requests)) * steps)
    for name, per in (("models.cfm.dit_encode", 1), ("text.tower", 2), ("vocoder.waveform", 1),
                      ("models.autoencoder.decode_first_stage", 1),
                      ("sample.pipeline.collect", 1)):
        got = sorted(s.id for s in spans if s.name == name)
        assert got == sorted(list(range(requests)) * per), name
    assert sum(s.name == "dsp.normalize_loudness" for s in spans) == requests * B
