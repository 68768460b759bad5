"""Golden multi-step training through the caption tower: the port's
``CFMTrainer`` against the JAX package's (CPU, tiny widths).

Both trainers start from the same DiT, VAE and T5 weights (the T5 directory
written by ``transformers``, read by each package's own loader), train on
batches from each package's own ``JoinSpecsTrain`` over the same manifest
and dataset seed (one item thread), encode every step's captions through
the frozen tower inside ``fit``, and run 5 steps with ``steps_per_call=2``
(groups of 2, 2 and 1), then one validation in eval routing. The JAX
trainer's random draws (the scale_by_std posterior, and per step the
posterior, t, the flow noise and the Gumbel noise; per validation batch the
posterior, t and the noise) are recorded as it makes them and handed to
the port in the same order.

Bars: each step's loss within 1e-5 relative of JAX's; every parameter after
step 5 within 1e-3 x LR x 5 of JAX's (0.1 % of the largest move Adam can
make in 5 steps); ``val/loss_simple`` within 1e-5 relative. AdamW's eps is
1e-3 on both sides, as in test_torch_port_train_step.py: the gradient of the
cross-attention's key bias is exactly 0 (softmax ignores a shift of a whole
row of scores), so what each package computes there is fp32 rounding noise,
which Adam at eps 1e-8 turns into moves of the order of the LR, a different
random walk in each (measured: 3.5e-5 apart after 5 steps, 7x the bar, in
that bias alone). Measured with eps 1e-3: losses 1.6e-6 relative at most,
parameters 2.4e-7 apart at most, the validation loss 1.3e-6 relative.
"""

import jax
import numpy as np
import pytest
import torch

from versband_tpu.data.datamodule import DataLoader as JLoader
from versband_tpu.data.sampler import IndexBatchSampler as JSampler
from versband_tpu.data.vocal2accomp import JoinSpecsTrain as JTrain
from versband_tpu.data.vocal2accomp import JoinSpecsValidation as JVal
from versband_tpu.models.cfm import CFM as JCFM
from versband_tpu.train.state import TrainState as JState, make_adamw as j_adamw
from versband_tpu.train.trainer import CFMTrainer as JTrainer
from versband_tpu_torch.data.datamodule import DataLoader
from versband_tpu_torch.data.sampler import IndexBatchSampler
from versband_tpu_torch.data.vocal2accomp import JoinSpecsTrain, JoinSpecsValidation
from versband_tpu_torch.models.cfm import CFM
from versband_tpu_torch.train.state import make_adamw
from versband_tpu_torch.train.trainer import CFMTrainer
from versband_tpu_torch.utils.convert import state_dict_from_jax
from torch_port_helpers import (DIT_TINY, VAE_TINY, caption_corpus, perturb_zero_init, to_jax,
                                train_unigram_tokenizer, write_t5_dir, write_v2a_manifest)

B, STEPS, K, LR = 2, 5, 2, 1e-3
EPS = 1e-3  # AdamW's eps on both sides (see the module doc)
T5 = dict(d_model=12, d_ff=24, d_kv=6, num_heads=2, num_layers=2, vocab_size=200,
          feed_forward_proj="gated-gelu")
N_VAL = 6  # validation items, of the 300 the dataset holds out


class _Module:
    """A datamodule over two prebuilt loaders."""

    def __init__(self, train, val):
        self.train, self.val = train, val

    def train_dataloader(self):
        return self.train

    def val_dataloader(self):
        return self.val


def _loaders(pkg, spec):
    """(train, val) loaders of one package: one item thread, one batch in
    flight, the training batches shuffled from seed 0."""
    train_cls, val_cls, sampler, loader = pkg
    tr, va = train_cls(spec), val_cls(spec)
    train = loader(tr, sampler(tr.ordered_indices(), B, num_replicas=1, rank=0, seed=0),
                   num_workers=1, prefetch=1)
    val = loader(va, sampler(va.ordered_indices()[:N_VAL], B, num_replicas=1, rank=0,
                             shuffle=False), num_workers=1, prefetch=1)
    return _Module(train, val)


class _Recorder:
    """Wraps ``jax.random`` samplers: each draw is also recorded, in program
    order, as the jitted (and scanned) steps make it."""

    def __init__(self, monkeypatch):
        self.draws = []
        for kind in ("normal", "randint", "gumbel"):
            real = getattr(jax.random, kind)
            monkeypatch.setattr(jax.random, kind, self._wrap(kind, real))

    def _wrap(self, kind, real):
        def draw(*args, **kwargs):
            v = real(*args, **kwargs)
            jax.debug.callback(lambda a: self.draws.append((kind, np.asarray(a))), v,
                               ordered=True)
            return v
        return draw

    def take(self, kind):
        i = next(i for i, (k, _) in enumerate(self.draws) if k == kind)
        return self.draws.pop(i)[1].copy()


@pytest.fixture(scope="module")
def t5_dir(tmp_path_factory):
    path = tmp_path_factory.mktemp("t5")
    write_t5_dir(path, T5, seed=3, tokenizer=train_unigram_tokenizer(caption_corpus()))
    return str(path)


def test_five_steps_and_validation_match_jax(tmp_path, t5_dir, monkeypatch):
    manifest, midi = write_v2a_manifest(tmp_path / "data", 300 + STEPS * B)
    spec = dict(main_spec_dir_path=manifest, other_condition=midi, spec_crop_len=40,
                min_batch_len=16, drop=0.2, seed=11)
    unet = dict(target="versband_tpu.models.dit.BandMoeDiT",
                params={**DIT_TINY, "ori_dim": T5["d_model"]})
    vae = dict(target="versband_tpu.models.autoencoder.AutoencoderKL", params=VAE_TINY)
    cond = dict(target="versband_tpu.text.embedders.TextVocalEmbedder",
                params=dict(version=t5_dir, max_length=8))
    common = dict(max_steps=STEPS, max_epochs=1, time_bucket=16, use_tensorboard=False,
                  log_every_n_steps=10 ** 6, seed=0)

    torch.manual_seed(0)
    cfm = CFM(unet_config=unet, first_stage_config=vae, cond_stage_config=cond, mel_dim=4,
              scale_by_std=True, device="cpu")
    perturb_zero_init(cfm.model, 0)
    params, vae_params = to_jax(cfm.model, "dit"), to_jax(cfm.first_stage, "vae")
    start = {k: v.clone() for k, v in cfm.model.state_dict().items()}

    # the JAX trainer, its draws recorded
    jcfm = JCFM(unet_config=unet, first_stage_config=vae, cond_stage_config=cond, mel_dim=4,
                scale_by_std=True)
    jtr = JTrainer(jcfm, vae_params, jcfm.cond_stage, learning_rate=LR, steps_per_call=K,
                   logdir=str(tmp_path / "jax"), **common)
    init = jtr.init_state

    def init_from_port(batch):
        init(batch)  # its model.init draws Gumbel noise the port does not: drop it
        jax.effects_barrier()
        rec.draws[:] = [d for d in rec.draws if d[0] != "gumbel"]
        jtr.state = JState.create(params, j_adamw(LR, eps=EPS, grad_clip=1.0))

    jtr.init_state = init_from_port
    j_losses, j_val = [], {}
    for name in ("train_step", "_multi_step"):
        real = getattr(jtr, name)

        def run(*a, real=real):
            state, metrics = real(*a)
            j_losses.extend(np.atleast_1d(np.asarray(metrics["loss"])).tolist())
            return state, metrics
        setattr(jtr, name, run)
    real_log = jtr.log_metrics
    jtr.log_metrics = lambda m, step, prefix="": (j_val.update(m), real_log(m, step, prefix))
    rec = _Recorder(monkeypatch)
    jtr.fit(_loaders((JTrain, JVal, JSampler, JLoader), spec))
    monkeypatch.undo()
    assert jtr.global_step == STEPS

    # the port, fed the recorded draws
    tr = CFMTrainer(cfm, cfm.cond_stage, learning_rate=LR, steps_per_call=K,
                    logdir=str(tmp_path / "port"), **common)
    tr.tx = make_adamw(LR, eps=EPS, grad_clip=1.0)
    shapes = cfm.model.gumbel_shapes

    def given(b, t_lat):
        return {"posterior": torch.from_numpy(rec.take("normal")),
                "t": torch.from_numpy(rec.take("randint")).long(),
                "noise": torch.from_numpy(rec.take("normal")),
                "gumbel": iter([torch.from_numpy(rec.take("gumbel"))
                                for _ in shapes(b, t_lat)])}

    scale = cfm.compute_scale_factor
    cfm.compute_scale_factor = lambda mel, gen: scale(
        mel, noise=torch.from_numpy(rec.take("normal")))
    losses, seen = [], []
    one, many, val = tr.train_step, tr.multi_step, tr._val_loss

    def step(state, db, gen):
        m = one(state, db, gen, given=given(db["image"].shape[0], db["image"].shape[2] // 2))
        losses.append(m["loss"].item())
        seen.append(1)
        return m

    def group(state, db, gen):
        n, b, _, t = db["image"].shape
        m = many(state, db, gen, given=[given(b, t // 2) for _ in range(n)])
        losses.extend(m["loss"].tolist())
        seen.append(n)
        return m

    def val_loss(db, gen):
        return val(db, gen, given={"posterior": torch.from_numpy(rec.take("normal")),
                                   "t": torch.from_numpy(rec.take("randint")).long(),
                                   "noise": torch.from_numpy(rec.take("normal"))})

    tr.train_step, tr.multi_step, tr._val_loss = step, group, val_loss
    agg = {}
    real_validate = tr._validate
    tr._validate = lambda loader: agg.update(real_validate(loader))
    tr.fit(_loaders((JoinSpecsTrain, JoinSpecsValidation, IndexBatchSampler, DataLoader), spec))

    assert rec.draws == [], f"{len(rec.draws)} JAX draws were not consumed"
    assert tr.global_step == STEPS and seen == [2, 2, 1]
    assert tr.cfm.scale_factor == pytest.approx(jcfm.scale_factor, rel=1e-5)
    rel = [abs(a - b) / abs(b) for a, b in zip(losses, j_losses)]
    assert len(losses) == len(j_losses) == STEPS and max(rel) <= 1e-5, (losses, j_losses)
    ref = state_dict_from_jax(jax.device_get(jtr.state.params), "dit")
    gap = moved = 0.0
    for k, p in cfm.model.state_dict().items():
        gap = max(gap, (p - ref[k]).abs().max().item())
        moved = max(moved, (p - start[k]).abs().max().item())
    assert gap <= 1e-3 * LR * STEPS and moved > 0.5 * LR, (gap, moved)
    v, jv = agg["val/loss_simple"], j_val["val/loss_simple"]
    assert abs(v - jv) <= 1e-5 * abs(jv), (v, jv)
