"""The port's ``CFMTrainer`` mechanics (CPU, tiny widths), as the JAX suite
holds its own (tests/test_trainer_pipeline.py, tests/test_multi_step.py):

* a pipelined fit (the prefetch thread) equals an inline fit bit for bit,
  through the caption tower and the data layer;
* K fused steps (``make_cfm_multi_step``) equal K single steps bit for bit;
* a partial group flushes at ``max_steps``;
* caption dedup returns the direct encode's rows with fewer tower rows, and
  the opt-in cache persists to disk and skips the tower;
* ``transfer_dtype="float16"`` trains, and ``_decompress_batch`` widens
  fp16/int16 exactly;
* validation runs on the EMA weights when ``use_ema`` (``val/loss_simple_ema``,
  saved by ``save_monitored``) and on the trained ones otherwise, where the
  shipped YAML's monitor (``val/loss_simple_ema`` with ``use_ema: false``)
  saves nothing, as in JAX.
"""

import glob

import numpy as np
import pytest
import torch

from versband_tpu_torch.data.datamodule import DataLoader
from versband_tpu_torch.data.sampler import IndexBatchSampler
from versband_tpu_torch.data.vocal2accomp import JoinSpecsTrain, JoinSpecsValidation
from versband_tpu_torch.models.cfm import CFM
from versband_tpu_torch.train.checkpoints import CheckpointManager
from versband_tpu_torch.train.state import TrainState, make_adamw
from versband_tpu_torch.train.step import (_decompress_batch, make_cfm_multi_step,
                                           make_cfm_train_step)
from versband_tpu_torch.train.trainer import CFMTrainer
from torch_port_helpers import DIT_TINY, VAE_TINY, perturb_zero_init, write_v2a_manifest

TOWER = dict(d_model=12, d_ff=24, d_kv=6, num_heads=2, num_layers=1, vocab_size=64)
B = 2


def _cfm(tower: bool = True, seed: int = 0) -> CFM:
    torch.manual_seed(seed)
    cond = dict(target="versband_tpu.text.embedders.TextVocalEmbedder",
                params=dict(version="no-such-dir", max_length=6, fallback_config=TOWER))
    cfm = CFM(unet_config=dict(target="versband_tpu.models.dit.BandMoeDiT",
                               params={**DIT_TINY, "ori_dim": 12}),
              first_stage_config=dict(target="versband_tpu.models.autoencoder.AutoencoderKL",
                                      params=VAE_TINY),
              cond_stage_config=cond if tower else None, mel_dim=4, device="cpu")
    perturb_zero_init(cfm.model, seed)
    return cfm


class _Module:
    def __init__(self, train, val=None):
        self.train, self.val = train, val

    def train_dataloader(self):
        return self.train

    def val_dataloader(self):
        if self.val is None:
            raise RuntimeError("no validation split")
        return self.val


@pytest.fixture(scope="module")
def spec(tmp_path_factory):
    root = tmp_path_factory.mktemp("pipe")
    manifest, midi = write_v2a_manifest(root, 300 + 5 * B, lengths=(40, 44), seed=2,
                                        vocal_extra=(0, 1))
    return dict(main_spec_dir_path=manifest, other_condition=midi, spec_crop_len=40,
                min_batch_len=16, drop=0.3, seed=4)


def _data(spec, n_val=0):
    tr = JoinSpecsTrain(spec)
    train = DataLoader(tr, IndexBatchSampler(tr.ordered_indices(), B, num_replicas=1, rank=0,
                                             seed=0), num_workers=1, prefetch=1)
    val = None
    if n_val:
        va = JoinSpecsValidation(spec)
        val = DataLoader(va, IndexBatchSampler(va.ordered_indices()[:n_val], B, num_replicas=1,
                                               rank=0, shuffle=False), num_workers=1, prefetch=1)
    return _Module(train, val)


def _trainer(cfm, tmp_path, tag, **kw):
    kw = {"max_steps": 5, "max_epochs": 1, **kw}
    return CFMTrainer(cfm, cfm.cond_stage, learning_rate=1e-3, logdir=str(tmp_path / tag),
                      time_bucket=16, use_tensorboard=False, log_every_n_steps=10 ** 6, seed=0,
                      **kw)


def test_pipelined_fit_equals_inline(tmp_path, spec):
    runs = []
    for prefetch in (0, 2):
        cfm = _cfm()
        tr = _trainer(cfm, tmp_path, f"p{prefetch}", steps_per_call=2, prefetch_groups=prefetch)
        tr.fit(_data(spec, n_val=4))
        assert tr.global_step == 5 and tr.state.step == 5
        runs.append((cfm.model.state_dict(), cfm.scale_factor,
                     tr.ckpt.last_meta()["step"]))
    (a, sa, na), (b, sb, nb) = runs
    assert sa == sb and na == nb == 5
    for k in a:
        assert torch.equal(a[k], b[k]), k


def test_fused_steps_equal_single_steps():
    rng = np.random.default_rng(0)
    K = 3
    batches = {"image": torch.from_numpy(rng.standard_normal((K, B, 80, 16)).astype(np.float32)),
               "caption": torch.from_numpy(rng.standard_normal((K, B, 6, 12)).astype(np.float32)),
               "midi": torch.from_numpy(rng.integers(0, 128, (K, B, 1, 16)).astype(np.int16)),
               "beats": torch.from_numpy(rng.integers(0, 2, (K, B, 1, 16)).astype(np.int16))}
    out = []
    for fused in (True, False):
        cfm = _cfm(tower=False)
        state = TrainState(cfm.model, make_adamw(1e-3, grad_clip=1.0))
        gen = torch.Generator().manual_seed(7)
        if fused:
            m = make_cfm_multi_step(cfm)(state, batches, gen)
        else:
            step = make_cfm_train_step(cfm)
            ms = [step(state, {k: v[i] for k, v in batches.items()}, gen) for i in range(K)]
            m = {k: torch.stack([x[k] for x in ms]) for k in ms[0]}
        assert state.step == K and m["loss"].shape == (K,)
        out.append((m, cfm.model.state_dict(), gen.get_state()))
    (m1, p1, g1), (m2, p2, g2) = out
    assert torch.equal(g1, g2)  # the same draws were taken
    for k in m1:
        assert torch.equal(m1[k], m2[k]), k
    for k in p1:
        assert torch.equal(p1[k], p2[k]), k


def test_partial_group_flushes_at_max_steps(tmp_path, spec):
    cfm = _cfm()
    tr = _trainer(cfm, tmp_path, "flush", steps_per_call=2, max_steps=3, prefetch_groups=1)
    sizes = []
    group = tr.multi_step
    tr.multi_step = lambda state, db, gen: (sizes.append(db["image"].shape[0]),
                                            group(state, db, gen))[1]
    single = tr.train_step
    tr.train_step = lambda state, db, gen: (sizes.append(1), single(state, db, gen))[1]
    tr.fit(_data(spec))
    assert tr.global_step == tr.state.step == 3 and sizes == [2, 1]
    assert tr.ckpt.last_meta()["step"] == 3


class _CountingCondStage:
    """A deterministic embedding per string; counts the rows encoded."""

    def __init__(self):
        self.rows = 0

    def __call__(self, cond):
        caps = cond["caption"]
        self.rows += len(caps)
        return {"caption": np.stack([np.full((3, 4), float(sum(c.encode()) % 97))
                                     for c in caps]).astype(np.float32)}


@pytest.mark.parametrize("n,pattern", [
    (8, ["a", "b", "a", "a", "b", "c", "c", "a"]),  # 3 distinct -> a bucket of 4
    (4, ["w", "x", "y", "z"]),  # all distinct
    (1, ["solo"]),
])
def test_caption_dedup_matches_direct_encode(tmp_path, n, pattern):
    cs = _CountingCondStage()
    tr = CFMTrainer(_cfm(tower=False), cs, 1e-3, logdir=str(tmp_path), use_tensorboard=False)
    got = tr._encode_caption_list(list(pattern))
    direct = cs({"caption": list(pattern)})["caption"]
    np.testing.assert_array_equal(got.numpy(), direct)
    if n == 8:
        assert cs.rows == 4 + 8  # the bucket of 4, then the direct encode's 8


def test_caption_cache_persists_and_skips_the_tower(tmp_path):
    def make(cs, cache="auto", tag="run"):
        return CFMTrainer(_cfm(tower=False), cs, 1e-3, logdir=str(tmp_path / tag),
                          caption_cache_dir=cache, use_tensorboard=False)

    caps = ["a", "b", "a"]
    cs = _CountingCondStage()
    tr = make(cs)
    first = tr._encode_caption_list(caps).numpy()
    np.testing.assert_array_equal(first, cs({"caption": caps})["caption"])
    rows = cs.rows
    np.testing.assert_array_equal(tr._encode_caption_list(caps).numpy(), first)
    assert cs.rows == rows  # a full hit runs no tower
    tr._cache_flush_pending()
    assert len(glob.glob(str(tmp_path / "run" / "caption_cache" / "*.npy"))) == 2
    cs2 = _CountingCondStage()
    np.testing.assert_array_equal(make(cs2)._encode_caption_list(caps).numpy(), first)
    assert cs2.rows == 0  # warm from disk
    plain = make(_CountingCondStage(), cache=None, tag="plain")
    assert plain._cap_cache_dir is None  # off by default
    np.testing.assert_array_equal(plain._encode_caption_list(caps).numpy(), first)


def test_transfer_dtype_float16_trains_and_widens_exactly(tmp_path, spec):
    cfm = _cfm()
    tr = _trainer(cfm, tmp_path, "fp16", steps_per_call=2, transfer_dtype="float16")
    wire = []
    group = tr.multi_step
    tr.multi_step = lambda state, db, gen: (wire.append({k: v.dtype for k, v in db.items()}),
                                            group(state, db, gen))[1]
    tr.fit(_data(spec))
    assert tr.global_step == 5
    assert wire[0] == {"image": torch.float16, "caption": torch.float32,
                       "midi": torch.int16, "beats": torch.int16}
    assert all(torch.isfinite(p).all() for p in cfm.model.parameters())
    half = np.float16([[0.5, -2.25, 65504.0, 6.1e-5]])
    out = _decompress_batch({"image": torch.from_numpy(half),
                             "midi": torch.tensor([[127, 129]], dtype=torch.int16),
                             "name": ["a"]})
    assert out["image"].dtype == torch.float32 and out["midi"].dtype == torch.int32
    np.testing.assert_array_equal(out["image"].numpy(), half.astype(np.float32))
    assert out["midi"].tolist() == [[127, 129]] and out["name"] == ["a"]
    with pytest.raises(ValueError):
        _trainer(cfm, tmp_path, "bad", transfer_dtype="bfloat16")


@pytest.mark.parametrize("use_ema", [True, False])
def test_validation_uses_the_ema_weights(tmp_path, spec, use_ema):
    cfm = _cfm()
    monitor = "val/loss_simple_ema"  # the shipped YAML's, whatever use_ema says
    ckpt = CheckpointManager(str(tmp_path / f"ema{use_ema}" / "checkpoints"), monitor=monitor)
    tr = _trainer(cfm, tmp_path, f"ema{use_ema}", max_steps=3, use_ema=use_ema, ckpt=ckpt)
    seen = {}
    real = tr._validate
    tr._validate = lambda loader: seen.update(real(loader))
    data = _data(spec, n_val=4)
    data.val = list(data.val)  # fixed batches: a new pass draws new captions
    tr.fit(data)
    key = "val/loss_simple_ema" if use_ema else "val/loss_simple"
    assert set(seen) == {key} and np.isfinite(seen[key])
    # the same validation, by hand, on the weights it should have used
    if use_ema:
        ema = tr.state.ema.copy_to(tr.state.named)
        # after validation the scope put the trained weights back
        assert any(not torch.equal(w, tr.state.named[k]) for k, w in ema.items())
        with torch.no_grad():
            for k, w in ema.items():
                tr.state.named[k].copy_(w)
    tr.use_ema = False
    assert real(data.val_dataloader())["val/loss_simple"] == seen[key]
    saved = glob.glob(str(tmp_path / f"ema{use_ema}" / "checkpoints" / "epoch_step_*.pt"))
    assert len(saved) == (1 if use_ema else 0)
