"""The port's profiling, misc and checkpoint utilities
(``versband_tpu_torch/utils/{profiling,misc,checkpoint}.py``) against their
JAX twins (CPU)."""

import json
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from versband_tpu.models.dit_timefreq import TimeFreqMoeDiT as JTimeFreq
from versband_tpu.utils import checkpoint as jck
from versband_tpu.utils import misc as jmisc
from versband_tpu.utils import profiling as jprof
from versband_tpu_torch.models.dit_timefreq import TimeFreqMoeDiT
from versband_tpu_torch.utils import checkpoint as tck
from versband_tpu_torch.utils import misc as tmisc
from versband_tpu_torch.utils import profiling as tprof
from versband_tpu_torch.utils.convert import state_dict_from_jax


def _clock(monkeypatch, ticks):
    it = iter(ticks)
    monkeypatch.setattr(time, "perf_counter", lambda: next(it))


@pytest.mark.parametrize("ema", [0.9, 0.5])
def test_step_timer_ema_matches_jax(monkeypatch, ema):
    ticks = [0.0, 1.0, 1.5, 4.0, 4.0, 4.25, 10.0, 10.125]
    out = {}
    for name, mod in (("jax", jprof), ("port", tprof)):
        _clock(monkeypatch, ticks)
        timer = mod.StepTimer(ema)
        dts = []
        for _ in range(4):
            timer.start()
            dts.append(timer.stop())
        out[name] = (dts, timer.avg)
    assert out["port"] == out["jax"]
    assert out["port"][0] == [1.0, 2.5, 0.25, 0.125]


def test_step_timer_stop_takes_nested_outputs():
    timer = tprof.StepTimer()
    timer.start()
    assert timer.stop({"loss": torch.ones(2), "parts": [torch.zeros(1), 3]}) >= 0.0
    assert tprof._cuda_devices({"a": [torch.ones(1)], "b": None}) == set()


def test_device_memory_stats_on_the_cpu_is_empty():
    assert tprof.device_memory_stats("cpu") == {} == jprof.device_memory_stats(
        jax.devices("cpu")[0])


def test_trace_writes_a_chrome_trace(tmp_path):
    with tprof.trace(str(tmp_path / "tb")):
        with tprof.annotate("legacy-step"):
            torch.ones(64, 64) @ torch.ones(64, 64)
    doc = json.loads((tmp_path / "tb" / "trace.json").read_text())
    assert any(ev.get("name") == "legacy-step" for ev in doc["traceEvents"])


def test_count_params_matches_jax():
    kw = dict(in_channels=4, context_dim=12, hidden_size=16, depth=2, num_heads=2,
              max_len=32, num_experts=4, multiple_of=8)
    params = JTimeFreq(**kw).init(jax.random.PRNGKey(0), jnp.zeros((1, 4, 8)), jnp.zeros((1,)),
                                  jnp.zeros((1, 3, 12)))
    want = jmisc.count_params(params)
    m = TimeFreqMoeDiT(**kw)
    m.load_state_dict(state_dict_from_jax(params, "dit"))
    assert tmisc.count_params(m) == tmisc.count_params(m.state_dict()) == want
    assert tmisc.count_params(jax.tree_util.tree_map(np.asarray, params)) == want
    assert tmisc.checkpoint is torch.utils.checkpoint.checkpoint


TREE = {"enc": {"w": np.ones((2, 3), np.float32), "b": np.zeros(3, np.float32)},
        "dec": {"w": np.full((3, 2), 2.0, np.float32)}, "extra": np.ones(1, np.float32)}


def _write_ckpts(d):
    """Two checkpoints by step; the newest holds a mis-shaped ``enc/w``, a
    new ``dec/w`` and lacks ``extra``."""
    jck.save_npz_params(str(d / "model_ckpt_steps_9.npz"), {"model": TREE})
    newest = {"enc": {"w": np.ones((4, 4), np.float32), "b": np.full(3, 5.0, np.float32)},
              "dec": {"w": np.full((3, 2), 7.0, np.float32)}}
    jck.save_npz_params(str(d / "model_ckpt_steps_10.npz"), {"model": newest})


@pytest.mark.parametrize("strict", [True, False])
def test_load_ckpt_matches_jax(tmp_path, capsys, strict):
    _write_ckpts(tmp_path)
    ref = jck.load_ckpt(TREE, str(tmp_path), strict=strict)
    jprinted = capsys.readouterr().out
    got = tck.load_ckpt(TREE, str(tmp_path), strict=strict)
    assert capsys.readouterr().out == jprinted
    flat_ref, flat_got = tck.flatten_params(ref), tck.flatten_params(got)
    assert flat_ref.keys() == flat_got.keys()
    for k in flat_ref:
        np.testing.assert_array_equal(flat_got[k], np.asarray(flat_ref[k]), err_msg=k)
    np.testing.assert_array_equal(got["enc"]["w"], TREE["enc"]["w"])  # mismatch keeps init
    np.testing.assert_array_equal(got["dec"]["w"], 7.0)
    assert "shape mismatch at /enc/w" in jprinted
    assert ("| missing key in checkpoint: /extra" in jprinted) == strict


def test_load_ckpt_without_a_checkpoint(tmp_path):
    with pytest.raises(FileNotFoundError, match="no checkpoint"):
        tck.load_ckpt(TREE, str(tmp_path))
    with pytest.raises(FileNotFoundError, match="no checkpoint"):
        jck.load_ckpt(TREE, str(tmp_path))
    assert tck.load_ckpt(TREE, str(tmp_path), force=False) is TREE


def test_load_ckpt_into_a_module(tmp_path, capsys):
    """A torch checkpoint of a sub-model under ``model.``: matching weights
    load, a mis-shaped one keeps the module's, a missing one is printed."""
    torch.manual_seed(0)
    m = torch.nn.Sequential(torch.nn.Linear(3, 4), torch.nn.Linear(4, 2))
    init = {k: v.clone() for k, v in m.state_dict().items()}
    sd = {"model.0.weight": torch.full((4, 3), 3.0), "model.0.bias": torch.ones(5),
          "model.1.weight": torch.full((2, 4), 2.0), "other.x": torch.zeros(1)}
    torch.save({"state_dict": sd}, tmp_path / "model_ckpt_steps_3.ckpt")
    torch.save({"state_dict": {}}, tmp_path / "model_ckpt_steps_1.ckpt")
    assert tck.load_ckpt(m, str(tmp_path)) is m
    printed = capsys.readouterr().out
    assert torch.equal(m[0].weight, torch.full((4, 3), 3.0))
    assert torch.equal(m[0].bias, init["0.bias"])  # shape mismatch: kept
    assert torch.equal(m[1].bias, init["1.bias"])  # missing: kept
    assert "shape mismatch at /0.bias" in printed
    assert "| missing key in checkpoint: /1.bias" in printed
