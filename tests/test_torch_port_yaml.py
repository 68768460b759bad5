"""The port's YAML reader (``utils/yaml_subset.py``) against ``yaml.safe_load``.

The card's machine has no PyYAML, so the port parses YAML itself. It must
give what ``safe_load`` gives on the repository's configs, on the vocoders'
config formats (a HiFi-GAN ``config.yaml``, a BigVGAN ``args.yml``), on the
dot-override values of ``tests/test_cli_e2e.py`` and on scalar strings drawn
by ``hypothesis`` (YAML 1.1 resolution); outside its subset it raises.
"""

import ast
import datetime
import math
from pathlib import Path

import pytest
import yaml
from hypothesis import given, settings
from hypothesis import strategies as st

from versband_tpu.utils import config as jax_config
from versband_tpu_torch.utils import config as port_config
from versband_tpu_torch.utils.yaml_subset import YAMLSubsetError, loads, resolve_plain

REPO = Path(__file__).resolve().parents[1]

HIFIGAN_CONFIG_YAML = """\
# HiFi-GAN vocoder config (reference egs/ layout)
audio_num_mel_bins: 80
audio_sample_rate: 24000
hop_size: 320  # 24k, 320 hop
win_size: 1280
fmin: 20
fmax: 12000
upsample_rates: [ 5, 4, 4, 4 ]
upsample_kernel_sizes: [ 9, 8, 8, 8 ]
upsample_initial_channel: 512
resblock: '1'
resblock_kernel_sizes: [ 3, 7, 11 ]
resblock_dilation_sizes: [ [ 1, 3, 5 ], [ 1, 3, 5 ], [ 1, 3, 5 ] ]
use_pitch_embed: false
use_fm_loss: false
lambda_mel: 45.0
generator_params:
  lr: 0.0002
  aux_context_window: 0
optimizer_params:
  betas: [0.8, 0.99]
  eps: 1.0e-6
  weight_decay: 0.0
discriminator_optimizer_params: {lr: 2.0e-4, betas: [0.8, 0.99]}
max_updates: 3000000
disc_start_steps: 40000
binarization_args:
  with_wav: true
  with_spk_embed: false
  with_align: false
pitch_extractor: parselmouth
vocoder_ckpt: ''
work_dir: ~
"""

BIGVGAN_ARGS_YML = """\
resblock: "1"
num_gpus: 0
batch_size: 32
learning_rate: 0.0001
adam_b1: 0.8
adam_b2: 0.99
lr_decay: 0.999
seed: 1234

upsample_rates: [4,4,2,2,2,2]
upsample_kernel_sizes: [8,8,4,4,4,4]
upsample_initial_channel: 1536
resblock_kernel_sizes: [3,7,11]
resblock_dilation_sizes: [[1,3,5], [1,3,5], [1,3,5]]

activation: "snakebeta"
snake_logscale: true

resolutions: [[1024, 120, 600], [2048, 240, 1200], [512, 50, 240]]
mpd_reshapes: [2, 3, 5, 7, 11]
use_spectral_norm: False
discriminator_channel_mult: 1

segment_size: 65536
num_mels: 100
num_freq: 1025
n_fft: 1024
hop_size: 256
win_size: 1024

sampling_rate: 24000

fmin: 0
fmax: null
fmax_for_loss: null

num_workers: 4

dist_config:
  dist_backend: "nccl"
  dist_url: "tcp://localhost:54321"
  world_size: 1
"""


def _same(a, b) -> bool:
    """Equal values of equal types; NaN equals NaN."""
    if isinstance(a, float) and isinstance(b, float) and math.isnan(a) and math.isnan(b):
        return True
    if isinstance(a, dict) and isinstance(b, dict):  # the packages' Config classes differ
        return a.keys() == b.keys() and all(_same(a[k], b[k]) for k in a)
    if type(a) is not type(b):
        return False
    if isinstance(a, list):
        return len(a) == len(b) and all(_same(x, y) for x, y in zip(a, b))
    return a == b


@pytest.mark.parametrize("path", sorted((REPO / "configs").glob("*.yaml")),
                         ids=lambda p: p.name)
def test_repo_configs(path):
    text = path.read_text()
    assert _same(loads(text), yaml.safe_load(text))
    assert _same(dict(port_config.load_config(path)), dict(jax_config.load_config(str(path))))


@pytest.mark.parametrize("text", [HIFIGAN_CONFIG_YAML, BIGVGAN_ARGS_YML],
                         ids=["hifigan_config.yaml", "bigvgan_args.yml"])
def test_vocoder_config_formats(text, tmp_path):
    assert _same(loads(text), yaml.safe_load(text))
    from versband_tpu_torch.vocoder.bigvgan import VocoderBigVGAN
    from versband_tpu_torch.vocoder.hifigan import HifiGAN

    if "audio_num_mel_bins" in text:
        (tmp_path / "config.yaml").write_text(text)
        voc = HifiGAN(str(tmp_path), device="cpu", upsample_initial_channel=16)
        assert voc.model.num_kernels == 3
    else:
        (tmp_path / "args.yml").write_text(text)
        voc = VocoderBigVGAN(str(tmp_path), device="cpu", upsample_initial_channel=32,
                             resblock_kernel_sizes=[3], resblock_dilation_sizes=[[1]])
        assert voc.model.num_kernels == 1


def _cli_e2e_overrides():
    """Every ``a.b=value`` string literal of tests/test_cli_e2e.py."""
    tree = ast.parse((REPO / "tests" / "test_cli_e2e.py").read_text())
    out = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Constant) and isinstance(node.value, str):
            key, eq, value = node.value.partition("=")
            if eq and "." in key and " " not in key and "{" not in key:
                out.add(node.value)
        elif isinstance(node, ast.JoinedStr):  # f"...{o}" pieces: take the constant tail
            for part in node.values:
                if isinstance(part, ast.Constant) and "=" in part.value:
                    out.add(part.value.split(".", 1)[-1] if part.value.startswith(".")
                            else part.value)
    return sorted(o for o in out if "=" in o and o.split("=", 1)[0])


def test_cli_e2e_dot_overrides():
    overrides = _cli_e2e_overrides()
    assert any("fallback_config={d_model: 16" in o for o in overrides)
    assert any("ch_mult=[1, 2]" in o for o in overrides)
    base = dict(jax_config.load_config(str(REPO / "configs" / "vocal2music.yaml")))
    want = jax_config.apply_dot_overrides(base, overrides)
    got = port_config.apply_dot_overrides(base, overrides)
    assert _same(dict(got), dict(want))
    for o in overrides:
        raw = o.partition("=")[2]
        assert _same(port_config.apply_dot_overrides({}, ["x=" + raw])["x"],
                     jax_config.apply_dot_overrides({}, ["x=" + raw])["x"]), o


SCALAR = st.text(alphabet="0123456789+-._:eExXbBoOaAnNfFiItTyYuUlLsS~ #=<'\"", max_size=12)
WORDS = st.sampled_from(["yes", "No", "TRUE", "off", "On", "null", "~", "NULL", ".inf", "-.Inf",
                         ".NaN", "1e-6", "3.0e-06", "1.0e6", "10000000000000", "0x1F", "012",
                         "08", "0b101", "1_000", "1:30", "190:20:30.15", "-0", "+12", ".5",
                         "-.5", "1.", "0o12", "2001-12-14", "="])


def _agree(text, strict=True):
    """``loads`` returns what ``safe_load`` returns, or raises; it raises
    wherever ``safe_load`` raises. ``strict``: where only it raises, the
    value is a construct outside its subset (timestamps)."""
    try:
        want = ("ok", yaml.safe_load(text))
    except yaml.YAMLError:
        want = ("error", None)
    try:
        got = ("ok", loads(text))
    except YAMLSubsetError:
        got = ("error", None)
    if got[0] == "ok":
        assert want[0] == "ok" and _same(got[1], want[1]), (text, got, want)
    elif want[0] == "ok" and strict:
        assert "datetime" in repr(want[1]) or isinstance(want[1], datetime.date), (text, want)


@settings(max_examples=400, deadline=None, derandomize=True, database=None)
@given(st.one_of(SCALAR, WORDS))
def test_scalars_resolve_as_safe_load(s):
    _agree(f"k: {s}\n")
    _agree(s)


@settings(max_examples=200, deadline=None, derandomize=True, database=None)
@given(st.lists(st.one_of(WORDS, st.text(alphabet="0123456789.-eabc", min_size=1,
                                         max_size=6)), max_size=5))
def test_flow_collections(items):
    _agree("k: [" + ", ".join(items) + "]\n")
    _agree("k: {" + ", ".join(f"k{i}: {v}" for i, v in enumerate(items)) + "}\n")
    _agree("k:\n" + "".join(f"  - {v}\n" for v in items))


NOISE = st.text(alphabet="0123456789+-._:eExXbBoOaAnNfFiItTyYuUlLsS~ #=<'\"[]{},?!&*|>\\\n",
               max_size=14)


@settings(max_examples=300, deadline=None, derandomize=True, database=None)
@given(NOISE)
def test_any_text_in_any_position(s):
    """Wider text (brackets, quotes, indicators, line breaks) as a value, a
    flow item, a sequence entry, a key and a mapping value in a sequence:
    never a value ``safe_load`` would not give (it may raise where
    ``safe_load`` reads YAML beyond the subset)."""
    for text in (f"k: {s}\n", s, f"k: [{s}]\n", f"- {s}\n", f"a:\n  {s}: 1\n",
                 f"k: {{a: {s}}}\n", f"a:\n  - b: {s}\n    c: 1\n"):
        _agree(text, strict=False)


@pytest.mark.parametrize("text", [
    "a: &x 1\nb: *x\n", "a: !!int 3\n", "a: |\n  block\n", "a: >\n  folded\n",
    "a: 1\n---\nb: 2\n", "%YAML 1.1\n---\na: 1\n", "? a\n: b\n", "<<: {a: 1}\n",
    "a: 2001-12-14\n", "- a\n  continued\n", "[a: 1]\n", "a: b: c\n", "a: [1, 2\n",
    "a:\n\t- 1\n", ":\n", "a: 1\n  b: 2\n",
])
def test_outside_the_subset_raises(text):
    with pytest.raises(YAMLSubsetError):
        loads(text)


def test_quirks():
    assert resolve_plain("1e-6") == "1e-6" and resolve_plain("3.0e-06") == 3e-06
    assert resolve_plain("10000000000000") == 10000000000000
    assert [resolve_plain(s) for s in ("yes", "no", "on", "off")] == [True, False, True, False]
    assert resolve_plain("~") is None and resolve_plain("null") is None
    assert resolve_plain("0x1F") == 31 and resolve_plain("012") == 10
    assert resolve_plain("1_000") == 1000 and math.isnan(resolve_plain(".nan"))
    assert resolve_plain(".inf") == math.inf
    assert loads("a: ''\nb: 'it''s'\nc: \"tab\\there\"\n") == {"a": "", "b": "it's",
                                                            "c": "tab\there"}
    assert loads("k: [1,\n   2]  # across lines\n") == {"k": [1, 2]}
