"""The FLOP counters of ``benchmark/lib/flops.py`` against a count of the
reference's own products (``torch.utils.flop_counter``) at tiny widths."""

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from benchmark.drivers import serve
from benchmark.lib import flops
from benchmark.reference import models as ref
from benchmark.tests.tiny import tiny_cell

B, L, T = 2, 16, 48


def counted(fn) -> float:
    with FlopCounterMode(display=False) as fc:
        fn()
    return fc.get_total_flops()


@pytest.fixture(scope="module")
def setup():
    cell = tiny_cell()
    prog = serve.Program(cell["config_data"], cell["traffic_data"], 1, torch.device("cpu"))
    W = serve.reference_weights(prog.specs, 1, torch.device("cpu"))
    return cell["config_data"], W


def test_t5(setup):
    config, W = setup
    t5 = config["model"]["params"]["cond_stage_config"]["params"]["fallback_config"]
    ids = torch.randint(0, t5["vocab_size"], (B, L))
    assert counted(lambda: ref.t5_encode(W["t5"], t5, ids, ref.Precision())) == \
        flops.t5_encoder(t5, B, L)


def test_dit_encode_and_forward(setup):
    config, W = setup
    dit = config["model"]["params"]["unet_config"]["params"]
    P = ref.Precision()
    midi, beats = torch.randint(0, 128, (B, T)), torch.randint(0, 2, (B, T))
    cap = torch.randn(B, L, dit["ori_dim"])
    assert counted(lambda: ref.dit_encode(W["dit"], dit, midi, beats, cap, P)) == \
        flops.dit_encode(dit, B, T, L)
    enc = ref.dit_encode(W["dit"], dit, midi, beats, cap, P)
    rope = ref._rope(dit["hidden_size"] // dit["num_heads"], dit["max_len"], "cpu")
    x, t = torch.randn(B, 20, T // 2), torch.full((B,), 5.0)
    # the reference computes every expert and mixes them by einsum; the
    # counter takes the two experts a token is routed to
    d, E, rows = dit["hidden_size"], dit["num_experts"], B * T // 2
    dense = dit["depth"] * (2 * (E - 1) * 3 * flops.linear(rows, d, flops.swiglu_hidden(d))
                            + 2 * 2 * E * rows * d)
    assert counted(lambda: ref.dit_velocity(W["dit"], dit, x, t, enc, rope, P)) == \
        flops.dit_forward(dit, B, T // 2, L) + dense


def test_vae_decode_and_hifigan(setup):
    config, W = setup
    vae = config["model"]["params"]["first_stage_config"]["params"]
    z = torch.randn(B, vae["embed_dim"], T // 2)
    assert counted(lambda: ref.vae_decode(W["vae"], vae["ddconfig"], z, ref.Precision())) == \
        flops.vae_decode(vae["ddconfig"], vae["embed_dim"], B, T // 2)
    voc = config["vocoder"]["generator"]
    mel = torch.randn(1, 80, 8)
    assert counted(lambda: ref.hifigan(W["voc"], voc, mel, ref.Precision())) == \
        flops.hifigan(voc, 1, 8)


def test_hand_counts():
    assert flops.linear(3, 4, 5) == 120
    assert flops.conv1d(2, 10, 3, 4, 5) == 2 * 2 * 10 * 3 * 4 * 5
    assert flops.attention(1, 2, 3, 4, 5) == 4 * 2 * 3 * 4 * 5
    assert flops.swiglu_hidden(768) == 512


def test_vae_encode_and_patchgan(setup):
    from benchmark.reference import train as ref_train
    from benchmark.reference import vae_gan

    config, W = setup
    vae = config["model"]["params"]["first_stage_config"]["params"]
    mel = torch.randn(B, 80, T)
    assert counted(lambda: ref_train.vae_moments(W["vae"], vae["ddconfig"], mel)) == \
        flops.vae_encode(vae["ddconfig"], vae["embed_dim"], B, T)
    from versband_tpu_torch.vocoder.discriminators import NLayerDiscriminator
    from benchmark.lib import weights

    disc = NLayerDiscriminator()
    D = weights.make(weights.spec_of(disc), 1, "gan", torch.device("cpu"))
    x = torch.randn(B, 1, 80, 64)
    assert counted(lambda: vae_gan.patchgan(D, x)) == flops.patchgan(B, 80, 64)
