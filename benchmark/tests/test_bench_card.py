"""Tests that need the card (marked ``cuda``; they skip without one, decided
inside a fixture): each training cell's control, the reference with its
products in TF32, against the float32 reference; the serve driver at tiny
widths on the card."""

import time

import pytest
import torch

from benchmark.lib import compare


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: TF32 exists only on the card")
    return torch.device("cuda")


SHORT = {"accomp_band.train": dict(songs=3, song_s=[6, 8], rows=320, batch_size=2,
                                   crop_frames=384, padded_frames=384, warmup_steps=1),
         "accomp_vae.train": dict(songs=3, song_s=[10, 12], rows=120, batch_size=2,
                                  crop_frames=624, padded_frames=640, warmup_steps=1)}


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(SHORT))
def test_train_control_is_not_correct(card, tmp_path, monkeypatch, name):
    """At the cell's published widths (TF32's rounding is too small to show
    at tiny ones), with a short run's data: batch 2."""
    import copy

    from benchmark.drivers import train
    from benchmark.lib import cells
    from versband_tpu_torch.device import resolve_device

    monkeypatch.setenv("TMPDIR", str(tmp_path))
    resolve_device(card)
    cell = copy.deepcopy(cells.cell(name))
    cell["traffic_data"].update(SHORT[name])
    seed = 2 ** 31 + 3
    cb, specs, data = train.drive(cell, seed, 0.0, False, card, checked_only=True)
    batches = cb.batches
    del cb
    train.free(card)
    want = train.reference(cell, seed, specs, batches, card)
    got = train.reference(cell, seed, specs, batches, card, use_tf32=True)
    ok, _ = compare.judge({**train.compare_steps(got, want), "loader_mismatch": 0.0,
                           "failed_steps": 0.0}, cell["limits"])
    assert not ok


@pytest.mark.cuda
def test_serve_cell_runs_on_the_card(card):
    from benchmark.drivers import serve
    from benchmark.tests.tiny import tiny_cell

    cell = tiny_cell()
    out = serve.run(cell, 2 ** 31 + 9, 2.0, False, time.perf_counter(), card)
    ok, lines = compare.judge(out["checks"], cell["limits"])
    assert ok, lines
