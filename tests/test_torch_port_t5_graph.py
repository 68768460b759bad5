"""The caption tower's CUDA-graph path, at tiny widths on the CPU.

* ``T5Attention.bucket_indices``: kept once per (length, device), equal to
  ``relative_position_bucket`` of the same length;
* ``compute_bias``: bit-equal to the per-call lookup it replaces, and a table
  changed in place shows in the next bias;
* ``tower_graph_key``: a new key for other rows, length, ids' dtype,
  parameters' dtype or float32 precision, the same key for other ids;
* ``_FrozenT5Tower`` on the CPU takes no graph and counts nothing;
* the graph path's control flow (``_on_card`` with the capture replaced by a
  graph that reruns the encoder): eager, capture, replays, a copy returned on
  every replay, and replaced storage dropping the graphs.

What only a card can show (bit-equal replays, thread-local capture) is in
``tests/test_torch_port_cuda.py``.
"""

import numpy as np
import pytest
import torch

from versband_tpu_torch.models.cfm import _Graph
from versband_tpu_torch.text.embedders import _FrozenT5Tower, tower_graph_key
from versband_tpu_torch.text.t5 import relative_position_bucket
from versband_tpu_torch.utils import profiling

TINY = dict(d_model=16, d_ff=24, d_kv=4, num_heads=2, num_layers=2, vocab_size=64,
            feed_forward_proj="gated-gelu")
LENGTHS = [1, 7, 80, 160]


def _tower(max_length: int = 7) -> _FrozenT5Tower:
    return _FrozenT5Tower("no-such-t5-directory", max_length, TINY, "cpu")


def _attn(tower: _FrozenT5Tower):
    return tower.model.encoder.block[0].layer[0].SelfAttention


def _per_call_buckets(length: int) -> torch.Tensor:
    pos = torch.arange(length, dtype=torch.long)
    return relative_position_bucket(pos[None, :] - pos[:, None], 32, 128)


def _ids(tower: _FrozenT5Tower, texts) -> torch.Tensor:
    return torch.from_numpy(np.asarray(tower.tokenize(texts), np.int64))


def _drained_counts(fn):
    profiling.spans_on()
    try:
        out = fn()
    finally:
        profiling.spans_off()
        _, counts = profiling.drain()
    return out, {k: v for k, v in counts.items() if k.startswith("text.tower.graph")}


@pytest.mark.parametrize("length", LENGTHS)
def test_kept_buckets_equal_relative_position_bucket(length):
    attn = _attn(_tower())
    got = attn.bucket_indices(length, torch.device("cpu"))
    assert torch.equal(got, _per_call_buckets(length))
    assert attn.bucket_indices(length, "cpu") is got  # computed once per (length, device)


@pytest.mark.parametrize("length", LENGTHS)
def test_compute_bias_is_bit_equal_to_the_per_call_lookup(length):
    attn = _attn(_tower())
    table = attn.relative_attention_bias.weight
    want = table[_per_call_buckets(length)].permute(2, 0, 1)[None]
    for _ in range(2):  # the first call fills the cache, the second reads it
        got = attn.compute_bias(length)
        assert got.shape == (1, TINY["num_heads"], length, length)
        assert torch.equal(got, want)


def test_a_table_changed_in_place_shows_in_the_next_bias():
    attn = _attn(_tower())
    before = attn.compute_bias(80).clone()
    with torch.no_grad():
        attn.relative_attention_bias.weight.mul_(2.0)
    assert torch.equal(attn.compute_bias(80), before * 2.0)


def _key_with(change: str):
    model = _tower().model
    dev, rows, length, dtype = torch.device("cuda"), 1, 80, torch.int64
    if change == "rows":
        rows = 4
    elif change == "length":
        length = 77
    elif change == "ids_dtype":
        dtype = torch.int32
    elif change == "param_dtype":
        model.double()
    prev = torch.get_float32_matmul_precision(), torch.backends.cudnn.allow_tf32
    try:
        if change == "matmul_precision":
            torch.set_float32_matmul_precision("high" if prev[0] == "highest" else "highest")
        elif change == "cudnn_tf32":
            torch.backends.cudnn.allow_tf32 = not prev[1]
        return tower_graph_key(torch.zeros(rows, length, dtype=dtype), dev, model)
    finally:
        torch.set_float32_matmul_precision(prev[0])
        torch.backends.cudnn.allow_tf32 = prev[1]


@pytest.mark.parametrize("change", ["rows", "length", "ids_dtype", "param_dtype",
                                    "matmul_precision", "cudnn_tf32"])
def test_the_graph_key_follows_the_signature(change):
    base = _key_with("none")
    assert base == _key_with("none")
    model = _tower().model
    assert base == tower_graph_key(torch.ones(1, 80, dtype=torch.int64), torch.device("cuda"),
                                   model)  # the ids' values are not part of it
    assert _key_with(change) != base


def test_on_the_cpu_the_tower_takes_no_graph_and_counts_nothing(monkeypatch):
    tower = _tower()

    def no_graph(_ids):
        raise AssertionError("the CPU tower took the graph path")

    monkeypatch.setattr(tower, "_on_card", no_graph)
    outs, counts = _drained_counts(lambda: [tower(["a soft piano", ""]) for _ in range(3)])
    assert counts == {}
    assert not tower.graphs.graphs and not tower.graphs.seen
    assert all(torch.equal(o, outs[0]) for o in outs)


def _rerun_capture(tower: _FrozenT5Tower):
    """A stand-in for ``_capture`` on the CPU: a graph whose replay reruns the
    encoder on its static ids into its static output."""

    def capture(ids):
        static = ids.clone()
        out = tower.model(static)

        class Rerun:
            def replay(self):
                out.copy_(tower.model(static))

        return _Graph(Rerun(), [static], out, 0)

    return capture


@torch.no_grad()
def test_the_graph_path_runs_eager_then_captures_then_replays(monkeypatch):
    """Caption then ``""`` three times over (one signature): 1 eager call, 1
    capture, 4 replays, each the eager encoder's states; what a call returned
    is not overwritten by later replays. Another row count starts over; a
    parameter given new storage drops the graphs."""
    tower = _tower(max_length=12)
    monkeypatch.setattr(tower, "_capture", _rerun_capture(tower))
    texts = ["a soft piano accompaniment", ""]
    want = [tower.model(_ids(tower, [t])) for t in texts]
    got, counts = _drained_counts(
        lambda: [tower._on_card(_ids(tower, [t])) for _ in range(3) for t in texts])
    assert counts == {"text.tower.graph.eager": 1, "text.tower.graph.captures": 1,
                      "text.tower.graph.replays": 4}
    for i, out in enumerate(got):
        assert torch.equal(out, want[i % 2])
    assert len(tower.graphs.graphs) == 1

    _, counts = _drained_counts(lambda: tower._on_card(_ids(tower, texts)))
    assert counts == {"text.tower.graph.eager": 1}

    wi = tower.model.encoder.block[1].layer[1].DenseReluDense.wi_0.weight
    wi.data = wi.data * 0.5  # new storage
    fresh = tower.model(_ids(tower, texts[:1]))
    got, counts = _drained_counts(lambda: [tower._on_card(_ids(tower, texts[:1]))
                                           for _ in range(3)])
    assert counts == {"text.tower.graph.eager": 1, "text.tower.graph.captures": 1,
                      "text.tower.graph.replays": 1}
    assert all(torch.equal(out, fresh) for out in got)
    assert not torch.equal(fresh, want[0])
