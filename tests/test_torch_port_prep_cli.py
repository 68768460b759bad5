"""The port's data-preparation CLIs against the JAX package's (CPU).

``make_manifest``, ``mel_extract`` (``extract``, ``drop_bad_wavs``,
``addmel2tsv``) and ``postprocess`` run in process, each port CLI beside its
JAX twin, on two identical copies of a tree of wavs that the test writes with
scipy: 16, 22.05, 44.1 and 48 kHz; mono and stereo; int16, int32, uint8 and
float32 payloads; one file that does not decode, one clip shorter than
``--min_wav_len`` and one silent clip. Paths in the TSVs are relative and each
side runs from its own copy, so the files the two sides write can be compared
byte for byte.

Bars: the rows kept and dropped and the printed lines equal; the TSVs that
``make_manifest`` writes and that ``drop_bad_wavs``/``addmel2tsv`` rewrite,
and ``total.tsv``, byte-identical; ``midi.npy``/``beats.npy`` equal in keys,
key order, dtypes and values; the mels within 1e-4 absolute (the
log-mel bar of ``tests/test_torch_port_mel.py``). The JAX pipeline writes no
``vocal_mel_path`` column, which ``postprocess`` reads: the test joins each
accompaniment row with its vocal row's mel, as ``tests/test_cli_e2e.py``
builds that column by hand.
"""

import os
import shutil

import numpy as np
import pandas as pd
import pytest
from scipy.io import wavfile

from versband_tpu.cli import make_manifest as j_manifest
from versband_tpu.cli import mel_extract as j_mel
from versband_tpu.cli import postprocess as j_post
from versband_tpu_torch.cli import make_manifest as p_manifest
from versband_tpu_torch.cli import mel_extract as p_mel
from versband_tpu_torch.cli import postprocess as p_post
from versband_tpu_torch.dsp import audio_io

DUR = 1.2  # seconds: 28,800 samples at 24 kHz from every rate, one hop multiple
TEMPLATE = "{root}/{ds}_sp_demix_24k/{sub}/[{idx}]{name}.accomp.wav"


def _signal(rng, sr, n_sec, channels, amp):
    t = np.arange(int(round(sr * n_sec))) / sr
    x = amp * (0.6 * np.sin(2 * np.pi * 220.0 * t) + 0.3 * np.sin(2 * np.pi * 1330.0 * t))
    x = x + 0.05 * amp * rng.standard_normal(t.shape)
    if channels == 2:
        x = np.stack([x, 0.5 * x + 0.02 * amp * rng.standard_normal(t.shape)], axis=1)
    return np.clip(x, -1.0, 1.0)


def _encode(x, kind):
    if kind == "int16":
        return (x * 32767).astype(np.int16)
    if kind == "int32":
        return (x * 2147483000).astype(np.int32)
    if kind == "uint8":
        return (x * 127 + 128).astype(np.uint8)
    return x.astype(np.float32)


# (name, sample rate, channels, payload, seconds, amplitude)
PAIRS = [("alpha", 44100, 2, "int16", DUR, 0.3),
         ("beta", 48000, 1, "int32", DUR, 0.05),
         ("gamma", 22050, 2, "uint8", DUR, 0.5),
         ("delta", 16000, 1, "int16", 0.5, 0.3),  # shorter than --min_wav_len
         ("eps", 16000, 1, "int16", DUR, 0.0)]  # silent


def _write_tree(root):
    rng = np.random.default_rng(0)
    prompts = []
    for i, (name, sr, ch, kind, sec, amp) in enumerate(PAIRS):
        sub = f"set{i % 2}"
        path = TEMPLATE.format(root=root, ds="crawl", sub=sub, idx=i, name=name)
        os.makedirs(os.path.dirname(path), exist_ok=True)
        for p in (path, path.replace("accomp", "vocal")):
            wavfile.write(p, sr, _encode(_signal(rng, sr, sec, ch, amp), kind))
        prompts.append((f"crawl<sep>{sub}<sep>{name}<sep>{i}", str([f"{name} song", "calm"])))
    # a vocal stem that is missing, too few parts, and captions that are no list
    lonely = TEMPLATE.format(root=root, ds="crawl", sub="set0", idx=9, name="lonely")
    wavfile.write(lonely, 24000, _encode(_signal(rng, 24000, DUR, 1, 0.3), "int16"))
    prompts += [("crawl<sep>set0<sep>lonely<sep>9", "['x']"), ("crawl<sep>only", "['y']")]
    prompts[1] = (prompts[1][0], "not a list")
    prompts[2] = (prompts[2][0], "['with \"quotes\" inside', 'and\\\\slash']")
    prompts[4] = (prompts[4][0], "")
    with open(f"{root}/prompts.tsv", "w") as f:
        f.write("item_name\tcaption\tsource\n")
        for j, (item, cap) in enumerate(prompts):
            f.write(f"{item}\t{cap}\t{j}\n")
    # files that make_manifest cannot list: float32 (no PCM header) and garbage
    os.makedirs(f"{root}/extra", exist_ok=True)
    wavfile.write(f"{root}/extra/float.wav", 16000,
                  _encode(_signal(rng, 16000, DUR, 2, 0.4), "float32"))
    with open(f"{root}/extra/broken.wav", "wb") as f:
        f.write(b"RIFF\x00\x00\x00\x00WAVEjunk")


def _same_file(a, b):
    with open(a, "rb") as fa, open(b, "rb") as fb:
        assert fa.read() == fb.read(), (a, b)


@pytest.fixture(scope="module")
def trees(tmp_path_factory):
    base = tmp_path_factory.mktemp("prep")
    _write_tree(str(base / "jax"))
    shutil.copytree(base / "jax", base / "port")
    return base / "jax", base / "port"


def _run(monkeypatch, capsys, cwd, fn, argv):
    monkeypatch.chdir(cwd)
    assert fn(argv) == 0
    return capsys.readouterr().out


def test_audio_io_reads_as_jax(trees):
    from versband_tpu.dsp import audio_io as j_io

    jax_root, _ = trees
    paths = sorted(str(p) for p in jax_root.rglob("*.wav") if "broken" not in p.name)
    assert len(paths) == 12
    for p in paths:
        for sr in (None, 24000):
            got, got_sr = audio_io.load_wav(p, sr)
            ref, ref_sr = j_io.load_wav(p, sr)
            assert got_sr == ref_sr and got.dtype == ref.dtype == np.float32
            np.testing.assert_array_equal(got, ref)
        if "float" not in p:
            assert audio_io.get_wav_num_frames(p, 24000) == j_io.get_wav_num_frames(p, 24000)
    with pytest.raises(Exception):
        audio_io.get_wav_num_frames(f"{jax_root}/extra/float.wav")  # not PCM, as in JAX
    x = np.linspace(-1.5, 1.5, 11).astype(np.float32)
    audio_io.save_wav(f"{jax_root}/saved_p.wav", x, 24000)
    j_io.save_wav(f"{jax_root}/saved_j.wav", x, 24000)
    _same_file(f"{jax_root}/saved_p.wav", f"{jax_root}/saved_j.wav")


def test_chain_matches_jax(trees, monkeypatch, capsys):
    """make_manifest -> extract -> drop_bad_wavs -> addmel2tsv, step by step."""
    jax_root, port_root = trees
    argv = ["--prompts", "prompts.tsv", "--data_root", ".", "--out", "music.tsv",
            "--path_template", TEMPLATE]
    out_j = _run(monkeypatch, capsys, jax_root, j_manifest.main, argv)
    out_p = _run(monkeypatch, capsys, port_root, p_manifest.main, argv)
    assert out_p == out_j == "wrote 10 rows to music.tsv (skip 2)\n"
    _same_file(jax_root / "music.tsv", port_root / "music.tsv")
    text = (port_root / "music.tsv").read_text()
    # the fallback str() of a cell, of an empty cell, and the escapes
    assert "\tnot a list\n" in text and "\tnan\n" in text
    assert '\twith \\"quotes\\" inside<psep>and\\\\slash\n' in text

    # the extra files, and a row per wav that make_manifest could not list
    for root in trees:
        with open(root / "music.tsv", "a") as f:
            for p in ("extra/float.wav", "extra/broken.wav", "extra/absent.wav"):
                f.write(f"x\textra\t{p}\t\t1.2\tcaption\n")
    argv = ["--tsv_path", "music.tsv"]
    out_j = _run(monkeypatch, capsys, jax_root, j_mel.main, argv)
    out_p = _run(monkeypatch, capsys, port_root, p_mel.main, argv + ["--platform", "cpu"])
    assert out_p == out_j
    assert "finished: 7 extracted, 6 skipped" in out_p
    assert out_p.count("skip short") == 2 and out_p.count("skip silent") == 2
    mels = sorted(p.relative_to(jax_root) for p in jax_root.rglob("*_mel.npy"))
    assert mels == sorted(p.relative_to(port_root) for p in port_root.rglob("*_mel.npy"))
    assert len(mels) == 7
    for rel in mels:
        got, ref = np.load(port_root / rel), np.load(jax_root / rel)
        assert got.dtype == ref.dtype == np.float32 and got.shape == ref.shape == (80, 90)
        assert np.abs(got - ref).max() <= 1e-4, rel

    # a second run keeps the files; --overwrite writes them again
    out_p = _run(monkeypatch, capsys, port_root, p_mel.main, argv + ["--platform", "cpu"])
    assert "finished: 0 extracted, 6 skipped" in out_p

    for mode, line in (("drop_bad_wavs", "kept 11/13 rows"), ("addmel2tsv",
                                                             "wrote mel_path for 7 rows")):
        argv = ["--tsv_path", "music.tsv", "--mode", mode]
        out_j = _run(monkeypatch, capsys, jax_root, j_mel.main, argv)
        out_p = _run(monkeypatch, capsys, port_root, p_mel.main, argv)
        assert out_p == out_j and line in out_p, mode
        _same_file(jax_root / "music.tsv", port_root / "music.tsv")


def test_ranks_stride_the_rows(trees, monkeypatch, capsys, tmp_path):
    """--rank/--world split the rows that one rank extracts; --nproc hands
    the same argv to the port's fan-out, which appends the rank flags."""
    _, port_root = trees
    work = tmp_path / "ranks"
    shutil.copytree(port_root / "crawl_sp_demix_24k", work / "crawl_sp_demix_24k")
    rows = sorted(str(p.relative_to(work)) for p in work.rglob("*.wav")
                  if "alpha" in p.name or "beta" in p.name or "gamma" in p.name)
    for p in work.rglob("*_mel.npy"):
        p.unlink()
    pd.DataFrame({"audio_path": rows}).to_csv(work / "a.tsv", sep="\t", index=False)
    base = ["--tsv_path", "a.tsv", "--platform", "cpu"]
    outs = [_run(monkeypatch, capsys, work, p_mel.main, base + ["--rank", str(r), "--world", "2"])
            for r in (0, 1)]
    assert "[0] finished: 3 extracted" in outs[0] and "[1] finished: 3 extracted" in outs[1]
    got = sorted(str(p.relative_to(work)) for p in work.rglob("*_mel.npy"))
    assert got == sorted(p_mel.mel_path_for(r) for r in rows)

    from versband_tpu_torch.utils import fanout

    calls = []
    monkeypatch.setattr(fanout, "spawn_ranks", lambda *a: calls.append(a) or 0)
    assert p_mel.main(base + ["--nproc", "2"]) == 0
    assert calls == [("versband_tpu_torch.cli.mel_extract", base + ["--nproc", "2"], 2)]
    assert fanout.strip_flag(calls[0][1], "--nproc") == base


def _post_inputs(root, music_rows):
    """A joined manifest (``bpm`` read as floats for its empty cell, ``track``
    as integers), note and beat dicts (0.4 s notes: 30 frames each) and a
    music-feature TSV naming s0 and s2 (s2's emotion empty)."""
    rng = np.random.default_rng(1)
    os.makedirs(root, exist_ok=True)
    rows, notes, beats = [], {}, {}
    for i, (name, frames, midi_frames, duration, bpm) in enumerate(music_rows):
        mel = f"{name}_vocal_mel.npy"
        np.save(f"{root}/{mel}", rng.standard_normal((80, frames)).astype(np.float32))
        rows.append({"name": name, "dataset": "crawl", "audio_path": f"{name}.wav",
                     "mel_path": f"{name}_mel.npy", "vocal_mel_path": mel,
                     "duration": duration, "caption": f"{name}<psep>calm", "bpm": bpm,
                     "track": i})
        if midi_frames is None:
            continue
        durs = [0.4] * (midi_frames // 30) + [(midi_frames % 30) / 75.0]
        notes[name] = {"pitches": rng.integers(0, 128, len(durs)), "note_durs": durs}
        beats[name] = [[t, 1] for t in np.arange(0.0, frames / 75.0 + 1.0, 0.48)]
    pd.DataFrame(rows).to_csv(f"{root}/music.tsv", sep="\t", index=False)
    np.save(f"{root}/notes.npy", notes, allow_pickle=True)
    np.save(f"{root}/beats.npy", beats, allow_pickle=True)
    with open(f"{root}/feat.tsv", "w") as f:
        f.write("item_name\tkey\ttempo\temotion\n")
        f.write("s0\tC major\t120\t['calm']\ns2\tA minor\t96\t\n")


def _check_post(monkeypatch, capsys, roots, extra=()):
    outs = []
    for fn, root in zip((j_post.main, p_post.main), roots):
        argv = ["--manifest", "music.tsv", "--notes", "notes.npy", "--beats", "beats.npy",
                "--out_dir", "out", *extra]
        outs.append(_run(monkeypatch, capsys, root, fn, argv))
    assert outs[0] == outs[1]
    _same_file(roots[0] / "out" / "total.tsv", roots[1] / "out" / "total.tsv")
    for name in ("midi.npy", "beats.npy"):
        ref = np.load(roots[0] / "out" / name, allow_pickle=True).item()
        got = np.load(roots[1] / "out" / name, allow_pickle=True).item()
        assert list(got) == list(ref), name
        for k in ref:
            assert got[k].dtype == ref[k].dtype == np.int64
            np.testing.assert_array_equal(got[k], ref[k])
    return outs[1], open(roots[1] / "out" / "total.tsv").read()


def test_postprocess_matches_jax(tmp_path, monkeypatch, capsys):
    # (name, mel frames, midi frames, duration, bpm): s1's midi is 30 frames
    # off its mel (a --frame_tolerance reject); s3 has no notes; s4's 21.3 s
    # of notes are cut at 20 s and its 25 s duration capped there
    music = [("s0", 1500, 1496, 20.0, 120), ("s1", 600, 630, 8.0, ""),
             ("s2", 1200, 1205, 16.0, 100), ("s3", 300, None, 4.0, 90),
             ("s4", 1500, 1600, 25.0, 110)]
    roots = [tmp_path / "jax", tmp_path / "port"]
    for root in roots:
        _post_inputs(str(root), music)
    out, tsv = _check_post(monkeypatch, capsys, roots, ["--music_feat", "feat.tsv"])
    assert "| Skip s1: midi frames 630 vs mel 600" in out
    assert "wrote 3 items to out (skip 2)" in out
    header, *lines = tsv.splitlines()
    assert header.split("\t")[-6:] == ["bpm", "track", "key", "tempo", "emotion", "wav_len"]
    # tempo's 120 is widened by s4's missing cell; bpm was read as floats
    assert lines[0].endswith("\t120.0\t0\tC major\t120.0\t['calm']\t20.0")
    assert lines[1].endswith("\t100.0\t2\tA minor\t96.0\t\t16.0")
    assert lines[2].endswith("\t110.0\t4\t\t\t\t20.0")  # s4 has no features
    # without the features: no feature columns; integers stay integers
    out, tsv = _check_post(monkeypatch, capsys, roots)
    assert tsv.splitlines()[0].split("\t")[-1] == "wav_len"


def test_postprocess_keeps_no_rows(tmp_path, monkeypatch, capsys):
    roots = [tmp_path / "jax", tmp_path / "port"]
    for root in roots:
        _post_inputs(str(root), [("s0", 600, 700, 8.0, 1), ("s1", 300, None, 4.0, 2)])
    out, tsv = _check_post(monkeypatch, capsys, roots)
    assert out.endswith("wrote 0 items to out (skip 2)\n") and tsv == "\n"


@pytest.mark.parametrize("mode", ["drop_bad_wavs", "addmel2tsv"])
def test_rewrites_of_an_empty_table(tmp_path, monkeypatch, capsys, mode):
    roots = [tmp_path / "jax", tmp_path / "port"]
    for fn, root in zip((j_mel.main, p_mel.main), roots):
        root.mkdir()
        (root / "m.tsv").write_text("audio_path\tname\tmel_path\n")
        _run(monkeypatch, capsys, root, fn, ["--tsv_path", "m.tsv", "--mode", mode])
    _same_file(roots[0] / "m.tsv", roots[1] / "m.tsv")
    assert (roots[1] / "m.tsv").read_text() == "\n"
