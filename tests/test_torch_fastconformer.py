"""FastConformer XXL (Parakeet-CTC 1.1B) on the port, on the CPU at a small
size that keeps its head size of 128 (d 256, 2 heads, 2 blocks, 32
subsample channels, depthwise kernel 9) on seeded random weights: the 8x
``dw_striding`` subsample, the ``"conformer"`` block, against the
plain reference ``tests/ref_fastconformer.py``; the subsample's frame
arithmetic; ``ASRInference``'s whole-file buckets (``full_context_s``) and
its chunks; ``load_pt`` reading the subsample and refusing NeMo's
``xscaling``, which the model does not compute.

Tolerances: the port and the reference compute the same fp32 function in
other orders (the port's relative term gathers a column per (i, j) where
the reference rel-shifts, its LayerNorm is ``F.layer_norm``, its between-
stage mask a ``where`` where the reference multiplies), so logits agree
within 1e-4 absolute, the model tests' fp32 tolerance. A file's logits
alone and in a padded batch of a longer bucket differ only by the summation
orders of other matrix shapes: 1e-4 as well.
"""

import math
import os
import sys
import wave

import numpy as np
import pytest
import torch
import torch.nn.functional as F

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import ref_fastconformer  # noqa: E402
from turkish_asr_torch.audio.features import log_mel_spectrogram  # noqa: E402
from turkish_asr_torch.data.buckets import DEFAULT_WAVEFORM_BUCKETS  # noqa: E402
from turkish_asr_torch.inference import ASRInference, whole_file_buckets  # noqa: E402
from turkish_asr_torch.models.conformer import (  # noqa: E402
    SUBSAMPLES, ConformerCTC, Conv4Subsample, DwStriding8Subsample, ModelConfig, count_params,
    init_model)
from turkish_asr_torch.utils import tracing  # noqa: E402
from turkish_asr_torch.utils.weights import load_pt  # noqa: E402

SMALL = dict(n_mels=80, d_model=256, n_heads=2, n_blocks=2, n_classes=56, dropout=0.0,
             conv_kernel_size=9, block="conformer", subsample="dw_striding8",
             subsample_channels=32)
SR = 16000


def _model(seed=0, **changes):
    """The small model with every weight drawn, and LayerNorms and
    BatchNorm's statistics moved off their identity values."""
    gen = torch.Generator().manual_seed(seed)
    model = init_model(ModelConfig(**dict(SMALL, **changes)), generator=gen)
    with torch.no_grad():
        for name, t in model.state_dict().items():
            if name.endswith("running_var"):
                t.copy_(torch.rand(t.shape, generator=gen) + 0.5)
            elif name.endswith("running_mean") or ("norm" in name and t.dim() == 1):
                t.add_(0.1 * torch.randn(t.shape, generator=gen))
    return model.eval()


def _batch(lengths, T=None, seed=1):
    """Seeded features, zero past each row's frames (as the front end's)."""
    gen = torch.Generator().manual_seed(seed)
    lens = torch.tensor(lengths)
    T = T or max(lengths)
    x = torch.randn((len(lengths), T, 80), generator=gen)
    return x * (torch.arange(T)[None, :, None] < lens[:, None, None]), lens


@pytest.mark.parametrize("lengths", [(301, 257, 96), (300, 1, 17), (128, 127, 129)])
def test_port_matches_the_plain_reference(lengths):
    model = _model()
    x, lens = _batch(lengths)
    with torch.no_grad():
        got = model(x, lens)
    want = ref_fastconformer.forward(model.state_dict(), SMALL, x, lens)
    assert got.shape == want.shape == (3, ref_fastconformer.frames(max(lengths)), 56)
    valid = ref_fastconformer.frames(lens)
    for i, n in enumerate(valid.tolist()):
        torch.testing.assert_close(got[i, :n], want[i, :n], rtol=0, atol=1e-4)


@pytest.mark.parametrize("kind", sorted(SUBSAMPLES))
def test_subsample_frames_against_the_convolutions(kind):
    """The 8x subsample's valid frames are its convolutions' own output
    lengths; the 4x keeps the reference's ``// 4`` (at most the convolutions'),
    and both give the mel bins input_proj is built for."""
    sub = SUBSAMPLES[kind](4, torch.nn.ReLU).eval()
    lengths = torch.arange(1, 70)
    with torch.no_grad():
        out = [sub(torch.zeros(1, int(n), 80), torch.float32).shape[2:] for n in lengths]
    got = sub.frames(lengths)
    assert got.dtype == lengths.dtype
    assert [int(f) for f, _ in out] == [-(-int(n) // sub.factor) for n in lengths]
    if kind == "dw_striding8":
        assert got.tolist() == [int(f) for f, _ in out]
        assert sub.frames(0) == 0 and sub.out_bins(80) == 10
    else:
        assert got.tolist() == (lengths // 4).tolist()
        assert sub.out_bins(80) == 20
    assert {b for _, b in out} == {sub.out_bins(80)}


def test_the_4x_subsample_keeps_its_arithmetic():
    """The flagship's and Conformer (L)'s subsample: the two convolutions
    with their bias and activation written out, bit for bit, and the mask
    at ``lengths // 4``."""
    for block in ("flagship", "conformer"):
        cfg = ModelConfig(n_mels=80, d_model=32, n_heads=2, n_blocks=1, n_classes=12,
                          block=block)
        model = init_model(cfg, torch.Generator().manual_seed(3)).eval()
        x, lens = _batch((97, 40))
        h = x[:, None]
        for i in (0, 2):
            conv, act = model.subsample[i], model.subsample[i + 1]
            h = act(F.conv2d(h, conv.weight, stride=2, padding=1)
                    + conv.bias.float().view(1, -1, 1, 1))
        with torch.no_grad():
            got = model.subsample(x, torch.float32, lens)
        assert torch.equal(got, h.detach())
        assert model.subsample.factor == 4 and model.input_proj.in_features == 32 * 20
        assert torch.equal(model.subsample.frames(lens.to(torch.int32)),
                           lens.to(torch.int32) // 4)


def test_a_files_logits_do_not_depend_on_its_bucket_or_batch():
    """The stages' padded frames are zeroed, so the last valid frame of a
    row does not read its padding; with it every frame through attention."""
    model = _model()
    x, lens = _batch((301, 257, 97))
    with torch.no_grad():
        batched = model(x, lens)
        for i in range(3):
            n = int(lens[i])
            alone = model(x[i:i + 1, :n], lens[i:i + 1])
            longer = model(torch.cat([x[i:i + 1], torch.zeros(1, 123, 80)], dim=1),
                           lens[i:i + 1])
            valid = int(ref_fastconformer.frames(lens[i]))
            torch.testing.assert_close(alone[0, :valid], batched[i, :valid], rtol=0, atol=1e-4)
            torch.testing.assert_close(longer[0, :valid], batched[i, :valid], rtol=0, atol=1e-4)


def test_counts_the_published_size():
    """Parakeet-CTC 1.1B: subsample 2,761,728 + 42 blocks of 25,207,808 +
    head 1,050,625."""
    cfg = ModelConfig(n_mels=80, d_model=1024, n_heads=8, n_blocks=42, n_classes=1025,
                      conv_kernel_size=9, block="conformer", subsample="dw_striding8",
                      subsample_channels=256)
    with torch.device("meta"):
        model = ConformerCTC(cfg)
    assert count_params(model) == 1_062_540_289
    assert sum(p.numel() for n, p in model.named_parameters()
               if n.startswith(("subsample.", "input_proj."))) == 2_761_728
    assert count_params(model.blocks[0]) == 25_207_808


def test_config_refuses_an_unknown_subsample():
    with pytest.raises(ValueError, match="subsample must be one of"):
        ModelConfig(subsample="conv6")


def _save(model, path, **stored):
    torch.save({"model_state_dict": model.state_dict(),
                "config": {"n_heads": 2, "n_mel_channels": 80, **stored}}, path)
    return str(path)


@pytest.mark.parametrize("xscaling", [True, False, None])
def test_load_pt_reads_the_subsample_and_xscaling(tmp_path, xscaling):
    """The 8x subsample from its keys and shapes (its channels from
    ``subsample.0``). A stored config that sets NeMo's ``xscaling`` (the
    input projection's output times sqrt(d), which no weight shows and no
    model of the port computes) is refused rather than served unscaled."""
    model = _model()
    stored = {} if xscaling is None else {"xscaling": xscaling}
    path = _save(model, tmp_path / "x.pt", **stored)
    if xscaling:
        with pytest.raises(ValueError, match="xscaling"):
            load_pt(path, "cpu")
        return
    cfg, loaded = load_pt(path, "cpu")
    assert cfg == ModelConfig(**dict(SMALL, use_mqa=False))
    x, lens = _batch((200, 150))
    with torch.no_grad():
        torch.testing.assert_close(loaded(x, lens), model(x, lens), rtol=0, atol=0)


def test_whole_file_buckets():
    assert whole_file_buckets() == DEFAULT_WAVEFORM_BUCKETS
    assert [b // SR for b in whole_file_buckets(256)[len(DEFAULT_WAVEFORM_BUCKETS):]] == [
        64, 96, 128, 160, 192, 224, 256]
    assert whole_file_buckets(70)[-1] == 96 * SR and whole_file_buckets(20)[-1] == 32 * SR
    with pytest.raises(ValueError, match="positive"):
        whole_file_buckets(0)


def _wav(path, seconds, seed):
    rng = np.random.default_rng(seed)
    pcm = (rng.standard_normal(int(SR * seconds)) * 3000).astype("<i2")
    with wave.open(str(path), "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(SR)
        w.writeframes(pcm.tobytes())
    return str(path), pcm.astype(np.float32) / 32768.0


def _counts():
    c = tracing.counters()
    return c.get("full_context_rows", 0), c.get("chunked_files", 0)


def test_full_context_runs_a_long_file_whole(tmp_path):
    """Past 32 s and within ``full_context_s`` a file runs whole, batched at
    its bucket (``full_context_rows``, no ``chunked_files``), and its logits
    are the reference's of the whole file; unset, the same file is chunked."""
    model = _model(n_blocks=1)
    path = _save(model, tmp_path / "x.pt")
    long_wav, pcm = _wav(tmp_path / "long.wav", 37.5, 0)
    short_wav, _ = _wav(tmp_path / "short.wav", 3.0, 1)
    asr = ASRInference(path, device="cpu", compute_dtype=torch.float32, data_parallel=False,
                       full_context_s=64)
    rows, chunked = _counts()
    logits, n = asr._logits(long_wav)
    assert _counts() == (rows + 1, chunked)
    feats, frames = log_mel_spectrogram(torch.from_numpy(pcm)[None],
                                        torch.tensor([len(pcm)]))
    want = ref_fastconformer.forward(model.state_dict(), dict(SMALL, n_blocks=1), feats, frames)
    assert n == int(ref_fastconformer.frames(frames)[0]) == 469
    torch.testing.assert_close(torch.from_numpy(logits), want[0, :n], rtol=0, atol=1e-4)
    texts = asr.transcribe_files([long_wav, short_wav, long_wav], batch_size=2)
    assert _counts() == (rows + 3, chunked)  # one 64 s batch of two rows
    assert texts == [asr.transcribe(long_wav), asr.transcribe(short_wav),
                     asr.transcribe(long_wav)]

    unset = ASRInference(path, device="cpu", compute_dtype=torch.float32, data_parallel=False)
    rows, chunked = _counts()
    assert unset.transcribe_files([long_wav], batch_size=2)[0] == unset.transcribe(long_wav)
    assert _counts() == (rows, chunked + 2)


def _chunked_logits_by_the_4x_rule(asr, pcm, chunk_s=28.0, overlap_s=2.0):
    """The chunk rule of a 4x model written out: 640 samples an output
    frame, ``// 4`` valid frames, a 25-frame margin."""
    chunk, overlap = int(chunk_s * SR), int(overlap_s * SR)
    margin = overlap // (160 * 4) // 2
    pieces, start = [], 0
    while start < len(pcm):
        seg = pcm[start:start + chunk]
        S = min(b for b in DEFAULT_WAVEFORM_BUCKETS if b >= len(seg))
        padded = np.zeros((1, S), np.float32)
        padded[0, :len(seg)] = seg
        with torch.inference_mode():
            feats, frames = log_mel_spectrogram(torch.from_numpy(padded),
                                                torch.tensor([len(seg)], dtype=torch.int32))
            logits = asr.model(feats, frames, torch.float32)[0].numpy()
        n = int(frames[0]) // 4
        last = start + chunk >= len(pcm)
        pieces.append(logits[:n][margin if start else 0:n if last else n - margin])
        if last:
            break
        start += chunk - overlap
    return np.concatenate(pieces)


def test_a_4x_models_frames_and_chunk_seams_are_unchanged(tmp_path):
    """A flagship-block model: ``_forward_batch``'s valid frames are the
    front end's ``// 4``, and a 37.5 s file's chunks are cut and trimmed as
    before (margin 25 frames of 40 ms)."""
    cfg = ModelConfig(n_mels=80, d_model=32, n_heads=2, n_blocks=1, n_classes=56)
    model = init_model(cfg, torch.Generator().manual_seed(2)).eval()
    path = _save(model, tmp_path / "f.pt")
    asr = ASRInference(path, n_heads=2, device="cpu", compute_dtype=torch.float32,
                       data_parallel=False)
    wav, pcm = _wav(tmp_path / "long.wav", 37.5, 3)
    lengths = np.asarray([16000, 7777, 1], np.int32)
    _, frames = asr._forward_batch(np.zeros((3, 16000), np.float32), lengths)
    assert frames.tolist() == [(1 + n // 160) // 4 for n in lengths.tolist()]
    assert asr.frame_s == 0.04
    rows, chunked = _counts()
    logits, n = asr._logits(wav)
    assert _counts() == (rows, chunked + 1)
    want = _chunked_logits_by_the_4x_rule(asr, pcm)
    assert n == want.shape[0] and np.array_equal(logits, want)


def test_the_8x_chunks_trim_at_its_own_frame_rate(tmp_path):
    """Unset, a 37.5 s file runs in two 28 s chunks whose seams trim the
    overlap's half at 80 ms a frame: 12 frames each side."""
    model = _model(n_blocks=1)
    asr = ASRInference(_save(model, tmp_path / "x.pt"), device="cpu",
                       compute_dtype=torch.float32, data_parallel=False)
    wav, pcm = _wav(tmp_path / "long.wav", 37.5, 4)
    logits, n = asr._logits(wav)
    first = ref_fastconformer.frames(1 + 28 * SR // 160)
    second = ref_fastconformer.frames(1 + (len(pcm) - 26 * SR) // 160)
    assert n == (first - 12) + (second - 12) and asr.frame_s == 0.08
    assert math.isclose(asr.frame_s * n, 37.5, abs_tol=2.0)


def test_8x_subsample_class_names_its_parameters_as_nemo():
    names = [n for n, _ in DwStriding8Subsample(8, torch.nn.ReLU).named_parameters()]
    assert names == ["0.weight", "0.bias", "2.weight", "2.bias", "3.weight", "3.bias",
                     "5.weight", "5.bias", "6.weight", "6.bias"]
    assert Conv4Subsample.factor == 4 and DwStriding8Subsample.factor == 8


def test_the_cli_takes_full_context_s(tmp_path, capsys):
    """``--full_context_s`` reaches ``ASRInference``: a 37.5 s file runs
    whole; without it the same file is chunked."""
    from turkish_asr_torch.inference import main
    model = _save(_model(n_blocks=1), tmp_path / "x.pt")
    wav, _ = _wav(tmp_path / "long.wav", 37.5, 6)
    rows, chunked = _counts()
    main(["--audio", wav, "--model", model, "--device", "cpu", "--full_context_s", "64"])
    assert _counts() == (rows + 1, chunked)
    main(["--audio", wav, "--model", model, "--device", "cpu"])
    assert _counts() == (rows + 1, chunked + 1)
    assert capsys.readouterr().out.count("Transcription:") == 2
