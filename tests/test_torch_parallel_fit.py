"""``python -m turkish_asr_torch.main`` over a mesh of gloo ranks (each
rank joins the group and calls ``main`` as under torchrun; the ranks run
from tests/torch_parallel_worker.py), its checkpoints, and served data
parallelism.

- ``data=2``, ``model=2`` and ``seq=2`` train two epochs (fp32, dropout 0)
  with the one-process run's losses: within 1e-5 relative on ``data``,
  1e-4 on ``model`` and ``seq``. Only rank 0 writes a checkpoint; both
  ranks keep the same best validation loss, so the same best epoch.
- The ``data=2`` checkpoint resumes in the one-process trainer and is
  served by ``ASRInference``; the ``model=2`` checkpoint resumes on
  ``data=2`` with the one-process resume's losses (1e-5 relative).
- ``ASRInference(data_parallel=True, devices=["cpu", "cpu"])``, greedy and
  beam + ARPA, and the service under ``ASR_DATA_PARALLEL=true`` give the
  texts of the one-replica path (``data_parallel=False``).
"""

import os
import shutil
import sys

import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from turkish_asr_torch.audio.wavio import write_wav  # noqa: E402
from turkish_asr_torch.inference import ASRInference  # noqa: E402
from beam_fixtures import WORD_ARPA  # noqa: E402
import torch_parallel_worker as W  # noqa: E402

WORDS = ["merhaba", "evet", "bir", "iki", "üç", "dört", "beş", "altı", "yedi", "sekiz",
         "dokuz", "on"]


def _argv(corpus, runs, epochs, *extra):
    return ["--data_path", str(corpus), "--val_split", "0.34", "--test_split", "0",
            "--checkpoint_dir", str(runs), "--d_model", "32", "--n_heads", "2",
            "--n_blocks", "1", "--batch_size", "4", "--learning_rate", "2e-3",
            "--save_interval", "1", "--log_interval", "1", "--device", "cpu",
            "--precision", "fp32", "--encoder_dropout", "0", "--num_workers", "1",
            "--epochs", str(epochs), *extra]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """A 12-file corpus (8 train, 4 valid), the one-process run and the
    data=2, model=2 and seq=2 runs of two epochs."""
    tmp = tmp_path_factory.mktemp("fit")
    corpus = tmp / "corpus"
    corpus.mkdir()
    rng = np.random.default_rng(0)
    for i, word in enumerate(WORDS):
        n = 8000 + 1600 * (i % 4)
        t = np.arange(n) / 16000
        x = 0.3 * np.sin(2 * np.pi * (180 + 60 * i) * t) + 0.02 * rng.standard_normal(n)
        write_wav(str(corpus / f"s{i:02d}.wav"), x.astype(np.float32), 16000)
        (corpus / f"s{i:02d}.txt").write_text(word, encoding="utf-8")
    out = {"corpus": corpus, "one": W.fit(str(tmp), _argv(corpus, tmp / "one", 2))}
    for spec in ("data=2", "model=2", "seq=2"):
        out[spec] = W.run_ranks(tmp, "fit", 2, argv=_argv(corpus, tmp / spec, 2,
                                                          "--mesh_shape", spec))
    out["tmp"] = tmp
    return out


@pytest.mark.parametrize("spec,rtol", [("data=2", 1e-5), ("model=2", 1e-4), ("seq=2", 1e-4)])
def test_main_on_a_mesh_matches_one_process(runs, spec, rtol):
    one = runs["one"]
    assert len(one["losses"]) == 4  # 2 epochs of 2 global batches
    for r in runs[spec]:
        np.testing.assert_allclose(r["losses"], one["losses"], rtol=rtol)
        np.testing.assert_allclose(r["best_val_loss"], one["best_val_loss"], rtol=rtol)
        assert r["global_step"] == one["global_step"] == 4
        assert r["files"] == one["files"]
    assert "train.log" in one["files"]
    rank0, rank1 = runs[spec]
    assert rank0["best_val_loss"] == rank1["best_val_loss"]
    assert rank1["written"] == [] and sorted(rank0["written"]) == sorted(one["written"])


def test_checkpoints_load_everywhere(runs, tmp_path):
    """The data=2 run's checkpoint resumes in one process and serves; the
    model=2 run's resumes on data=2 as it resumes in one process."""
    corpus, tmp = runs["corpus"], runs["tmp"]
    shutil.copytree(tmp / "data=2", tmp_path / "d2")
    resumed = W.fit(str(tmp_path), _argv(corpus, tmp_path / "d2", 3, "--resume"))
    assert resumed["start_epoch"] == 3 and resumed["global_step"] == 6
    asr = ASRInference(str(tmp / "data=2" / "best_model.pt"), device="cpu",
                       compute_dtype=torch.float32)
    assert isinstance(asr.transcribe(str(corpus / "s00.wav")), str)
    for k, v in torch.load(tmp / "data=2" / "turkish_conformer_final.pt",
                           weights_only=True)["model_state_dict"].items():
        assert torch.equal(asr.model.state_dict()[k], v), k

    for name in ("m_one", "m_d2"):
        shutil.copytree(tmp / "model=2", tmp_path / name)
    one = W.fit(str(tmp_path), _argv(corpus, tmp_path / "m_one", 3, "--resume"))
    ranks = W.run_ranks(tmp_path, "fit", 2, argv=_argv(corpus, tmp_path / "m_d2", 3, "--resume",
                                                       "--mesh_shape", "data=2"))
    for r in ranks:
        assert r["start_epoch"] == one["start_epoch"] == 3
        np.testing.assert_allclose(r["losses"], one["losses"], rtol=1e-5)
        assert len(r["losses"]) == 2


def _files(runs):
    return [str(runs["corpus"] / f"s{i:02d}.wav") for i in range(len(WORDS))]


@pytest.mark.parametrize("beam", [False, True])
def test_served_data_parallel_gives_one_replica_texts(runs, tmp_path, beam, monkeypatch):
    from turkish_asr_torch.serve.server import ASRService, ServerConfig
    model = str(runs["tmp"] / "one" / "turkish_conformer_final.pt")
    lm = tmp_path / "words.arpa"
    lm.write_text(WORD_ARPA)
    kw = dict(device="cpu", compute_dtype=torch.float32)
    if beam:
        kw.update(use_beam_search=True, beam_width=4, lm_path=str(lm))
    one = ASRInference(model, data_parallel=False, **kw)
    two = ASRInference(model, data_parallel=True, devices=["cpu", "cpu"], **kw)
    assert len(one.replicas) == 1 and len(two.replicas) == 2
    files = _files(runs)
    want = one.transcribe_files(files, batch_size=4)
    assert two.transcribe_files(files, batch_size=4) == want
    wav = np.stack([np.zeros(16000, np.float32), np.ones(16000, np.float32) * 0.1,
                    np.full(16000, -0.05, np.float32)])
    lens = np.asarray([16000, 12000, 9000], np.int32)
    (a, la), (b, lb) = one._forward_batch(wav, lens), two._forward_batch(wav, lens)
    torch.testing.assert_close(a, b, rtol=0, atol=1e-5)
    assert torch.equal(la, lb)

    monkeypatch.setenv("ASR_MODEL_PATH", model)
    if beam:
        monkeypatch.setenv("USE_BEAM_SEARCH", "true")
        monkeypatch.setenv("BEAM_WIDTH", "4")
        monkeypatch.setenv("ASR_LM_PATH", str(lm))
    uploads = [(os.path.basename(f), open(f, "rb").read()) for f in files[:5]]
    texts = {}
    for flag in ("false", "true"):
        monkeypatch.setenv("ASR_DATA_PARALLEL", flag)
        svc = ASRService(ServerConfig(), warmup=False, device="cpu", devices=["cpu", "cpu"])
        svc.asr.compute_dtype = torch.float32
        assert len(svc.asr.replicas) == (2 if flag == "true" else 1)
        status, payload = svc.transcribe_batch(uploads)
        assert status == 200
        texts[flag] = [r["text"] for r in payload["results"]]
    assert texts["true"] == texts["false"] == want[:5]
