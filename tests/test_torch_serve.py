"""Port's inference pipeline and server against the JAX package.

One ``.pt`` written from a JAX ``init_model`` (d_model 64, 4 heads, 2
blocks, 56 classes) is served by both packages in fp32 on the CPU. Texts
must be identical; logits agree within 1e-3 absolute: the front-end
agrees within 1e-4 (tests/test_torch_features.py) and two blocks
amplify that by a small factor.
"""

import json
import os
import re
import sys
import threading
import urllib.request
import uuid

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from turkish_asr_tpu.models.conformer import ModelConfig as JaxConfig  # noqa: E402
from turkish_asr_tpu.models.conformer import init_model as jax_init  # noqa: E402
from turkish_asr_tpu.utils.torch_export import export_torch_checkpoint  # noqa: E402
from turkish_asr_torch.audio.wavio import write_wav  # noqa: E402
from turkish_asr_torch.inference import ASRInference  # noqa: E402
from turkish_asr_torch.serve.server import (  # noqa: E402
    ASRService, ServerConfig, make_stdlib_server, parse_multipart)

SR = 16000


@pytest.fixture(scope="module")
def model_pt(tmp_path_factory):
    cfg = JaxConfig(n_mels=80, d_model=64, n_heads=4, n_blocks=2, n_classes=56, dropout=0.0)
    params, state = jax_init(jax.random.PRNGKey(1), cfg)
    path = str(tmp_path_factory.mktemp("model") / "model.pt")
    export_torch_checkpoint(path, params, state, cfg)
    return path


@pytest.fixture(scope="module")
def wavs(tmp_path_factory):
    d = tmp_path_factory.mktemp("wavs")
    rng = np.random.default_rng(0)
    paths = {}
    for name, seconds in (("one", 1.0), ("two_half", 2.5), ("long", 33.5)):
        t = np.arange(int(seconds * SR)) / SR
        x = 0.3 * np.sin(2 * np.pi * (220 + 40 * np.floor(t * 3)) * t)
        x = (x + 0.05 * rng.standard_normal(t.shape)).astype(np.float32)
        paths[name] = str(d / f"{name}.wav")
        write_wav(paths[name], x, SR)
    return paths


@pytest.fixture(scope="module")
def port_asr(model_pt):
    return ASRInference(model_pt, device="cpu", compute_dtype=torch.float32)


def test_transcripts_and_logits_match_jax(model_pt, wavs, port_asr):
    from inference import ASRInference as JaxASRInference
    jax_asr = JaxASRInference(model_path=model_pt, compute_dtype=jnp.float32,
                              data_parallel=False, use_pallas=False)
    files = [wavs["one"], wavs["two_half"], wavs["long"]]
    want = jax_asr.transcribe_files(files, batch_size=4)
    got = port_asr.transcribe_files(files, batch_size=4)
    assert got == want
    assert any(got), "a random model should still emit some tokens"
    for f in files:
        want_logits, want_n = jax_asr._logits(f)
        got_logits, got_n = port_asr._logits(f)
        assert got_n == want_n
        np.testing.assert_allclose(got_logits, want_logits, atol=1e-3)


def test_batched_equals_per_file(wavs, port_asr):
    files = [wavs["one"], wavs["two_half"], wavs["one"]]
    assert port_asr.transcribe_files(files, batch_size=2) == \
        [port_asr.transcribe(f) for f in files]


def test_beam_search_and_ckpt_are_refused(model_pt, wavs, port_asr, tmp_path):
    """Neither is refused any more: a JAX .ckpt of the same weights is
    served, with beam search or without, and gives the .pt's texts (the
    name is kept from when both were refused; tests/test_torch_ckpt.py
    holds the .ckpt path to the JAX package)."""
    from turkish_asr_tpu.train.checkpoint import save_checkpoint_file
    cfg = JaxConfig(n_mels=80, d_model=64, n_heads=4, n_blocks=2, n_classes=56, dropout=0.0)
    params, state = jax_init(jax.random.PRNGKey(1), cfg)
    ckpt = str(tmp_path / "model.ckpt")
    save_checkpoint_file(ckpt, {"model_config": {"n_heads": 4}}, params, state)
    files = [wavs["one"], wavs["two_half"]]
    for beam in (False, True):
        from_pt = ASRInference(model_pt, use_beam_search=beam, beam_width=4, device="cpu",
                               compute_dtype=torch.float32)
        from_ckpt = ASRInference(ckpt, use_beam_search=beam, beam_width=4, device="cpu",
                                 compute_dtype=torch.float32)
        assert from_ckpt.transcribe_files(files) == from_pt.transcribe_files(files)
    with pytest.raises(ValueError, match="export_model --format torch"):
        ASRInference("model.onnx", device="cpu")


def test_cuda_device_raises_without_gpu(model_pt):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    cfg = ServerConfig()
    cfg.MODEL_PATH = model_pt
    with pytest.raises(RuntimeError, match="cuda"):
        ASRInference(model_pt, device="cuda")
    with pytest.raises(RuntimeError, match="cuda"):
        ASRService(cfg, warmup=True, device="cuda")


def _service(model_pt, **overrides):
    cfg = ServerConfig()
    cfg.MODEL_PATH = model_pt
    for k, v in overrides.items():
        setattr(cfg, k, v)
    return ASRService(cfg, warmup=False, device="cpu")


@pytest.fixture(scope="module")
def service(model_pt):
    svc = _service(model_pt)
    assert svc.asr is not None
    return svc


def _read(path):
    with open(path, "rb") as f:
        return f.read()


def test_health(service):
    status, payload = service.health()
    assert status == 200
    assert payload == {"status": "healthy", "model_loaded": True, "device": "cpu"}


def test_upload_and_timestamps(service, wavs):
    status, plain = service.transcribe_upload("a.wav", _read(wavs["two_half"]))
    assert status == 200 and isinstance(plain["text"], str) and plain["duration_ms"] > 0
    status, timed = service.transcribe_upload("a.wav", _read(wavs["two_half"]),
                                              timestamps=True)
    assert status == 200 and timed["text"] == plain["text"]
    assert "".join(s["word"] for s in timed["segments"]) == plain["text"].replace(" ", "")
    for seg in timed["segments"]:
        assert 0 <= seg["start"] < seg["end"] <= 2.5 + 0.04


def test_bad_extension_rejected(service):
    status, payload = service.transcribe_upload("evil.exe", b"xx")
    assert status == 400 and "Unsupported file type" in payload["detail"]


def test_batch_captures_per_file_errors(service, wavs):
    status, payload = service.transcribe_batch(
        [("a.wav", _read(wavs["one"])), ("bad.wav", b"not a wav"),
         ("b.wav", _read(wavs["two_half"]))])
    assert status == 200
    r = payload["results"]
    assert [x["filename"] for x in r] == ["a.wav", "bad.wav", "b.wav"]
    assert r[0]["error"] is None and r[2]["error"] is None
    assert r[1]["error"] is not None and r[1]["text"] == ""
    assert r[0]["text"] == service.asr.transcribe(wavs["one"])


def _broken(paths, return_errors=False):
    raise RuntimeError("device fault")


def test_batched_forward_fault_falls_back_per_file(model_pt, wavs):
    """A fault in the batched forward costs no upload its text: each file
    is transcribed on its own, and the request answers 200 with each
    upload's text or error, as the JAX server does."""
    svc = _service(model_pt)
    svc.asr.transcribe_files = _broken
    status, payload = svc.transcribe_batch([("a.wav", _read(wavs["one"])),
                                            ("bad.wav", b"not a wav")])
    assert status == 200
    good, bad = payload["results"]
    assert good == {"filename": "a.wav", "text": svc.asr.transcribe(wavs["one"]), "error": None}
    assert bad["filename"] == "bad.wav" and bad["text"] == ""
    assert "audio format" in bad["error"]


def _without_temp_names(results):
    """The per-file errors name the upload's temporary file; each service
    draws its own."""
    return [dict(r, error=r["error"] and re.sub(r"\S+\.wav", "<upload>", r["error"]))
            for r in results]


def test_batched_forward_fault_gives_the_jax_servers_payload(model_pt, wavs, monkeypatch):
    """transcribe_files raises in both services and one upload is bad: the
    port and the JAX server (driven as tests/test_serve.py drives it) give
    the same status and results. Both serve the same .pt in fp32, where
    their texts agree (test_transcripts_and_logits_match_jax)."""
    import jax.numpy as jnp
    from inference import ASRInference as JaxASRInference
    from turkish_asr_tpu.serve import server as jax_server

    monkeypatch.setenv("ASR_MODEL_PATH", model_pt)
    jax_svc = jax_server.ASRService(jax_server.ServerConfig(), warmup=False)
    assert jax_svc.asr is not None
    jax_svc.asr = JaxASRInference(model_path=model_pt, compute_dtype=jnp.float32,
                                  data_parallel=False, use_pallas=False)
    port_svc = _service(model_pt)
    port_svc.asr.compute_dtype = torch.float32
    uploads = [("a.wav", _read(wavs["one"])), ("bad.wav", b"not a wav"),
               ("b.wav", _read(wavs["two_half"]))]
    answers = []
    for svc in (jax_svc, port_svc):
        svc.asr.transcribe_files = _broken
        status, payload = svc.transcribe_batch(uploads)
        answers.append((status, _without_temp_names(payload["results"])))
    assert answers[1] == answers[0]
    assert answers[0][0] == 200 and answers[0][1][1]["error"] is not None


def test_default_model_path_is_the_trainers_best_model(monkeypatch):
    monkeypatch.delenv("ASR_MODEL_PATH", raising=False)
    assert ServerConfig().MODEL_PATH == "./runs/best_model.pt"


def test_default_train_then_serve_answers_200(tmp_path, monkeypatch, wavs):
    """python -m turkish_asr_torch.main with its default checkpoint paths,
    then the server with its defaults, in one working directory: the
    server finds and serves the model the trainer wrote."""
    from turkish_asr_torch.main import main

    monkeypatch.delenv("ASR_MODEL_PATH", raising=False)
    monkeypatch.chdir(tmp_path)
    corpus = tmp_path / "corpus"
    corpus.mkdir()
    t = np.arange(SR // 2) / SR
    for i, word in enumerate(["merhaba", "evet", "bir", "iki", "üç", "dört"]):
        write_wav(str(corpus / f"s{i}.wav"),
                  (0.3 * np.sin(2 * np.pi * (180 + 90 * i) * t)).astype(np.float32), SR)
        (corpus / f"s{i}.txt").write_text(word, encoding="utf-8")
    main(["--data_path", str(corpus), "--val_split", "0.34", "--test_split", "0",
          "--d_model", "32", "--n_heads", "2", "--n_blocks", "2", "--batch_size", "2",
          "--epochs", "1", "--num_workers", "0", "--device", "cpu"])
    assert (tmp_path / "runs" / "best_model.pt").exists()
    svc = ASRService(warmup=False, device="cpu")
    assert svc.asr is not None
    status, payload = svc.transcribe_upload("a.wav", _read(wavs["one"]))
    assert status == 200 and isinstance(payload["text"], str)


def test_model_missing_503(tmp_path):
    svc = _service(str(tmp_path / "nope.pt"))
    assert svc.asr is None
    assert svc.transcribe_upload("a.wav", b"")[0] == 503
    assert svc.transcribe_batch([("a.wav", b"")])[0] == 503
    status, payload = svc.health()
    assert status == 200 and payload["model_loaded"] is False


def test_micro_batching_shares_one_forward(model_pt, wavs):
    svc = _service(model_pt, BATCH_WINDOW_MS=500.0, MAX_BATCH=3)
    calls = []
    inner = svc.asr.transcribe_files

    def counting(paths, return_errors=False):
        calls.append(len(paths))
        return inner(paths, return_errors=return_errors)

    svc.batcher.asr = type("Wrapped", (), {"transcribe_files": staticmethod(counting)})()
    content = _read(wavs["one"])
    results = [None] * 3

    def request(i):
        results[i] = svc.transcribe_upload("a.wav", content)

    threads = [threading.Thread(target=request, args=(i,)) for i in range(3)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
        assert not t.is_alive()
    want = svc.asr.transcribe(wavs["one"])
    assert [r[0] for r in results] == [200] * 3
    assert [r[1]["text"] for r in results] == [want] * 3
    assert calls == [3]


def _multipart(files):
    boundary = uuid.uuid4().hex
    body = b""
    for field, name, content in files:
        body += (f"--{boundary}\r\nContent-Disposition: form-data; name=\"{field}\"; "
                 f"filename=\"{name}\"\r\nContent-Type: application/octet-stream\r\n\r\n"
                 ).encode() + content + b"\r\n"
    return body + f"--{boundary}--\r\n".encode(), f"multipart/form-data; boundary={boundary}"


def test_parse_multipart_roundtrip():
    body, ctype = _multipart([("file", "x.wav", b"\x00\x01binary\r\n\xff")])
    assert parse_multipart(body, ctype) == [("x.wav", b"\x00\x01binary\r\n\xff")]


def test_http_round_trip(service, wavs):
    server = make_stdlib_server(service, "127.0.0.1", 0)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    base = f"http://127.0.0.1:{server.server_address[1]}"
    try:
        with urllib.request.urlopen(base + "/health", timeout=60) as r:
            assert json.loads(r.read())["model_loaded"] is True
        body, ctype = _multipart([("file", "a.wav", _read(wavs["one"]))])
        req = urllib.request.Request(base + "/transcribe?timestamps=1", data=body,
                                     headers={"Content-Type": ctype})
        with urllib.request.urlopen(req, timeout=120) as r:
            payload = json.loads(r.read())
        assert payload["text"] == service.asr.transcribe(wavs["one"])
        assert isinstance(payload["segments"], list)
        body, ctype = _multipart([("files", "a.wav", _read(wavs["one"])),
                                  ("files", "b.wav", _read(wavs["two_half"]))])
        req = urllib.request.Request(base + "/transcribe/batch", data=body,
                                     headers={"Content-Type": ctype})
        with urllib.request.urlopen(req, timeout=120) as r:
            results = json.loads(r.read())["results"]
        assert [x["error"] for x in results] == [None, None]
    finally:
        server.shutdown()
        server.server_close()
        thread.join(timeout=30)
    assert not thread.is_alive()
