"""The port's beam-search inference, service and CLI against the JAX package's.

One ``.pt`` written from a JAX ``init_model`` (d_model 64, 4 heads, 2
blocks, 56 classes) runs in fp32 on the CPU through both packages:
``ASRInference`` with beam search and each LM-fusion route (no LM: the
host beam; ``auto``: the trie tables of a word ARPA through the char
tokenizer; ``hash``; ``host``), the service with USE_BEAM_SEARCH=true,
and ``python -m turkish_asr_torch.inference`` against ``inference.py``'s
``main``, both called in-process with ``sys.argv`` patched and their
compute dtype patched to fp32 (the JAX CLI has no dtype flag). Texts,
payloads and printed lines must be identical.
"""

import functools
import os
import sys

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import inference as jax_inference  # noqa: E402
from turkish_asr_tpu.models.conformer import ModelConfig as JaxConfig  # noqa: E402
from turkish_asr_tpu.models.conformer import init_model as jax_init  # noqa: E402
from turkish_asr_tpu.serve import server as jax_server  # noqa: E402
from turkish_asr_tpu.utils.torch_export import export_torch_checkpoint  # noqa: E402
from turkish_asr_torch import inference as port_inference  # noqa: E402
from turkish_asr_torch.audio.wavio import write_wav  # noqa: E402
from turkish_asr_torch.decode.beam import CTCBeamDecoder  # noqa: E402
from turkish_asr_torch.decode.factory import DeviceBeamDecoder  # noqa: E402
from turkish_asr_torch.decode.lm import KenLMModel, NGramLanguageModel  # noqa: E402
from turkish_asr_torch.serve import server as port_server  # noqa: E402
from turkish_asr_torch.utils.errors import TimestampsUnsupportedError  # noqa: E402
from beam_fixtures import WORD_ARPA  # noqa: E402

SR = 16000
JaxASR = functools.partial(jax_inference.ASRInference, compute_dtype=jnp.float32,
                           use_pallas=False, data_parallel=False)
PortASR = functools.partial(port_inference.ASRInference, compute_dtype=torch.float32,
                            device="cpu")


@pytest.fixture(scope="module")
def model_pt(tmp_path_factory):
    cfg = JaxConfig(n_mels=80, d_model=64, n_heads=4, n_blocks=2, n_classes=56, dropout=0.0)
    params, state = jax_init(jax.random.PRNGKey(1), cfg)
    path = str(tmp_path_factory.mktemp("model") / "model.pt")
    export_torch_checkpoint(path, params, state, cfg)
    return path


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    """Three tones in the 2 s bucket, two with reference transcripts,
    and the word ARPA."""
    d = tmp_path_factory.mktemp("corpus")
    rng = np.random.default_rng(0)
    for i, seconds in enumerate((1.5, 1.75, 2.0)):
        t = np.arange(int(seconds * SR)) / SR
        x = 0.3 * np.sin(2 * np.pi * (220 + 40 * np.floor(t * (3 + i))) * t)
        write_wav(str(d / f"s{i}.wav"),
                  (x + 0.05 * rng.standard_normal(t.shape)).astype(np.float32), SR)
    (d / "s0.txt").write_text("bir iki", encoding="utf-8")
    (d / "s1.txt").write_text("Ev, o!", encoding="utf-8")
    lm = tmp_path_factory.mktemp("lm") / "words.arpa"
    lm.write_text(WORD_ARPA)
    return {"dir": str(d), "files": [str(d / f"s{i}.wav") for i in range(3)], "lm": str(lm)}


ROUTES = {"none": (None, "auto"), "auto": ("lm", "auto"), "hash": ("lm", "hash"),
          "host": ("lm", "host")}


@pytest.mark.parametrize("route", list(ROUTES))
def test_beam_transcripts_match_jax(model_pt, corpus, route, capsys):
    lm_key, fusion = ROUTES[route]
    kw = dict(use_beam_search=True, beam_width=8, lm_fusion=fusion,
              lm_path=corpus["lm"] if lm_key else None)
    want_asr = JaxASR(model_path=model_pt, **kw)
    want_out = capsys.readouterr().out
    port = PortASR(model_pt, **kw)
    assert capsys.readouterr().out == want_out
    files = corpus["files"]
    want = want_asr.transcribe_files(files, batch_size=4)
    assert port.transcribe_files(files, batch_size=4) == want
    assert [port.transcribe(f) for f in files] == [want_asr.transcribe(f) for f in files]
    assert any(want)
    if route in ("none", "host"):
        assert isinstance(port.decoder, CTCBeamDecoder)
        assert isinstance(port.decoder.lm, NGramLanguageModel if route == "none" else KenLMModel)
    else:
        assert isinstance(port.decoder, DeviceBeamDecoder)
        assert f"lm_{'trie' if route == 'auto' else 'hash'}" in port.decoder._lm_kwargs


def test_missing_lm_raises(model_pt, tmp_path):
    with pytest.raises(FileNotFoundError, match="LM file not found"):
        PortASR(model_pt, use_beam_search=True, lm_path=str(tmp_path / "nope.arpa"))


def test_timestamps_under_beam_refused_before_the_forward(model_pt, corpus):
    asr = PortASR(model_pt, use_beam_search=True, beam_width=4)

    def no_forward(*args, **kwargs):
        raise AssertionError("the forward ran")

    asr._logits = no_forward
    with pytest.raises(TimestampsUnsupportedError):
        asr.transcribe(corpus["files"][0], timestamps=True)


def test_bad_lm_fusion_env_raises(monkeypatch):
    monkeypatch.setenv("ASR_LM_FUSION", "gpu")
    with pytest.raises(ValueError, match="ASR_LM_FUSION"):
        port_server.ServerConfig()
    monkeypatch.setenv("ASR_LM_FUSION", " Hash ")
    assert port_server.ServerConfig().LM_FUSION == "hash"


def test_beam_service_gives_the_jax_servers_payload(model_pt, corpus, monkeypatch):
    """USE_BEAM_SEARCH=true with the ARPA: /transcribe, /transcribe/batch
    and a timestamps request (400) answer as the JAX server answers."""
    for k, v in {"ASR_MODEL_PATH": model_pt, "USE_BEAM_SEARCH": "true", "BEAM_WIDTH": "8",
                 "ASR_LM_PATH": corpus["lm"], "ASR_LM_FUSION": "auto", "ASR_LM_WEIGHT": "0.5",
                 "ASR_WORD_BONUS": "0.25"}.items():
        monkeypatch.setenv(k, v)
    jax_svc = jax_server.ASRService(jax_server.ServerConfig(), warmup=False)
    jax_svc.asr = JaxASR(model_path=model_pt, use_beam_search=True, beam_width=8,
                         lm_path=corpus["lm"], lm_weight=0.5, word_bonus=0.25)
    port_svc = port_server.ASRService(port_server.ServerConfig(), warmup=False, device="cpu")
    assert isinstance(port_svc.asr.decoder, DeviceBeamDecoder)
    assert port_svc.asr.decoder.beam_width == 8 and port_svc.asr.decoder.word_bonus == 0.25
    port_svc.asr.compute_dtype = torch.float32
    uploads = []
    for f in corpus["files"]:
        with open(f, "rb") as fh:
            uploads.append((os.path.basename(f), fh.read()))
    answers = []
    for svc in (jax_svc, port_svc):
        status, single = svc.transcribe_upload(*uploads[1])
        ts_status, ts = svc.transcribe_upload(*uploads[1], timestamps=True)
        batch = svc.transcribe_batch(uploads)
        answers.append((status, single["text"], ts_status, ts, batch))
    assert answers[1] == answers[0]
    assert answers[0][0] == 200 and answers[0][2] == 400
    assert answers[0][4][1]["results"][1]["text"] == answers[0][1]


CLI_CASES = {
    "file": ["--audio", "{f0}"],
    "dir_evaluate": ["--audio", "{dir}", "--evaluate"],
    "timestamps": ["--audio", "{f1}", "--timestamps", "--evaluate"],
    "beam_lm": ["--audio", "{dir}", "--beam_search", "--beam_width", "8", "--lm", "{lm}",
                "--evaluate"],
}


@pytest.mark.parametrize("case", list(CLI_CASES))
def test_cli_prints_what_the_jax_cli_prints(model_pt, corpus, case, capsys, monkeypatch):
    args = [a.format(f0=corpus["files"][0], f1=corpus["files"][1], dir=corpus["dir"],
                     lm=corpus["lm"]) for a in CLI_CASES[case]] + ["--model", model_pt]
    monkeypatch.setattr(jax_inference, "ASRInference", JaxASR)
    monkeypatch.setattr(port_inference, "ASRInference", PortASR)
    outputs = []
    for main, extra in ((jax_inference.main, []), (port_inference.main, ["--device", "cpu"])):
        monkeypatch.setattr(sys, "argv", ["inference.py"] + args + extra)
        main()
        outputs.append(capsys.readouterr().out)
    assert outputs[1] == outputs[0]
    assert "Transcription" in outputs[0] or "Found 3 audio files" in outputs[0]
    if "--evaluate" in args:
        assert "WER:" in outputs[0]


def test_cli_refuses_timestamps_under_beam(model_pt, corpus, monkeypatch):
    monkeypatch.setattr(port_inference, "ASRInference", PortASR)
    monkeypatch.setattr(sys, "argv", ["inference.py", "--audio", corpus["dir"], "--model",
                                      model_pt, "--beam_search", "--timestamps",
                                      "--device", "cpu"])
    with pytest.raises(TimestampsUnsupportedError):
        port_inference.main()


def test_cli_defaults_to_the_card(model_pt, corpus, monkeypatch):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    monkeypatch.setattr(sys, "argv", ["inference.py", "--audio", corpus["files"][0], "--model",
                                      model_pt, "--beam_search"])
    with pytest.raises(RuntimeError, match="cuda"):
        port_inference.main()


def test_trusted_checkpoint_unpickles_in_full(model_pt, tmp_path):
    """A .pt holding a non-tensor object loads only with trust_checkpoint
    (the CLI's --trust_checkpoint), as the JAX package's reader does."""
    blob = torch.load(model_pt, map_location="cpu", weights_only=True)
    blob["extra"] = functools.partial(print)  # not loadable with weights_only
    path = str(tmp_path / "pickled.pt")
    torch.save(blob, path)
    with pytest.raises(RuntimeError, match="--trust_checkpoint"):
        PortASR(path)
    asr = PortASR(path, trust_checkpoint=True)
    assert asr.cfg.n_blocks == 2
