"""HTTP serving for the port.

Counterpart of turkish_asr_tpu/serve/server.py, with the same env-var
configuration and endpoint surface as the reference API:

- GET  /health            -> {status, model_loaded, device}
- POST /transcribe        -> {text, duration_ms[, segments]}; 400 on a bad
  extension, 503 when the model is missing, 500 on a transcription error
  (``?timestamps=1`` adds word timings)
- POST /transcribe/batch  -> {results: [{filename, text, error}]}; one
  bucket-collated batched forward for all uploads. If that forward raises,
  each upload is transcribed on its own and carries its own error, as the
  JAX server does: the request still answers 200.

Transport: FastAPI + uvicorn when installed, else a stdlib
ThreadingHTTPServer on the same routes. The model is warmed at startup
with one dummy transcription, which also builds the CUDA kernels.
ASR_BATCH_WINDOW_MS > 0 turns on cross-request micro-batching.

Run: ``python -m turkish_asr_torch.serve.server`` (CUDA). The model path
defaults to ``./runs/best_model.pt``, the file that ``python -m
turkish_asr_torch.main`` writes with its defaults; ``ASR_MODEL_PATH``
names another ``.pt``, or a JAX ``.ckpt`` (e.g. the JAX trainer's
``best_model.ckpt``), which the port reads without jax.
"""

import json
import os
import re
import tempfile
import threading
import time
from urllib.parse import parse_qs

from turkish_asr_torch.utils.device import resolve_device
from turkish_asr_torch.utils.errors import TimestampsUnsupportedError

ALLOWED_EXTENSIONS = {".wav", ".mp3", ".flac", ".ogg", ".m4a"}


class MicroBatcher:
    """Cross-request dynamic batching for POST /transcribe.

    Concurrent requests collect for up to ``window_ms`` (or until
    ``max_batch`` arrive) and run through one bucket-collated batched
    forward (``ASRInference.transcribe_files``). Each request thread blocks
    until its slot is filled.
    """

    def __init__(self, asr, window_ms, max_batch=16):
        self.asr = asr
        self.window = window_ms / 1000.0
        self.max_batch = max_batch
        self._cond = threading.Condition()
        self._pending = []
        self._runner = threading.Thread(target=self._loop, daemon=True)
        self._runner.start()

    def submit(self, path, timeout=300.0):
        """Blocks until the batch holding this request completes.
        Returns (text, error or None)."""
        slot = {"path": path, "event": threading.Event(), "text": "", "error": None}
        with self._cond:
            self._pending.append(slot)
            self._cond.notify()
        if not slot["event"].wait(timeout):
            return "", "transcription timed out"
        return slot["text"], slot["error"]

    def _loop(self):
        while True:
            with self._cond:
                while not self._pending:
                    self._cond.wait()
                # Wait out the window on a deadline: every submit() wakes
                # the wait, and a single wait(window) would drain after the
                # first arrival.
                if self.window > 0:
                    deadline = time.monotonic() + self.window
                    while len(self._pending) < self.max_batch:
                        remaining = deadline - time.monotonic()
                        if remaining <= 0:
                            break
                        self._cond.wait(timeout=remaining)
                batch = self._pending[:self.max_batch]
                del self._pending[:len(batch)]
            try:
                texts, errors = self.asr.transcribe_files(
                    [s["path"] for s in batch], return_errors=True)
                for s, t, e in zip(batch, texts, errors):
                    s["text"], s["error"] = t, e
            except Exception as e:  # noqa: BLE001 — the whole batch fails
                for s in batch:
                    s["error"] = str(e)
            for s in batch:
                s["event"].set()


class ServerConfig:
    """Env-var server configuration: the JAX server's names and defaults.
    A ``.pt`` or ``.ckpt`` carries its own architecture (tensor shapes and
    stored config), so N_MEL_CHANNELS, D_MODEL and N_BLOCKS have no
    counterpart here; N_HEADS is used when the checkpoint stores none (a
    ``.ckpt``'s ``model_config`` holds it). USE_BEAM_SEARCH=true serves the
    beam of width BEAM_WIDTH, LM-fused with the ARPA at ASR_LM_PATH
    through ASR_LM_FUSION (auto/device/hash/host, the CLI's --lm_fusion),
    ASR_LM_WEIGHT and ASR_WORD_BONUS. The model path defaults to the port
    trainer's ``best_model.pt`` (the JAX server's default names its own
    trainer's ``best_model.ckpt``)."""

    def __init__(self):
        self.MODEL_PATH = os.environ.get("ASR_MODEL_PATH", "./runs/best_model.pt")
        self.N_HEADS = int(os.environ.get("N_HEADS", "4"))
        self.USE_BEAM_SEARCH = os.environ.get("USE_BEAM_SEARCH", "false").lower() == "true"
        self.BEAM_WIDTH = int(os.environ.get("BEAM_WIDTH", "10"))
        self.LM_PATH = os.environ.get("ASR_LM_PATH") or None
        # Normalized and checked like the CLI's choices: a typo would miss
        # every fusion branch and serve the sequential host beam.
        self.LM_FUSION = os.environ.get("ASR_LM_FUSION", "auto").strip().lower()
        if self.LM_FUSION not in ("auto", "device", "hash", "host"):
            raise ValueError(f"ASR_LM_FUSION={self.LM_FUSION!r} — must be one of "
                             "auto/device/hash/host (the CLI's --lm_fusion choices)")
        self.LM_WEIGHT = float(os.environ.get("ASR_LM_WEIGHT", "0.3"))
        self.WORD_BONUS = float(os.environ.get("ASR_WORD_BONUS", "0.5"))
        if self.LM_PATH and not self.USE_BEAM_SEARCH:
            print("WARNING: ASR_LM_PATH is set but USE_BEAM_SEARCH is not 'true' — "
                  "the LM is IGNORED on the greedy path. Set USE_BEAM_SEARCH=true to "
                  "serve LM-fused beam decoding.")
        self.TOKENIZER_PATH = os.environ.get("ASR_TOKENIZER_PATH") or None
        self.HOST = os.environ.get("ASR_HOST", "0.0.0.0")
        self.PORT = int(os.environ.get("ASR_PORT", "8000"))
        self.BATCH_WINDOW_MS = float(os.environ.get("ASR_BATCH_WINDOW_MS", "0"))
        self.MAX_BATCH = int(os.environ.get("ASR_MAX_BATCH", "16"))


class ASRService:
    """Transport-independent service core shared by both servers.

    ``device`` is used as given: "cuda" raises when CUDA is absent. A model
    file that fails to load leaves the service up with ``model_loaded``
    false (503 on the transcription routes), as the reference does; a
    failed warmup raises.
    """

    def __init__(self, config=None, warmup=True, device="cuda"):
        self.config = config or ServerConfig()
        self.device = resolve_device(device)
        self.asr = None
        self.batcher = None
        if not os.path.exists(self.config.MODEL_PATH):
            print(f"Warning: Model not found at {self.config.MODEL_PATH}")
            return
        from turkish_asr_torch.inference import ASRInference
        try:
            cfg = self.config
            self.asr = ASRInference(
                model_path=cfg.MODEL_PATH, n_heads=cfg.N_HEADS,
                use_beam_search=cfg.USE_BEAM_SEARCH, beam_width=cfg.BEAM_WIDTH,
                lm_path=cfg.LM_PATH, lm_fusion=cfg.LM_FUSION, lm_weight=cfg.LM_WEIGHT,
                word_bonus=cfg.WORD_BONUS, tokenizer_path=cfg.TOKENIZER_PATH,
                device=self.device)
        except Exception as e:  # noqa: BLE001 — serve anyway, 503 (reference)
            print(f"Failed to load model: {e}")
            return
        print("Model loaded successfully!")
        if self.config.BATCH_WINDOW_MS > 0:
            self.batcher = MicroBatcher(self.asr, self.config.BATCH_WINDOW_MS,
                                        self.config.MAX_BATCH)
            print(f"Micro-batching: window {self.config.BATCH_WINDOW_MS} ms, "
                  f"max batch {self.config.MAX_BATCH}")
        if warmup:
            self._warmup()

    def _warmup(self):
        """One dummy transcription: builds the kernels and warms the caches."""
        import numpy as np
        from turkish_asr_torch.audio.wavio import write_wav
        with tempfile.NamedTemporaryFile(suffix=".wav", delete=False) as tmp:
            write_wav(tmp.name, np.zeros(16000, dtype=np.float32), 16000)
            path = tmp.name
        try:
            self.asr.transcribe(path)
            print("Warmup complete.")
        finally:
            os.unlink(path)

    # -- handlers returning (status_code, payload dict) --------------------
    def health(self):
        return 200, {"status": "healthy",
                     "model_loaded": self.asr is not None,
                     "device": self.device.type if self.asr is not None else "N/A"}

    def transcribe_upload(self, filename, content, timestamps=False):
        if self.asr is None:
            return 503, {"detail": "Model not loaded"}
        ext = os.path.splitext(filename or "")[1].lower()
        if ext not in ALLOWED_EXTENSIONS:
            return 400, {"detail": f"Unsupported file type. Allowed: {ALLOWED_EXTENSIONS}"}
        from turkish_asr_torch.audio.wavio import supported_formats
        if ext not in supported_formats():
            return 400, {"detail": f"{ext} decode unavailable in this deployment "
                                   f"(install ffmpeg; wav/flac are built in)"}
        try:
            with tempfile.NamedTemporaryFile(suffix=ext, delete=False) as tmp:
                tmp.write(content)
                tmp_path = tmp.name
        except OSError as e:
            return 500, {"detail": f"Failed to save file: {e}"}
        try:
            start = time.time()
            segments = None
            if timestamps:
                # word timings need the per-request path (the batcher
                # decodes text only)
                out = self.asr.transcribe(tmp_path, timestamps=True)
                text, segments = out["text"], out["segments"]
            elif self.batcher is not None:
                text, err = self.batcher.submit(tmp_path)
                if err is not None:
                    return 500, {"detail": f"Transcription failed: {err}"}
            else:
                text = self.asr.transcribe(tmp_path)
            body = {"text": text, "duration_ms": (time.time() - start) * 1000}
            if segments is not None:
                body["segments"] = segments
            return 200, body
        except Exception as e:  # noqa: BLE001 — request boundary
            from turkish_asr_torch.audio.wavio import UnsupportedFormatError
            if isinstance(e, (UnsupportedFormatError, TimestampsUnsupportedError)):
                return 400, {"detail": str(e)}
            return 500, {"detail": f"Transcription failed: {e}"}
        finally:
            if os.path.exists(tmp_path):
                os.unlink(tmp_path)

    def transcribe_batch(self, uploads):
        """All uploads through one batched bucket-collated forward
        (``transcribe_files``), with per-file load/decode errors in the
        results. If the batched forward itself raises, each file is
        transcribed on its own (``transcribe``), so one fault does not
        lose every upload's text: 200 with each upload's text or error."""
        if self.asr is None:
            return 503, {"detail": "Model not loaded"}
        results = [None] * len(uploads)
        paths, slots = [], []
        try:
            for i, (filename, content) in enumerate(uploads):
                ext = os.path.splitext(filename or "")[1].lower() or ".wav"
                try:
                    with tempfile.NamedTemporaryFile(suffix=ext, delete=False) as tmp:
                        tmp.write(content)
                    paths.append(tmp.name)
                    slots.append(i)
                except OSError as e:
                    results[i] = {"filename": filename, "text": "", "error": str(e)}
            if paths:
                try:
                    texts, errors = self.asr.transcribe_files(paths, return_errors=True)
                except Exception as e:  # noqa: BLE001 — fall back to one file at a time
                    print(f"Batched transcription failed ({e}); falling back to per-file")
                    texts, errors = [], []
                    for p in paths:
                        try:
                            texts.append(self.asr.transcribe(p))
                            errors.append(None)
                        except Exception as file_error:  # noqa: BLE001 — this upload's error
                            texts.append("")
                            errors.append(str(file_error))
                for slot, text, err in zip(slots, texts, errors):
                    results[slot] = {"filename": uploads[slot][0], "text": text,
                                     "error": err}
        finally:
            for p in paths:
                if os.path.exists(p):
                    os.unlink(p)
        return 200, {"results": results}


# ---------------------------------------------------------------------------
# Multipart parsing (stdlib-only)
# ---------------------------------------------------------------------------

def parse_multipart(body, content_type):
    """Minimal multipart/form-data parser -> [(filename, bytes), ...]."""
    m = re.search(r'boundary="?([^";]+)"?', content_type or "")
    if not m:
        return []
    boundary = m.group(1).encode()
    uploads = []
    for part in body.split(b"--" + boundary):
        # Trim exactly one protocol CRLF each side: binary uploads may end
        # in 0x0D / 0x0A bytes of their own.
        if part.startswith(b"\r\n"):
            part = part[2:]
        if part.endswith(b"\r\n"):
            part = part[:-2]
        if not part or part == b"--" or b"\r\n\r\n" not in part:
            continue
        header_blob, content = part.split(b"\r\n\r\n", 1)
        headers = header_blob.decode("utf-8", errors="replace")
        fm = re.search(r'filename="([^"]*)"', headers)
        if fm is not None:
            uploads.append((fm.group(1), content))
    return uploads


# ---------------------------------------------------------------------------
# Transports
# ---------------------------------------------------------------------------

def build_fastapi_app(service):
    """FastAPI app with the reference's endpoint surface."""
    from typing import List

    from fastapi import FastAPI, File, HTTPException, UploadFile
    from fastapi.concurrency import run_in_threadpool

    app = FastAPI(title="Turkish ASR API",
                  description="Automatic Speech Recognition API for Turkish language",
                  version="1.0.0")

    @app.get("/health")
    async def health_check():
        return service.health()[1]

    # Blocking service calls run in the threadpool, so concurrent requests
    # overlap (and the MicroBatcher has something to batch).
    @app.post("/transcribe")
    async def transcribe_audio(file: UploadFile = File(...), timestamps: bool = False):
        content = await file.read()
        status, payload = await run_in_threadpool(
            service.transcribe_upload, file.filename, content, timestamps)
        if status != 200:
            raise HTTPException(status_code=status, detail=payload["detail"])
        return payload

    @app.post("/transcribe/batch")
    async def transcribe_batch(files: List[UploadFile] = File(...)):
        uploads = [(f.filename, await f.read()) for f in files]
        status, payload = await run_in_threadpool(service.transcribe_batch, uploads)
        if status != 200:
            raise HTTPException(status_code=status, detail=payload["detail"])
        return payload

    return app


def make_stdlib_server(service, host, port):
    """A stdlib ThreadingHTTPServer on the service's routes, not yet
    serving: call ``serve_forever()`` (in a thread if need be), then
    ``shutdown()`` and ``server_close()``. Port 0 picks a free port
    (``server.server_address``)."""
    from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

    class Handler(BaseHTTPRequestHandler):
        def _send(self, status, payload):
            blob = json.dumps(payload).encode()
            self.send_response(status)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(blob)))
            self.end_headers()
            self.wfile.write(blob)

        def do_GET(self):
            if self.path == "/health":
                self._send(*service.health())
            else:
                self._send(404, {"detail": "Not found"})

        def do_POST(self):
            length = int(self.headers.get("Content-Length", "0"))
            body = self.rfile.read(length)
            uploads = parse_multipart(body, self.headers.get("Content-Type"))
            path, _, query = self.path.partition("?")
            if path == "/transcribe":
                if not uploads:
                    self._send(400, {"detail": "No file uploaded"})
                    return
                raw = parse_qs(query).get("timestamps", ["false"])[-1]
                ts = raw.lower() in ("1", "true", "yes", "on")
                self._send(*service.transcribe_upload(*uploads[0], timestamps=ts))
            elif path == "/transcribe/batch":
                self._send(*service.transcribe_batch(uploads))
            else:
                self._send(404, {"detail": "Not found"})

        def log_message(self, fmt, *args):  # quiet
            pass

    return ThreadingHTTPServer((host, port), Handler)


def run_stdlib_server(service, host, port):
    """Serve the routes over the stdlib server until interrupted."""
    server = make_stdlib_server(service, host, port)
    print(f"Serving (stdlib HTTP) on {host}:{server.server_address[1]}")
    try:
        server.serve_forever()
    finally:
        server.server_close()


def run_server(config=None, device="cuda"):
    config = config or ServerConfig()
    service = ASRService(config, device=device)
    try:
        import uvicorn
    except ImportError:
        run_stdlib_server(service, config.HOST, config.PORT)
        return
    uvicorn.run(build_fastapi_app(service), host=config.HOST, port=config.PORT)


if __name__ == "__main__":
    run_server()
