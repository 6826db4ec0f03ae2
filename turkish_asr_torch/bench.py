"""The port's benchmark: bench.py's five workload configurations and its
headline, run through turkish_asr_torch on a CUDA card.

    python -m turkish_asr_torch.bench [--device cuda]

Prints one JSON line per configuration as it completes, then the HEADLINE
line last, with bench.py's metric names, units and fields, plus ``device``
(``torch.cuda.get_device_name``) and ``power_limit_w`` (nvidia-smi's
``power.limit`` of that same card, found by its UUID, read once) on every
line (both null on the CPU):

    {"metric": "rtfx_greedy_batch", "value": N,
     "unit": "audio_sec/sec/chip", "vs_baseline": R, "mfu": M, ...}

Configs (BASELINE.json:6-12):
  1 rtfx_greedy_single      single 16 kHz wav greedy inference (B=1)
  2 train_step_ms_b8        CTC training step, batch 8, no augmentation
  3 train_step_ms_b32_aug   augmented training step, batch 32, accum 4
  4 rtfx_beam16_arpa        batched beam-16 with ARPA LM fusion on device
    rtfx_beam16_arpa_100k   the same with a 100k-word order-4 ARPA (hash)
  5 rtfx_longform_conformer_l  Conformer-L (512d/8h/16blk), B=16 x 64 s
    train_step_ms_conformer_l  its training step, B=4 x 64 s
  H rtfx_greedy_batch       batched greedy (headline; B=128 x 8 s)

A configuration that raises prints an ``error_<function>`` line (value -1,
unit "error") and the run goes on, as bench.py does.

Timing: eager PyTorch. One warm-up call (it builds the CUDA kernels and
runs the first launches), then 3 trials, each ``iters`` back-to-back
pipeline calls under ``torch.inference_mode()`` between the host clock and
``torch.cuda.synchronize()``; the median trial over ``iters``. No op is
added inside the timed loop: eager calls are not deduplicated, so
bench.py's chaining of one iteration's output into the next is not needed.
Training configurations time ``Trainer.train_step`` as it stands, its
per-step host reads of the loss and the skip flag included.

The numbers are not comparable with bench.py's (BENCH_r0*.json, a TPU):
there each figure is ITERS calls inside one jitted ``lax.scan``, a single
dispatch; here the host launches every kernel of every call, and that
launch cost is part of what a user of the port pays.

MFU: bench.py's analytic forward FLOPs (``model_forward_flops``, its
definition unchanged) over elapsed time, against the card's bf16 dense
peak from ``PEAK_FLOPS`` (NVIDIA's data sheets), keyed by the card's name;
an unknown card gives ``mfu: null``.

vs_baseline: the headline over the stock torch.nn CPU proxy cached in the
repo's ``baseline_measured.json`` (read, never written; measured again
here, and not saved, when the file is absent).

Kernel-off figures (config 5) run the attention core through its plain
version (``attn_kernel=False``: ``ops.flash_attention_plain``), the
counterpart of bench.py's ``attn_kernel=None`` einsum core.

``run(device, cap)`` caps every configuration's timed iterations and
steps, and the host beam's utterances and trials, at ``cap`` (chip_smoke.py's
bench phase); shapes and widths are unchanged.

``host_peak_rss_gb`` (config 4 at 100k words) is the process's peak RSS
over the ARPA's generation, parse and hash build alone, sampled every
10 ms by a thread from ``/proc/self/statm``: the process's resident
memory before the generation plus what the build adds, not the earlier
configurations' training peak (bench.py's ``ru_maxrss`` holds both).
Null where ``/proc/self/statm`` cannot be read (not Linux).
"""

import argparse
import contextlib
import functools
import json
import os
import statistics
import subprocess
import tempfile
import threading
import time

import numpy as np
import torch

from turkish_asr_torch.audio.features import log_mel_spectrogram
from turkish_asr_torch.data.tokenizer import TurkishTokenizer
from turkish_asr_torch.decode.beam import CTCBeamDecoder
from turkish_asr_torch.decode.greedy import greedy_collapse_batch
from turkish_asr_torch.decode.lm import (
    ArpaLanguageModel, build_arpa_fusion_tables, build_hash_fusion_tables,
    build_trie_fusion_tables)
from turkish_asr_torch.models.conformer import ModelConfig, init_model
from turkish_asr_torch.ops.beam_search import ctc_beam_search, prepare_lm
from turkish_asr_torch.scripts.synthetic_arpa import (
    PRODUCTION, synthetic_token_arpa, synthetic_word_arpa)
from turkish_asr_torch.train.optim import make_optimizer
from turkish_asr_torch.train.trainer import Trainer
from turkish_asr_torch.utils.config import get_config
from turkish_asr_torch.utils.device import resolve_device
from turkish_asr_torch.utils.logger import get_logger

BATCH = 128          # bench.py's headline batch
SECONDS = 8.0
SR = 16000
ITERS = 10
BASELINE_BATCH = 16  # torch-CPU proxy saturates its threads at small batch
BASELINE_CACHE = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                              "baseline_measured.json")
CONFORMER_L = dict(d_model=512, n_heads=8, n_blocks=16)
LONGFORM = (16, 64.0)        # (B, seconds) of config 5's forward: T' = 1601
LONGFORM_TRAIN = (4, 64.0)   # and of its training step
ARPA_100K = PRODUCTION       # config 4's production-scale ARPA
HASH_KEYS = ("keys", "vals", "pnext", "wq", "tok_kind", "qwid", "start_ctx", "unk_prob",
             "uniq_q", "qcol")
TABLE_KEYS = ("keys", "vals", "pnext", "wq", "tok_kind", "qwid")

# bench.py's fields of each line beyond metric, value and unit (as its
# lines in BENCH_r05.json hold them); every line here also carries device
# and power_limit_w.
FIELDS = {
    "rtfx_greedy_single": ("config", "latency_ms"),
    "train_step_ms_b8": ("config", "eval_step_ms", "wer", "cer", "audio_sec_per_sec", "mfu",
                         "anatomy"),
    "train_step_ms_b32_aug": ("config", "accumulation_steps", "audio_sec_per_sec", "mfu"),
    "rtfx_beam16_arpa": ("config", "lm_fusion", "word_states", "trie_nodes", "word_table_rtfx",
                         "host_beam_rtfx", "vs_host_beam"),
    "rtfx_beam16_arpa_100k": ("config", "lm_fusion", "n_ngrams", "n_words", "trie_nodes",
                              "table_slots", "device_tables_mb", "arpa_gen_s", "arpa_parse_s",
                              "tables_build_s", "host_peak_rss_gb"),
    "rtfx_longform_conformer_l": ("config", "kernel_off_rtfx", "flash_kernel_speedup", "mfu"),
    "train_step_ms_conformer_l": ("batch", "audio_seconds", "audio_sec_per_sec", "kernel_off_ms",
                                  "flash_kernel_speedup", "mfu"),
    "rtfx_greedy_batch": ("vs_baseline", "mfu", "device"),
}

# bf16 dense tensor-core peak (FLOP/s) by torch.cuda.get_device_name(),
# from NVIDIA's H100 data sheet (SXM, PCIe, NVL).
PEAK_FLOPS = {
    "NVIDIA H100 80GB HBM3": 989e12,
    "NVIDIA H100 PCIe": 756e12,
    "NVIDIA H100 NVL": 835e12,
}


@functools.lru_cache(maxsize=None)
def _card(device):
    """(name, power limit in W) of a CUDA ``device``; (None, None) on the
    CPU. The power limit is nvidia-smi's for the card whose UUID is the
    device's (so CUDA_VISIBLE_DEVICES and other cards on the host do not
    mix in), read once; None where nvidia-smi does not list that card."""
    dev = torch.device(device)
    if dev.type != "cuda":
        return None, None
    name = torch.cuda.get_device_name(dev)
    uuid = f"GPU-{torch.cuda.get_device_properties(dev).uuid}"
    try:
        smi = subprocess.run(["nvidia-smi", "--query-gpu=uuid,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=60, check=True)
        limits = dict(line.split(", ", 1) for line in smi.stdout.splitlines() if ", " in line)
        watts = float(limits[uuid].split()[0])
    except (OSError, subprocess.SubprocessError, KeyError, ValueError):
        watts = None
    return name, watts


def _emit(metric, value, unit, device, **extra):
    line = {"metric": metric, "value": round(value, 2), "unit": unit}
    line.update(extra)
    line["device"], line["power_limit_w"] = _card(str(device))
    print(json.dumps(line), flush=True)
    return line


def _peak_flops(device):
    """(bf16 peak FLOP/s or None, the card's name or None)."""
    name = _card(str(device))[0]
    return PEAK_FLOPS.get(name), name


def _rss_bytes():
    with open("/proc/self/statm") as f:
        return int(f.read().split()[1]) * os.sysconf("SC_PAGE_SIZE")


@contextlib.contextmanager
def _peak_rss(interval=0.01):
    """Yields a dict whose ``gb`` is, after the block, the process's peak
    resident memory over the block in GB, sampled every ``interval`` s by
    a thread; None where /proc/self/statm cannot be read."""
    out = {"gb": None}
    try:
        peak = [_rss_bytes()]
    except OSError:
        yield out
        return
    done = threading.Event()

    def sample():
        while not done.wait(interval):
            peak[0] = max(peak[0], _rss_bytes())

    sampler = threading.Thread(target=sample, daemon=True)
    sampler.start()
    try:
        yield out
    finally:
        done.set()
        sampler.join()
        out["gb"] = max(peak[0], _rss_bytes()) / 1e9


def _cap(n, cap):
    return n if cap is None else max(1, min(n, cap))


def _flagship_cfg(n_classes=55, **kw):
    """Copied from __graft_entry__._flagship_cfg (:15-20), body unchanged
    but for the port's ModelConfig: 80 mel, d_model 256, 4 heads, 8 blocks,
    55 classes, dropout 0.1."""
    base = dict(n_mels=80, d_model=256, n_heads=4, n_blocks=8,
                n_classes=n_classes, dropout=0.1)
    base.update(kw)
    return ModelConfig(**base)


def model_forward_flops(cfg, seconds):
    """Analytic matmul FLOPs for one utterance forward (2*M*N*K terms).

    Copied from bench.py::model_forward_flops (:73-99), body unchanged."""
    T = int(1 + seconds * SR / 160)      # mel frames
    F, d, L = cfg.n_mels, cfg.d_model, cfg.n_blocks
    T2, T4 = T // 2, T // 4
    F2, F4 = F // 2, F // 4
    dh = d // cfg.n_heads
    fl = 0
    # mel front-end: frames (T, n_fft) x DFT (n_fft, 2*bins) + mel proj
    n_fft, n_bins = 400, 201
    fl += 2 * T * n_fft * 2 * n_bins + 2 * T * n_bins * F
    # subsample convs + input proj
    fl += 2 * T2 * F2 * 9 * cfg.d_model            # conv1 (C_in=1)
    fl += 2 * T4 * F4 * 9 * d * d                  # conv2
    fl += 2 * T4 * (F4 * d) * d                    # input projection
    # conformer blocks
    per_ff = 2 * (T4 * d * 8 * d) + 2 * (T4 * 4 * d * d)   # SwiGLU in+out
    attn = (2 * T4 * d * d                      # q proj
            + 2 * 2 * T4 * d * dh               # k/v proj (MQA single head)
            + 2 * 2 * T4 * T4 * d               # scores + context
            + 2 * T4 * d * d)                   # out proj
    conv = (2 * T4 * d * 2 * d                  # pw1
            + 2 * T4 * 31 * d                   # depthwise k=31
            + 2 * T4 * d * d)                   # pw2
    fl += L * (2 * per_ff + attn + conv)
    fl += 2 * T4 * d * cfg.n_classes            # classifier head
    return fl


def _sync(device):
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def _timed(pipeline, waveforms, wav_lengths, iters, device):
    """Median seconds a pipeline call: one warm-up call, then 3 trials of
    ``iters`` back-to-back calls, host clock to ``torch.cuda.synchronize``."""
    with torch.inference_mode():
        pipeline(waveforms, wav_lengths)
        _sync(device)
        trials = []
        for _ in range(3):
            start = time.perf_counter()
            for _ in range(iters):
                pipeline(waveforms, wav_lengths)
            _sync(device)
            trials.append(time.perf_counter() - start)
    return statistics.median(trials) / iters


def _logits(cfg, model, waveforms, wav_lengths, compute_dtype=torch.bfloat16,
            attn_kernel=True):
    """log-mel -> the model in eval: (logits (B, T', V) fp32, T' lengths)."""
    feats, frame_lengths = log_mel_spectrogram(waveforms, wav_lengths, n_mels=cfg.n_mels)
    logits = model(feats, frame_lengths, compute_dtype, attn_kernel=attn_kernel)
    return logits, frame_lengths // 4


def _lm_kwargs(device, start=0, **tables):
    """ctc_beam_search's fusion keywords for one of ``lm_tables``,
    ``lm_trie``, ``lm_hash``, with the tables made device tensors once
    (``prepare_lm``), as bench.py passes them to its jit as arguments."""
    mode, lm = prepare_lm(device, **tables)
    if mode is None:
        return {}
    if mode == "tables":
        lm = (lm["score"], lm["next"])
    return {f"lm_{mode}": lm, "lm_start_state": int(start)}


def _make_pipeline(cfg, model, decode="greedy", lm_kwargs=None, beam_width=16,
                   attn_kernel=True, compute_dtype=torch.bfloat16):
    """bench.py::_make_pipeline (:138-181): log-mel -> the model in eval
    (bf16) -> greedy collapse, or log_softmax in fp32 -> the W=16 prefix
    beam with ``lm_kwargs``'s fusion. Returns the device tensors (ids,
    counts); nothing is read on the host."""
    def pipeline(waveforms, wav_lengths):
        logits, out_lengths = _logits(cfg, model, waveforms, wav_lengths, compute_dtype,
                                      attn_kernel)
        if decode == "greedy":
            return greedy_collapse_batch(logits, out_lengths, blank_id=0)
        lp = torch.log_softmax(logits.float(), -1)
        return ctc_beam_search(lp, out_lengths, beam_width=beam_width, blank_id=0,
                               max_prefix_len=min(lp.shape[1], 512), **(lm_kwargs or {}))

    return pipeline


def _waves(batch, seconds, seed=0, device="cpu"):
    """bench.py::_waves (:184): seeded noise, (B, S) fp32 and (B,) int32."""
    S = int(seconds * SR)
    rng = np.random.default_rng(seed)
    w = torch.from_numpy((rng.standard_normal((batch, S)) * 0.1).astype(np.float32))
    n = torch.full((batch,), S, dtype=torch.int32)
    return w.to(device), n.to(device)


def _model(cfg, device):
    """The model with seeded random weights (init_model, torch.Generator
    seed 0) on ``device``."""
    return init_model(cfg, torch.Generator().manual_seed(0)).to(device)


def _flagship(device):
    cfg = _flagship_cfg()
    return cfg, _model(cfg, device)


def bench_greedy_headline(device="cuda", cap=None):
    """(RTFx, MFU or None, card name) of greedy at B=BATCH x SECONDS."""
    cfg, model = _flagship(device)
    w, n = _waves(BATCH, SECONDS, device=device)
    sec = _timed(_make_pipeline(cfg, model), w, n, _cap(ITERS, cap), device)
    rtfx = BATCH * SECONDS / sec
    peak, kind = _peak_flops(device)
    flops = model_forward_flops(cfg, SECONDS) * BATCH
    mfu = (flops / sec / peak) if peak else None
    return rtfx, mfu, kind


def bench_greedy_single(device="cuda", cap=None):
    cfg, model = _flagship(device)
    w, n = _waves(1, SECONDS, device=device)
    sec = _timed(_make_pipeline(cfg, model), w, n, _cap(20, cap), device)
    return _emit("rtfx_greedy_single", SECONDS / sec, "audio_sec/sec/chip", device,
                 config=1, latency_ms=round(sec * 1e3, 2))


def bench_beam_arpa(device="cuda", cap=None):
    """Config 4: beam-16 with a 400-word word ARPA fused through the char
    tokenizer (trie tables); beside it the word-granular state tables over
    a char-level trigram ARPA, and the host beam (decode/beam.py, 3
    utterances, best of 2)."""
    tokenizer = TurkishTokenizer()
    cfg, model = _flagship(device)
    w, n = _waves(BATCH, SECONDS, device=device)
    with tempfile.TemporaryDirectory() as tmp:
        word_arpa = os.path.join(tmp, "bench_words.arpa")
        synthetic_word_arpa(word_arpa)
        word_model = ArpaLanguageModel(word_arpa)
        trie = build_trie_fusion_tables(word_model, tokenizer, cfg.n_classes)
        pipeline = _make_pipeline(cfg, model, decode="beam", lm_kwargs=_lm_kwargs(
            device, trie["start_h"], lm_trie=trie))
        sec = _timed(pipeline, w, n, _cap(6, cap), device)
        rtfx = BATCH * SECONDS / sec

        tok_arpa = os.path.join(tmp, "bench_lm.arpa")
        synthetic_token_arpa(tokenizer, tok_arpa)
        tables = build_arpa_fusion_tables(ArpaLanguageModel(tok_arpa), tokenizer,
                                          cfg.n_classes)
        pipeline_w = _make_pipeline(cfg, model, decode="beam", lm_kwargs=_lm_kwargs(
            device, tables[2], lm_tables=tables[:2]))
        sec_w = _timed(pipeline_w, w, n, _cap(6, cap), device)
        rtfx_word = BATCH * SECONDS / sec_w

    # The host beam: the reference's sequential Python prefix beam with
    # per-extension LM queries, on the bf16 forward's logits.
    utterances = _cap(3, cap)
    with torch.inference_mode():
        logits, _ = _logits(cfg, model, w[:utterances], n[:utterances])
    logits = logits.float().cpu().numpy()
    host = CTCBeamDecoder(tokenizer, beam_width=16, lm=word_model, lm_weight=0.3)
    trials = []
    for _ in range(_cap(2, cap)):
        start = time.perf_counter()
        for i in range(utterances):
            host.decode(logits[i])
        trials.append(time.perf_counter() - start)
    host_rtfx = utterances * SECONDS / min(trials)
    return _emit("rtfx_beam16_arpa", rtfx, "audio_sec/sec/chip", device, config=4,
                 lm_fusion="trie(char tokenizer, word ARPA)",
                 word_states=int(trie["score_w"].shape[0]),
                 trie_nodes=int(trie["trie_nodes"]),
                 word_table_rtfx=round(rtfx_word, 2),
                 host_beam_rtfx=round(host_rtfx, 2),
                 vs_host_beam=round(rtfx / host_rtfx, 1))


def bench_beam_arpa_100k(device="cuda", cap=None):
    """Config 4 at production LM scale: beam-16 fused with a 100k-word,
    ~1M-n-gram order-4 word ARPA through the char tokenizer.
    ``build_trie_fusion_tables`` must refuse it; the hash tables (linear
    memory, probed scores) are what a user with such an LM gets. Build
    times, host peak RSS and the device tables' MB beside the RTFx."""
    tokenizer = TurkishTokenizer()
    cfg, model = _flagship(device)
    w, n = _waves(BATCH, SECONDS, device=device)
    with _peak_rss() as rss:
        with tempfile.TemporaryDirectory() as tmp:
            arpa = os.path.join(tmp, "bench_100k.arpa")
            t0 = time.perf_counter()
            synthetic_word_arpa(arpa, **ARPA_100K)
            gen_s = time.perf_counter() - t0
            t0 = time.perf_counter()
            lm = ArpaLanguageModel(arpa)
            parse_s = time.perf_counter() - t0
        if build_trie_fusion_tables(lm, tokenizer, cfg.n_classes) is not None:
            raise AssertionError("build_trie_fusion_tables did not refuse the production ARPA")
        t0 = time.perf_counter()
        ht = build_hash_fusion_tables(lm, tokenizer, cfg.n_classes)
        build_s = time.perf_counter() - t0
    rss_gb = None if rss["gb"] is None else round(rss["gb"], 2)
    dev_mb = sum(ht[k].nbytes for k in TABLE_KEYS) / 1e6
    pipeline = _make_pipeline(cfg, model, decode="beam", lm_kwargs=_lm_kwargs(
        device, lm_hash={k: ht[k] for k in HASH_KEYS}))
    sec = _timed(pipeline, w, n, _cap(4, cap), device)
    rtfx = BATCH * SECONDS / sec
    return _emit("rtfx_beam16_arpa_100k", rtfx, "audio_sec/sec/chip", device, config=4,
                 lm_fusion="hash(char tokenizer, 100k-word order-4 ARPA)",
                 n_ngrams=len(lm.logprob), n_words=int(ht["n_words"]),
                 trie_nodes=int(ht["trie_nodes"]),
                 table_slots=int(ht["table_size"]),
                 device_tables_mb=round(dev_mb, 1),
                 arpa_gen_s=round(gen_s, 1), arpa_parse_s=round(parse_s, 1),
                 tables_build_s=round(build_s, 1),
                 host_peak_rss_gb=rss_gb)


def bench_longform_conformer_l(device="cuda", cap=None):
    """Config 5's forward: Conformer-L, B=16 x 64 s (T'=1601), with the
    attention kernel and with its plain version (kernel off)."""
    cfg = _flagship_cfg(**CONFORMER_L)
    model = _model(cfg, device)
    B, seconds = LONGFORM
    w, n = _waves(B, seconds, device=device)
    iters = _cap(3, cap)
    sec_on = _timed(_make_pipeline(cfg, model), w, n, iters, device)
    sec_off = _timed(_make_pipeline(cfg, model, attn_kernel=False), w, n, iters, device)
    rtfx = B * seconds / sec_on
    peak, _ = _peak_flops(device)
    flops = model_forward_flops(cfg, seconds) * B
    return _emit("rtfx_longform_conformer_l", rtfx, "audio_sec/sec/chip", device, config=5,
                 kernel_off_rtfx=round(B * seconds / sec_off, 2),
                 flash_kernel_speedup=round(sec_off / sec_on, 3),
                 mfu=round(flops / sec_on / peak, 4) if peak else None)


def _train_step_ms(batch_size, augment, accumulation_steps, n_steps=10, cfg=None, seconds=None,
                   attn_kernel=True, device="cuda"):
    """(sec a train step, sec an eval step or None, {"wer", "cer"} or None)
    of the port's Trainer on one process: bf16, bench.py's optimizer, the
    char tokenizer, seeded noise and random targets of length 64 on the
    device; 2 warm-up steps, then ``n_steps`` of ``Trainer.train_step``.
    Without augmentation (config 2) also the eval step as
    ``Trainer.validate`` runs it (the eval loss + greedy collapse on the
    device), scored through ``ASRMetrics.compute_from_ids``."""
    seconds = SECONDS if seconds is None else seconds
    cfg = _flagship_cfg() if cfg is None else cfg
    model = _model(cfg, device)
    optimizer, schedule = make_optimizer(
        [p for p in model.parameters() if p.requires_grad], 5e-4, 1e-6, 1000,
        accumulation_steps=accumulation_steps)
    trainer = Trainer(model, optimizer, schedule, get_config([]),
                      get_logger("bench", log_file=None), tokenizer=TurkishTokenizer(),
                      device=device, accumulation_steps=accumulation_steps,
                      compute_dtype=torch.bfloat16, augment=augment, attn_kernel=attn_kernel)

    S = int(seconds * SR)
    rng = np.random.default_rng(0)
    host = {
        "waveforms": (rng.standard_normal((batch_size, S)) * 0.1).astype(np.float32),
        "wav_lengths": np.full((batch_size,), S, dtype=np.int32),
        "targets": rng.integers(2, cfg.n_classes, (batch_size, 64)).astype(np.int32),
        "target_lengths": np.full((batch_size,), 64, dtype=np.int32),
        "sample_mask": np.ones((batch_size,), dtype=np.float32),
    }
    batch = {k: torch.from_numpy(v).to(device) for k, v in host.items()}
    for _ in range(2):  # kernel builds + warm-up
        trainer.train_step(batch, 0)
    _sync(device)
    start = time.perf_counter()
    for _ in range(n_steps):
        trainer.train_step(batch, 0)  # ends in the step's host reads
    _sync(device)
    sec = (time.perf_counter() - start) / n_steps

    eval_sec = None
    eval_metrics = None
    if not augment:
        # config 2 includes the per-epoch greedy WER eval loop.
        with torch.no_grad():
            _eval_step(trainer, batch)
            _sync(device)
            start = time.perf_counter()
            for _ in range(n_steps):
                ids, counts = _eval_step(trainer, batch)
            _sync(device)
            eval_sec = (time.perf_counter() - start) / n_steps
        eval_metrics = _eval_metrics(trainer.metrics, ids, counts, host["targets"])
    return sec, eval_sec, eval_metrics


def _eval_step(trainer, batch):
    """The port's counterpart of the JAX trainer's ``_eval_step``, as
    ``Trainer.validate`` runs it: the eval loss, then the greedy collapse
    on the device with the tokenizer's blank. -> (ids, counts)."""
    _, _, logits, frame_lengths = trainer._loss(batch, False)
    return greedy_collapse_batch(logits, frame_lengths // 4, blank_id=trainer.blank)


def _eval_metrics(metrics, ids, counts, targets):
    """Config 2's wer/cer: the eval ids through the full WER/CER path
    (decode -> corpus metrics), as bench.py scores them. On this synthetic
    batch (random weights, noise audio, random targets) the values are
    ~1.0 by construction; they certify the metric path runs on device
    output."""
    result, _, _ = metrics.compute_from_ids(ids.cpu().numpy(), counts.cpu().numpy(),
                                            np.asarray(targets))
    return {"wer": round(float(result["wer"]), 4), "cer": round(float(result["cer"]), 4)}


def _train_mfu(batch_size, sec, device):
    """Train-step MFU: analytic fwd+bwd matmul FLOPs (3x the forward's)
    over elapsed time; CTC and the optimizer update are excluded
    (bench.py::_train_mfu)."""
    peak, _ = _peak_flops(device)
    if not peak:
        return None
    flops = 3 * model_forward_flops(_flagship_cfg(), SECONDS) * batch_size
    return round(flops / sec / peak, 4)


def bench_train_small(device="cuda", cap=None):
    sec, eval_sec, eval_metrics = _train_step_ms(
        8, augment=False, accumulation_steps=1, n_steps=_cap(10, cap), device=device)
    return _emit("train_step_ms_b8", sec * 1e3, "ms/step", device, config=2,
                 eval_step_ms=round(eval_sec * 1e3, 2),
                 **(eval_metrics or {}),
                 audio_sec_per_sec=round(8 * SECONDS / sec, 2),
                 mfu=_train_mfu(8, sec, device),
                 # bench.py's field holds a TPU profile's breakdown; the
                 # port's step has not been broken down here.
                 anatomy="not measured")


def bench_train_aug(device="cuda", cap=None):
    sec, _, _ = _train_step_ms(32, augment=True, accumulation_steps=4,
                               n_steps=_cap(10, cap), device=device)
    return _emit("train_step_ms_b32_aug", sec * 1e3, "ms/microstep", device, config=3,
                 accumulation_steps=4,
                 audio_sec_per_sec=round(32 * SECONDS / sec, 2),
                 mfu=_train_mfu(32, sec, device))


def bench_train_conformer_l(device="cuda", cap=None):
    """Config 5's training step: Conformer-L, B=4 x 64 s (T'=1601),
    --augment, with the attention kernels (forward and backward, dropout in
    the kernel) and with the plain version (kernel off)."""
    cfg = _flagship_cfg(**CONFORMER_L)
    B, seconds = LONGFORM_TRAIN
    sec_on, _, _ = _train_step_ms(B, augment=True, accumulation_steps=1,
                                  n_steps=_cap(6, cap), cfg=cfg, seconds=seconds,
                                  attn_kernel=True, device=device)
    sec_off, _, _ = _train_step_ms(B, augment=True, accumulation_steps=1,
                                   n_steps=_cap(6, cap), cfg=cfg, seconds=seconds,
                                   attn_kernel=False, device=device)
    peak, _ = _peak_flops(device)
    flops = 3 * model_forward_flops(cfg, seconds) * B
    return _emit("train_step_ms_conformer_l", sec_on * 1e3, "ms/step", device,
                 batch=B, audio_seconds=seconds,
                 audio_sec_per_sec=round(B * seconds / sec_on, 2),
                 kernel_off_ms=round(sec_off * 1e3, 2),
                 flash_kernel_speedup=round(sec_off / sec_on, 3),
                 mfu=round(flops / sec_on / peak, 4) if peak else None)


def bench_torch_baseline():
    """Reference-architecture forward in stock torch.nn on CPU (proxy
    baseline; the actual reference stack needs torchaudio+CUDA).

    Copied from bench.py::bench_torch_baseline (:629-709), but it only
    reads the repo's cache and never writes it."""
    if os.path.exists(BASELINE_CACHE):
        with open(BASELINE_CACHE) as f:
            return json.load(f)["rtfx_torch_cpu"]

    torch.manual_seed(0)
    d, heads, blocks, n_mels, vocab = 256, 4, 8, 80, 55

    class Block(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.n1 = torch.nn.GroupNorm(32, d)
            self.ff1a = torch.nn.Linear(d, 8 * d)
            self.ff1b = torch.nn.Linear(4 * d, d)
            self.attn = torch.nn.MultiheadAttention(d, heads, batch_first=True)
            self.n2 = torch.nn.GroupNorm(32, d)
            self.pw1 = torch.nn.Conv1d(d, 2 * d, 1)
            self.dw = torch.nn.Conv1d(d, d, 31, padding=15, groups=d)
            self.bn = torch.nn.BatchNorm1d(d)
            self.pw2 = torch.nn.Conv1d(d, d, 1)
            self.ff2a = torch.nn.Linear(d, 8 * d)
            self.ff2b = torch.nn.Linear(4 * d, d)
            self.n3 = torch.nn.GroupNorm(32, d)

        def _gn(self, norm, x):
            return norm(x.transpose(1, 2)).transpose(1, 2)

        def _ff(self, a, b, x):
            h = a(x)
            h1, h2 = h.chunk(2, dim=-1)
            return b(torch.nn.functional.silu(h1) * h2)

        def forward(self, x):
            x = x + 0.5 * self._ff(self.ff1a, self.ff1b, self._gn(self.n1, x))
            a, _ = self.attn(x, x, x, need_weights=False)
            x = x + a
            h = x.transpose(1, 2)
            h = self.pw2(torch.nn.functional.silu(self.bn(self.dw(
                torch.nn.functional.glu(self.pw1(h), dim=1)))))
            x = x + h.transpose(1, 2)
            x = x + 0.5 * self._ff(self.ff2a, self.ff2b, self._gn(self.n2, x))
            return self._gn(self.n3, x)

    class Model(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.sub = torch.nn.Sequential(
                torch.nn.Conv2d(1, d, 3, 2, 1), torch.nn.SiLU(),
                torch.nn.Conv2d(d, d, 3, 2, 1), torch.nn.SiLU())
            self.proj = torch.nn.Linear(d * (n_mels // 4), d)
            self.blocks = torch.nn.ModuleList([Block() for _ in range(blocks)])
            self.fc = torch.nn.Linear(d, vocab)

        def forward(self, feats):
            x = self.sub(feats.unsqueeze(1))
            b, c, t, f = x.shape
            x = self.proj(x.permute(0, 2, 1, 3).reshape(b, t, c * f))
            for blk in self.blocks:
                x = blk(x)
            return self.fc(x)

    model = Model().eval()
    T = int(1 + SECONDS * SR / 160)
    feats = torch.randn(BASELINE_BATCH, T, n_mels)
    with torch.no_grad():
        model(feats)  # warmup
        start = time.perf_counter()
        for _ in range(2):
            out = model(feats)
            out.argmax(-1)
        elapsed = time.perf_counter() - start
    return 2 * BASELINE_BATCH * SECONDS / elapsed


CONFIGS = (bench_greedy_single, bench_train_small, bench_train_aug, bench_beam_arpa,
           bench_beam_arpa_100k, bench_longform_conformer_l, bench_train_conformer_l)


def run(device="cuda", cap=None, around=None):
    """Every configuration on ``device``; returns the printed lines.

    The headline is measured first (its number lands even if a later
    configuration fails) and printed last. ``around(name)``, when given, is
    a context manager entered around each configuration (chip_smoke.py
    counts each one's kernel launches with it)."""
    around = around or (lambda name: contextlib.nullcontext())
    with around(bench_greedy_headline.__name__):
        rtfx, mfu, _ = bench_greedy_headline(device, cap)
    lines = []
    for fn in CONFIGS:
        if torch.device(device).type == "cuda":
            torch.cuda.empty_cache()
        try:
            with around(fn.__name__):
                lines.append(fn(device, cap))
        except Exception as e:  # noqa: BLE001 — one config must not kill the run
            lines.append(_emit(f"error_{fn.__name__}", -1, "error", device,
                               detail=str(e)[:200]))

    baseline = bench_torch_baseline()
    vs = rtfx / baseline if baseline else 1.0
    lines.append(_emit("rtfx_greedy_batch", rtfx, "audio_sec/sec/chip", device,
                       vs_baseline=round(vs, 2), mfu=round(mfu, 4) if mfu else None))
    return lines


def main(argv=None):
    parser = argparse.ArgumentParser(description="The port's benchmark (bench.py's configs)")
    parser.add_argument("--device", default="cuda", help="torch device: cuda (default) or cpu")
    args = parser.parse_args(argv)
    device = str(resolve_device(args.device))
    run(device)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
