"""ASR inference in PyTorch: the pipeline and its CLI.

Counterpart of ``inference.py`` (``ASRInference``, ``main``,
``_report_metrics``): wav decode (host) -> log-mel -> Conformer forward at
a static bucketed length -> greedy CTC collapse on the device, or with
``use_beam_search`` the prefix beam search (decode/factory.py), on the
device and LM-fused when an ARPA compiles into fusion tables. The bucket
length is part of the numerics, because GroupNorm statistics span the
padding (the reference's behaviour), so a file gives the same text alone
and in a batch.

CLI: ``python -m turkish_asr_torch.inference --audio FILE_OR_DIR --model
model.pt|model.ckpt [--beam_search --beam_width 16 --lm lm.arpa --lm_fusion
auto|device|hash|host --lm_weight 0.3 --word_bonus 0.5] [--evaluate]
[--timestamps] [--device cuda|cpu] [--full_context_s 256]``.

Files up to the largest bucket (32 s) run whole and batched; a longer file
runs in overlapping 28 s chunks, one file at a time. With
``full_context_s`` (seconds) files up to that length run whole too, in
buckets of 32 s steps past 32 s (64, 96, ... up to ``full_context_s``),
batched through the same staging ring and forward as short files, as
FastConformer models are served; only longer files are chunked.

The model is a reference-format ``.pt`` or the JAX package's ``.ckpt``
(``utils/weights.load_model``; a ``.ckpt`` is read without jax, flax or
msgpack).

Data parallelism (``data_parallel``, the default, as in the JAX package's
``ASRInference``): the model has a replica on every visible CUDA device,
and a batched forward's rows are split over them in order and the logits
concatenated on the first. Training over a mesh of processes is
``torchrun --nproc_per_node N -m turkish_asr_torch.main --mesh_shape
data=N ...`` (``turkish_asr_torch/main.py``).
"""

import argparse
import contextlib
import copy
import os
from pathlib import Path

import numpy as np
import torch

from turkish_asr_torch.audio.features import log_mel_spectrogram
from turkish_asr_torch.audio.wavio import TARGET_SAMPLE_RATE, load_audio
from turkish_asr_torch.data.buckets import DEFAULT_WAVEFORM_BUCKETS, bucket_table
from turkish_asr_torch.data.tokenizer import load_tokenizer
from turkish_asr_torch.decode.beam import CTCBeamDecoder
from turkish_asr_torch.decode.greedy import GreedyDecoder
from turkish_asr_torch.decode.lm import KenLMModel, NGramLanguageModel
from turkish_asr_torch.utils import tracing
from turkish_asr_torch.utils.device import resolve_device
from turkish_asr_torch.utils.errors import TimestampsUnsupportedError
from turkish_asr_torch.utils.weights import load_model

LM_FUSIONS = ("auto", "device", "hash", "host")
tracing.count("full_context_rows", 0)
tracing.count("chunked_files", 0)
HOP = 160  # samples between log-mel frames (audio/features.py)
LONG_BUCKET_S = 32  # the step of the whole-file buckets past the largest default bucket


def whole_file_buckets(full_context_s=None):
    """The waveform buckets files run whole in: ``DEFAULT_WAVEFORM_BUCKETS``
    (up to 32 s), then with ``full_context_s`` 32 s steps past them up to the
    first that holds ``full_context_s`` (64, 96, ..., 256 for 256)."""
    if full_context_s is None:
        return DEFAULT_WAVEFORM_BUCKETS
    if full_context_s <= 0:
        raise ValueError(f"full_context_s must be positive, got {full_context_s}")
    last = DEFAULT_WAVEFORM_BUCKETS[-1]
    step = LONG_BUCKET_S * TARGET_SAMPLE_RATE
    n = max(0, -(-(int(full_context_s * TARGET_SAMPLE_RATE) - last) // step))
    return DEFAULT_WAVEFORM_BUCKETS + tuple(last + step * (k + 1) for k in range(n))


def _check_vocab_match(n_classes, tokenizer, model_path):
    """A checkpoint decoded through a tokenizer of another vocabulary
    emits garbage, so the mismatch is an error."""
    vs = getattr(tokenizer, "vocab_size", None)
    if vs is not None and int(vs) != int(n_classes):
        raise ValueError(
            f"Checkpoint/tokenizer vocabulary mismatch: {model_path} was trained "
            f"with n_classes={int(n_classes)} but the loaded tokenizer "
            f"({getattr(tokenizer, 'backend', '?')}) has vocab_size={int(vs)}. "
            f"Pass the tokenizer the model was trained with via tokenizer_path / "
            f"ASR_TOKENIZER_PATH.")


class ASRInference:
    """ASR inference on one device.

    Usage:
        asr = ASRInference("model.pt")               # CUDA, bf16, greedy
        asr = ASRInference("best_model.ckpt")        # a JAX-trained checkpoint
        text = asr.transcribe("audio.wav")
        asr = ASRInference("model.pt", use_beam_search=True, beam_width=16,
                           lm_path="lm.arpa")        # LM-fused beam on the card
    """

    def __init__(self, model_path, n_heads=4, use_beam_search=False, beam_width=10,
                 lm_path=None, lm_fusion="auto", lm_weight=0.3, word_bonus=0.5,
                 compute_dtype=torch.bfloat16, tokenizer_path=None, trust_checkpoint=False,
                 device="cuda", data_parallel=True, devices=None, full_context_s=None):
        """``data_parallel``: batched forwards split their rows over a
        replica of the model on each of ``devices`` (default: every
        visible CUDA device when ``device`` is a CUDA device; the first
        is ``device``'s). Off, or with one device, one model runs all rows.
        ``full_context_s``: files up to this many seconds run whole (module
        docstring); None chunks every file past 32 s."""
        self.device = resolve_device(device)
        self.buckets = whole_file_buckets(full_context_s)
        # the longest file run whole; longer ones are chunked
        self.whole_max = DEFAULT_WAVEFORM_BUCKETS[-1]
        if full_context_s is not None:
            self.whole_max = max(self.whole_max, int(full_context_s * TARGET_SAMPLE_RATE))
        self.compute_dtype = compute_dtype
        self.tokenizer = load_tokenizer(tokenizer_path)
        self.cfg, self.model = load_model(model_path, self.device, n_heads=n_heads,
                                          allow_pickle=trust_checkpoint)
        _check_vocab_match(self.cfg.n_classes, self.tokenizer, model_path)
        refusal = self.model.block_type.serving_refusal(compute_dtype, self.device)
        if refusal:
            raise ValueError(f"{model_path} is {refusal}, got compute_dtype={compute_dtype}")
        self.replicas = [self.model]
        if data_parallel:
            if devices is None and self.device.type == "cuda":
                first = torch.device("cuda", torch.cuda.current_device()
                                     if self.device.index is None else self.device.index)
                devices = [first] + [torch.device("cuda", i) for i in
                                     range(torch.cuda.device_count()) if i != first.index]
            for dev in (devices or [])[1:]:
                self.replicas.append(copy.deepcopy(self.model).to(resolve_device(dev)))
        self.use_beam_search = use_beam_search
        self.decoder = None
        if use_beam_search:
            self.decoder = self._beam_decoder(beam_width, lm_path, lm_fusion, lm_weight,
                                              word_bonus)
        elif lm_path:
            # An LM without beam search is inert, which reads as "fusion
            # active" to the operator.
            print("WARNING: --lm/ASR_LM_PATH is set but beam search is off — the LM is "
                  "IGNORED on the greedy path (pass --beam_search / USE_BEAM_SEARCH=true).")
        self.greedy = GreedyDecoder(self.tokenizer)
        self.frame_s = self.model.subsample.factor * HOP / TARGET_SAMPLE_RATE
        self._rings = []  # free _StagingRings
        print(f"ASR ready on {self.device}")

    def _beam_decoder(self, beam_width, lm_path, lm_fusion, lm_weight, word_bonus):
        """The JAX package's routing (inference.py:194-243): "auto" and
        "device" take the ARPA state tables for word tokenizers, else the
        trie tables, else (dense tables over budget) the hash tables;
        "hash" forces the hash tables; "host", no LM, or a tokenizer no
        builder can model take the host beam."""
        from turkish_asr_torch.decode.factory import DeviceBeamDecoder
        from turkish_asr_torch.decode.lm import (
            build_arpa_fusion_tables, build_hash_fusion_tables, build_trie_fusion_tables,
            tokenizer_is_word_granular)
        if lm_path and not os.path.exists(lm_path):
            # Loud: a typo'd --lm / ASR_LM_PATH would otherwise serve an
            # unfused (and much slower host) beam.
            raise FileNotFoundError(
                f"LM file not found: {lm_path} (from --lm / ASR_LM_PATH) — beam search "
                f"would silently run without LM fusion")
        n_classes = self.cfg.n_classes
        tables = trie = lm_ht = lm = None
        if lm_path:
            lm = KenLMModel(lm_path)
            if lm_fusion in ("device", "auto"):
                if tokenizer_is_word_granular(self.tokenizer, n_classes):
                    tables = build_arpa_fusion_tables(lm, self.tokenizer, n_classes)
                if tables is None:
                    trie = build_trie_fusion_tables(lm, self.tokenizer, n_classes)
            if lm_fusion == "hash" or (tables is None and trie is None
                                       and lm_fusion in ("device", "auto")):
                lm_ht = build_hash_fusion_tables(lm, self.tokenizer, n_classes)
        if tables is None and trie is None and lm_ht is None:
            if word_bonus < 0:
                print("WARNING: the host beam preserves the reference CTCBeamDecoder "
                      "contract of applying word_bonus only when > 0 — a negative "
                      "insertion penalty is IGNORED here (use --lm_fusion device/hash for "
                      "flashlight-style negative word scores).")
            return CTCBeamDecoder(self.tokenizer, beam_width=beam_width,
                                  lm=lm if lm is not None else NGramLanguageModel(),
                                  lm_weight=lm_weight, word_bonus=word_bonus)
        decoder = DeviceBeamDecoder(self.tokenizer, beam_width=beam_width, lm_tables=tables,
                                    lm_trie=trie, lm_hash=lm_ht, lm_weight=lm_weight,
                                    word_bonus=word_bonus, device=self.device)
        if tables is not None:
            print(f"Beam decoder: on-device ARPA fusion ({tables[0].shape[0]} LM states)")
        elif trie is not None:
            print(f"Beam decoder: on-device ARPA trie fusion "
                  f"({trie['score_w'].shape[0]} word states, {trie['trie_nodes']} trie nodes)")
        else:
            print(f"Beam decoder: on-device ARPA hash fusion ({lm_ht['n_words']} words, "
                  f"{lm_ht['table_size']} hash slots, {lm_ht['trie_nodes']} trie nodes)")
        return decoder

    @torch.inference_mode()
    def _forward_batch(self, waveforms, lengths):
        """(B, S) float32 and (B,) int32, numpy arrays or CPU tensors ->
        (logits (B, T', V) fp32, valid output frames (B,)), both on the
        device. The rows are split in order into contiguous slices over the
        replicas (``data_parallel``); each replica's launches are queued
        before any result is read. Page-locked waveforms (a ``_StagingRing``
        arena's) are copied asynchronously."""
        B, S = waveforms.shape
        tracing.count("forward_samples_valid", int(lengths.sum()))
        tracing.count("forward_samples_padded", B * S)
        if S > DEFAULT_WAVEFORM_BUCKETS[-1]:
            tracing.count("full_context_rows", B)
        pinned = torch.is_tensor(waveforms) and waveforms.is_pinned()
        with tracing.span("forward", B=B, S=S):
            outs = []
            for model, rows in zip(self.replicas, np.array_split(np.arange(B),
                                                                 len(self.replicas))):
                if len(rows) == 0:
                    continue
                dev = next(model.parameters()).device
                part = slice(rows[0], rows[-1] + 1)
                with tracing.span("h2d"):
                    wav = torch.as_tensor(waveforms[part]).to(dev, non_blocking=pinned)
                    lens = torch.as_tensor(lengths[part]).to(dev, non_blocking=pinned)
                feats, frame_lengths = log_mel_spectrogram(wav, lens, n_mels=self.cfg.n_mels)
                outs.append((model(feats, frame_lengths, self.compute_dtype),
                             model.subsample.frames(frame_lengths)))
            if pinned:
                tracing.count("staged_pinned")
            return (torch.cat([o[0].to(self.device) for o in outs]),
                    torch.cat([o[1].to(self.device) for o in outs]))

    @contextlib.contextmanager
    def _staging_ring(self):
        """A ``_StagingRing`` for one ``transcribe_files`` call: a free one,
        or a new one while every ring is in use, so calls from several
        threads (the server's) never share an arena."""
        try:
            ring = self._rings.pop()  # one atomic pop: no two calls take one ring
        except IndexError:
            ring = _StagingRing(self.device)
        try:
            yield ring
        finally:
            self._rings.append(ring)

    def _forward_padded(self, waveform):
        n = waveform.shape[0]
        S = bucket_table(n, self.buckets)
        padded = np.zeros((1, S), dtype=np.float32)
        padded[0, :min(n, S)] = waveform[:S]
        logits, out_len = self._forward_batch(padded, np.asarray([min(n, S)], np.int32))
        return logits[0].cpu().numpy(), int(out_len[0])

    def _logits(self, audio_path, chunk_seconds=28.0, overlap_seconds=2.0):
        """Logits of a file; audio longer than the largest bucket runs in
        overlapping chunks whose trimmed logits are concatenated (the
        counter ``chunked_files``)."""
        with tracing.span("load") as span:
            waveform, sr = load_audio(audio_path)
            span.set(samples=waveform.shape[0])
        n = waveform.shape[0]
        if n <= self.whole_max:
            logits, out_len = self._forward_padded(waveform)
            return logits[:out_len], out_len

        tracing.count("chunked_files")
        chunk = int(chunk_seconds * sr)
        overlap = int(overlap_seconds * sr)
        step = chunk - overlap
        # post-subsample frame rate: hop 160 then the subsample's factor
        margin_frames = overlap // (HOP * self.model.subsample.factor) // 2
        pieces = []
        start = 0
        while start < n:
            seg = waveform[start:start + chunk]
            is_last = start + chunk >= n
            logits, out_len = self._forward_padded(seg)
            logits = logits[:out_len]
            lo = margin_frames if start > 0 else 0
            hi = out_len if is_last else out_len - margin_frames
            pieces.append(logits[lo:hi])
            if is_last:
                break  # a chunk ending exactly at n must not respawn a tail
            start += step
        merged = np.concatenate(pieces, axis=0)
        return merged, merged.shape[0]

    def transcribe(self, audio_path, timestamps=False):
        """One file -> text, or with ``timestamps=True`` (greedy only)
        ``{"text", "segments": [{"word", "start", "end"}]}`` from the CTC
        emission frames (one output frame = 10 ms times the subsample's
        factor: 40 ms by 4, 80 ms by 8)."""
        if timestamps and self.use_beam_search:
            # refused before the forward: the check must not cost a transcription
            raise TimestampsUnsupportedError(
                "timestamps are available on the greedy path only "
                "(run without --beam_search)")
        logits, _ = self._logits(audio_path)
        if self.decoder is not None:
            return self.decoder.decode(logits)
        pred_ids = np.argmax(logits, axis=-1)
        if not timestamps:
            return self.tokenizer.ctc_decode(pred_ids.tolist())
        return self._with_segments(pred_ids)

    def _with_segments(self, pred_ids):
        """CTC collapse keeping each kept token's emission frame
        (``frame_s`` apart), then words split at the tokens' own spaces."""
        frame_sec = self.frame_s
        blank = self.tokenizer.pad_token_id
        prev = -1
        kept, frames = [], []
        for t, tid in enumerate(pred_ids.tolist()):
            if tid != prev and tid != blank:
                kept.append(tid)
                frames.append(t)
            prev = tid
        text = self.tokenizer.decode(kept)
        segments = []
        word, start, last = "", None, None
        for tid, fr in zip(kept, frames):
            piece = self.tokenizer.decode([tid])
            for ch_i, part in enumerate(piece.split(" ")):
                if ch_i > 0 and word:  # a space inside the piece ends a word
                    segments.append({"word": word, "start": round(start * frame_sec, 3),
                                     "end": round((last + 1) * frame_sec, 3)})
                    word, start = "", None
                if part:
                    if start is None:
                        start = fr
                    word += part
                    last = fr
        if word:
            segments.append({"word": word, "start": round(start * frame_sec, 3),
                             "end": round((last + 1) * frame_sec, 3)})
        return {"text": text, "segments": segments}

    def transcribe_batch(self, audio_paths):
        """Files one by one; a file that fails gives "" (reference contract)."""
        results = []
        for path in audio_paths:
            try:
                results.append(self.transcribe(path))
            except Exception as e:  # noqa: BLE001 — per-file error capture
                print(f"Error processing {path}: {e}")
                results.append("")
        return results

    def transcribe_files(self, audio_paths, batch_size=16, return_errors=False):
        """Batched transcription: files are grouped by bucket and padded
        batches of ``batch_size`` rows run as one forward and one decode
        each (the device collapse, or the configured beam decoder). Files
        load in order; a bucket's batch is dispatched once it holds
        ``batch_size`` files, the partial ones at the end in ascending
        length, so each batch holds the files it would if every file were
        loaded first. While one batch's forward runs on the card the host
        loads the next batch's files and pads them into the other arena of a
        ``_StagingRing``, then decodes the batch on the card and dispatches
        the next. Files longer than 32 s (or ``full_context_s``) run alone,
        chunked, after the batches. A file that fails to load or decode
        gives ""; with ``return_errors=True`` returns (texts, error strings
        or None)."""
        if batch_size < 1:
            raise ValueError(f"batch_size must be at least 1, got {batch_size}")
        with tracing.span("transcribe_files", files=len(audio_paths), batch_size=batch_size), \
                contextlib.ExitStack() as batch_span, self._staging_ring() as ring:
            out = [""] * len(audio_paths)
            errors = [None] * len(audio_paths)
            by_bucket, longer = {}, []
            pending = None  # (file indices, logits, out_lens) of the batch on the card

            def collect():
                idx, logits, out_lens = pending
                with tracing.span("decode"):
                    if isinstance(self.decoder, CTCBeamDecoder):  # the host beam: numpy
                        texts = self.decoder.decode_batch(logits.cpu().numpy(),
                                                          out_lens.cpu().numpy())
                    elif self.decoder is not None:
                        texts = self.decoder.decode_batch(logits, out_lens)
                    else:
                        texts = self.greedy.decode_batch(logits, out_lens)
                for j, i in enumerate(idx):
                    out[i] = texts[j]
                batch_span.close()

            def dispatch(S, group):
                nonlocal pending
                with tracing.span("stage", S=S, rows=len(group)):
                    wav, lens = ring.stage([w for _, w in group], S, batch_size)
                if pending is not None:
                    collect()
                batch_span.enter_context(tracing.span("batch", S=S, rows=len(group)))
                pending = ([i for i, _ in group], *self._forward_batch(wav, lens))
                ring.sent()

            for i, p in enumerate(audio_paths):
                try:
                    with tracing.span("load") as span:
                        w, _ = load_audio(p)
                        span.set(samples=w.shape[0])
                except Exception as e:  # noqa: BLE001 — per-file error capture
                    print(f"Error processing {p}: {e}")
                    errors[i] = str(e)
                    continue
                if pending is not None:
                    tracing.count("load_behind_forward")
                if w.shape[0] > self.whole_max:
                    longer.append(i)
                    continue
                S = bucket_table(w.shape[0], self.buckets)
                group = by_bucket.setdefault(S, [])
                group.append((i, w))
                if len(group) == batch_size:
                    dispatch(S, by_bucket.pop(S))
            for S, group in sorted(by_bucket.items()):
                dispatch(S, group)
            if pending is not None:
                collect()

            for i in longer:
                try:
                    out[i] = self.transcribe(audio_paths[i])
                except Exception as e:  # noqa: BLE001 — per-file error capture
                    errors[i] = str(e)
            if return_errors:
                return out, errors
            return out


class _StagingRing:
    """Two host arenas that ``transcribe_files`` pads its batches into in
    turn, so one is filled while the card copies from the other. On CUDA
    they are page-locked and ``_forward_batch`` copies from them
    asynchronously, and an arena is refilled only once the event ``sent``
    recorded after its batch has fired. Both are sized for the largest batch
    seen and grow together."""

    def __init__(self, device):
        self.device = device
        self.pinned = device.type == "cuda"
        self.arenas = []  # [(waveforms, lengths)], flat
        self.events = [None, None]  # the event after each arena's last batch
        self.turn = 0

    def stage(self, rows, S, batch_size):
        """``rows`` (at most ``batch_size`` 1-D float32 arrays of at most
        ``S`` samples) -> ((batch_size, S) waveforms, (batch_size,) int32
        lengths), views of the next arena holding what a batch made by
        ``np.zeros`` would: each row zero-padded, padding rows all zero with
        length 1 (so zero valid output frames)."""
        have = tuple(a.numel() for a in self.arenas[0]) if self.arenas else (0, 0)
        n, b = max(batch_size * S, have[0]), max(batch_size, have[1])
        if (n, b) != have:
            for i in (0, 1):
                self._wait(i)
            self.arenas = [(torch.empty(n, dtype=torch.float32, pin_memory=self.pinned),
                            torch.empty(b, dtype=torch.int32, pin_memory=self.pinned))
                           for _ in range(2)]
        i = self.turn
        self.turn ^= 1
        self._wait(i)
        wav_arena, len_arena = self.arenas[i]
        wav, lens = wav_arena[:batch_size * S].view(batch_size, S), len_arena[:batch_size]
        w, n = wav.numpy(), lens.numpy()
        for j, x in enumerate(rows):
            w[j, :x.shape[0]] = x
            w[j, x.shape[0]:] = 0
            n[j] = x.shape[0]
        w[len(rows):] = 0
        n[len(rows):] = 1
        return wav, lens

    def sent(self):
        """The batch staged last was dispatched: on CUDA its arena's event
        goes on the device's stream, which every replica's copies precede."""
        if self.pinned:
            event = torch.cuda.Event()
            event.record(torch.cuda.current_stream(self.device))
            self.events[self.turn ^ 1] = event

    def _wait(self, i):
        event, self.events[i] = self.events[i], None
        if event is not None:
            event.synchronize()


def main(argv=None):
    parser = argparse.ArgumentParser(description="Turkish ASR Inference (PyTorch)")
    parser.add_argument("--audio", type=str, required=True, help="Audio file or directory")
    parser.add_argument("--model", type=str, required=True,
                        help="Model checkpoint path (a reference-format .pt or a JAX .ckpt)")
    parser.add_argument("--beam_search", action="store_true", help="Use beam search decoding")
    parser.add_argument("--beam_width", type=int, default=10, help="Beam width")
    parser.add_argument("--n_mel_channels", type=int, default=80,
                        help="Mel channels (a .pt or .ckpt carries its own; accepted and ignored)")
    parser.add_argument("--d_model", type=int, default=256,
                        help="Model dimension (a .pt or .ckpt carries its own; accepted and ignored)")
    parser.add_argument("--n_heads", type=int, default=4,
                        help="Attention heads, when the checkpoint stores none")
    parser.add_argument("--n_blocks", type=int, default=8,
                        help="Conformer blocks (a .pt or .ckpt carries its own; accepted and ignored)")
    parser.add_argument("--lm", type=str, default=None,
                        help="KenLM/ARPA language model for beam-search fusion")
    parser.add_argument("--lm_fusion", type=str, default="auto", choices=list(LM_FUSIONS),
                        help="LM fusion path: auto takes the on-device ARPA state tables for "
                             "word tokenizers, the trie tables for char/subword tokenizers "
                             "and the hash tables when the dense tables exceed their budget; "
                             "device does the same; hash forces the hash tables; host runs "
                             "the host beam")
    parser.add_argument("--lm_weight", type=float, default=0.3,
                        help="LM fusion weight (the reference decoder's alpha)")
    parser.add_argument("--word_bonus", type=float, default=0.5,
                        help="Per-word insertion bonus (the reference decoder's beta; reranks "
                             "the final beams). Negative values apply on the device fusion "
                             "paths; the host beam ignores word_bonus <= 0")
    parser.add_argument("--tokenizer_path", type=str, default=None,
                        help="Tokenizer: .json BPE vocab or HF model name")
    parser.add_argument("--trust_checkpoint", action="store_true",
                        help="Allow full unpickling of .pt checkpoints (only for trusted files)")
    parser.add_argument("--evaluate", action="store_true",
                        help="Score transcripts against sibling .txt references and report "
                             "corpus WER/CER")
    parser.add_argument("--timestamps", action="store_true",
                        help="Emit word-level timestamps from the CTC emission frames "
                             "(greedy decode only)")
    parser.add_argument("--device", type=str, default="cuda",
                        help="Device to run on (cuda, or cpu); no fallback")
    parser.add_argument("--full_context_s", type=float, default=None,
                        help="Run files up to this many seconds whole, in 32 s buckets past "
                             "32 s (FastConformer's long-form use); longer files, and every "
                             "file past 32 s when unset, run in 28 s chunks")
    args = parser.parse_args(argv)

    asr = ASRInference(
        model_path=args.model,
        n_heads=args.n_heads,
        use_beam_search=args.beam_search,
        beam_width=args.beam_width,
        lm_path=args.lm,
        lm_fusion=args.lm_fusion,
        lm_weight=args.lm_weight,
        word_bonus=args.word_bonus,
        tokenizer_path=args.tokenizer_path,
        trust_checkpoint=args.trust_checkpoint,
        device=args.device,
        full_context_s=args.full_context_s,
    )

    audio_path = Path(args.audio)
    if audio_path.is_dir():
        audio_files = sorted(audio_path.glob("*.wav"))
        print(f"Found {len(audio_files)} audio files")
        if args.timestamps:
            texts = []
            for f in audio_files:
                # One bad file gives "" and does not end the corpus run.
                try:
                    out = asr.transcribe(str(f), timestamps=True)
                except TimestampsUnsupportedError:
                    raise
                except Exception as e:  # noqa: BLE001 — per-file error capture
                    print(f"Error processing {f}: {e}")
                    out = {"text": "", "segments": []}
                texts.append(out["text"])
                print(f"{f.name}: {out['text']}")
                for seg in out["segments"]:
                    print(f"  [{seg['start']:7.2f} - {seg['end']:7.2f}] {seg['word']}")
        else:
            # One batched forward and one decode a batch, greedy or beam.
            texts = asr.transcribe_files([str(f) for f in audio_files])
            for f, text in zip(audio_files, texts):
                print(f"{f.name}: {text}")
        if args.evaluate:
            _report_metrics(audio_files, texts, asr.tokenizer)
    elif args.timestamps:
        out = asr.transcribe(str(audio_path), timestamps=True)
        print(f"\nTranscription:\n{out['text']}\n")
        for seg in out["segments"]:
            print(f"  [{seg['start']:7.2f} - {seg['end']:7.2f}] {seg['word']}")
        if args.evaluate:
            _report_metrics([audio_path], [out["text"]], asr.tokenizer)
    else:
        text = asr.transcribe(str(audio_path))
        print(f"\nTranscription:\n{text}\n")
        if args.evaluate:
            _report_metrics([audio_path], [text], asr.tokenizer)


def _report_metrics(audio_files, hypotheses, tokenizer=None):
    """Corpus WER/CER against sibling .txt references, the trainer's
    validation metrics (utils/metrics.wer/cer). References go through the
    tokenizer's round trip (decode(encode(text))), as the trainer's
    validation targets do, so case and characters outside the tokenizer's
    set count as no error."""
    from turkish_asr_torch.utils.metrics import cer, wer

    refs, hyps, skipped = [], [], 0
    for f, hyp in zip(audio_files, hypotheses):
        ref_path = Path(f).with_suffix(".txt")
        if not ref_path.exists():
            skipped += 1
            continue
        text = ref_path.read_text(encoding="utf-8").strip()
        if tokenizer is not None:
            text = tokenizer.decode(tokenizer.encode(text)).strip()
        refs.append(text)
        hyps.append(hyp)
    if skipped:
        print(f"(skipped {skipped} files without .txt references)")
    n_empty = sum(1 for r in refs if not r)
    if n_empty:
        pairs = [(r, h) for r, h in zip(refs, hyps) if r]
        print(f"(skipped {n_empty} empty references)")
        refs, hyps = [p[0] for p in pairs], [p[1] for p in pairs]
    if not refs:
        print("No non-empty references found — nothing to score")
        return
    print(f"Scored {len(refs)} files | WER: {wer(refs, hyps) * 100:.2f}% | "
          f"CER: {cer(refs, hyps) * 100:.2f}%")


if __name__ == "__main__":
    main()
