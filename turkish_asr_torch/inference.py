"""ASR inference pipeline in PyTorch, greedy decoding.

Counterpart of the greedy path of ``inference.py::ASRInference``: wav
decode (host) -> log-mel -> Conformer forward at a static bucketed length
-> greedy CTC collapse on the device. The bucket length is part of the
numerics, because GroupNorm statistics span the padding (the reference's
behaviour), so a file gives the same text alone and in a batch.

Not ported yet (ROADMAP.md): beam search and LM fusion, reading the JAX
package's msgpack ``.ckpt``, the multi-device mesh, and the CLI.
"""

import numpy as np
import torch

from turkish_asr_torch.audio.features import log_mel_spectrogram
from turkish_asr_torch.audio.wavio import load_audio
from turkish_asr_torch.data.buckets import DEFAULT_WAVEFORM_BUCKETS, bucket_table
from turkish_asr_torch.data.tokenizer import load_tokenizer
from turkish_asr_torch.decode.greedy import GreedyDecoder
from turkish_asr_torch.utils.device import resolve_device
from turkish_asr_torch.utils.weights import load_pt


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
    """Greedy ASR inference on one device.

    Usage:
        asr = ASRInference("model.pt")               # CUDA, bf16
        text = asr.transcribe("audio.wav")
    """

    def __init__(self, model_path, n_heads=4, use_beam_search=False,
                 compute_dtype=torch.bfloat16, tokenizer_path=None, device="cuda"):
        if use_beam_search:
            raise NotImplementedError(
                "beam search is not ported to turkish_asr_torch yet (ROADMAP.md); "
                "the port decodes greedily only when asked to")
        if not (model_path.endswith(".pt") or model_path.endswith(".pth")):
            raise NotImplementedError(
                f"{model_path}: the port reads reference-format .pt checkpoints "
                "(export_model.py --format torch); JAX .ckpt reading is not "
                "ported yet (ROADMAP.md)")
        self.device = resolve_device(device)
        self.compute_dtype = compute_dtype
        self.use_beam_search = False
        self.tokenizer = load_tokenizer(tokenizer_path)
        self.cfg, self.model = load_pt(model_path, self.device, n_heads=n_heads)
        _check_vocab_match(self.cfg.n_classes, self.tokenizer, model_path)
        self.greedy = GreedyDecoder(self.tokenizer)
        print(f"ASR ready on {self.device}")

    @torch.inference_mode()
    def _forward_batch(self, waveforms, lengths):
        """(B, S) float32 and (B,) int32 numpy -> (logits (B, T', V) fp32,
        valid output frames (B,)), both on the device."""
        wav = torch.from_numpy(waveforms).to(self.device)
        lens = torch.from_numpy(lengths).to(self.device)
        feats, frame_lengths = log_mel_spectrogram(wav, lens, n_mels=self.cfg.n_mels)
        logits = self.model(feats, frame_lengths, self.compute_dtype)
        return logits, frame_lengths // 4

    def _forward_padded(self, waveform):
        n = waveform.shape[0]
        S = bucket_table(n, DEFAULT_WAVEFORM_BUCKETS)
        padded = np.zeros((1, S), dtype=np.float32)
        padded[0, :min(n, S)] = waveform[:S]
        logits, out_len = self._forward_batch(padded, np.asarray([min(n, S)], np.int32))
        return logits[0].cpu().numpy(), int(out_len[0])

    def _logits(self, audio_path, chunk_seconds=28.0, overlap_seconds=2.0):
        """Logits of a file; audio longer than the largest bucket runs in
        overlapping chunks whose trimmed logits are concatenated."""
        waveform, sr = load_audio(audio_path)
        n = waveform.shape[0]
        if n <= DEFAULT_WAVEFORM_BUCKETS[-1]:
            logits, out_len = self._forward_padded(waveform)
            return logits[:out_len], out_len

        chunk = int(chunk_seconds * sr)
        overlap = int(overlap_seconds * sr)
        step = chunk - overlap
        # post-subsample frame rate: hop 160 then // 4 -> 640 samples a frame
        margin_frames = overlap // (160 * 4) // 2
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
        """One file -> text, or with ``timestamps=True``
        ``{"text", "segments": [{"word", "start", "end"}]}`` from the CTC
        emission frames (one output frame = 40 ms at 16 kHz)."""
        logits, _ = self._logits(audio_path)
        pred_ids = np.argmax(logits, axis=-1)
        if not timestamps:
            return self.tokenizer.ctc_decode(pred_ids.tolist())
        return self._with_segments(pred_ids)

    def _with_segments(self, pred_ids, frame_sec=0.04):
        """CTC collapse keeping each kept token's emission frame, then words
        split at the tokens' own spaces."""
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
        batches of ``batch_size`` rows run as one forward and one device
        collapse each. Files longer than the largest bucket run alone,
        chunked. A file that fails to load or decode gives ""; with
        ``return_errors=True`` returns (texts, error strings or None)."""
        waveforms = []
        errors = [None] * len(audio_paths)
        for i, p in enumerate(audio_paths):
            try:
                w, _ = load_audio(p)
                waveforms.append(None if w.shape[0] > DEFAULT_WAVEFORM_BUCKETS[-1] else w)
            except Exception as e:  # noqa: BLE001 — per-file error capture
                print(f"Error processing {p}: {e}")
                errors[i] = str(e)
                waveforms.append(False)

        results = {}
        by_bucket = {}
        for idx, w in enumerate(waveforms):
            if w is None or w is False:
                continue
            by_bucket.setdefault(bucket_table(w.shape[0], DEFAULT_WAVEFORM_BUCKETS),
                                 []).append(idx)
        for S, group_idx in sorted(by_bucket.items()):
            for i in range(0, len(group_idx), batch_size):
                group = group_idx[i:i + batch_size]
                wav = np.zeros((batch_size, S), dtype=np.float32)
                # Padding rows: one sample, so zero valid output frames.
                lens = np.full((batch_size,), 1, dtype=np.int32)
                for j, idx in enumerate(group):
                    w = waveforms[idx]
                    wav[j, :w.shape[0]] = w
                    lens[j] = w.shape[0]
                logits, out_lens = self._forward_batch(wav, lens)
                texts = self.greedy.decode_batch(logits, out_lens)
                for j, idx in enumerate(group):
                    results[idx] = texts[j]

        out = []
        for idx, p in enumerate(audio_paths):
            if waveforms[idx] is False:
                out.append("")
            elif waveforms[idx] is None:
                try:
                    out.append(self.transcribe(p))
                except Exception as e:  # noqa: BLE001 — per-file error capture
                    errors[idx] = str(e)
                    out.append("")
            else:
                out.append(results[idx])
        if return_errors:
            return out, errors
        return out
