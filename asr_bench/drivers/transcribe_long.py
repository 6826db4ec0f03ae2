"""Batch transcription of long recordings, each run whole: the
``transcribe_by_config`` driver with the program's ``full_context_s`` (the
mix's), for a configuration served past 32 s in one pass (FastConformer
XXL, Parakeet-CTC 1.1B).

Set-up checks first that the program takes ``full_context_s`` (a tree
without it fails at once), then writes the seeded weights as a ``.pt``
(``transcribe_by_config.write_checkpoint``), the pool of WAV files, loads
``ASRInference(..., full_context_s=mix["full_context_s"])`` and warms every
bucket the pool's lengths fall in at the batch size. The long buckets are this driver's own
copy of the program's rule (``reference/fastconformer_xxl.long_bucket``:
32 s steps past 32 s): the harness imports nothing of the program but its
recorder. The window, the traced stretches and the check (``text_gap`` and
``logit_err`` of a sample of the files transcribed, the longest among them,
against the reference, which runs each file whole at its long bucket) are
``transcribe_by_config``'s; the program's logits of the checked files are
taken after the window at their long buckets.
"""

import inspect
import os
import tempfile

import numpy as np

from asr_bench import common, traffic
from asr_bench.reference.fastconformer_xxl import long_bucket
from asr_bench.served import vocabulary_path

_by_config = common.load_module("drivers", "transcribe_by_config")
_base = _by_config._base


def buckets_of(pcms, full_context_s):
    """{bucket: indices of the clips in it}, at the long buckets."""
    out = {}
    for i, p in enumerate(pcms):
        out.setdefault(long_bucket(len(p), full_context_s), []).append(i)
    return out


def program_logits(asr, pcms, batch_size, full_context_s):
    """The program's (valid frames, V) float32 logits of each clip, padded
    to its long bucket, ``batch_size`` rows a forward, as
    ``transcribe_files`` batches them."""
    out = [None] * len(pcms)
    for S, idx in sorted(buckets_of(pcms, full_context_s).items()):
        for j in range(0, len(idx), batch_size):
            part = idx[j:j + batch_size]
            wav = np.zeros((len(part), S), np.float32)
            for r, i in enumerate(part):
                wav[r, :len(pcms[i])] = pcms[i].astype(np.float32) / 32768.0
            lengths = np.asarray([len(pcms[i]) for i in part], np.int32)
            logits, frames = asr._forward_batch(wav, lengths)
            for r, i in enumerate(part):
                out[i] = logits[r, :int(frames[r])].float().cpu()
    return out


def warm(asr, pcms, tmp, batch_size, full_context_s, rounds=2):
    """Every long bucket of ``pcms`` through ``transcribe_files`` at
    ``batch_size`` rows, ``rounds`` times."""
    for S, idx in sorted(buckets_of(pcms, full_context_s).items()):
        paths = []
        for j in range(batch_size):
            path = os.path.join(tmp, f"warm_{S}_{j}.wav")
            traffic.write_file(path, traffic.wav_bytes(pcms[idx[j % len(idx)]]))
            paths.append(path)
        for _ in range(rounds):
            asr.transcribe_files(paths, batch_size=batch_size)
        for p in paths:
            os.unlink(p)


class Driver(_by_config.Driver):
    def setup(self):
        from turkish_asr_torch.inference import ASRInference

        if "full_context_s" not in inspect.signature(ASRInference).parameters:
            raise RuntimeError("the program's ASRInference takes no full_context_s: it cannot "
                               "run files past 32 s whole")
        cell, cfg, mix = self.cell, self.cell.config, self.cell.mix
        full = mix["full_context_s"]
        self.tmp = tempfile.mkdtemp(prefix="asr_bench_transcribe_long_")
        model = os.path.join(self.tmp, "model.pt")
        _by_config.write_checkpoint(cfg, cell.seed, self.device, model)
        self.pool = traffic.clip_pool(mix, cell.seed)
        self.paths = []
        for i, pcm in enumerate(self.pool):
            path = os.path.join(self.tmp, f"clip_{i:04d}.wav")
            traffic.write_file(path, traffic.wav_bytes(pcm))
            self.paths.append(path)
        traffic.flush_to_disk()
        self.asr = ASRInference(model, n_heads=cfg["n_heads"], device=self.device,
                                data_parallel=False, tokenizer_path=vocabulary_path(cfg),
                                full_context_s=full)
        warm(self.asr, self.pool, self.tmp, mix["batch_size"], full)
        if getattr(cell, "fault", None) is not None:
            cell.fault(self.asr)
        if cell.trace:
            cell.stats["samples"] = cell.stats["padded"] = 0

            def forward_attrs(wav, lens):
                if not cell.spans.tracing:
                    cell.stats["samples"] += int(lens.sum())
                    cell.stats["padded"] += int(wav.shape[0] * wav.shape[1])
                return {"B": wav.shape[0], "S": wav.shape[1]}

            cell.spans.wrap(self.asr, "_forward_batch", "forward_batch", forward_attrs)

    def release(self):
        if self.calls:
            self.logits = program_logits(self.asr, [self.pool[i] for i, _ in self.chosen()],
                                         self.cell.mix["batch_size"],
                                         self.cell.mix["full_context_s"])
        _base.Driver.release(self)
