"""Batch transcription: ``ASRInference.transcribe_files(paths,
batch_size)`` in a closed loop, greedy.

Set-up writes the seeded weights to a ``.pt`` and the mix's pool of WAV
files under ``TMPDIR``, loads ``ASRInference`` (one replica) and warms every
bucket the pool's lengths fall in at the batch size. The window makes one
call after another, each on ``paths_per_call`` files drawn from the pool
by the seed, until ``--seconds`` have passed; the rate is the audio seconds
of the calls completed over the time they took.

The check: a sample of the files transcribed, drawn from the seed with the
longest among them, against the reference's logits of the same files.
"""

import os
import shutil
import tempfile
import time

from asr_bench import traffic
from asr_bench.served import reference_gaps, sample, vocabulary_path, warm, write_checkpoint
from asr_bench.trace import CLEAN_SHARE, STRETCHES, attention_attrs

SR = 16000


class Driver:
    def __init__(self, cell):
        self.cell = cell
        self.device = getattr(cell, "device", "cuda")
        self.attempted = self.failed = 0

    def setup(self):
        cell, cfg, mix = self.cell, self.cell.config, self.cell.mix
        self.tmp = tempfile.mkdtemp(prefix="asr_bench_transcribe_")
        model = os.path.join(self.tmp, "model.pt")
        write_checkpoint(cfg, cell.seed, self.device, model)
        self.pool = traffic.clip_pool(mix, cell.seed)
        self.paths = []
        for i, pcm in enumerate(self.pool):
            path = os.path.join(self.tmp, f"clip_{i:04d}.wav")
            traffic.write_file(path, traffic.wav_bytes(pcm))
            self.paths.append(path)
        traffic.flush_to_disk()
        from turkish_asr_torch.inference import ASRInference

        self.asr = ASRInference(model, n_heads=cfg["n_heads"], device=self.device,
                                data_parallel=False, tokenizer_path=vocabulary_path(cfg))
        warm(self.asr, self.pool, self.tmp, mix["batch_size"])
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
            import turkish_asr_torch.ops.flash_attention as fa

            cell.spans.wrap(fa, "_fwd", "attn_fwd", attention_attrs)

    def window(self):
        """Calls until ``--seconds`` have passed. Traced, the first
        ``CLEAN_SHARE`` of the window feeds the host-side metrics and the
        profiler then takes ``STRETCHES`` stretches of one call each."""
        cell, mix = self.cell, self.cell.mix
        per_call = mix["paths_per_call"]
        profile = None
        if cell.trace:
            from asr_bench.trace import Profile
            profile = cell.profile = Profile(cell.spans)
        self.calls = []
        audio, stream, clean = 0, 0, None
        t0 = cell.window_start = time.perf_counter()
        while (time.perf_counter() - t0 < cell.seconds
               or (profile and len(profile._done) < STRETCHES)):
            tracing = (profile is not None and len(profile._done) < STRETCHES
                       and time.perf_counter() - t0 >= CLEAN_SHARE * cell.seconds)
            if tracing:
                if clean is None:
                    clean = (time.perf_counter() - t0, len(self.calls))
                profile.start()
            idx = traffic.choices(len(self.pool), per_call, cell.seed, stream=100 + stream)
            stream += 1
            texts, errors = self.asr.transcribe_files([self.paths[i] for i in idx],
                                                      batch_size=mix["batch_size"],
                                                      return_errors=True)
            self.calls.append((idx, texts))
            self.failed += sum(e is not None for e in errors)
            audio += sum(len(self.pool[i]) for i in idx)
            if tracing:
                profile.stop()
        self.window_s = time.perf_counter() - t0
        self.audio_s = audio / SR
        self.attempted = sum(len(c[0]) for c in self.calls)
        if profile is not None:
            window_s, n = clean
            cell.stats.update(window_s=window_s, utterance_samples=[
                len(self.pool[i]) for c in self.calls[:n] for i in c[0]])

    def end_to_end(self):
        return {"transcribe_audio_s_per_s": self.audio_s / self.window_s}

    def release(self):
        self.asr = None
        shutil.rmtree(self.tmp, ignore_errors=True)

    def check(self, precision="fp32"):
        done = [(i, t) for idx, texts in self.calls for i, t in zip(idx, texts)]
        longest = max(range(len(done)), key=lambda j: len(self.pool[done[j][0]]))
        chosen = [done[j] for j in sample(len(done), self.cell.mix["check_files"], longest,
                                          self.cell.seed)]
        gaps = reference_gaps(self.cell.config, self.cell.seed,
                              [self.pool[i] for i, _ in chosen], [t for _, t in chosen],
                              self.device, precision)
        return [("text_gap", float(max(gaps)))]
