"""Batch transcription of a configuration that brings its own weights
layout and reference: ``drivers/transcribe.py``'s ``Driver``, loaded by
name, with the checkpoint it writes and the reference logits it checks
against taken from the modules the configuration names (``"weights"``: a
module with ``make_state_dict``; ``"reference"``: a module with
``logits_of``, both as paths under the checkout).

The pool, the warm-up, the closed loop, the traced stretches and the
sample of answers checked are that driver's. The check adds a second
number to ``text_gap``: ``logit_err``, the program's logits of the checked
files against the reference's. They are taken after the window, before
the program is freed, through the program's batched forward at the cell's
batch size (``ASRInference._forward_batch``, which ``transcribe_files``
calls). ``text_gap`` reads the served texts only where a frame's best
labels nearly tie, so it moves with the tail of the logits' error; the
logits' whole error moves ``logit_err`` (PERF.md section 2).
"""

import importlib
import os

import numpy as np

from asr_bench import common
from asr_bench.reference import judge
from asr_bench.reference.bpe import Vocabulary
from asr_bench.served import buckets_of, sample

_base = common.load_module("drivers", "transcribe")


def module_of(cfg, key):
    """The module at the configuration's ``key`` path (``asr_bench/x/y.py``)."""
    return importlib.import_module(cfg[key].removesuffix(".py").replace("/", "."))


def write_checkpoint(cfg, seed, device, path):
    """The seeded, served weights as a reference-format ``.pt``."""
    import torch

    sd = module_of(cfg, "weights").make_state_dict(cfg, seed, device, served=True)
    blob = {k: (v.to(torch.bfloat16) if v.is_floating_point() else v).cpu()
            for k, v in sd.items()}
    with open(path, "wb") as f:
        torch.save({"model_state_dict": blob,
                    "config": {"n_heads": cfg["n_heads"], "n_mel_channels": cfg["n_mels"]}}, f)
        f.flush()
        os.fsync(f.fileno())


def program_logits(asr, pcms, batch_size):
    """The program's (valid frames, V) float32 logits of each clip: the
    clips of a bucket padded to it, ``batch_size`` rows a forward, as
    ``transcribe_files`` batches them."""
    out = [None] * len(pcms)
    for S, idx in sorted(buckets_of(pcms).items()):
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


def logit_err(got, ref):
    """The root-mean-square of ``got - ref`` ((T, V) logits, each frame
    less its mean over the classes, which no decoding sees) as a share of
    the root-mean-square of ``ref`` so centred."""
    got, ref = got.double(), ref.double()
    got = got - got.mean(dim=-1, keepdim=True)
    ref = ref - ref.mean(dim=-1, keepdim=True)
    return float((got - ref).pow(2).mean().sqrt() / ref.pow(2).mean().sqrt())


class Driver(_base.Driver):
    def chosen(self):
        """The (pool index, served text) of each answer checked: the flagship
        driver's sample, the longest file among them."""
        done = [(i, t) for idx, texts in self.calls for i, t in zip(idx, texts)]
        longest = max(range(len(done)), key=lambda j: len(self.pool[done[j][0]]))
        return [done[j] for j in sample(len(done), self.cell.mix["check_files"], longest,
                                        self.cell.seed)]

    def release(self):
        if self.calls:
            self.logits = program_logits(self.asr, [self.pool[i] for i, _ in self.chosen()],
                                         self.cell.mix["batch_size"])
        super().release()

    def check(self, precision="fp32"):
        """``text_gap`` and ``logit_err`` of the answers checked, each the
        largest over them, against the reference's fp32 logits; with another
        ``precision`` (the control) the reference in that precision takes
        the program's place: its greedy texts and its logits."""
        cfg, chosen = self.cell.config, self.chosen()
        vocab = Vocabulary.of(cfg)
        sd = module_of(cfg, "weights").make_state_dict(cfg, self.cell.seed, self.device,
                                                        served=True)
        reference = module_of(cfg, "reference")
        waves = [self.pool[i].astype(np.float32) / 32768.0 for i, _ in chosen]
        ref = reference.logits_of(sd, cfg, waves, "fp32", self.device)
        texts, logits = [t for _, t in chosen], self.logits
        if precision != "fp32":
            logits = reference.logits_of(sd, cfg, waves, precision, self.device)
            texts = [vocab.greedy_text(lg.numpy()) for lg in logits]
        gaps = [judge.text_gap(r.numpy(), t, vocab) for r, t in zip(ref, texts)]
        errs = [logit_err(g, r) for g, r in zip(logits, ref)]
        return [("text_gap", float(max(gaps))), ("logit_err", float(max(errs)))]


_base.write_checkpoint = write_checkpoint
