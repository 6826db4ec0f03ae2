"""What the drivers of served cells share: the seeded checkpoint, the
warm-up of a cell's buckets, the sample of answers checked, and their
gaps to the reference.
"""

import os

import numpy as np

from asr_bench import traffic
from asr_bench.reference import conformer_ctc, judge
from asr_bench.reference.bpe import ROOT, Vocabulary
from asr_bench.weights import make_state_dict


def vocabulary_path(cfg):
    """The configuration's vocabulary file, which the program loads as its
    tokenizer and the reference reads."""
    return str(ROOT / cfg["vocabulary"])


def write_checkpoint(cfg, seed, device, path):
    """The seeded, served weights as a reference-format ``.pt``."""
    import torch

    sd = make_state_dict(cfg, seed, device, served=True)
    blob = {k: (v.to(torch.bfloat16) if v.is_floating_point() else v).cpu()
            for k, v in sd.items()}
    with open(path, "wb") as f:
        torch.save({"model_state_dict": blob,
                    "config": {"n_heads": cfg["n_heads"], "n_mel_channels": cfg["n_mels"]}}, f)
        f.flush()
        os.fsync(f.fileno())


def buckets_of(pcms):
    """{bucket: indices of the clips in it}."""
    out = {}
    for i, p in enumerate(pcms):
        out.setdefault(conformer_ctc.bucket(len(p)), []).append(i)
    return out


def warm(asr, pcms, tmp, batch_size, rounds=2):
    """Every bucket of ``pcms`` through ``transcribe_files`` at
    ``batch_size`` rows, ``rounds`` times."""
    for S, idx in sorted(buckets_of(pcms).items()):
        paths = []
        for j in range(batch_size):
            path = os.path.join(tmp, f"warm_{S}_{j}.wav")
            traffic.write_file(path, traffic.wav_bytes(pcms[idx[j % len(idx)]]))
            paths.append(path)
        for _ in range(rounds):
            asr.transcribe_files(paths, batch_size=batch_size)
        for p in paths:
            os.unlink(p)


def reference_gaps(cfg, seed, pcms, texts, device, precision="fp32"):
    """text_gap of each served text against the reference's logits of its
    clip; with another ``precision`` (the control) the texts are ignored
    and the reference's greedy text in that precision is judged instead."""
    vocab = Vocabulary.of(cfg)
    sd = make_state_dict(cfg, seed, device, served=True)
    waves = [p.astype(np.float32) / 32768.0 for p in pcms]
    ref = conformer_ctc.logits_of(sd, cfg, waves, "fp32", device)
    if precision != "fp32":
        low = conformer_ctc.logits_of(sd, cfg, waves, precision, device)
        texts = [vocab.greedy_text(lg.numpy()) for lg in low]
    return [judge.text_gap(r.numpy(), t, vocab) for r, t in zip(ref, texts)]


def sample(n, count, longest, seed):
    """``count`` of ``n`` indices drawn from the seed, ``longest`` among them."""
    rng = traffic.rng_of(seed, 9)
    rest = [i for i in rng.permutation(n).tolist() if i != longest]
    return [longest] + rest[:max(count - 1, 0)]
