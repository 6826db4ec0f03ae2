"""Memorization: the port's training path must learn five spoken words by heart.

Counterpart of tests/test_overfit.py (the JAX package's): five 0.5 s tones
with the transcripts "bir", "iki", "üç", "dört", "beş", a model of d_model
64, 2 heads, 2 blocks (dropout 0, the char tokenizer's 56 classes),
AdamW at a constant 3e-3 (weight decay 1e-6, no clipping), 300 full-batch
steps of the CTC loss with BatchNorm in train mode. The loss must end
below 0.1 and greedy decoding must give the five words back.

    python -m turkish_asr_torch.scripts.overfit [--device cuda|cpu] [--dtype bf16|fp32]

prints one JSON line (first and final loss, texts, seconds, the card's
name) and exits non-zero when the words are not memorized. On the card the
steps run the attention and CTC kernels; tests/test_torch_overfit.py runs
it on the CPU.
"""

import argparse
import json
import math
import sys
import time

import numpy as np
import torch

WORDS = ("bir", "iki", "üç", "dört", "beş")
SR = 16000
STEPS = 300


def memorize(device="cuda", compute_dtype=torch.float32, steps=STEPS, lr=3e-3):
    """Train on the five words; returns {"first_loss", "final_loss",
    "texts", "seconds"}."""
    from turkish_asr_torch.audio.features import log_mel_spectrogram
    from turkish_asr_torch.data.tokenizer import CharTokenizer
    from turkish_asr_torch.decode.greedy import GreedyDecoder
    from turkish_asr_torch.models.conformer import ModelConfig, init_model
    from turkish_asr_torch.ops.ctc import ctc_loss
    from turkish_asr_torch.train.optim import ClippedAdamW
    from turkish_asr_torch.utils.device import resolve_device

    device = resolve_device(device)
    tok = CharTokenizer()
    rng = np.random.default_rng(0)
    B, S = len(WORDS), SR // 2
    t = np.arange(S) / SR
    wav = np.stack([0.3 * np.sin(2 * np.pi * (200 + 150 * i) * t) + 0.01 * rng.standard_normal(S)
                    for i in range(B)]).astype(np.float32)
    ids = [tok.encode(w) for w in WORDS]
    targets = np.zeros((B, max(map(len, ids))), np.int32)
    for i, row in enumerate(ids):
        targets[i, :len(row)] = row
    tg = torch.from_numpy(targets).to(device)
    tl = torch.tensor([len(row) for row in ids], dtype=torch.int32, device=device)

    cfg = ModelConfig(n_mels=80, d_model=64, n_heads=2, n_blocks=2, n_classes=tok.vocab_size,
                      dropout=0.0)
    model = init_model(cfg, torch.Generator().manual_seed(0)).to(device)
    params = [p for p in model.parameters() if p.requires_grad]
    opt = ClippedAdamW(params, lambda count: lr, 1e-6, gradient_clip=math.inf)
    feats, fl = log_mel_spectrogram(torch.from_numpy(wav).to(device),
                                    torch.full((B,), S, dtype=torch.int32, device=device))
    start = time.perf_counter()
    losses = []
    for _ in range(steps):
        logits, bn = model(feats, fl, compute_dtype, train=True)
        lp = torch.log_softmax(logits.float(), dim=-1)
        loss = ctc_loss(lp, tg, fl // 4, tl)
        opt.update(torch.autograd.grad(loss, params))
        model.commit_batch_norm(bn)
        losses.append(loss.detach())
    with torch.no_grad():
        logits = model(feats, fl, compute_dtype)
    texts = GreedyDecoder(tok).decode_batch(logits.float(), fl // 4)
    if device.type == "cuda":
        torch.cuda.synchronize()
    return {"first_loss": losses[0].item(), "final_loss": losses[-1].item(), "texts": texts,
            "seconds": time.perf_counter() - start}


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--device", default="cuda", help="cuda or cpu; no fallback")
    parser.add_argument("--dtype", default="bf16", choices=("bf16", "fp32"))
    args = parser.parse_args(argv)
    dtype = torch.bfloat16 if args.dtype == "bf16" else torch.float32
    result = memorize(args.device, dtype)
    result["device"] = (torch.cuda.get_device_name(0) if args.device.startswith("cuda")
                        else "cpu")
    print(json.dumps(result, ensure_ascii=False))
    if not (result["final_loss"] < 0.1 and result["texts"] == list(WORDS)):
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
