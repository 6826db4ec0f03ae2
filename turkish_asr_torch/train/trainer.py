"""CTC trainer on one device.

Counterpart of turkish_asr_tpu/train/trainer.py (:42-629). One train step
runs on the device from the padded waveform batch: log-mel, SpecAugment
(``--augment``), the Conformer in train mode (dropout, BatchNorm batch
statistics, per-block recomputation), log-softmax, CTC (the CUDA kernels
on the card), backward, then

- the NaN/Inf skip, on the loss and on the gradient norm (a non-finite
  activation in a masked-out sample gives a finite loss but NaN gradients
  through 0 * NaN): a skipped step leaves the parameters, the optimizer
  state and the BatchNorm statistics untouched;
- clip -> AdamW on the OneCycle schedule, accumulated over
  ``accumulation_steps`` micro-batches (``train/optim.py``), with the
  epoch-end flush of a partial window;
- ``global_step`` read from the optimizer's own count.

The loss is the reference's: per-sample CTC over ``frame_lengths // 4``
frames, divided by the target length, averaged over ``sample_mask``.
Validation computes the same loss in eval mode and WER/CER from the greedy
collapse with the tokenizer's ``pad_token_id`` as blank (the loss's blank
is 0). Checkpoints are the reference's ``.pt`` (``train/checkpoint.py``).

Dropout and SpecAugment draw from seeds derived from (--seed, epoch,
batch), not from a generator that advances, so a step is a pure function
of its inputs and a resumed run continues bit for bit.
"""

import math
import os
import time

import torch

from turkish_asr_torch.audio.augment import spec_augment_batch
from turkish_asr_torch.audio.features import log_mel_spectrogram
from turkish_asr_torch.decode.greedy import greedy_collapse_batch
from turkish_asr_torch.models.conformer import derive_seed
from turkish_asr_torch.ops.ctc import ctc_loss
from turkish_asr_torch.train.checkpoint import (
    latest_checkpoint, load_checkpoint_file, save_checkpoint_file)
from turkish_asr_torch.train.optim import MultiSteps
from turkish_asr_torch.utils.metrics import ASRMetrics

SEED_AUGMENT, SEED_DROPOUT = 0, 1


class Trainer:
    """Turkish ASR trainer on one device."""

    def __init__(self, model, optimizer, schedule, config, logger, tokenizer=None,
                 train_loader=None, valid_loader=None, device="cuda", accumulation_steps=1,
                 compute_dtype=torch.bfloat16, augment=False):
        self.device = torch.device(device)
        self.model = model.to(self.device)
        self.cfg = model.cfg
        self.params = [p for p in self.model.parameters() if p.requires_grad]
        self.optimizer = optimizer
        self.schedule = schedule
        self.config = config
        self.logger = logger
        self.tokenizer = tokenizer
        self.train_loader = train_loader
        self.valid_loader = valid_loader
        self.accumulation_steps = accumulation_steps
        self.compute_dtype = compute_dtype
        self.augment = augment
        self.remat = not getattr(config, "no_remat", False)
        self.metrics = ASRMetrics(tokenizer) if tokenizer else None
        if not tokenizer:
            logger.warning("Tokenizer not provided! WER/CER calculation disabled.")
        self.blank = int(getattr(tokenizer, "pad_token_id", 0) or 0) if tokenizer else 0
        self.start_epoch = 1
        self.best_val_loss = float("inf")
        self.global_step = 0
        self.losses = []  # every train step's loss, in order (NaN for a skipped step)

    # ------------------------------------------------------------------
    # steps
    # ------------------------------------------------------------------
    def _to_device(self, batch):
        return {k: torch.as_tensor(v).to(self.device, non_blocking=True)
                for k, v in batch.items()}

    def _loss(self, batch, train, seed=None):
        """(loss, new BatchNorm state or None, logits, frame_lengths)."""
        feats, frame_lengths = log_mel_spectrogram(batch["waveforms"], batch["wav_lengths"],
                                                   n_mels=self.cfg.n_mels)
        if train:
            if self.augment:
                gen = torch.Generator(device=self.device)
                gen.manual_seed(derive_seed(seed, SEED_AUGMENT))
                feats = spec_augment_batch(
                    feats, gen, frame_lengths,
                    freq_mask_param=getattr(self.config, "spec_augment_freq", 27),
                    time_mask_param=getattr(self.config, "spec_augment_time", 100))
            logits, bn_state = self.model(feats, frame_lengths, self.compute_dtype, train=True,
                                          seed=derive_seed(seed, SEED_DROPOUT),
                                          remat=self.remat)
        else:
            logits, bn_state = self.model(feats, frame_lengths, self.compute_dtype), None
        log_probs = torch.log_softmax(logits.float(), dim=-1)
        per_sample = ctc_loss(log_probs, batch["targets"], frame_lengths // 4,
                              batch["target_lengths"], reduction="none")
        per_sample = per_sample / batch["target_lengths"].clamp(min=1)
        mask = batch["sample_mask"]
        loss = (per_sample * mask).sum() / mask.sum().clamp(min=1.0)
        return loss, bn_state, logits, frame_lengths

    def train_step(self, batch, seed):
        """One micro-step on a collated batch; returns the loss (a float,
        non-finite for a skipped step)."""
        loss, bn_state, _, _ = self._loss(self._to_device(batch), True, seed)
        grads = torch.autograd.grad(loss, self.params, allow_unused=True)
        grads = [torch.zeros_like(p) if g is None else g for p, g in zip(self.params, grads)]
        grad_norm_sq = sum(torch.sum(g.float() ** 2) for g in grads)
        bad = ~torch.isfinite(loss) | ~torch.isfinite(grad_norm_sq)
        if not bool(bad):
            self.optimizer.update(grads)
            self.model.commit_batch_norm(bn_state)
        return loss.item()

    def flush_accumulation(self):
        """Apply a partial accumulation window at epoch end: the diluted
        partial mean, one schedule step (JAX ``flush_accumulation``)."""
        if isinstance(self.optimizer, MultiSteps) and self.optimizer.flush():
            self.sync_global_step()

    def sync_global_step(self):
        self.global_step = self.optimizer.step_count

    # ------------------------------------------------------------------
    # checkpoints
    # ------------------------------------------------------------------
    def save_checkpoint(self, epoch, name=None):
        self.sync_global_step()
        ckpt_dir = self.config.checkpoint_dir
        os.makedirs(ckpt_dir, exist_ok=True)
        payload = {
            "model_state_dict": self.model.state_dict(),
            "config": {k: v for k, v in vars(self.config).items()
                       if isinstance(v, (int, float, str, bool, type(None)))},
            "model_config": {"n_mels": self.cfg.n_mels, "d_model": self.cfg.d_model,
                             "n_heads": self.cfg.n_heads, "n_blocks": self.cfg.n_blocks,
                             "n_classes": self.cfg.n_classes, "dropout": self.cfg.dropout,
                             "masked_norm": self.cfg.masked_norm, "use_mqa": self.cfg.use_mqa},
            "epoch": int(epoch),
            "global_step": int(self.global_step),
            "best_val_loss": float(self.best_val_loss),
            "optimizer_state_dict": self.optimizer.state_dict(),
            "scheduler_state_dict": {"step": int(self.global_step)},
        }
        path = os.path.join(ckpt_dir, name or f"checkpoint_epoch_{epoch}.pt")
        save_checkpoint_file(path, payload)
        self.logger.info(f"Checkpoint saved: {path}")

    def load_checkpoint(self):
        if not getattr(self.config, "resume", False):
            return
        path = latest_checkpoint(self.config.checkpoint_dir)
        if path is None:
            self.logger.warning("No checkpoint found! Starting from scratch.")
            return
        self.logger.info(f"Resuming from: {path}")
        ckpt = load_checkpoint_file(path)
        # The vocabulary guard comes before any state is restored, so a
        # tokenizer swap is named as such, not as a shape error.
        n_classes = (ckpt.get("model_config") or {}).get("n_classes")
        if n_classes is not None and int(n_classes) != self.cfg.n_classes:
            raise ValueError(
                f"Checkpoint/model vocabulary mismatch on resume: {path} has "
                f"n_classes={int(n_classes)} but the current tokenizer/model uses "
                f"n_classes={self.cfg.n_classes}. Use the tokenizer the run started with.")
        self.model.load_state_dict(ckpt["model_state_dict"], strict=True)
        if "optimizer_state_dict" in ckpt:
            self.optimizer.load_state_dict(ckpt["optimizer_state_dict"])
        self.start_epoch = int(ckpt.get("epoch", 0)) + 1
        self.global_step = int(ckpt.get("global_step", 0))
        self.best_val_loss = float(ckpt.get("best_val_loss", float("inf")))
        self.logger.info(f"Loaded checkpoint. Resuming from Epoch {self.start_epoch}")

    # ------------------------------------------------------------------
    # loops
    # ------------------------------------------------------------------
    def train_epoch(self, epoch):
        epoch_loss, num_batches = 0.0, 0
        start_time = time.time()
        for batch_idx, batch in enumerate(self.train_loader):
            if batch is None:
                continue
            loss = self.train_step(batch, derive_seed(self.config.seed, epoch, batch_idx))
            self.losses.append(loss)
            if math.isfinite(loss):
                epoch_loss += loss
                num_batches += 1
            else:
                self.logger.warning(f"Epoch {epoch}, Batch {batch_idx}: NaN loss, skipping...")
            if (batch_idx + 1) % self.config.log_interval == 0:
                self.sync_global_step()
                self.logger.info(
                    f"Epoch [{epoch}/{self.config.epochs}] "
                    f"Batch [{batch_idx + 1}/{len(self.train_loader)}] "
                    f"Loss: {loss:.4f} LR: {self.schedule(self.global_step):.2e}")
        self.flush_accumulation()
        self.sync_global_step()
        avg_loss = epoch_loss / max(num_batches, 1)
        self.logger.info(f"Epoch {epoch} Complete | Loss: {avg_loss:.4f} | "
                         f"Time: {time.time() - start_time:.1f}s")
        return avg_loss

    @torch.no_grad()
    def validate(self, epoch):
        if not self.valid_loader:
            return None
        val_loss, total_wer, total_cer, num_batches = 0.0, 0.0, 0.0, 0
        example_preds, example_targets = [], []
        for batch in self.valid_loader:
            if batch is None:
                continue
            n_valid = int(batch["sample_mask"].sum())
            loss, _, logits, frame_lengths = self._loss(self._to_device(batch), False)
            val_loss += loss.item()
            if self.metrics:
                ids, counts = greedy_collapse_batch(logits, frame_lengths // 4,
                                                    blank_id=self.blank)
                result, preds, targs = self.metrics.compute_from_ids(
                    ids[:n_valid].cpu().numpy(), counts[:n_valid].cpu().numpy(),
                    batch["targets"][:n_valid])
                total_wer += result["wer"]
                total_cer += result["cer"]
                if num_batches == 0:
                    example_preds, example_targets = preds[:2], targs[:2]
            num_batches += 1
        if num_batches == 0:
            self.logger.warning("Validation produced no batches; skipping.")
            return None
        avg_val_loss = val_loss / num_batches
        self.logger.info(f"Epoch {epoch} Validation | Loss: {avg_val_loss:.4f} | "
                         f"WER: {total_wer / num_batches:.2%} | CER: {total_cer / num_batches:.2%}")
        if example_preds:
            self.logger.info(f"  Pred: {example_preds[0]}")
            self.logger.info(f"  True: {example_targets[0]}")
        return avg_val_loss

    def fit(self):
        self.logger.info("=" * 60)
        self.logger.info("Starting Training")
        self.logger.info("=" * 60)
        self.load_checkpoint()
        if self.start_epoch > self.config.epochs:
            self.logger.info("Training already completed.")
            return
        self.logger.info(f"Epochs: {self.start_epoch} -> {self.config.epochs}")
        self.logger.info(f"Gradient Clipping: {self.config.gradient_clip}")
        self.logger.info(f"Accumulation Steps: {self.accumulation_steps}")
        self.logger.info(f"Device: {self.device}")
        self.logger.info("=" * 60)
        for epoch in range(self.start_epoch, self.config.epochs + 1):
            self.train_epoch(epoch)
            val_loss = self.validate(epoch)
            if epoch % self.config.save_interval == 0:
                self.save_checkpoint(epoch)
            if val_loss is not None and val_loss < self.best_val_loss:
                self.best_val_loss = val_loss
                self.save_checkpoint(epoch, name="best_model.pt")
        self.save_checkpoint(self.config.epochs, name=self.config.output_model_path)
        self.logger.info("=" * 60)
        self.logger.info("Training Complete!")
        self.logger.info("=" * 60)
