"""CTC trainer on one device, or on one rank of a mesh of processes.

Counterpart of turkish_asr_tpu/train/trainer.py (:42-629). One train step
runs on the device from the padded waveform batch: log-mel, SpecAugment
(``--augment``), the Conformer in train mode (dropout, BatchNorm batch
statistics, per-block recomputation: ``--remat_policy full`` or ``dots``,
off with ``--no_remat``), log-softmax, CTC (the CUDA kernels on the card),
backward, then

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
is 0). Checkpoints are the reference's ``.pt`` (``train/checkpoint.py``);
``--resume`` also continues from the JAX trainer's ``.ckpt``: the
parameters, BatchNorm state, Adam moments and counts, and MultiSteps'
window (``utils/weights.restore_optimizer_from_named``), or, for a file
without optimizer state, the JAX step-offset rule. ``--profile_dir``
traces the first ``PROFILE_BATCHES`` batches of the start epoch
(``utils/runtime.py``), as the JAX trainer does.

Dropout and SpecAugment draw from seeds derived from (--seed, epoch,
batch), not from a generator that advances, so a step is a pure function
of its inputs and a resumed run continues bit for bit.

On a mesh (``mesh``, with the model sharded by ``parallel/mesh.shard_model``)
each data rank holds its slice of the global batch and the step equals the
one-process step on the global batch:

- the model and seq ranks of a data line take the batch of its first rank
  (``parallel/collectives.broadcast_``), so their activations agree
  whatever their loaders drew;
- every data rank pads its waveforms to the longest rank's length, as the
  one-process batch is padded;
- the loss is the local ``sum(per_sample * mask)`` over the global
  ``sum(mask)`` (all-reduced over "data"): a mean of local means would be
  wrong whenever ranks hold different numbers of valid samples;
- the gradients are summed over the (data, seq) ranks in flat buckets
  after ``torch.autograd.grad`` (DistributedDataParallel's hooks fire on
  ``.grad`` accumulation, which ``autograd.grad`` bypasses);
- the NaN/Inf skip reads the all-reduced loss and the global gradient
  norm (``parallel/mesh.grad_sq_norm``, which the clip reads too), so
  every rank takes the same decision;
- validation's loss is global; WER/CER are averaged over the data ranks,
  as the JAX trainer does (:576-587);
- a checkpoint holds the full state, gathered over "model", written by
  rank 0 and followed by a barrier; every rank reads it and takes its
  shard, so a run resumes on another mesh.
"""

import math
import os
import time

import torch
import torch.nn.functional as F

from turkish_asr_torch.audio.augment import spec_augment_batch
from turkish_asr_torch.audio.features import log_mel_spectrogram
from turkish_asr_torch.decode.greedy import greedy_collapse_batch
from turkish_asr_torch.models.conformer import ConformerCTC, derive_seed
from turkish_asr_torch.ops.ctc import ctc_loss
from turkish_asr_torch.parallel.collectives import all_reduce_, broadcast_
from turkish_asr_torch.parallel.mesh import (
    axis_group, barrier, gather_state_dict, grad_sq_norm, shard_seed, shard_state_dict)
from turkish_asr_torch.train.checkpoint import (
    gather_optimizer_state, latest_checkpoint, load_checkpoint_file, load_jax_checkpoint_file,
    save_checkpoint_file, shard_optimizer_state)
from turkish_asr_torch.train.optim import MultiSteps, make_optimizer
from turkish_asr_torch.utils.metrics import ASRMetrics
from turkish_asr_torch.utils.runtime import start_profiler_trace, stop_profiler_trace
from turkish_asr_torch.utils.weights import (
    default_model_state, restore_optimizer_from_named, state_dict_from_jax, trainable_names)

SEED_AUGMENT, SEED_DROPOUT = 0, 1
PROFILE_BATCHES = 20  # the JAX trainer's traced window


class Trainer:
    """Turkish ASR trainer on one device, or on one rank of ``mesh``."""

    def __init__(self, model, optimizer, schedule, config, logger, tokenizer=None,
                 train_loader=None, valid_loader=None, device="cuda", accumulation_steps=1,
                 compute_dtype=torch.bfloat16, augment=False, mesh=None, attn_kernel=True):
        if model.mesh is not mesh:
            raise ValueError("the model is not sharded for this mesh "
                             "(parallel.mesh.shard_model(model, mesh) first)")
        self.device = torch.device(device)
        self.model = model.to(self.device)
        self.cfg = model.cfg
        self.params = [p for p in self.model.parameters() if p.requires_grad]
        self.names = trainable_names(self.model)
        self.mesh = mesh
        self.rank = 0 if mesh is None else mesh.rank
        self.data = axis_group(mesh, "data")
        self.line = axis_group(mesh, "model", "seq")
        self.grad_group = axis_group(mesh, "data", "seq")
        if mesh is not None:  # the clip's norm, and the skip's, of the full gradient
            adam = optimizer.inner if isinstance(optimizer, MultiSteps) else optimizer
            adam.sq_norm = grad_sq_norm(self.names, mesh)
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
        # False: the attention core's plain version (the bench's kernel-off
        # runs, JAX's attn_kernel=None); nothing else passes it.
        self.attn_kernel = attn_kernel
        self.remat = (False if getattr(config, "no_remat", False)
                      else getattr(config, "remat_policy", "full"))
        self.metrics = ASRMetrics(tokenizer) if tokenizer else None
        if not tokenizer:
            logger.warning("Tokenizer not provided! WER/CER calculation disabled.")
        self.blank = int(getattr(tokenizer, "pad_token_id", 0) or 0) if tokenizer else 0
        self.start_epoch = 1
        self.best_val_loss = float("inf")
        self.global_step = 0
        # A resumed JAX checkpoint without optimizer state carries a
        # global_step but no count: global_step = offset + the count.
        self._step_offset = 0
        self.profile_trace = None  # the last --profile_dir trace file
        self.losses = []  # every train step's loss, in order (NaN for a skipped step)

    # ------------------------------------------------------------------
    # steps
    # ------------------------------------------------------------------
    def _to_device(self, batch):
        out = {k: torch.as_tensor(v).to(self.device, non_blocking=True)
               for k, v in batch.items()}
        if self.line is not None:
            # The model and seq ranks of a data line load the same rows, but
            # a loader's host augmentation draws from a generator its
            # threads share in no fixed order: the line takes its first
            # rank's batch, as JAX's one loader feeds all of a process's devices.
            out = dict(zip(out, broadcast_(list(out.values()), self.line)))
        if self.data is not None:  # the global batch's padded length
            S = out["waveforms"].shape[1]
            longest = all_reduce_([torch.tensor([S], device=self.device)], self.data, "max")[0]
            out["waveforms"] = F.pad(out["waveforms"], (0, int(longest) - S))
        return out

    def _data_sum(self, t):
        """``t`` summed over the data ranks (a new tensor, no autograd)."""
        return all_reduce_([t.detach().clone()], self.data)[0]

    def _loss(self, batch, train, seed=None):
        """(loss, new BatchNorm state or None, logits, frame_lengths)."""
        feats, frame_lengths = log_mel_spectrogram(batch["waveforms"], batch["wav_lengths"],
                                                   n_mels=self.cfg.n_mels)
        if train:
            if self.augment:
                gen = torch.Generator(device=self.device)
                gen.manual_seed(shard_seed(derive_seed(seed, SEED_AUGMENT),
                                           0 if self.mesh is None else self.mesh.index("data")))
                feats = spec_augment_batch(
                    feats, gen, frame_lengths,
                    freq_mask_param=getattr(self.config, "spec_augment_freq", 27),
                    time_mask_param=getattr(self.config, "spec_augment_time", 100))
            logits, bn_state = self.model(feats, frame_lengths, self.compute_dtype, train=True,
                                          seed=derive_seed(seed, SEED_DROPOUT),
                                          remat=self.remat, attn_kernel=self.attn_kernel)
        else:
            logits, bn_state = self.model(feats, frame_lengths, self.compute_dtype,
                                          attn_kernel=self.attn_kernel), None
        log_probs = torch.log_softmax(logits.float(), dim=-1)
        per_sample = ctc_loss(log_probs, batch["targets"], frame_lengths // 4,
                              batch["target_lengths"], reduction="none")
        per_sample = per_sample / batch["target_lengths"].clamp(min=1)
        mask = batch["sample_mask"]
        # This data rank's share of the global batch's mean: summed over
        # the data ranks it is the loss, and its gradients sum likewise.
        loss = (per_sample * mask).sum() / self._data_sum(mask.sum()).clamp(min=1.0)
        return loss, bn_state, logits, frame_lengths

    def train_step(self, batch, seed):
        """One micro-step on a collated batch; returns the loss (a float,
        non-finite for a skipped step)."""
        loss, bn_state, _, _ = self._loss(self._to_device(batch), True, seed)
        grads = torch.autograd.grad(loss, self.params, allow_unused=True)
        grads = [torch.zeros_like(p) if g is None else g for p, g in zip(self.params, grads)]
        all_reduce_(grads, self.grad_group)
        loss = self._data_sum(loss)
        grad_norm_sq = self.optimizer.sq_norm(grads)
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
        self.global_step = self._step_offset + self.optimizer.step_count

    # ------------------------------------------------------------------
    # checkpoints
    # ------------------------------------------------------------------
    def save_checkpoint(self, epoch, name=None):
        """Every rank calls it; rank 0 writes the full state."""
        self.sync_global_step()
        model_state = gather_state_dict(self.model.state_dict(), self.mesh)
        optimizer_state = gather_optimizer_state(self.optimizer.state_dict(), self.names,
                                                 self.mesh)
        if self.rank != 0:
            self._barrier()
            return
        ckpt_dir = self.config.checkpoint_dir
        os.makedirs(ckpt_dir, exist_ok=True)
        payload = {
            "model_state_dict": model_state,
            "config": {k: v for k, v in vars(self.config).items()
                       if isinstance(v, (int, float, str, bool, type(None)))},
            "model_config": {"n_mels": self.cfg.n_mels, "d_model": self.cfg.d_model,
                             "n_heads": self.cfg.n_heads, "n_blocks": self.cfg.n_blocks,
                             "n_classes": self.cfg.n_classes, "dropout": self.cfg.dropout,
                             "masked_norm": self.cfg.masked_norm, "use_mqa": self.cfg.use_mqa},
            "epoch": int(epoch),
            "global_step": int(self.global_step),
            "best_val_loss": float(self.best_val_loss),
            "optimizer_state_dict": optimizer_state,
            "scheduler_state_dict": {"step": int(self.global_step)},
        }
        path = os.path.join(ckpt_dir, name or f"checkpoint_epoch_{epoch}.pt")
        save_checkpoint_file(path, payload)
        self.logger.info(f"Checkpoint saved: {path}")
        self._barrier()

    def _barrier(self):
        if self.mesh is not None and self.mesh.distributed:
            barrier()

    def _optimizer_state_from_named(self, state_dict, named):
        """The full optimizer state of a JAX checkpoint's ``opt_named``,
        restored into an optimizer of this trainer's kind over an
        unsharded CPU copy of the model."""
        full = ConformerCTC(self.cfg)
        full.load_state_dict(state_dict, strict=True)
        k = self.optimizer.k if isinstance(self.optimizer, MultiSteps) else 1
        optimizer, _ = make_optimizer([p for p in full.parameters() if p.requires_grad],
                                      1.0, 0.0, 10, accumulation_steps=k)
        restore_optimizer_from_named(optimizer, full, named)
        return optimizer.state_dict()

    def load_checkpoint(self):
        if not getattr(self.config, "resume", False):
            return
        path = latest_checkpoint(self.config.checkpoint_dir)
        if path is None:
            self.logger.warning("No checkpoint found! Starting from scratch.")
            return
        self.logger.info(f"Resuming from: {path}")
        jax_ckpt = path.endswith(".ckpt")
        ckpt = load_jax_checkpoint_file(path) if jax_ckpt else load_checkpoint_file(path)
        meta = ckpt["meta"] if jax_ckpt else ckpt
        # The vocabulary guard comes before any state is restored, so a
        # tokenizer swap is named as such, not as a shape error.
        n_classes = (meta.get("model_config") or {}).get("n_classes")
        if n_classes is not None and int(n_classes) != self.cfg.n_classes:
            raise ValueError(
                f"Checkpoint/model vocabulary mismatch on resume: {path} has "
                f"n_classes={int(n_classes)} but the current tokenizer/model uses "
                f"n_classes={self.cfg.n_classes}. Use the tokenizer the run started with.")
        if jax_ckpt:
            sd = state_dict_from_jax(ckpt["params"],
                                     ckpt["model_state"] or default_model_state(ckpt["params"]),
                                     self.cfg.n_heads)
            optimizer_state = (None if ckpt["opt_named"] is None
                               else self._optimizer_state_from_named(sd, ckpt["opt_named"]))
        else:
            sd, optimizer_state = ckpt["model_state_dict"], ckpt.get("optimizer_state_dict")
        # Every rank reads the full state and takes its shard.
        self.model.load_state_dict(shard_state_dict(sd, self.mesh), strict=True)
        if optimizer_state is not None:
            self.optimizer.load_state_dict(
                shard_optimizer_state(optimizer_state, self.names, self.mesh))
        self.start_epoch = int(meta.get("epoch", 0)) + 1
        self.global_step = int(meta.get("global_step", 0))
        if jax_ckpt and ckpt["opt_named"] is None:
            self._step_offset = self.global_step - self.optimizer.step_count
        self.best_val_loss = float(meta.get("best_val_loss", float("inf")))
        self.logger.info(f"Loaded checkpoint. Resuming from Epoch {self.start_epoch}")

    # ------------------------------------------------------------------
    # loops
    # ------------------------------------------------------------------
    def train_epoch(self, epoch):
        epoch_loss, num_batches = 0.0, 0
        start_time = time.time()
        trace = None
        if getattr(self.config, "profile_dir", None) and epoch == self.start_epoch:
            trace = start_profiler_trace(self.config.profile_dir)
        for batch_idx, batch in enumerate(self.train_loader):
            if batch is None:
                continue
            loss = self.train_step(batch, derive_seed(self.config.seed, epoch, batch_idx))
            self.losses.append(loss)
            if trace is not None and batch_idx + 1 == PROFILE_BATCHES:
                self._stop_trace(trace)
                trace = None
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
        if trace is not None:
            self._stop_trace(trace)
        self.sync_global_step()
        avg_loss = epoch_loss / max(num_batches, 1)
        self.logger.info(f"Epoch {epoch} Complete | Loss: {avg_loss:.4f} | "
                         f"Time: {time.time() - start_time:.1f}s")
        return avg_loss

    def _stop_trace(self, trace):
        self.profile_trace = stop_profiler_trace(trace)
        self.logger.info(f"Profiler trace written to {self.profile_trace}")

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
            val_loss += self._data_sum(loss).item()
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
        if self.data is not None:
            # WER/CER of this rank's rows, averaged over the data ranks (JAX
            # :576-587): every rank then takes the same best epoch.
            rates = self._data_sum(torch.tensor([total_wer, total_cer], dtype=torch.float64,
                                                device=self.device)) / self.data.size
            total_wer, total_cer = (float(r) for r in rates)
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
        self.logger.info(f"Mesh: {self.mesh.shape if self.mesh else {'data': 1}} "
                         f"(rank {self.rank})")
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
