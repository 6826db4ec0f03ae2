"""Turkish ASR training with the PyTorch/CUDA port.

Counterpart of main.py (the JAX package's training entry), run as::

    python -m turkish_asr_torch.main --data_path DIR [--device cuda] [flags of main.py]
    torchrun --nproc_per_node N -m turkish_asr_torch.main --mesh_shape data=N ...

WAV corpus -> bucketed padded batches on the host (``data/dataset.py``) ->
the train step on the device (``train/trainer.py``) -> ``.pt`` checkpoints
in ``--checkpoint_dir`` that ``turkish_asr_torch.serve.server`` serves.
``main(argv)`` returns the Trainer after ``fit``.

Under ``torchrun`` (world size > 1), or with ``--distributed``, each
process joins the process group (NCCL on ``cuda:LOCAL_RANK``, gloo with
``--device cpu``) and takes its place on ``--mesh_shape``'s mesh
(``parallel/mesh.py``; default: every rank on "data"). ``--batch_size``
is the global batch: each data rank loads the interleaved
``1/data`` slice of every batch, and the model and seq ranks of one
data line load the same rows. Rank 0 builds the CUDA kernels before the
others load them, and writes the logs' file and the checkpoints.
"""

import os
import random

import numpy as np
import torch
import torch.distributed as dist

from turkish_asr_torch.data.buckets import DEFAULT_WAVEFORM_BUCKETS
from turkish_asr_torch.data.dataset import BucketingSampler, PrefetchLoader, create_datasets
from turkish_asr_torch.data.tokenizer import load_tokenizer
from turkish_asr_torch.models.conformer import ModelConfig, count_params, init_model
from turkish_asr_torch.parallel.mesh import (
    barrier, check_batch, init_distributed, make_mesh, shard_model)
from turkish_asr_torch.train.optim import make_optimizer
from turkish_asr_torch.train.trainer import Trainer
from turkish_asr_torch.utils.config import get_config
from turkish_asr_torch.utils.device import resolve_device
from turkish_asr_torch.utils.logger import get_logger


def parse_buckets(spec):
    if not spec:
        return DEFAULT_WAVEFORM_BUCKETS
    return tuple(int(x) for x in spec.split(","))


def build_kernels_once(device, mesh):
    """Build the training path's CUDA libraries on rank 0 while the others
    wait, then let them load the built files: N ranks would otherwise run
    nvcc N times."""
    if device.type != "cuda" or mesh is None or not mesh.distributed:
        return
    if mesh.rank == 0:
        from turkish_asr_torch.ops import ctc, flash_attention
        for load in (flash_attention.load_kernel, flash_attention.load_bwd_kernel,
                     ctc.load_fwd_kernel, ctc.load_bwd_kernel):
            load()
    barrier()


def main(argv=None):
    config = get_config(argv)
    device = init_distributed(resolve_device(config.device), required=config.distributed)
    mesh = None
    if dist.is_initialized() or config.mesh_shape:
        mesh = make_mesh(config.mesh_shape, dist.get_world_size() if dist.is_initialized() else 1)
    rank = 0 if mesh is None else mesh.rank
    os.makedirs(config.checkpoint_dir, exist_ok=True)
    logger = get_logger("turkish_asr_torch.train",
                        log_file=(os.path.join(config.checkpoint_dir, "train.log")
                                  if rank == 0 else None))
    logger.info("=" * 60)
    logger.info("Turkish ASR Model Training (PyTorch/CUDA)")
    logger.info("=" * 60)

    random.seed(config.seed)
    np.random.seed(config.seed)
    logger.info(f"Device: {device}"
                + (f" ({torch.cuda.get_device_name(device)})" if device.type == "cuda" else ""))
    if mesh is not None:
        logger.info(f"Mesh: {mesh.shape}, rank {rank} at {mesh.coords}")
    build_kernels_once(device, mesh)

    tokenizer = load_tokenizer(config.tokenizer_path)
    backend = getattr(tokenizer, "backend", type(tokenizer).__name__)
    logger.info(f"Tokenizer loaded ({backend}). Vocab size: {tokenizer.vocab_size}")

    logger.info("Preparing datasets...")
    train_dataset, valid_dataset, test_dataset = create_datasets(
        config, tokenizer, augment_train=config.augment)
    if train_dataset is None or len(train_dataset) == 0:
        raise ValueError("Training dataset is empty! Check --data_path or --train_path.")
    logger.info(f"Datasets: Train={len(train_dataset)}, "
                f"Valid={len(valid_dataset) if valid_dataset else 0}, "
                f"Test={len(test_dataset) if test_dataset else 0}")

    buckets = parse_buckets(config.bucket_lengths)
    # --batch_size is global: each data rank loads its interleaved slice.
    check_batch(mesh, config.batch_size)
    shards = dict(process_index=0 if mesh is None else mesh.index("data"),
                  process_count=1 if mesh is None else mesh.size("data"))
    local_batch = config.batch_size // shards["process_count"]
    train_loader = PrefetchLoader(
        train_dataset, BucketingSampler(train_dataset, batch_size=config.batch_size,
                                        shuffle=True, seed=config.seed, **shards),
        local_batch, num_workers=config.num_workers, waveform_buckets=buckets)
    valid_loader = None
    if valid_dataset:
        valid_loader = PrefetchLoader(
            valid_dataset, BucketingSampler(valid_dataset, batch_size=config.batch_size,
                                            shuffle=False, **shards),
            local_batch, num_workers=config.num_workers, waveform_buckets=buckets)

    logger.info("Building model...")
    model_cfg = ModelConfig(n_mels=config.n_mel_channels, d_model=config.d_model,
                            n_heads=config.n_heads, n_blocks=config.n_blocks,
                            n_classes=tokenizer.vocab_size, dropout=config.encoder_dropout,
                            masked_norm=config.masked_norm)
    model = init_model(model_cfg, torch.Generator().manual_seed(config.seed))
    logger.info(f"Model Parameters: {count_params(model):,} total")
    model = shard_model(model, mesh).to(device)

    # ceil: a partial accumulation window is flushed at epoch end and takes
    # one schedule step (Trainer.flush_accumulation).
    steps_per_epoch = max(-(-len(train_loader) // config.accumulation_steps), 1)
    optimizer, schedule = make_optimizer(
        [p for p in model.parameters() if p.requires_grad], config.learning_rate,
        config.weight_decay, steps_per_epoch * config.epochs, pct_start=0.1,
        gradient_clip=config.gradient_clip, accumulation_steps=config.accumulation_steps)

    trainer = Trainer(model, optimizer, schedule, config, logger, tokenizer=tokenizer,
                      train_loader=train_loader, valid_loader=valid_loader, device=device,
                      accumulation_steps=config.accumulation_steps,
                      compute_dtype=torch.bfloat16 if config.precision == "bf16" else torch.float32,
                      augment=config.augment, mesh=mesh)
    try:
        trainer.fit()
    except KeyboardInterrupt:
        logger.info("Training interrupted by user.")
        trainer.save_checkpoint(trainer.start_epoch, name="interrupted_checkpoint.pt")
    return trainer


if __name__ == "__main__":
    main()
