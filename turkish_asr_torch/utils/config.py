"""Training CLI configuration.

Counterpart of turkish_asr_tpu/utils/config.py: the same flag names and
defaults (the reference CLI's, plus the JAX package's additions), so a
reference or JAX invocation runs unchanged, with three differences:

- ``--device`` (default ``cuda``) picks the device; the port's kernels
  run on CUDA tensors and their plain versions on CPU tensors, and no flag
  routes a CUDA tensor to a plain version.
- ``--output_model_path`` defaults to a ``.pt`` file: the port writes the
  reference's ``.pt`` checkpoints (and resumes from a JAX ``.ckpt`` too).
- the flags that only mean something on a TPU or in the JAX package
  (``--rng_impl``, ``--ctc_impl``, ``--use_pallas``) are accepted at their
  defaults and refused otherwise.

``--remat_policy full|dots`` and ``--profile_dir`` run as in the JAX
package (``models/conformer.py``, ``utils/runtime.py``). ``--mesh_shape``
(e.g. ``data=4,model=2``) lays the ranks of a ``torchrun`` job out as the
JAX package lays out devices (``parallel/mesh.py``); ``--distributed``
joins a process group even at world size 1.
"""

import argparse

# flag -> (default, why another value is refused)
_REFUSED = {
    "rng_impl": ("rbg", "not applicable: the port's dropout masks come from "
                        "torch.Generator seeds and the kernels' position hash"),
    "ctc_impl": ("auto", "not applicable: CTC runs the CUDA kernels on the card and "
                         "their plain version on the CPU"),
    "use_pallas": (False, "not applicable: the port's CUDA kernels take every "
                          "attention call on the card"),
}


def get_config(argv=None):
    """Parse the training flags; raises ValueError for a refused value."""
    parser = argparse.ArgumentParser(description="Turkish ASR Model Training (PyTorch/CUDA)")

    # --- Data Paths ---
    parser.add_argument("--data_path", type=str, default=None, help="Main data directory (wav + txt files)")
    parser.add_argument("--train_path", type=str, default=None, help="Training data directory (optional)")
    parser.add_argument("--valid_path", type=str, default=None, help="Validation data directory (optional)")
    parser.add_argument("--test_path", type=str, default=None, help="Test data directory (optional)")
    parser.add_argument("--noise_dir", type=str, default=None, help="Directory with noise files for augmentation")
    parser.add_argument("--val_split", type=float, default=0.1, help="Validation split ratio")
    parser.add_argument("--test_split", type=float, default=0.1, help="Test split ratio")
    parser.add_argument("--vocab_size", type=int, default=1000, help="Vocabulary size")

    # Checkpoints
    parser.add_argument("--checkpoint_dir", type=str, default="./runs", help="Checkpoint save directory")
    parser.add_argument("--resume", action="store_true", help="Resume from latest checkpoint")
    parser.add_argument("--output_model_path", type=str, default="turkish_conformer_final.pt",
                        help="Final model filename (in --checkpoint_dir)")

    # --- Model Architecture ---
    parser.add_argument("--n_mel_channels", type=int, default=80, help="Number of mel filterbanks")
    parser.add_argument("--d_model", type=int, default=256, help="Model dimension")
    parser.add_argument("--n_heads", type=int, default=4, help="Number of attention heads")
    parser.add_argument("--n_blocks", type=int, default=8, help="Number of Conformer blocks")
    parser.add_argument("--encoder_dropout", type=float, default=0.1, help="Dropout rate")

    # --- Training Hyperparameters ---
    parser.add_argument("--batch_size", type=int, default=32, help="Batch size")
    parser.add_argument("--epochs", type=int, default=70, help="Number of epochs")
    parser.add_argument("--learning_rate", type=float, default=5e-4, help="Max learning rate")
    parser.add_argument("--weight_decay", type=float, default=1e-6, help="Weight decay")
    parser.add_argument("--num_workers", type=int, default=4, help="Data pipeline worker threads")
    parser.add_argument("--gradient_clip", type=float, default=1.0, help="Gradient clipping max norm")
    parser.add_argument("--accumulation_steps", type=int, default=1, help="Gradient accumulation steps")

    # Augmentation
    parser.add_argument("--augment", action="store_true", help="Enable data augmentation")
    parser.add_argument("--speed_perturb", action="store_true", help="Enable speed perturbation")
    parser.add_argument("--spec_augment_freq", type=int, default=27, help="SpecAugment frequency mask param")
    parser.add_argument("--spec_augment_time", type=int, default=100, help="SpecAugment time mask param")

    # --- Other ---
    parser.add_argument("--seed", type=int, default=42, help="Random seed")
    parser.add_argument("--log_interval", type=int, default=10, help="Logging frequency (batches)")
    parser.add_argument("--save_interval", type=int, default=5, help="Checkpoint save frequency (epochs)")

    # --- The JAX package's additions ---
    parser.add_argument("--precision", type=str, default="bf16", choices=["bf16", "fp32"],
                        help="Compute precision for matmuls/convs (params stay fp32)")
    parser.add_argument("--bucket_lengths", type=str, default=None,
                        help="Comma-separated padded waveform lengths in samples. Default: 1-32 s")
    parser.add_argument("--tokenizer_path", type=str, default=None,
                        help="Tokenizer: a .json BPE vocab from spm_train.py, or an HF model name")
    parser.add_argument("--masked_norm", action="store_true",
                        help="Exclude padded frames from GroupNorm/BatchNorm statistics")
    parser.add_argument("--no_remat", action="store_true",
                        help="Disable per-block recomputation in the backward pass")
    parser.add_argument("--remat_policy", type=str, default="full", choices=["full", "dots"],
                        help="Per-block recomputation policy: 'full' recomputes the block; "
                             "'dots' saves the linear layers' products and recomputes the rest")
    parser.add_argument("--mesh_shape", type=str, default=None,
                        help="Process mesh, e.g. 'data=4,model=2' (axes data, model, seq; "
                             "one size may be -1). Default: every rank on 'data'")
    parser.add_argument("--distributed", action="store_true",
                        help="Join a torch.distributed process group (torchrun's env) even at "
                             "world size 1")
    parser.add_argument("--rng_impl", type=str, default="rbg", choices=["rbg", "threefry2x32"],
                        help="JAX PRNG implementation (not applicable)")
    parser.add_argument("--ctc_impl", type=str, default="auto", choices=["auto", "scan", "pallas"],
                        help="JAX CTC implementation (not applicable)")
    parser.add_argument("--use_pallas", action="store_true", help="Pallas TPU kernels (not applicable)")
    parser.add_argument("--profile_dir", type=str, default=None,
                        help="Write a torch.profiler Chrome trace of the first 20 batches here")

    # --- The port's own ---
    parser.add_argument("--device", type=str, default="cuda", help="torch device: cuda or cpu")

    config = parser.parse_args(argv)
    for flag, (default, why) in _REFUSED.items():
        if getattr(config, flag) != default:
            raise ValueError(f"--{flag} {getattr(config, flag)!r}: {why}")
    return config
