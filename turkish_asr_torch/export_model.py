"""Model export for the port: ``python -m turkish_asr_torch.export_model``.

Counterpart of ``export_model.py`` (the JAX package's CLI), with its flags
(``--checkpoint --output --format --n_mel_channels --d_model --n_heads
--n_blocks --opset``) and ``--device`` (default ``cuda``). The checkpoint
is a reference-format ``.pt`` or a JAX ``.ckpt``; either carries its own
architecture, so ``--n_mel_channels``, ``--d_model`` and ``--n_blocks``
are accepted and ignored, and ``--n_heads`` is used when the checkpoint
stores none. Formats:

- ``export`` (default; the counterpart of ``stablehlo``): the fp32 forward
  without the length mask (features -> logits, as the JAX
  ``_load_forward``), traced by ``torch.export.export`` with a dynamic
  batch and a dynamic time that is a multiple of 4, and written with
  ``torch.export.save`` (a ``.pt2``). The attention forward is the op
  ``turkish_asr_torch::flash_attention_fwd`` (``ops/flash_attention.py``),
  one node a block, and on the card each bias with its tail is the op
  ``turkish_asr_torch::bias_act`` (``ops/bias_act.py``), so the loaded
  program launches the hand-written kernels there. Loading the file needs
  those ops registered::

      import torch
      import turkish_asr_torch.ops.bias_act  # registers the ops
      import turkish_asr_torch.ops.flash_attention
      program = torch.export.load("model.pt2").module()
      logits = program(features)  # (B, 4 t, n_mels) fp32 -> (B, t, n_classes)

  Verified: the reloaded program against the live model on
  ``default_rng(0)`` features of shape (2, 200, n_mels), max abs diff
  <= 1e-4.
- ``torch``: a reference-format ``.pt`` (``model_state_dict`` and
  ``config``), so a JAX ``.ckpt`` converts without JAX; verified by
  reloading it and running the same forward (<= 1e-4).
- ``stablehlo`` and ``savedmodel`` are refused: they need jax or
  TensorFlow, which the port never imports (``python export_model.py``
  writes them). ONNX is not offered: ``onnx`` is not installed.
"""

import argparse
import os

import numpy as np
import torch

from turkish_asr_torch.utils.device import resolve_device
from turkish_asr_torch.utils.weights import load_model, load_pt

FORMATS = ("export", "torch", "stablehlo", "savedmodel")
REFUSED = {
    "stablehlo": "--format stablehlo needs jax, which the port never imports; run "
                 "`python export_model.py --format stablehlo` in the JAX package",
    "savedmodel": "--format savedmodel needs jax and TensorFlow, which the port never "
                  "imports; run `python export_model.py --format savedmodel` in the JAX "
                  "package",
}
VERIFY_SHAPE = (2, 200)  # (B, T) of the verification features, as export_model.py
MAX_BATCH, MAX_T4 = 1024, 10000  # the dynamic dims' ranges: T up to 40000 frames (400 s)


class Forward(torch.nn.Module):
    """features (B, T, n_mels) fp32 -> logits (B, T // 4, n_classes) fp32,
    without the length mask (the reference ONNX wrapper's contract)."""

    def __init__(self, model):
        super().__init__()
        self.model = model

    def forward(self, features):
        return self.model(features, None, torch.float32)


def _verify(run, model, cfg, device):
    x = np.random.default_rng(0).standard_normal((*VERIFY_SHAPE, cfg.n_mels)).astype(np.float32)
    x = torch.from_numpy(x).to(device)
    with torch.no_grad():
        want = model(x, None, torch.float32)
        got = run(x)
    err = (want - got).abs().max().item()
    print(f"Max abs diff vs live model: {err:.3e}")
    if not err <= 1e-4:
        raise RuntimeError(f"Export verification failed: max diff {err}")
    print("Verification passed.")
    return err


def export_program(model, cfg, output_path, device, verify=True):
    """``torch.export`` the fp32 forward (dynamic batch, time a multiple
    of 4) into ``output_path``; returns the ExportedProgram."""
    batch = torch.export.Dim("batch", min=1, max=MAX_BATCH)
    t4 = torch.export.Dim("t4", min=2, max=MAX_T4)
    example = torch.zeros((*VERIFY_SHAPE, cfg.n_mels), dtype=torch.float32, device=device)
    print("Exporting with torch.export (dynamic batch, time a multiple of 4)...")
    with torch.no_grad():
        program = torch.export.export(Forward(model), (example,),
                                      dynamic_shapes={"features": {0: batch, 1: 4 * t4}},
                                      strict=False)
    torch.export.save(program, output_path)
    print(f"Exported: {output_path}")
    if verify:
        print("Verifying numeric parity (torch.export.load -> forward)...")
        _verify(torch.export.load(output_path).module(), model, cfg, device)
    return program


def export_torch(model, cfg, output_path, device, verify=True):
    """Write a reference-format ``.pt``; returns its state dict."""
    sd = {k: v.detach().cpu() for k, v in model.state_dict().items()}
    config = {"n_mel_channels": cfg.n_mels, "d_model": cfg.d_model, "n_heads": cfg.n_heads,
              "n_blocks": cfg.n_blocks, "dropout": cfg.dropout, "masked_norm": cfg.masked_norm}
    torch.save({"model_state_dict": sd, "config": config}, output_path)
    print(f"Exported: {output_path}")
    if verify:
        print("Verifying round-trip parity (export -> load_pt -> forward)...")
        _, reloaded = load_pt(output_path, device, n_heads=cfg.n_heads)
        _verify(lambda x: reloaded(x, None, torch.float32), model, cfg, device)
    return sd


def export_model(checkpoint_path, output_path, fmt="export", n_heads=4, device="cuda",
                 verify=True):
    """Export ``checkpoint_path`` as ``fmt``; returns the output path."""
    if fmt in REFUSED:
        raise ValueError(REFUSED[fmt])
    if fmt not in FORMATS:
        raise ValueError(f"unknown format {fmt!r}: one of {FORMATS}")
    device = resolve_device(device)
    print(f"Loading checkpoint: {checkpoint_path}")
    cfg, model = load_model(checkpoint_path, device, n_heads=n_heads)
    exporter = export_program if fmt == "export" else export_torch
    exporter(model, cfg, output_path, device, verify=verify)
    print(f"Model size: {os.path.getsize(output_path) / (1024 * 1024):.2f} MB")
    return output_path


def main(argv=None):
    parser = argparse.ArgumentParser(
        description="Export the ASR model (torch.export program or reference .pt)")
    parser.add_argument("--checkpoint", type=str, required=True,
                        help="Model checkpoint: a reference-format .pt or a JAX .ckpt")
    parser.add_argument("--output", type=str, default="model.pt2", help="Output path")
    parser.add_argument("--format", type=str, default="export", choices=list(FORMATS),
                        help="export: a torch.export program (.pt2) that launches the "
                             "port's attention kernel; torch: a reference-format .pt; "
                             "stablehlo and savedmodel need jax and are refused")
    parser.add_argument("--n_mel_channels", type=int, default=80,
                        help="Mel channels (the checkpoint carries its own; accepted and ignored)")
    parser.add_argument("--d_model", type=int, default=256,
                        help="Model dimension (the checkpoint carries its own; accepted and "
                             "ignored)")
    parser.add_argument("--n_heads", type=int, default=4,
                        help="Attention heads, when the checkpoint stores none")
    parser.add_argument("--n_blocks", type=int, default=8,
                        help="Conformer blocks (the checkpoint carries its own; accepted and "
                             "ignored)")
    parser.add_argument("--opset", type=int, default=None,
                        help="Unused (ONNX-parity flag); artifact versioning is automatic")
    parser.add_argument("--device", type=str, default="cuda",
                        help="Device to load, trace and verify on (cuda, or cpu); no fallback")
    args = parser.parse_args(argv)
    if args.format in REFUSED:
        parser.error(REFUSED[args.format])
    return export_model(args.checkpoint, args.output, args.format, n_heads=args.n_heads,
                        device=args.device)


if __name__ == "__main__":
    main()
