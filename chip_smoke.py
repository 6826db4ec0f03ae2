"""Smoke run of turkish_asr_torch on one CUDA card: `python3 chip_smoke.py`
(`python3 chip_smoke.py --multichip` on four cards: see the end).

Phases; any failure raises and the script exits non-zero.

1. Setup: prints the card's name and power limit (nvidia-smi), then builds
   every CUDA kernel from turkish_asr_torch/csrc with nvcc, one nvcc per
   source, all started together.
2. Attention kernels: first their SASS (cuobjdump -sass of the two
   libraries): every function's HGMMA (wgmma), HMMA (mma.sync) and UTMALDG
   (TMA load) count is printed, and a bf16 forward, dk/dv or dq instance
   without HGMMA or UTMALDG fails the phase. Then the flash-attention
   forward (with dropout 0 and 0.1)
   and backward against their plain PyTorch versions on the card, first at
   the main path's two shapes (training: B=32, T'=200, dropout 0.1; the
   long served bucket: B=16, T'=601; both bf16, H=4, Kh=1, D=64) and bench
   config 5's two (LONGFORM_ATTENTION: Conformer-L's H=8, Kh=1, D=64 at
   T'=1601, B=16 and B=4 with dropout 0.1), then
   B=4, H=4, D=64, T' in {26, 201, 601, 801}, Kh in {1, 4}; ragged lengths
   with a length-0 row, bf16 and fp32 inputs. Tolerances: forward out 1e-4
   (fp32 inputs) and 2e-2 (bf16: both round p to bf16, row sums in another
   order), lse 1e-3 (1e-4 for fp32 inputs); backward dq, dk, dv within
   1e-4 of the largest gradient (the kernel rebuilds the forward's p bit
   for bit, and its fp32 operands enter the tensor cores as bf16 hi + lo
   pairs). At the main-path shapes the kernels, their plain versions and
   torch's scaled_dot_product_attention (forward, and its gradient through
   autograd; the names of the device kernels it ran, which say the backend
   it chose) are timed over 20 chained calls, beside single-call medians
   and each kernel's bound (kernel_bounds); the kernels through the same
   calls, seed and order as turkish_asr_torch/scripts/ab_attention.py
   (kernel_calls, time_calls), so the two report one number for a shape;
   so is the MHA shape with no
   main-path launches (B=4, Kh=4, T'=801, rate 0, bf16, the A/B's), beside
   SDPA. The dropout dump kernel must be
   bit-identical to the plain hash at B=4, H=4, T'=801, at T' in
   DUMP_EDGES with B=H=3 (rows across its 16-byte groups at every phase)
   and, at B=H=1, T' in DUMP_LARGE (past 2^31 and past 2^32 elements) on
   the rows around those boundaries and the last rows (the plain hash of
   those rows alone, keep_rows_ref), and launch one device kernel a call.
   "Device ms" below and in the kernels
   line ("ms", "plain_ms", "library_ms") is CUDA events around 20 calls
   queued behind a spin kernel, so the kernels run back to back without
   the host's gaps (the profiler's kernel times for a call that waits for
   the card); "chained_ms" is CUDA events
   around 20 chained calls, which also counts the host's gaps where the
   wrapper's Python takes longer than the kernel.
3. CTC kernels: forward and backward against the plain version at B=32,
   T' in {200, 800}, L in {64, 512}, V in {56, 1000, 32768}, and at the
   kernels' edges (CTC_EDGES: S = 1055 and 1057 on either side of the
   warp path's limit, T'=77 across 32-frame chunks, S = 8191 on the wide
   path); int32 targets and lengths as the trainer gives them, ragged
   lengths, a dummy row (1 frame, no target) and impossible alignments.
   Tolerances: losses 1e-5 relative (+1e-4 absolute); gradients 1e-4 of
   1 + |plain|: the same fp32 recursion, with the lanes of a label summed
   in another order, and a row whose alignment is impossible carries
   unscaled lane values that sum to hundreds (the loss's zero_infinity
   multiplies them by 0). Median CUDA-event times of kernels and plain
   versions throughout; at the training step's shape (T'=200, L=64, V=56)
   two backward calls must be bit-identical, and the wrappers are timed
   over 20 calls (device and chained), the kernels alone by the profiler
   ("kernel_ms"), beside torch.nn.functional.ctc_loss with its gradient
   through autograd; the device kernels one ctc_loss forward and one
   backward launch are printed. The kernels' branch-free log1p must equal
   the math library's log1pf bit for bit on every float in [0, 1].
4. SwiGLU: first the library's SASS and ptxas report: every instance
   holds HGMMA (wgmma) and no HMMA (mma.sync), every TMA instance
   UTMALDG, and no instance spills. Then the port's A/B
   (turkish_asr_torch/scripts/ab_swiglu.py, the fused SwiGLU FFN kernel
   against the matmul chain and cuBLAS's two products) at SWIGLU_SHAPES:
   C=256, F=1024 at M in {6400, 6401, 25600}, Conformer-L's C=512,
   F=2048 at M in {6404, 25616}; then the kernel at every row tile that
   takes C against the fused plain version on the A/B's inputs with
   seeded nonzero biases, and at SWIGLU_EDGES (the copy path's edges, C
   near 512, and every F split the plan picks, which must all run), into
   an output buffer the allocator last held as NaN: every row finite,
   max|kernel - plain| <= 2^-7 max|plain| (both sum fp32 products of bf16
   values in other orders, so g can round one bf16 ulp apart). At each
   width's first shape two calls must be bit-identical and a call must
   launch one device kernel, the SwiGLU kernel. Median CUDA-event times
   of the kernel, the fused plain version and the chain at each shape.
5. Training: a synthetic corpus (tones with character transcripts, 1-8 s)
   trained through turkish_asr_torch.main at flagship width (80 mels,
   d_model 256, 4 heads MQA, 8 blocks, char tokenizer, dropout 0.1,
   --augment, bf16, batch 32, per-block recomputation) for >= 20 optimizer
   steps: the loss must be finite and fall, and every step must launch the
   attention forward >= 16 times (8 blocks and their recompute), its
   backward 8 times and each CTC kernel once. Then a resume from the
   checkpoint, and a run with --accumulation_steps 2.
6. Gradient check: one fp32 train step of the flagship model (dropout on,
   the same seeds) with the kernels against the same step with every
   kernel replaced by its plain version: each parameter's gradient within
   1e-3 of its largest element (or of 1e-4 of the largest gradient, for
   the biases whose gradient is rounding noise), the loss within 1e-5
   relative.
7. Serving: the trained .pt answers one /transcribe through ASRService;
   then the flagship model with seeded random weights, served by
   turkish_asr_torch.serve.server on 127.0.0.1 (/health, 1 s, 8 s, 24 s,
   timestamps, a 3-file batch) with 8 forward-kernel launches per forward,
   exactly 8 for the batch request (one batched forward: the per-file
   fallback that serves a failed batched forward would launch 24);
   the 8 s input's bf16 logits held within bf16's own noise of the plain
   path's and at 0.99 frame-argmax agreement, its fp32 logits within 1e-3
   and 0.99 frame-argmax agreement of the plain path's, and fp32 on the
   card against the CPU.

8. Beam search: the served model (7's weights) behind ASRService with
   USE_BEAM_SEARCH=true, BEAM_WIDTH=16 and bench config 4's 400-word
   word ARPA (trie fusion through the char tokenizer): POST /transcribe
   (8 s) and /transcribe/batch (four 8 s files, one forward) answer 200
   with the texts transcribe / transcribe_files give in the process, and
   the attention forward launches 8 times a forward; each request's ms
   split into forward and beam. The host beam (no LM) on two 1 s files.
   Then log-probs of B tones of 8 s (the served bf16 forward, log_softmax
   in fp32) through three searches at W=16 on the card, each against the
   same function on the CPU on the same log-probs: (a) no LM, (b) the
   400-word ARPA's trie tables, (c) the production ARPA's hash tables
   (100k words, order 4, ~1.05M n-grams; its generation, parse and build
   seconds printed). The best beam's ids must be identical wherever the
   CPU's two best scores differ by more than 1e-4 (the count inside that
   margin printed), and the best scores agree within 1e-3. One search of
   each runs under torch.cuda.set_sync_debug_mode("error"), so a host sync
   in it fails the phase. Printed for B=16 and B=128: wall and device ms
   a decode (median of BEAM_REPS), decode RTFx, and at B=16 the device
   kernels a decode and a frame and their summed ms (torch.profiler).
   A JSON line {"beam": ...} holds these numbers.

9. Checkpoint boundary: the resumed model of phase 5 written as a JAX
   ``.ckpt`` by the port (``save_jax_checkpoint_file``, with ``opt_named``
   from its optimizer), served by ``ASRInference`` with the ``.pt``'s
   logits bit for bit (8 s and 24 s) and by the HTTP server with the same
   text, then resumed from a directory whose newest checkpoint is that
   ``.ckpt``: start epoch, global step, Adam moments and count and the
   weights equal the ``.pt`` resume's bit for bit, and 2 more steps run.
10. Remat: one bf16 training step at B=32, T' <= 200 for each of no
   recomputation, ``--remat_policy full`` and ``dots``: wall ms (median of
   5), peak memory, attention forward launches (8, 16, 16 a step); fp32
   gradients of ``dots`` within 1e-3 of ``full`` (of each tensor's largest
   element, floored as in the gradient check).
11. Profile: 3 steps with ``--profile_dir``; the Chrome trace names the
   attention forward and backward and the CTC forward and backward kernels.
12. Export: ``python -m turkish_asr_torch.export_model --format export``
   of the ``.ckpt`` on the card (its own check: 1e-4), loaded in this
   process and run at B=2 x T=200 and B=16 x 24 s: within 1e-4 of the eager
   fp32 model, and exactly 8 attention forward launches a forward
   (``export_launches`` in the kernels line); then ``--format torch``.
13. Parallel (turkish_asr_torch/parallel/): two ranks on cuda:0 over
   gloo (NCCL refuses two ranks on one card), started by this script
   (``--parallel-rank``) with a FileStore in a temp dir, at flagship
   width. Meshes data=2, model=2 and seq=2 each run 3 steps at B=32 in
   fp32 with dropout 0: losses within 1e-4 relative of the one-process
   trainer's on the same global batch, and the weights after the steps
   within 1e-4 (the elements whose Adam gradient scale is under 1e-7,
   rounding noise, within 3 lr: tests/test_torch_parallel.py); every rank
   launches the attention and CTC kernels (the wrappers' counts over the 3
   steps, and the last step's device kernels by name under torch.profiler,
   both > 0). Then
   data=2 in bf16 with dropout 0.1 and --augment: finite losses, the
   replicas' weights bit-equal, and the two ranks' attention keep masks
   (dump_keep_mask with each rank's mixed kernel seed) different. One rank
   over NCCL (init_distributed at world size 1): the same 3 fp32 steps
   within 1e-5 relative of the run without a process group. Served data
   parallelism: ASRInference on the visible cards and on two replicas on
   cuda:0 gives the one-replica texts (fp32). Wall ms a step and the
   all-reduce calls and bytes a step for each mesh, and the launches, go
   into a {"parallel": ...} JSON line. Four gloo ranks on cuda:0 run
   model=2,seq=2 the same way (3 fp32 steps against one process: losses
   1e-4, weights 1e-4, the gathered initial state equal to the init, the
   kernels launched on every rank); and over the one-rank NCCL group,
   turkish_asr_torch.multichip.dryrun_multichip(1) (one bf16 step with
   --augment and accumulation 2, then W=4 trie and hash beam decodes that
   must agree), which must launch the attention and CTC kernels. Ranks
   time-sliced on one card measure correctness and overhead, not scaling.
14. Memorization: ``turkish_asr_torch/scripts/overfit.py`` on the card in
   bf16: loss under 0.1 after 300 steps, the five words decoded back.
15. Data: the host C++ library (``turkish_asr_torch/native``) must build
   and load; ``AudioPreprocessor()`` must choose the card and give
   ``AudioPreprocessor(device="cpu")``'s features within 1e-4 on an 8 s
   stereo WAV; ``resample`` at 44100 -> 16000 must call the native routine
   and at 16000 -> 17777 (speed perturbation 0.9, whose native polyphase
   bank exceeds ``wavio.NATIVE_BANK_MAX``) sum the taps in support, each
   bit-equal to ``resample_native`` and within 1e-5 of the numpy fallback
   (``TASR_NATIVE=0``), with both routes' host seconds;
   ``levenshtein_native`` must equal the DP on 200 seeded pairs (both
   timed); and ``ASRMetrics.compute_from_ids`` over one validation pass of
   phase 5's trained model is timed with the native edit distance and with
   the DP (the same results; host seconds, median of 5, printed beside the
   card's name and power limit).
16. Bench (``turkish_asr_torch/bench.py``): bench config 5's forward
   (Conformer-L: d_model 512, 8 heads, 16 blocks; B=16 x 64 s, T'=1601,
   seeded random weights) with the attention kernel against the same
   model with the plain core (``attn_kernel=False``) by the serving
   phase's bars (fp32 within 1e-3 at 0.99 frame-argmax agreement; bf16
   within bf16's own noise, its argmaxes agreeing at 0.99 or, where bf16
   itself moves more than that, as often as the plain bf16 and fp32
   argmaxes agree, and never below AGREE_BF16_FLOOR, 0.95). Then ``bench.run`` on the card:
   every configuration at its full shapes and widths, BENCH_CAP timed
   iterations or steps each (the host beam: BENCH_CAP utterances and
   trials). It fails on an ``error_`` line, unless the headline is last,
   unless every line has bench.py's fields (``bench.FIELDS``) plus the
   card's name and its power limit (not null), and unless each configuration launched
   its kernels (BENCH_KERNELS: the attention forward everywhere, the
   backward and both CTC kernels in the training ones), counted with the
   counts set to 0 before each configuration and read after it.

``python3 chip_smoke.py --multichip`` (four cards on one host;
raises with fewer visible cards) runs the parallel layer over NCCL, one
rank a card, at flagship width (the parallel phase's init and batches),
after the build:
(a) ranks started by ``turkish_asr_torch.multichip.launch`` hold
data=4, data=2,model=2, model=2,seq=2 and seq=2,data=2 (3 fp32 steps,
dropout 0) to the one-process trainer on cuda:0 as the parallel phase
does, every rank on its own card; (b) data=4 in bf16 with dropout 0.1 and
--augment: finite losses, the four replicas' weights bit-equal, four
different keep masks; (c) ``python -m turkish_asr_torch.main`` on the
synthetic corpus under torchrun on data=2,model=2 for 2 epochs (rank 0
writes the .pt checkpoints), its epoch-2 checkpoint written as a JAX
.ckpt, then ``--resume`` on data=4 through the launcher continues from
the .ckpt for epoch 3, and ASRInference serves the final .pt with a
replica on each card: the texts equal one replica's, greedy and W=16
trie beam, and their fp32 logits within 1e-3; (d) ``python -m
turkish_asr_torch.multichip 4`` (the
dryrun, mesh data=2,model=2). Printed: wall ms a step per mesh (median of
the steps after the first) beside the one-process step, all-reduce calls
and bytes a step, and a served B=128 x 8 s bf16 batched forward with one
and with four replicas, in a {"multichip": ...} JSON line with the
cards' names and power limits and the NCCL version; then the cards' lines
and {"ok": true, "device": {..., "count": 4}}.

Each phase prints its seconds. The last six lines are a JSON line of
phases 9-12's, 14's and 15's numbers, the parallel phase's JSON line, the bench
phase's (its lines, launches and the long-form check), then the
card, the kernels (launch counts from the training run, errors, chained
and single-call times, bound_ms and bound_by from kernel_bounds,
library_ms: the one torch call that computes the same function, or null
where none does; kernel_ms for the CTC kernels; device kernels a call for
the CTC, dump and SwiGLU kernels; the MHA shape's times under "mha"; each
rank's launches in the parallel phase's data=2 steps; each bench
configuration's launches; the attention kernels' times at bench config
5's shapes under "longform") and {"ok": true, "device": {...}}.
"""

import contextlib
import json
import logging
import math
import os
import re
import statistics
import subprocess
import sys
import tempfile
import threading
import time
import types
import urllib.request
import uuid
from pathlib import Path
from unittest import mock

import numpy as np
import torch

SR = 16000
# (M, C, F): the flagship FFN (d_model 256, d_ff 1024) at the A/B's M,
# and Conformer-L's (bench config 5: d_model 512, d_ff 2048) at its
# training step's and its forward's rows (B=4 and B=16 x T'=1601).
SWIGLU_SHAPES = ((6400, 256, 1024), (6401, 256, 1024), (25600, 256, 1024), (6404, 512, 2048),
                 (25616, 512, 2048))
# (M, C, F) at the SwiGLU kernel's edges: ragged everything (the copy
# path), F off the 64-unit chunk (TMA, boxes past F), F % 8 == 4 (the copy
# path at the flagship width); the M at which the plan splits F over
# clusters of 4 and 8 (on 132 SMs), so that with the shapes above every
# split runs; Conformer-L's width with ragged M and F (TMA), and C near
# 512 with C % 8 != 0 (the copy path).
SWIGLU_EDGES = ((37, 40, 70), (6400, 256, 1000), (6400, 256, 1020), (3000, 256, 1024),
                (5, 256, 1024), (301, 512, 1960), (77, 508, 1996))
TOLERANCES = {torch.float32: (1e-4, 1e-4), torch.bfloat16: (2e-2, 1e-3)}  # (out, lse)
CTC_SHAPES = dict(B=32, T=(200, 800), L=(64, 512), V=(56, 1000, 32768))
CTC_MAIN = dict(B=32, T=200, L=64, V=56)  # a training step's CTC shape
# (T', L, V) at the kernels' edges: S = 1055 and 1057 on either side of the
# warp path's 32 x 33 lanes, a T' that is no multiple of the 32-frame
# chunk, and the widest target the wrappers take (S = 8191, 16 warps).
CTC_EDGES = ((200, 527, 56), (200, 528, 56), (77, 64, 56), (40, 4095, 56))
CHAINED_CALLS = 20  # the calls between two CUDA events, as in ab_attention.py
DUMP_EDGES = (1, 15, 16, 17)  # T' at B=3, H=3: rows across 16-byte groups at every phase
DUMP_LARGE = (46341, 65537)  # T' at B=H=1: past 2^31 (2.1 GB) and past 2^32 elements (4.3 GB)
# The H100 SXM's published peaks (NVIDIA's data sheet, dense, at 700 W):
# bf16 tensor cores, fp32 outside them, device memory.
PEAK_FLOPS = {"bf16": 989e12, "fp32": 67e12}
PEAK_BYTES = 3.35e12
TRAIN_EPOCHS = 5
BEAM_WIDTH = 16
BEAM_BATCHES = (16, 128)  # a served batch, and bench.py's BATCH
BEAM_SECONDS = 8
BEAM_REPS = 3
# bench config 5's attention shapes (turkish_asr_torch/bench.py): Conformer-L
# (8 heads MQA, D=64) at 64 s, T'=1601 (a tail tile that is no multiple of
# the kernels' tiles): the long-form forward's B=16, and the training
# step's B=4 with dropout 0.1 (the backward's dk/dv chunk plan at B=4).
LONGFORM_ATTENTION = {"longform_serve": dict(B=16, H=8, Kh=1, T=1601, D=64, rate=0.0),
                      "longform_train": dict(B=4, H=8, Kh=1, T=1601, D=64, rate=0.1)}
AGREE_BF16_FLOOR = 0.95  # the long-form bf16 argmax bar never goes below this
BENCH_CAP = 2  # timed iterations and steps of each bench configuration (bench.run's cap)
_FWD = ("flash_attention_fwd",)
_TRAIN = ("flash_attention_fwd", "flash_attention_bwd", "ctc_fwd", "ctc_bwd")
# The kernels each configuration of turkish_asr_torch.bench.run must launch.
BENCH_KERNELS = {"bench_greedy_headline": _FWD, "bench_greedy_single": _FWD,
                 "bench_train_small": _TRAIN, "bench_train_aug": _TRAIN,
                 "bench_beam_arpa": _FWD, "bench_beam_arpa_100k": _FWD,
                 "bench_longform_conformer_l": _FWD, "bench_train_conformer_l": _TRAIN}
WORDS = ("merhaba", "evet", "hayır", "bir", "iki", "üç", "dört", "beş", "altı", "yedi",
         "sekiz", "dokuz", "on", "güneş", "deniz", "kitap")


def _median_ms(fn, reps=20, warmup=3):
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def _times(fn, calls=CHAINED_CALLS):
    """(device ms, chained CUDA-event ms) per call: device ms times the
    calls queued behind a spin kernel, without the host's gaps between
    launches (turkish_asr_torch/scripts/ab_attention.py)."""
    from turkish_asr_torch.scripts.ab_attention import chained_ms, device_ms
    return device_ms(fn, calls), chained_ms(fn, calls)


def kernel_bounds(name, **shape):
    """The least time the card could take for one call of a kernel's
    function: the larger of its operations over the peak rate for their
    type and its bytes over the memory rate, each input read once and each
    output written once. Returns {"flops", "bytes", "bound_ms", "bound_by"}.

    flash_attention_fwd / _bwd (B, H, Kh, T, D, dtype="bf16"): q (B, H, T, D)
      and k, v (B, Kh, T, D) in dtype, mask (B, T) uint8; the forward writes
      out (B, H, T, D) and lse, m, l (B, H, T) fp32 and does 4*B*H*T*T*D
      flops (q k^T and p v); the backward reads g (B, H, T, D) and m, l,
      delta (B, H, T) fp32, writes dq, dk, dv fp32 and does 10*B*H*T*T*D
      flops (q k^T, g v^T, y^T g, ds^T q, ds k). bf16 inputs run on the
      tensor cores (989 TFLOP/s); fp32 inputs are held to the fp32 rate.
    dropout_mask (B, H, T): writes the (B, H, T, T) one-byte keep mask; the
      hash is integer work the peak table has no rate for, so the bound is
      bytes only (turkish_asr_torch/scripts/dump_floor.py counts the integer
      instructions the compiled kernel spends, a floor this does not see).
    ctc_fwd / ctc_bwd (B, T, V, L), S = 2L + 1 lanes: the forward reads
      log-probs (B, T, V) fp32, targets (B, L) int32 and the two (B,) int32
      lengths (the kernels build the extended labels and skip flags from
      the targets), writes alpha (B, T, S) and nll (B,) fp32; the backward
      also reads alpha, nll and the (B,) cotangent and writes the
      (B, T, V) fp32 gradient (it builds its label chains itself). About
      10 fp32 operations per lane and frame in the forward (a three-way
      logaddexp) and 20 in the backward (beta and the gradient), at the
      fp32 rate.
    swiglu_fwd (M, C, F): x (M, C), w1 (C, 2F), w2 (F, C) bf16, b1 (2F,),
      b2 (C,) fp32, y (M, C) bf16; 6*M*C*F flops on the tensor cores.
    """
    if name in ("flash_attention_fwd", "flash_attention_bwd"):
        B, H, Kh, T, D = (shape[k] for k in ("B", "H", "Kh", "T", "D"))
        dtype = shape.get("dtype", "bf16")
        qkv = (B * H * T * D + 2 * B * Kh * T * D) * (2 if dtype == "bf16" else 4) + B * T
        if name == "flash_attention_fwd":
            flops, nbytes = 4 * B * H * T * T * D, qkv + 4 * (B * H * T * D + 3 * B * H * T)
        else:
            flops = 10 * B * H * T * T * D
            nbytes = qkv + 4 * (2 * B * H * T * D + 3 * B * H * T + 2 * B * Kh * T * D)
        peak = PEAK_FLOPS[dtype]
    elif name == "dropout_mask":
        B, H, T = shape["B"], shape["H"], shape["T"]
        flops, nbytes, peak = 0, B * H * T * T, PEAK_FLOPS["fp32"]
    elif name in ("ctc_fwd", "ctc_bwd"):
        B, T, V, L = shape["B"], shape["T"], shape["V"], shape["L"]
        S = 2 * L + 1
        inputs = 4 * B * T * V + 4 * B * L + 8 * B
        if name == "ctc_fwd":
            flops, nbytes = 10 * B * T * S, inputs + 4 * B * T * S + 4 * B
        else:
            flops = 20 * B * T * S
            nbytes = inputs + 4 * B * T * S + 8 * B + 4 * B * T * V
        peak = PEAK_FLOPS["fp32"]
    elif name == "swiglu_fwd":
        M, C, F = shape["M"], shape["C"], shape["F"]
        flops = 6 * M * C * F
        nbytes = 2 * (M * C + C * 2 * F + F * C + M * C) + 4 * (2 * F + C)
        peak = PEAK_FLOPS["bf16"]
    else:
        raise ValueError(f"no bound for kernel {name!r}")
    t_ops, t_bytes = flops / peak, nbytes / PEAK_BYTES
    bound = {"flops": flops, "bytes": nbytes, "bound_ms": 1e3 * max(t_ops, t_bytes),
             "bound_by": "operations" if t_ops > t_bytes else "bytes"}
    return bound


LAUNCH_COUNTERS = ("flash_attention_fwd", "flash_attention_bwd", "dropout_mask", "ctc_fwd",
                   "ctc_bwd", "swiglu_fwd")


def _counts():
    """The kernel wrappers' launch counters (``utils/tracing.py``)."""
    from turkish_asr_torch.utils import tracing
    counters = tracing.counters()
    return {name: counters.get(name, 0) for name in LAUNCH_COUNTERS}


def _reset_counts(*names):
    """Set the launch counters ``names`` (all six, with none given) to 0."""
    from turkish_asr_torch.utils import tracing
    tracing.reset_counters(*(names or LAUNCH_COUNTERS))


def build_phase():
    from turkish_asr_torch.ops import _build, ctc, flash_attention as fa, swiglu
    libraries = {"flash_attention_fwd": fa.KERNEL_SOURCES, "flash_attention_bwd": fa.BWD_SOURCES,
                 "dropout_mask": fa.DUMP_SOURCES, "ctc_fwd": ctc.FWD_SOURCES,
                 "ctc_bwd": ctc.BWD_SOURCES, "swiglu_fwd": swiglu.SOURCES}
    start = time.perf_counter()
    _build.build_all(libraries)
    fa.load_kernel(), fa.load_bwd_kernel(), fa.load_dump_kernel()
    ctc.load_fwd_kernel(), ctc.load_bwd_kernel(), swiglu.load_kernel()
    print(f"kernel build + load ({len(libraries)} libraries in parallel): "
          f"{time.perf_counter() - start:.3f} s", flush=True)
    for name, sources in libraries.items():
        print(f"  {_build.library_path(name, sources)}", flush=True)


SASS_OPS = ("HGMMA", "HMMA", "UTMALDG")  # wgmma, mma.sync, TMA tile loads
SASS_KERNELS = ("flash_fwd_kernel", "flash_bwd_dkdv", "flash_bwd_dq")  # the bf16 products' kernels
# swiglu_fwd_kernel<kSplit, kTma>: the instance's TMA flag from its name
_SWIGLU_INSTANCE = re.compile(r"swiglu_fwd_kernelILb[01]ELb([01])E")


def sass_counts(text):
    """{function: {opcode: count}} of SASS_OPS in ``cuobjdump -sass`` text
    (read as turkish_asr_torch/scripts/dump_floor.py reads it)."""
    from turkish_asr_torch.scripts.dump_floor import parse_sass
    return {name: {op: sum(1 for i in body if i.opcode == op) for op in SASS_OPS}
            for name, body in parse_sass(text).items()}


def wgmma_missing(counts):
    """The instances in ``counts`` whose products are not on wgmma fed by
    TMA: a bf16 attention forward, dk/dv or dq instance without an HGMMA
    (wgmma) or a UTMALDG (TMA load), and a SwiGLU instance without HGMMA,
    with an HMMA (mma.sync), or, on its TMA path, without UTMALDG."""
    missing = []
    for name, c in counts.items():
        swiglu = _SWIGLU_INSTANCE.search(name)
        if swiglu:
            if c["HGMMA"] == 0 or c["HMMA"] > 0 or (swiglu.group(1) == "1" and c["UTMALDG"] == 0):
                missing.append(name)
        elif ("__nv_bfloat16" in name and any(k in name for k in SASS_KERNELS)
              and (c["HGMMA"] == 0 or c["UTMALDG"] == 0)):
            missing.append(name)
    return missing


def ptxas_spills(log):
    """{function: (spill store bytes, spill load bytes)} of every function
    whose ``nvcc -Xptxas -v`` report in ``log`` spills."""
    spills, name = {}, None
    for line in log.splitlines():
        m = re.search(r"Function properties for (\S+)", line)
        if m:
            name = m.group(1)
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m and name is not None and (int(m.group(1)) or int(m.group(2))):
            spills[name] = (int(m.group(1)), int(m.group(2)))
    return spills


def library_sass(libraries):
    """The SASS of each {name: sources} library: for every function, its
    HGMMA, HMMA and UTMALDG count; raises if an instance's products are
    not on wgmma fed by TMA (wgmma_missing)."""
    from turkish_asr_torch.ops import _build
    cuobjdump = Path(_build.find_nvcc()).parent / "cuobjdump"
    result = {}
    for name, sources in libraries.items():
        text = subprocess.run([str(cuobjdump), "-sass", str(_build.library_path(name, sources))],
                              capture_output=True, text=True, check=True).stdout
        counts = result[name] = sass_counts(text)
        for fn, c in counts.items():
            print(f"SASS {name} {fn}: " + ", ".join(f"{op} {n}" for op, n in c.items()),
                  flush=True)
        missing = wgmma_missing(counts)
        if missing or not counts:
            raise AssertionError(f"{name}: instances without wgmma or TMA loads: {missing}")
    return result


def attention_sass():
    """The attention libraries' SASS (library_sass)."""
    from turkish_asr_torch.ops import flash_attention as fa
    return library_sass({"flash_attention_fwd": fa.KERNEL_SOURCES,
                         "flash_attention_bwd": fa.BWD_SOURCES})


def attention_phase():
    """Forward (dropout 0 and 0.1) and backward kernels against the plain
    versions, and the dump kernel against the plain hash; first the
    attention libraries' SASS (attention_sass)."""
    from turkish_asr_torch.ops import flash_attention as fa
    from turkish_asr_torch.ops._dropout import keep_mask_ref, keep_rows_ref
    from turkish_asr_torch.ops._flash_attention import (
        flash_attention_bwd_ref, flash_attention_fwd_stats_ref)
    from turkish_asr_torch.scripts.ab_attention import (
        MAIN_PATH, SWEEP, attention_inputs, kernel_calls, time_calls)

    gen = torch.Generator().manual_seed(0)
    B, H, D = SWEEP["B"], SWEEP["H"], SWEEP["D"]
    err = {"flash_attention_fwd": 0.0, "flash_attention_bwd": 0.0}
    times = {"sass": attention_sass()}

    def check(dtype, Kh, T, rate, out, lse, grads, ref_out, ref_lse, ref_grads):
        """(max |out - ref|, max |lse - ref|, grads' max error over their largest
        plain element); raises where a tolerance is broken."""
        torch.cuda.synchronize()
        if not all(torch.isfinite(t).all() for t in (out, lse) + tuple(grads)):
            raise AssertionError(f"non-finite attention output at {dtype} Kh={Kh} T={T} "
                                 f"rate={rate}")
        err_o = (out - ref_out).abs().max().item()
        err_l = (lse - ref_lse).abs().max().item()
        err_g = max((a - b).abs().max().item() / max(1.0, b.abs().max().item())
                    for a, b in zip(grads, ref_grads))
        tol_o, tol_l = TOLERANCES[dtype]
        if err_o > tol_o or err_l > tol_l or err_g > 1e-4:
            raise AssertionError(
                f"attention kernels disagree at {dtype} Kh={Kh} T={T} rate={rate}: "
                f"out {err_o} (tol {tol_o}), lse {err_l} (tol {tol_l}), "
                f"grads {err_g} (tol 1e-4 of the largest)")
        err["flash_attention_fwd"] = max(err["flash_attention_fwd"], err_o, err_l)
        err["flash_attention_bwd"] = max(err["flash_attention_bwd"], max(
            (a - b).abs().max().item() for a, b in zip(grads, ref_grads)))
        return err_o, err_l, err_g

    # The main path's two shapes and bench config 5's two: errors, then
    # chained and single-call times of the kernels, their plain versions and
    # torch's fused attention.
    for where, shp in {**MAIN_PATH, **LONGFORM_ATTENTION}.items():
        Bm, Hm, Km, T, Dm, rate = (shp[k] for k in ("B", "H", "Kh", "T", "D", "rate"))
        q, k, v, g, mask = attention_inputs(Bm, Hm, Km, T, Dm, torch.bfloat16)
        seed = 77
        out, lse, m, l = fa._fwd(q, k, v, mask, rate, seed)
        ref_out, ref_lse, _, _ = flash_attention_fwd_stats_ref(q, k, v, mask, rate, seed)
        delta = (g * out).sum(-1)
        grads = fa._bwd(q, k, v, mask, m, l, delta, g, rate, seed)
        ref_grads = flash_attention_bwd_ref(q, k, v, mask, m, l, delta, g, rate, seed)
        err_o, err_l, err_g = check(torch.bfloat16, Km, T, rate, out, lse, grads, ref_out,
                                    ref_lse, ref_grads)
        # The kernels timed as ab_attention.py times them: the same calls
        # (its seed), in the same order, before anything else runs here.
        fwd, bwd = kernel_calls(fa, q, k, v, g, mask, rate)
        timed = time_calls((fwd, bwd))  # chained fwd, bwd; device fwd, bwd
        chained = dict(zip(("flash_attention_fwd", "flash_attention_bwd"), timed[:2]))
        device = dict(zip(("flash_attention_fwd", "flash_attention_bwd"), timed[2:]))
        fwd_plain = lambda: flash_attention_fwd_stats_ref(q, k, v, mask, rate, seed)  # noqa: E731
        bwd_plain = lambda: flash_attention_bwd_ref(  # noqa: E731
            q, k, v, mask, m, l, delta, g, rate, seed)
        lib = _sdpa_yardstick(q, k, v, mask, g, rate)
        row = {}
        for kname, kernel, plain, library in (("flash_attention_fwd", fwd, fwd_plain, lib[0]),
                                              ("flash_attention_bwd", bwd, bwd_plain, lib[1])):
            plain_ms, plain_chained = _times(plain)
            row[kname] = dict(ms=device[kname], chained_ms=chained[kname],
                              median_ms=_median_ms(kernel), plain_ms=plain_ms,
                              plain_chained_ms=plain_chained, library_ms=library[0],
                              library_chained_ms=library[1], library_kernels=library[2],
                              **kernel_bounds(kname, B=Bm, H=Hm, Kh=Km, T=T, D=Dm))
        times[where] = row
        del q, k, v, g, mask, out, lse, m, l, delta, grads, ref_out, ref_lse, ref_grads
        torch.cuda.empty_cache()
        print(f"attention path ({where}) bf16 B={Bm} H={Hm} Kh={Km} T'={T} D={Dm} "
              f"rate={rate}: max|out-ref|={err_o:.3e} max|lse-ref|={err_l:.3e} grads rel "
              f"{err_g:.3e}", flush=True)
        for kname, r in row.items():
            print(f"  {kname} (device ms; {CHAINED_CALLS} chained calls): kernel {r['ms']:.4f} "
                  f"({r['chained_ms']:.4f}; single {r['median_ms']:.4f}), plain "
                  f"{r['plain_ms']:.4f} ({r['plain_chained_ms']:.4f}), torch SDPA "
                  f"{r['library_ms']:.4f} ({r['library_chained_ms']:.4f}; "
                  f"{', '.join(r['library_kernels'])}); bound "
                  f"{r['bound_ms']:.4f} ms by {r['bound_by']} ({r['flops'] / 1e9:.3f} GFLOP, "
                  f"{r['bytes'] / 1e6:.3f} MB)", flush=True)

    # MHA (Kh = H) has no main-path shape: the A/B's B=4, T'=801, rate 0,
    # bf16, timed as the main path's shapes are, beside torch's SDPA.
    T = max(SWEEP["T"])
    q, k, v, g, mask = attention_inputs(B, H, H, T, D, torch.bfloat16)
    out, _, m, l = fa._fwd(q, k, v, mask, 0.0, 5)
    delta = (g * out).sum(-1)
    lib = _sdpa_yardstick(q, k, v, mask, g, 0.0)
    times["mha"] = {}
    for kname, kernel, plain, library in (
            ("flash_attention_fwd", lambda: fa._fwd(q, k, v, mask, 0.0, 5),
             lambda: flash_attention_fwd_stats_ref(q, k, v, mask, 0.0, 5), lib[0]),
            ("flash_attention_bwd", lambda: fa._bwd(q, k, v, mask, m, l, delta, g, 0.0, 5),
             lambda: flash_attention_bwd_ref(q, k, v, mask, m, l, delta, g, 0.0, 5), lib[1])):
        (ms, chained), (plain_ms, plain_chained) = _times(kernel), _times(plain)
        r = times["mha"][kname] = dict(
            ms=ms, chained_ms=chained, plain_ms=plain_ms, plain_chained_ms=plain_chained,
            library_ms=library[0], library_chained_ms=library[1], library_kernels=library[2],
            **kernel_bounds(kname, B=B, H=H, Kh=H, T=T, D=D))
        print(f"attention MHA bf16 B={B} H={H} Kh={H} T'={T} D={D} rate=0 {kname} (device ms; "
              f"chained): kernel {r['ms']:.4f} ({r['chained_ms']:.4f}), plain {r['plain_ms']:.4f} "
              f"({r['plain_chained_ms']:.4f}), torch SDPA {r['library_ms']:.4f} "
              f"({r['library_chained_ms']:.4f}; {', '.join(r['library_kernels'])}); bound "
              f"{r['bound_ms']:.4f} ms by {r['bound_by']}", flush=True)
    del q, k, v, g, mask, out

    for dtype in (torch.float32, torch.bfloat16):
        for Kh in SWEEP["Kh"]:
            for T in SWEEP["T"]:
                q = torch.randn(B, H, T, D, generator=gen).to("cuda", dtype)
                k = torch.randn(B, Kh, T, D, generator=gen).to("cuda", dtype)
                v = torch.randn(B, Kh, T, D, generator=gen).to("cuda", dtype)
                g = torch.randn(B, H, T, D, generator=gen).cuda()
                lens = torch.tensor([T, (2 * T) // 3, 0, 1])
                mask = (torch.arange(T)[None, :] < lens[:, None]).cuda()
                for rate in SWEEP["rate"]:
                    seed = 1000 + T
                    out, lse, m, l = fa._fwd(q, k, v, mask, rate, seed)
                    ref_out, ref_lse, _, _ = flash_attention_fwd_stats_ref(q, k, v, mask, rate, seed)
                    delta = (g * out).sum(-1)
                    grads = fa._bwd(q, k, v, mask, m, l, delta, g, rate, seed)
                    ref_grads = flash_attention_bwd_ref(q, k, v, mask, m, l, delta, g, rate, seed)
                    err_o, err_l, err_g = check(dtype, Kh, T, rate, out, lse, grads, ref_out,
                                                ref_lse, ref_grads)
                    fwd_ms = _median_ms(lambda: fa._fwd(q, k, v, mask, rate, seed))
                    fwd_plain = _median_ms(
                        lambda: flash_attention_fwd_stats_ref(q, k, v, mask, rate, seed))
                    bwd_ms = _median_ms(lambda: fa._bwd(q, k, v, mask, m, l, delta, g, rate, seed))
                    bwd_plain = _median_ms(lambda: flash_attention_bwd_ref(
                        q, k, v, mask, m, l, delta, g, rate, seed))
                    print(f"attention {str(dtype)[6:]} B={B} H={H} Kh={Kh} T'={T} D={D} "
                          f"rate={rate}: max|out-ref|={err_o:.3e} max|lse-ref|={err_l:.3e} "
                          f"grads rel {err_g:.3e}; fwd kernel {fwd_ms:.4f} ms, plain "
                          f"{fwd_plain:.4f} ms; bwd kernel {bwd_ms:.4f} ms, plain "
                          f"{bwd_plain:.4f} ms", flush=True)

    T = max(SWEEP["T"])
    keep = fa.dump_keep_mask(B, H, T, 0xC0FFEE, 0.1, "cuda")
    want = keep_mask_ref(0xC0FFEE, B, H, T, 0.1, "cuda")
    if not torch.equal(keep, want):
        raise AssertionError(f"dump kernel differs from the plain hash in "
                             f"{(keep != want).sum().item()} elements")
    share = keep.float().mean().item()
    if abs(share - 0.9) > 5 * math.sqrt(0.09 / keep.numel()):
        raise AssertionError(f"kept share {share} is not within 5 sigma of 0.9")
    dump = lambda: fa.dump_keep_mask(B, H, T, 7, 0.1, "cuda")  # noqa: E731
    dump_plain = lambda: keep_mask_ref(7, B, H, T, 0.1, "cuda")  # noqa: E731
    (ms, chained), (plain_ms, plain_chained) = _times(dump), _times(dump_plain)
    kernels = _one_kernel(dump, "dump_keep_mask_kernel")
    times["dropout_mask"] = dict(ms=ms, chained_ms=chained, median_ms=_median_ms(dump),
                                 plain_ms=plain_ms, plain_chained_ms=plain_chained,
                                 library_ms=None, device_kernels_per_call=kernels,
                                 **kernel_bounds("dropout_mask", B=B, H=H, T=T))
    err["dropout_mask"] = 0.0
    r = times["dropout_mask"]
    print(f"dropout dump B={B} H={H} T'={T}: bit-identical to the plain hash, kept share "
          f"{share:.5f}, {kernels:.2f} device kernels a call (the dump kernel alone); device ms "
          f"(chained): kernel {r['ms']:.4f} ({r['chained_ms']:.4f}; single {r['median_ms']:.4f}), "
          f"plain {r['plain_ms']:.4f} ({r['plain_chained_ms']:.4f}); bound {r['bound_ms']:.4f} ms "
          f"by {r['bound_by']}", flush=True)
    del keep, want
    # Rows that cross the kernel's 16-byte groups at every phase (B*H odd).
    for T in DUMP_EDGES:
        keep = fa.dump_keep_mask(3, 3, T, 0xBEEF + T, 0.3, "cuda")
        if not torch.equal(keep, keep_mask_ref(0xBEEF + T, 3, 3, T, 0.3, "cuda")):
            raise AssertionError(f"dump kernel differs from the plain hash at B=3 H=3 T'={T}")
    print(f"dropout dump B=3 H=3 T' in {DUMP_EDGES}: bit-identical to the plain hash", flush=True)
    # Past 2^31 elements (32-bit indices) and past 2^32 (the 64-bit
    # instance): the rows around each boundary and the last rows against
    # the plain hash of those rows alone.
    for T in DUMP_LARGE:
        keep = fa.dump_keep_mask(1, 1, T, 0xC0FFEE, 0.1, "cuda")
        rows = sorted({0, (2 ** 31) // T, (2 ** 32) // T, T - 2, T - 1} & set(range(T)))
        want = keep_rows_ref(0xC0FFEE, 0, 1, 0, rows, T, 0.1, "cuda")
        if not torch.equal(keep[0, 0, rows], want):
            raise AssertionError(f"dump kernel differs from the plain hash at T'={T}, rows {rows}")
        large_ms = _times(lambda: fa.dump_keep_mask(1, 1, T, 7, 0.1, "cuda"), calls=5)[0]
        print(f"dropout dump B=1 H=1 T'={T} ({T * T} elements): rows {rows} bit-identical to the "
              f"plain hash; device {large_ms:.4f} ms, bound "
              f"{kernel_bounds('dropout_mask', B=1, H=1, T=T)['bound_ms']:.4f} ms", flush=True)
        times["dropout_mask"].setdefault("large", {})[T] = large_ms
        del keep
        torch.cuda.empty_cache()
    return err, times


def _sdpa_yardstick(q, k, v, mask, g, rate):
    """((device ms, chained ms, its device kernels) of the forward, the same
    of the backward) of torch's fused attention on the kernels' inputs: the
    library yardstick, timed here and never called by the port. The
    kernels (by torch.profiler, the longest first) name the backend SDPA
    chose (a padding mask rules out its FlashAttention backend). MQA k/v go in with
    enable_gqa=True, or expanded to the query heads (a view) where this
    torch's SDPA has no such keyword. Every row gets a valid key (SDPA
    gives NaN for a row with none; only its time is used)."""
    import torch.nn.functional as F
    H = q.shape[1]
    lib_mask = mask.clone()
    lib_mask[:, 0] = True
    attn_mask = lib_mask[:, None, None, :]
    qq, kk, vv = (t.detach().requires_grad_(True) for t in (q, k, v))

    def call():
        try:
            return F.scaled_dot_product_attention(qq, kk, vv, attn_mask=attn_mask,
                                                  dropout_p=rate, enable_gqa=True)
        except TypeError:  # no enable_gqa keyword
            return F.scaled_dot_product_attention(
                qq, kk.expand(-1, H, -1, -1), vv.expand(-1, H, -1, -1), attn_mask=attn_mask,
                dropout_p=rate)

    from turkish_asr_torch.scripts.ab_attention import kernel_split

    def timed(fn):
        split = sorted(kernel_split(fn).items(), key=lambda kv: -kv[1])[:3]
        return (*_times(fn), [re.split(r"[<(]", name)[0].strip() for name, _ in split])

    with torch.no_grad():
        fwd = timed(call)
    out, g16 = call(), g.to(q.dtype)
    bwd = timed(lambda: torch.autograd.grad(out, (qq, kk, vv), g16, retain_graph=True))
    return fwd, bwd


def ctc_phase():
    from turkish_asr_torch.ops import ctc
    from turkish_asr_torch.ops._ctc import ctc_bwd_ref, ctc_fwd_ref, ctc_topology
    from turkish_asr_torch.scripts.ab_attention import device_kernels
    from turkish_asr_torch.scripts.ab_ctc import calls_of, ctc_inputs, kernel_stats

    B = CTC_SHAPES["B"]
    err = {"ctc_fwd": 0.0, "ctc_bwd": 0.0}
    times = {}
    shapes = [(T, L, V) for T in CTC_SHAPES["T"] for L in CTC_SHAPES["L"]
              for V in CTC_SHAPES["V"]] + list(CTC_EDGES)
    for T, L, V in shapes:
        lp, tg, il, tl, cot = ctc_inputs(B, T, L, V)
        ext, skip = ctc_topology(tg, 0)
        nll, alpha = ctc._forward(lp, tg, il, tl, 0)
        grad = ctc._backward(lp, tg, il, tl, alpha, nll, cot, 0)
        ref_nll, ref_alpha = ctc_fwd_ref(lp, ext, skip, il, tl)
        ref_grad = ctc_bwd_ref(lp, ext, skip, il, tl, ref_alpha, ref_nll, cot)
        torch.cuda.synchronize()
        if not (torch.isfinite(nll).all() and torch.isfinite(grad).all()):
            raise AssertionError(f"non-finite CTC output at T={T} L={L} V={V}")
        err_f = ((nll - ref_nll).abs() / (1.0 + ref_nll.abs())).max().item()
        err_b = ((grad - ref_grad).abs() / (1.0 + ref_grad.abs())).max().item()
        if ((nll - ref_nll).abs() > 1e-5 * ref_nll.abs() + 1e-4).any() or err_b > 1e-4:
            raise AssertionError(f"CTC kernels disagree at T={T} L={L} V={V}: "
                                 f"nll {err_f} (tol 1e-5 rel + 1e-4), grad {err_b} "
                                 f"(tol 1e-4 of 1 + |plain|)")
        feasible = 2 * tl <= il  # rows whose losses are not the 1e30 sentinel
        if feasible.any():
            err["ctc_fwd"] = max(err["ctc_fwd"], (nll - ref_nll)[feasible].abs().max().item())
        err["ctc_bwd"] = max(err["ctc_bwd"], (grad - ref_grad).abs().max().item())
        fwd = lambda: ctc._forward(lp, tg, il, tl, 0)  # noqa: E731
        bwd = lambda: ctc._backward(lp, tg, il, tl, alpha, nll, cot, 0)  # noqa: E731
        fwd_plain = lambda: ctc_fwd_ref(lp, ext, skip, il, tl)  # noqa: E731
        bwd_plain = lambda: ctc_bwd_ref(lp, ext, skip, il, tl, ref_alpha, ref_nll, cot)  # noqa: E731
        fwd_ms = _median_ms(fwd, reps=5, warmup=1)
        bwd_ms = _median_ms(bwd, reps=5, warmup=1)
        fwd_plain_ms = _median_ms(fwd_plain, reps=3, warmup=1)
        bwd_plain_ms = _median_ms(bwd_plain, reps=3, warmup=1)
        plans = {k: tuple(ctc.ctc_plan(k, 2 * L + 1, T)[:3]) for k in ("fwd", "bwd")}
        impossible = int((2 * tl > il).sum().item())
        print(f"ctc B={B} T'={T} L={L} V={V} (S={2 * L + 1}, {impossible} rows with more "
              f"labels than half the frames; plan (warps, lanes, chunk) {plans}): nll rel "
              f"{err_f:.3e}, grad {err_b:.3e}; fwd kernel {fwd_ms:.4f} ms, plain "
              f"{fwd_plain_ms:.4f} ms; bwd kernel {bwd_ms:.4f} ms, plain {bwd_plain_ms:.4f} ms",
              flush=True)
        if dict(B=B, T=T, L=L, V=V) == CTC_MAIN:
            first, second = ctc._backward(lp, tg, il, tl, alpha, nll, cot, 0), bwd()
            torch.cuda.synchronize()
            if not torch.equal(first, second):
                raise AssertionError("two CTC backward calls differ")
            lib_fwd, lib_bwd = _ctc_yardstick(lp, tg, il, tl, cot)
            loss_fwd, loss_bwd = calls_of(ctc.CTCNegLogLikelihood, lp, tg, il, tl, cot)
            for name, kernel, plain_fn, median, lib, whole in (
                    ("ctc_fwd", fwd, fwd_plain, fwd_ms, lib_fwd, loss_fwd),
                    ("ctc_bwd", bwd, bwd_plain, bwd_ms, lib_bwd, loss_bwd)):
                ms, chained = _times(kernel)
                _, kernel_ms, _ = kernel_stats(kernel)
                launches = sum(device_kernels(whole).values())
                # the plain recursion launches thousands of small kernels a call
                plain_ms, plain_chained = _times(plain_fn, calls=2)
                times[name] = dict(ms=ms, chained_ms=chained, median_ms=median,
                                   kernel_ms=kernel_ms, device_kernels_per_call=launches,
                                   plain_ms=plain_ms, plain_chained_ms=plain_chained,
                                   library_ms=lib[0], library_chained_ms=lib[1],
                                   **kernel_bounds(name, **CTC_MAIN))
                r = times[name]
                print(f"  {name} (device ms; chained): wrapper {r['ms']:.4f} "
                      f"({r['chained_ms']:.4f}), the kernel alone {r['kernel_ms']:.4f} "
                      f"(profiler), plain {r['plain_ms']:.4f} ({r['plain_chained_ms']:.4f}), "
                      f"torch ctc_loss {r['library_ms']:.4f} ({r['library_chained_ms']:.4f}); "
                      f"bound {r['bound_ms']:.5f} ms by {r['bound_by']} "
                      f"({r['bytes'] / 1e6:.3f} MB)", flush=True)
            print(f"device kernels one ctc_loss forward launches: "
                  f"{times['ctc_fwd']['device_kernels_per_call']:.0f}, one backward: "
                  f"{times['ctc_bwd']['device_kernels_per_call']:.0f} (the parent tree's "
                  f"in ab_ctc.py's output)", flush=True)
        del lp, grad, ref_grad, alpha, ref_alpha
        torch.cuda.empty_cache()
    mismatches = ctc.log1p_unit_mismatches()
    if mismatches:
        raise AssertionError(f"the CTC kernels' log1p differs from log1pf at {mismatches} floats "
                             f"in [0, 1] or NaNs")
    print("the CTC kernels' branch-free log1p equals log1pf bit for bit on every float in "
          "[0, 1] and every NaN", flush=True)
    return err, times


def _ctc_yardstick(lp, targets, il, tl, cot):
    """((device ms, chained ms) of torch.nn.functional.ctc_loss (reduction
    none, zero_infinity), the same of its gradient through autograd) on the
    kernels' inputs: the library yardstick, never called by the port."""
    import torch.nn.functional as F
    x = lp.detach().requires_grad_(True)

    def call():
        return F.ctc_loss(x.transpose(0, 1), targets, il, tl, blank=0, reduction="none",
                          zero_infinity=True)

    with torch.no_grad():
        fwd = _times(call)
    loss = call()
    return fwd, _times(lambda: torch.autograd.grad(loss, x, cot, retain_graph=True))


def _one_kernel(fn, name):
    """The device kernels one call of ``fn`` launches (torch.profiler over
    20 calls, the fullest of five windows: the profiler on the card now and
    then drops a window's events, or some of them): raises unless the only
    kernel is the one whose name holds ``name``, about once a call."""
    from turkish_asr_torch.scripts.ab_attention import device_kernels
    kernels = device_kernels(fn)
    launches = sum(kernels.values())
    if any(name not in key for key in kernels) or round(launches) != 1:
        raise AssertionError(f"one call launched {kernels}; expected {name} alone, once")
    return launches


def swiglu_phase():
    """The SwiGLU library's SASS (every instance on wgmma, the TMA ones with
    TMA loads, no mma.sync) and ptxas report (no spills), the port's A/B
    at each shape (its kernel launches counted), then the kernel at every
    row tile against the fused plain version, two calls' bits, the edges
    and the device kernels a call.

    Returns (launches in the A/B runs, max abs error, times): the kernel's,
    the fused plain version's and the chain's times and the bound at the
    first shape, the same at Conformer-L's first under "conformer_l", the
    SASS counts, and cuBLAS's two products alone ("cublas_products_ms", a
    yardstick). No single torch call computes the fused FFN: library_ms is
    None."""
    from turkish_asr_torch.ops import _build, swiglu as sw
    from turkish_asr_torch.ops._swiglu import swiglu_chain, swiglu_fused_ref
    from turkish_asr_torch.scripts import ab_swiglu

    sass = library_sass({"swiglu_fwd": sw.SOURCES})["swiglu_fwd"]
    spills = ptxas_spills(_build.library_path("swiglu_fwd", sw.SOURCES)
                          .with_suffix(".log").read_text())
    if spills:
        raise AssertionError(f"swiglu_fwd instances spill (store, load bytes): {spills}")
    print(f"swiglu_fwd: {len(sass)} instances, no spills; HMMA in the library: "
          f"{sum(c['HMMA'] for c in sass.values())}", flush=True)

    _reset_counts("swiglu_fwd")
    ab = [ab_swiglu.main([str(M), str(C), str(F)]) for M, C, F in SWIGLU_SHAPES]
    launches = _counts()["swiglu_fwd"]
    if launches == 0:
        raise AssertionError("the SwiGLU A/B launched no kernel")
    print(f"kernel launches in the SwiGLU A/B runs: {launches}", flush=True)

    rng = np.random.default_rng(1)
    err, by_width = 0.0, {}
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    fsplits = set()

    def check(M, C, F, args, label):
        """Every tile against the fused plain version, into a block the
        allocator last held as NaN; returns the largest error."""
        ref = swiglu_fused_ref(*args)
        tol = 2.0 ** -7 * ref.abs().max().item()
        worst = 0.0
        for tm in sw.row_tiles(C):
            # The allocator hands the kernel's output the block this NaN
            # tensor frees, so a row the kernel leaves unwritten shows.
            poison = torch.full((M, C), float("nan"), dtype=torch.bfloat16, device="cuda")
            del poison
            y = sw.swiglu(*args, tm=tm)
            torch.cuda.synchronize()
            rows = torch.isfinite(y.float()).all(dim=1)
            if not rows.all():
                raise AssertionError(f"swiglu {label} tm={tm}: {(~rows).sum().item()} rows not "
                                     f"finite, the first {torch.nonzero(~rows)[0].item()}")
            e = (y.float() - ref.float()).abs().max().item()
            if e > tol:
                raise AssertionError(f"swiglu {label} tm={tm}: max|kernel - plain| {e} > {tol} "
                                     f"(2^-7 max|plain|)")
            worst = max(worst, e)
        plans = {tm: sw.swiglu_plan(M, C, F, tm, sms) for tm in sw.row_tiles(C)}
        fsplits.update(p.cluster for p in plans.values())
        print(f"swiglu {label}: every row finite at tm {sw.row_tiles(C)} (plans (grid, "
              f"fsplit) {({tm: (p.grid, p.cluster) for tm, p in plans.items()})}), "
              f"max|kernel - plain| {worst:.3e} (tol {tol:.3e})", flush=True)
        return worst

    for (M, C, F), result in zip(SWIGLU_SHAPES, ab):
        x, w1, b1, w2, b2 = ab_swiglu.make_inputs(M, C, F)
        b1 = (0.1 * rng.standard_normal(b1.shape)).astype(np.float32)
        b2 = (0.1 * rng.standard_normal(b2.shape)).astype(np.float32)
        args = sw.args_from_numpy(x, w1, b1, w2, b2, "cuda")
        err = max(err, check(M, C, F, args, f"M={M} C={C} F={F}"))
        kernel_ms = _median_ms(lambda: sw.swiglu(*args))
        plain_ms = _median_ms(lambda: swiglu_fused_ref(*args))
        chain_ms = _median_ms(lambda: swiglu_chain(*args))
        if C not in by_width:  # each width's first shape
            first, second = sw.swiglu(*args), sw.swiglu(*args)
            torch.cuda.synchronize()
            if not torch.equal(first.view(torch.int16), second.view(torch.int16)):
                raise AssertionError(f"two swiglu calls at M={M} C={C} differ")
            kernels = _one_kernel(lambda: sw.swiglu(*args), "swiglu_fwd_kernel")
            (ms, chained), (plain, plain_chained) = (_times(lambda: sw.swiglu(*args)),
                                                     _times(lambda: swiglu_fused_ref(*args)))
            t = by_width[C] = dict(
                M=M, C=C, F=F, tm=sw.default_tile(C), ms=ms, chained_ms=chained,
                median_ms=kernel_ms, plain_ms=plain, plain_chained_ms=plain_chained,
                library_ms=None, chain_ms=_times(lambda: swiglu_chain(*args))[0],
                cublas_products_ms=result["cublas_products"]["ms"],
                device_kernels_per_call=kernels, **kernel_bounds("swiglu_fwd", M=M, C=C, F=F))
            print(f"swiglu M={M} C={C}: two calls bit-identical; {kernels:.2f} device kernels a "
                  f"call (swiglu_fwd_kernel alone); device ms (chained): kernel {ms:.4f} "
                  f"({chained:.4f}), fused plain {plain:.4f} ({plain_chained:.4f}), chain "
                  f"{t['chain_ms']:.4f}, cuBLAS products {t['cublas_products_ms']:.4f}; bound "
                  f"{t['bound_ms']:.4f} ms by {t['bound_by']}", flush=True)
        print(f"swiglu M={M} C={C} F={F}: kernel (tm={sw.default_tile(C)}) {kernel_ms:.4f} ms, "
              f"fused plain {plain_ms:.4f} ms, chain {chain_ms:.4f} ms (single-call medians)",
              flush=True)
    # The edges: C, F and M off every tile and chunk (the copy path), F off
    # the 64-unit chunk through TMA, F % 8 == 4 and C % 8 != 0 (the copy
    # path at width); the M at which the plan splits F four and eight ways.
    for M, Ce, Fe in SWIGLU_EDGES:
        x, w1, b1, w2, b2 = (rng.standard_normal(shape).astype(np.float32) * scale
                             for shape, scale in (((M, Ce), 1.0), ((Ce, 2 * Fe), 0.05),
                                                  ((1, 2 * Fe), 0.1), ((Fe, Ce), 0.05),
                                                  ((1, Ce), 0.1)))
        args = sw.args_from_numpy(x, w1, b1, w2, b2, "cuda")
        aligned = sw.swiglu_plan(M, Ce, Fe, sw.default_tile(Ce), sms).aligned
        err = max(err, check(M, Ce, Fe, args, f"M={M} C={Ce} F={Fe} "
                                               f"({'TMA' if aligned else 'copy path'})"))
    if fsplits != set(sw.FSPLITS):
        raise AssertionError(f"the SwiGLU checks split F {sorted(fsplits)} ways on {sms} SMs, "
                             f"not every split of {sw.FSPLITS}")
    times = dict(by_width[256], conformer_l=by_width[512], sass=sass)
    return launches, err, times


def _write_corpus(root, n):
    from turkish_asr_torch.audio.wavio import write_wav
    os.makedirs(root)
    rng = np.random.default_rng(0)
    for i in range(n):
        seconds = (1.0, 2.5, 4.0, 6.0, 8.0)[i % 5]
        words = [WORDS[j] for j in rng.integers(0, len(WORDS), max(1, int(seconds)))]
        write_wav(os.path.join(root, f"u{i:03d}.wav"), _tone(seconds, 100 + i), SR)
        with open(os.path.join(root, f"u{i:03d}.txt"), "w", encoding="utf-8") as f:
            f.write(" ".join(words))


def train_phase(workdir):
    """Returns (the kernel counts of the main training run, the final .pt,
    the resumed run's Trainer)."""
    from turkish_asr_torch.main import main as train_main
    from turkish_asr_torch.train.trainer import Trainer

    corpus = os.path.join(workdir, "corpus")
    _write_corpus(corpus, 110)  # 99 train (4 batches of <= 32), 11 valid
    run = os.path.join(workdir, "run")
    argv = ["--data_path", corpus, "--val_split", "0.1", "--test_split", "0.0",
            "--n_mel_channels", "80", "--d_model", "256", "--n_heads", "4", "--n_blocks", "8",
            "--encoder_dropout", "0.1", "--augment", "--precision", "bf16", "--batch_size", "32",
            "--learning_rate", "1e-3", "--save_interval", "1", "--log_interval", "1",
            "--num_workers", "4", "--device", "cuda"]

    per_step = []
    real_step = Trainer.train_step

    def counted_step(self, batch, seed):
        before = _counts()
        loss = real_step(self, batch, seed)
        torch.cuda.synchronize()
        after = _counts()
        per_step.append({k: after[k] - before[k] for k in after})
        return loss

    _reset_counts()
    start = time.perf_counter()
    with mock.patch.object(Trainer, "train_step", counted_step):
        trainer = train_main(argv + ["--checkpoint_dir", run, "--epochs", str(TRAIN_EPOCHS)])
    counts = _counts()
    seconds = time.perf_counter() - start
    losses = trainer.losses
    print(f"training: {len(losses)} steps ({trainer.global_step} optimizer steps) in "
          f"{seconds:.3f} s; losses {[round(x, 4) for x in losses]}", flush=True)
    print(f"kernel launches in the training run: {counts}", flush=True)
    if trainer.global_step < 20 or not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"training: {trainer.global_step} optimizer steps, losses {losses}")
    first, last = statistics.mean(losses[:3]), statistics.mean(losses[-3:])
    if not last < first:
        raise AssertionError(f"training loss did not fall: first 3 {first}, last 3 {last}")
    for i, step in enumerate(per_step):
        if (step["flash_attention_fwd"] < 16 or step["flash_attention_bwd"] != 8
                or step["ctc_fwd"] != 1 or step["ctc_bwd"] != 1):
            raise AssertionError(f"step {i} launched {step}; expected attention forward >= 16, "
                                 f"backward 8, CTC forward 1 and backward 1")
    print(f"every step: {per_step[0]} (first), loss {first:.4f} -> {last:.4f} "
          f"(mean of the first and last 3)", flush=True)
    names = set(os.listdir(run))
    want = {f"checkpoint_epoch_{e}.pt" for e in range(1, TRAIN_EPOCHS + 1)}
    want |= {"best_model.pt", "turkish_conformer_final.pt"}
    if not want <= names:
        raise AssertionError(f"checkpoints missing: {sorted(want - names)}")

    resumed = train_main(argv + ["--checkpoint_dir", run, "--epochs", str(TRAIN_EPOCHS + 1),
                                 "--resume"])
    if resumed.start_epoch != TRAIN_EPOCHS + 1 or resumed.global_step <= trainer.global_step:
        raise AssertionError(f"resume: start epoch {resumed.start_epoch}, global step "
                             f"{resumed.global_step} after {trainer.global_step}")
    print(f"resumed at epoch {resumed.start_epoch}: global step {trainer.global_step} -> "
          f"{resumed.global_step}, losses {[round(x, 4) for x in resumed.losses]}", flush=True)

    accum = train_main(argv + ["--checkpoint_dir", os.path.join(workdir, "run_accum"),
                               "--epochs", "1", "--accumulation_steps", "2"])
    micro = len(accum.losses)
    if accum.global_step != -(-micro // 2) or not all(math.isfinite(x) for x in accum.losses):
        raise AssertionError(f"accumulation 2: {micro} micro-steps gave {accum.global_step} "
                             f"optimizer steps, losses {accum.losses}")
    print(f"--accumulation_steps 2: {micro} micro-steps, {accum.global_step} optimizer steps, "
          f"losses {[round(x, 4) for x in accum.losses]}", flush=True)
    return counts, os.path.join(run, "turkish_conformer_final.pt"), resumed


def gradient_check():
    """One fp32 train step, kernels against plain versions, same seeds."""
    from turkish_asr_torch.models.conformer import ModelConfig, init_model
    from turkish_asr_torch.ops import ctc, flash_attention as fa
    from turkish_asr_torch.ops._ctc import ctc_bwd_ref, ctc_fwd_ref, ctc_topology
    from turkish_asr_torch.ops._flash_attention import (
        flash_attention_bwd_ref, flash_attention_fwd_stats_ref)
    from turkish_asr_torch.train.trainer import Trainer

    cfg = ModelConfig(n_mels=80, d_model=256, n_heads=4, n_blocks=8, n_classes=56, dropout=0.1)
    model = init_model(cfg, torch.Generator().manual_seed(1)).cuda()
    rng = np.random.default_rng(5)
    B, S = 8, 8 * SR
    lens = np.asarray([S, S, 6 * SR, 5 * SR, 4 * SR, 3 * SR, 2 * SR, 640], np.int32)
    wav = np.zeros((B, S), np.float32)
    for i, n in enumerate(lens):
        wav[i, :n] = _tone(n / SR, 50 + i)
    tl = np.asarray([40, 35, 30, 25, 20, 15, 10, 0], np.int32)
    batch = {"waveforms": wav, "wav_lengths": lens,
             "targets": rng.integers(1, 56, (B, 64)).astype(np.int32), "target_lengths": tl,
             "sample_mask": np.asarray([1] * 7 + [0], np.float32)}
    config = types.SimpleNamespace(no_remat=False, spec_augment_freq=27, spec_augment_time=100)
    trainer = Trainer(model, None, None, config, mock.Mock(), device="cuda",
                      compute_dtype=torch.float32)
    names, params = zip(*[(n, p) for n, p in model.named_parameters() if p.requires_grad])

    def step():
        loss, bn, _, _ = trainer._loss(trainer._to_device(batch), True, seed=1234)
        grads = torch.autograd.grad(loss, params)
        return loss.item(), grads, bn

    loss_k, grads_k, bn_k = step()
    with mock.patch.object(fa, "_fwd", flash_attention_fwd_stats_ref), \
            mock.patch.object(fa, "_bwd", flash_attention_bwd_ref), \
            mock.patch.object(ctc, "_forward", lambda lp, tg, il, tl, blank: ctc_fwd_ref(
                lp, *ctc_topology(tg, blank), il, tl)), \
            mock.patch.object(ctc, "_backward", lambda lp, tg, il, tl, alpha, nll, cot, blank:
                              ctc_bwd_ref(lp, *ctc_topology(tg, blank), il, tl, alpha, nll, cot)):
        before = _counts()
        loss_p, grads_p, bn_p = step()
        if _counts() != before:
            raise AssertionError("the plain step launched a kernel")
    # Each tensor's difference over its largest element, floored at 1e-4 of
    # the largest gradient anywhere: the depthwise convs' biases feed
    # BatchNorm with batch statistics, which removes them exactly, so their
    # gradients are rounding noise on both sides.
    floor = 1e-4 * max(g.abs().max().item() for g in grads_p)
    rel = {n: (a - b).abs().max().item() / max(b.abs().max().item(), floor)
           for n, a, b in zip(names, grads_k, grads_p)}
    worst_name = max(rel, key=rel.get)
    worst = rel[worst_name]
    bn_err = max((a - b).abs().max().item() for x, y in zip(bn_k, bn_p) for a, b in zip(x, y))
    print(f"gradient check (fp32, flagship, dropout 0.1, B={B}): loss kernel {loss_k:.6f}, "
          f"plain {loss_p:.6f}; worst gradient tensor {worst_name}: max|kernel - plain| / "
          f"max|plain| {worst:.3e}; BatchNorm statistics max diff {bn_err:.3e}", flush=True)
    if abs(loss_k - loss_p) > 1e-5 * abs(loss_p) or worst > 1e-3 or bn_err > 1e-4:
        raise AssertionError("the kernel train step disagrees with the plain one")
    return worst


def serve_trained(pt):
    from turkish_asr_torch.serve.server import ASRService, ServerConfig, make_stdlib_server
    from turkish_asr_torch.audio.wavio import write_wav

    server_cfg = ServerConfig()
    server_cfg.MODEL_PATH = pt
    service = ASRService(server_cfg, warmup=False, device="cuda")
    if service.asr is None:
        raise AssertionError(f"the service did not load the trained model {pt}")
    server = make_stdlib_server(service, "127.0.0.1", 0)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    try:
        with tempfile.NamedTemporaryFile(suffix=".wav") as f:
            write_wav(f.name, _tone(4, 9), SR)
            with open(f.name, "rb") as fh:
                content = fh.read()
        status, payload, ms = _post(f"http://127.0.0.1:{server.server_address[1]}/transcribe",
                                    [("file", "trained.wav", content)])
    finally:
        server.shutdown()
        server.server_close()
        thread.join(timeout=60)
    if status != 200 or not isinstance(payload.get("text"), str):
        raise AssertionError(f"/transcribe with the trained model: {status} {payload}")
    print(f"trained .pt served: POST /transcribe {ms:.2f} ms, text={payload['text'][:40]!r}",
          flush=True)


def _multipart(files):
    boundary = uuid.uuid4().hex
    body = b""
    for field, name, content in files:
        body += (f"--{boundary}\r\nContent-Disposition: form-data; name=\"{field}\"; "
                 f"filename=\"{name}\"\r\nContent-Type: audio/wav\r\n\r\n").encode()
        body += content + b"\r\n"
    return body + f"--{boundary}--\r\n".encode(), f"multipart/form-data; boundary={boundary}"


def _tone(seconds, seed):
    rng = np.random.default_rng(seed)
    t = np.arange(int(seconds * SR)) / SR
    x = 0.3 * np.sin(2 * np.pi * (200 + 60 * np.floor(t * 4)) * t)
    return (x + 0.03 * rng.standard_normal(t.shape)).astype(np.float32)


def _post(url, files):
    body, ctype = _multipart(files)
    req = urllib.request.Request(url, data=body, headers={"Content-Type": ctype})
    start = time.perf_counter()
    with urllib.request.urlopen(req, timeout=300) as resp:
        status, payload = resp.status, json.loads(resp.read())
    return status, payload, (time.perf_counter() - start) * 1000


def serving_phase(workdir):
    from turkish_asr_torch.audio.wavio import write_wav
    from turkish_asr_torch.models import attention
    from turkish_asr_torch.models.conformer import ModelConfig, init_model
    from turkish_asr_torch.ops._flash_attention import flash_attention_fwd_ref
    from turkish_asr_torch.serve.server import ASRService, ServerConfig, make_stdlib_server

    cfg = ModelConfig(n_mels=80, d_model=256, n_heads=4, n_blocks=8, n_classes=56, dropout=0.0)
    model = init_model(cfg, torch.Generator().manual_seed(0))
    pt = os.path.join(workdir, "flagship.pt")
    torch.save({"model_state_dict": model.state_dict(),
                "config": {"n_mel_channels": 80, "d_model": 256, "n_heads": 4,
                           "n_blocks": 8, "dropout": 0.0}}, pt)
    wav = {}
    for name, seconds, seed in (("s1", 1, 1), ("s8", 8, 2), ("s24", 24, 3),
                                ("b3", 3, 4), ("b35", 3.5, 5), ("b4", 4, 6)):
        wav[name] = os.path.join(workdir, f"{name}.wav")
        write_wav(wav[name], _tone(seconds, seed), SR)

    server_cfg = ServerConfig()
    server_cfg.MODEL_PATH = pt
    start = time.perf_counter()
    service = ASRService(server_cfg, warmup=True, device="cuda")
    print(f"service ready (load + warmup) in {time.perf_counter() - start:.3f} s", flush=True)
    if service.asr is None:
        raise AssertionError("the service did not load the model")
    server = make_stdlib_server(service, "127.0.0.1", 0)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    base = f"http://127.0.0.1:{server.server_address[1]}"

    def read(name):
        with open(wav[name], "rb") as f:
            return f.read()

    try:
        _reset_counts("flash_attention_fwd")
        forwards = 0
        with urllib.request.urlopen(base + "/health", timeout=60) as resp:
            health = json.loads(resp.read())
        if resp.status != 200 or health["model_loaded"] is not True or health["device"] != "cuda":
            raise AssertionError(f"bad /health: {resp.status} {health}")
        for name in ("s1", "s8", "s24"):
            status, payload, ms = _post(base + "/transcribe", [("file", name + ".wav", read(name))])
            forwards += 1
            if status != 200 or not isinstance(payload.get("text"), str):
                raise AssertionError(f"/transcribe {name}: {status} {payload}")
            print(f"POST /transcribe {name}: {ms:.2f} ms (server {payload['duration_ms']:.2f} ms)"
                  f" text={payload['text'][:40]!r}", flush=True)
        status, payload, ms = _post(base + "/transcribe?timestamps=1",
                                    [("file", "s8.wav", read("s8"))])
        forwards += 1
        if status != 200 or not isinstance(payload.get("text"), str) \
                or not isinstance(payload.get("segments"), list):
            raise AssertionError(f"/transcribe?timestamps=1: {status} {payload}")
        print(f"POST /transcribe?timestamps=1 s8: {ms:.2f} ms, "
              f"{len(payload['segments'])} segments", flush=True)
        before = _counts()["flash_attention_fwd"]
        status, payload, ms = _post(base + "/transcribe/batch",
                                    [("files", n + ".wav", read(n)) for n in ("b3", "b35", "b4")])
        batch_launches = _counts()["flash_attention_fwd"] - before
        forwards += 1  # all three fall in the 4 s bucket: one batched forward
        results = payload.get("results") or []
        if status != 200 or len(results) != 3 or any(
                r["error"] is not None or not isinstance(r["text"], str) for r in results):
            raise AssertionError(f"/transcribe/batch: {status} {payload}")
        # One batched forward launches the forward kernel once a block; the
        # per-file fallback (the batched forward raised) would launch it
        # once a block and file.
        if batch_launches != cfg.n_blocks:
            raise AssertionError(f"/transcribe/batch launched the attention forward "
                                 f"{batch_launches} times; one batched forward launches "
                                 f"{cfg.n_blocks}")
        print(f"POST /transcribe/batch 3 files: {ms:.2f} ms, {batch_launches} attention forward "
              f"launches (one batched forward)", flush=True)
        launches = _counts()["flash_attention_fwd"]
    finally:
        server.shutdown()
        server.server_close()
        thread.join(timeout=60)
    if launches < cfg.n_blocks * forwards:
        raise AssertionError(f"kernel launched {launches} times over {forwards} forwards; "
                             f"expected at least {cfg.n_blocks} per forward")
    print(f"kernel launches on the served path: {launches} over {forwards} forwards", flush=True)

    # Served (kernel) logits vs the same model with the plain attention.
    asr = service.asr
    waveform = _tone(8, 2)
    served, n = asr._forward_padded(waveform)
    asr.compute_dtype = torch.float32
    served_fp32, _ = asr._forward_padded(waveform)
    with mock.patch.object(attention, "flash_attention", flash_attention_fwd_ref):
        plain_fp32, _ = asr._forward_padded(waveform)
        asr.compute_dtype = torch.bfloat16
        plain, _ = asr._forward_padded(waveform)
    served, plain, served_fp32, plain_fp32 = (x[:n] for x in (served, plain, served_fp32,
                                                               plain_fp32))
    if not (np.isfinite(served).all() and served.shape == (n, cfg.n_classes)):
        raise AssertionError(f"served logits: shape {served.shape}, finite "
                             f"{np.isfinite(served).all()}")
    diff = float(np.abs(served - plain).max())
    bf16_noise = float(np.abs(plain - plain_fp32).max())
    agree = float((served.argmax(-1) == plain.argmax(-1)).mean())
    diff32 = float(np.abs(served_fp32 - plain_fp32).max())
    agree32 = float((served_fp32.argmax(-1) == plain_fp32.argmax(-1)).mean())
    print(f"8 s input, {n} frames: max|kernel - plain| = {diff:.4e} (bf16 logits); "
          f"max|plain bf16 - plain fp32| = {bf16_noise:.4e}; argmax agreement {agree:.4f} "
          f"(bf16), {agree32:.4f} (fp32, max|kernel - plain| = {diff32:.4e})", flush=True)
    # Kernel and plain path differ only in summation order; the served
    # logits may differ from the plain path's by no more than bf16 itself
    # moves them from fp32, and their frame argmaxes agree at 0.99. The fp32
    # forward is held to the same agreement and to the 1e-3 of the
    # card-vs-CPU check below.
    if diff > bf16_noise or agree < 0.99 or agree32 < 0.99 or diff32 > 1e-3:
        raise AssertionError("served logits disagree with the plain path")

    # fp32 on the card (kernel) vs fp32 on the CPU (plain path), 1 s input.
    from turkish_asr_torch.audio.features import log_mel_spectrogram
    x = torch.from_numpy(_tone(1, 7))[None]
    lens = torch.tensor([x.shape[1]], dtype=torch.int32)
    with torch.inference_mode():
        outs = []
        for dev in ("cuda", "cpu"):
            m = model.to(dev)
            feats, fl = log_mel_spectrogram(x.to(dev), lens.to(dev))
            outs.append(m(feats, fl, torch.float32).cpu().numpy())
    err_cpu = float(np.abs(outs[0] - outs[1]).max())
    print(f"1 s input fp32: max|card - cpu| = {err_cpu:.4e}", flush=True)
    if err_cpu > 1e-3:
        raise AssertionError("fp32 logits on the card disagree with the CPU")
    return launches


def _beam_times(search, B):
    """One decode's wall ms (host clock, to the synchronize), device ms
    (CUDA events around it: the stream's span, launch gaps included), busy
    ms (the profiler's sum of its kernels' times) and kernels a decode
    (the profiler), medians over BEAM_REPS decodes."""
    search()
    torch.cuda.synchronize()
    wall, events = [], []
    for _ in range(BEAM_REPS):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        t0 = time.perf_counter()
        start.record()
        search()
        end.record()
        end.synchronize()
        wall.append((time.perf_counter() - t0) * 1e3)
        events.append(start.elapsed_time(end))
    out = {"B": B, "wall_ms": statistics.median(wall), "device_ms": statistics.median(events)}
    out["rtfx"] = B * BEAM_SECONDS / (out["wall_ms"] / 1e3)
    if B == BEAM_BATCHES[0]:
        out["kernels"], out["busy_ms"] = _profile_decode(search)
    return out


def _profile_decode(search):
    """(device kernels, their summed ms) of one decode by torch.profiler:
    the fuller of two profiled decodes, since on the card the profiler now
    and then drops events."""
    from torch.profiler import ProfilerActivity, profile
    best = (0, 0.0)
    for _ in range(2):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            search()
            torch.cuda.synchronize()
        evts = [e for e in prof.key_averages() if e.device_type == torch.autograd.DeviceType.CUDA]
        best = max(best, (sum(e.count for e in evts),
                          sum(e.self_device_time_total for e in evts) / 1e3))
    return best


def _beam_against_cpu(name, lp, lens, kw_card, kw_cpu):
    """The card's search against the same function on the CPU, on the
    same log-probs: the best beam's ids must be identical wherever the
    CPU's two best final scores differ by more than 1e-4, and the best
    scores agree within 1e-3. Returns (utterances inside that margin,
    max |best score card - cpu|)."""
    from turkish_asr_torch.ops.beam_search import ctc_beam_search
    L = min(lp.shape[1], 512)
    card = ctc_beam_search(lp, lens, beam_width=BEAM_WIDTH, max_prefix_len=L,
                           return_all_beams=True, **kw_card)
    cpu = ctc_beam_search(lp.cpu(), lens.cpu(), beam_width=BEAM_WIDTH, max_prefix_len=L,
                          return_all_beams=True, **kw_cpu)
    ids_g, cnt_g, sc_g = (x.cpu() for x in card)
    ids_c, cnt_c, sc_c = cpu
    top2 = sc_c.topk(2, dim=1).values
    clear = (top2[:, 0] - top2[:, 1]) > 1e-4
    bg, bc = sc_g.argmax(1), sc_c.argmax(1)
    rows = torch.arange(lp.shape[0])
    same = ((cnt_g[rows, bg] == cnt_c[rows, bc])
            & (ids_g[rows, bg] == ids_c[rows, bc]).all(dim=1))
    score_err = float((sc_g.max(1).values - sc_c.max(1).values).abs().max())
    n_close = int((~clear).sum())
    print(f"beam {name}: card vs cpu at B={lp.shape[0]}, W={BEAM_WIDTH}: best ids identical in "
          f"{int((same & clear).sum())} of {int(clear.sum())} utterances outside the 1e-4 "
          f"margin ({n_close} inside it); max|best score card - cpu| = {score_err:.3e}; "
          f"mean length {float(cnt_c[rows, bc].float().mean()):.1f} tokens", flush=True)
    if not bool(same[clear].all()) or score_err > 1e-3:
        raise AssertionError(f"beam {name}: the card's search disagrees with the CPU's")
    return n_close, score_err


def _timed(fn, log, key):
    """fn, with the ms of each call (to a synchronize) appended to log[key]."""
    def wrapped(*args, **kwargs):
        start = time.perf_counter()
        out = fn(*args, **kwargs)
        torch.cuda.synchronize()
        log.setdefault(key, []).append((time.perf_counter() - start) * 1e3)
        return out
    return wrapped


def beam_phase(workdir):
    """The served beam path with LM fusion, the three decoders against the
    CPU, the sync-free frame loop, and the decode's times and launches.
    Returns (the attention forward's launches on the served beam path,
    the phase's numbers)."""
    from turkish_asr_torch.audio.wavio import write_wav
    from turkish_asr_torch.data.tokenizer import TurkishTokenizer
    from turkish_asr_torch.decode import lm as lmmod
    from turkish_asr_torch.decode.beam import CTCBeamDecoder
    from turkish_asr_torch.inference import ASRInference
    from turkish_asr_torch.ops.beam_search import ctc_beam_search, prepare_lm
    from turkish_asr_torch.scripts.synthetic_arpa import PRODUCTION, synthetic_word_arpa
    from turkish_asr_torch.serve.server import ASRService, ServerConfig, make_stdlib_server

    start_phase = time.perf_counter()
    pt = os.path.join(workdir, "flagship.pt")  # the serving phase's seeded weights
    arpa400 = os.path.join(workdir, "words400.arpa")
    synthetic_word_arpa(arpa400)
    wav = {}
    for name, seconds, seed in (("s8", 8, 20), ("q1", 8, 21), ("q2", 8, 22), ("q3", 8, 23),
                                ("q4", 8, 24), ("h1", 1, 25), ("h2", 1, 26)):
        wav[name] = os.path.join(workdir, f"beam_{name}.wav")
        write_wav(wav[name], _tone(seconds, seed), SR)

    # Served beam: USE_BEAM_SEARCH=true, BEAM_WIDTH=16, the 400-word ARPA
    # (bench config 4: "auto" takes the trie tables through the char tokenizer).
    cfg = ServerConfig()
    cfg.MODEL_PATH, cfg.USE_BEAM_SEARCH, cfg.BEAM_WIDTH, cfg.LM_PATH = pt, True, BEAM_WIDTH, arpa400
    _reset_counts()
    service = ASRService(cfg, warmup=True, device="cuda")
    asr = service.asr
    if asr is None or asr.decoder.__class__.__name__ != "DeviceBeamDecoder" \
            or "lm_trie" not in asr.decoder._lm_kwargs:
        raise AssertionError("the beam service did not load the trie-fused device beam")
    # A request's ms split into its forwards and its beam decodes (a
    # single file's decode calls decode_batch too).
    split = {"forward": [], "beam": []}
    asr._forward_batch = _timed(asr._forward_batch, split, "forward")
    asr.decoder.decode_batch = _timed(asr.decoder.decode_batch, split, "beam")
    server = make_stdlib_server(service, "127.0.0.1", 0)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    base = f"http://127.0.0.1:{server.server_address[1]}"

    def read(name):
        with open(wav[name], "rb") as f:
            return f.read()

    def post(route, files):
        marks = {k: len(v) for k, v in split.items()}
        status, payload, ms = _post(base + route, files)
        return status, payload, ms, *(sum(split[k][marks[k]:]) for k in ("forward", "beam"))

    batch_names = ("q1", "q2", "q3", "q4")  # one 8 s bucket: one forward, one decode
    try:
        # Each request twice: the first at a shape also picks the library's
        # convolution and GEMM algorithms; the second is the one kept.
        first = [post("/transcribe", [("file", "s8.wav", read("s8"))])[2]]
        status, single, ms_single, fwd, beam_ms = post("/transcribe",
                                                      [("file", "s8.wav", read("s8"))])
        batch_files = [("files", n + ".wav", read(n)) for n in batch_names]
        first.append(post("/transcribe/batch", batch_files)[2])
        status_b, batch, ms_batch, fwd_b, beam_b = post("/transcribe/batch", batch_files)
    finally:
        server.shutdown()
        server.server_close()
        thread.join(timeout=60)
    launches = _counts()["flash_attention_fwd"]
    served = {"single_ms": ms_single, "forward_ms": fwd, "beam_ms": beam_ms,
              "batch_ms": ms_batch, "batch_forward_ms": fwd_b, "batch_beam_ms": beam_b,
              "first_single_ms": first[0], "first_batch_ms": first[1]}
    results = batch.get("results") or []
    if status != 200 or status_b != 200 or len(results) != 4 \
            or any(r["error"] is not None for r in results):
        raise AssertionError(f"served beam: {status} {single}; {status_b} {batch}")
    want_single = asr.transcribe(wav["s8"])
    want_batch = asr.transcribe_files([wav[n] for n in batch_names])
    if single["text"] != want_single or [r["text"] for r in results] != want_batch:
        raise AssertionError(f"served beam texts {single['text']!r}, {results} differ from the "
                             f"in-process {want_single!r}, {want_batch}")
    print(f"served beam (W={BEAM_WIDTH}, trie fusion, 400-word ARPA): POST /transcribe 8 s "
          f"{ms_single:.2f} ms = forward {served['forward_ms']:.2f} + beam "
          f"{served['beam_ms']:.2f} ms + the rest; /transcribe/batch 4 files {ms_batch:.2f} ms "
          f"= forward {served['batch_forward_ms']:.2f} + beam {served['batch_beam_ms']:.2f} ms "
          f"(the first of each: {first[0]:.2f}, {first[1]:.2f} ms); texts equal the "
          f"in-process transcribe / transcribe_files; {launches} attention forward launches "
          f"(warmup and 4 requests); text={single['text'][:40]!r}", flush=True)
    if launches < 5 * 8:
        raise AssertionError(f"the served beam path launched the attention forward {launches} "
                             f"times over five forwards of 8 blocks")

    # The host beam (no LM): a Python loop, on two 1 s files only.
    host = ASRInference(pt, use_beam_search=True, beam_width=BEAM_WIDTH, device="cuda")
    if not isinstance(host.decoder, CTCBeamDecoder):
        raise AssertionError("beam search without an LM must take the host beam")
    t0 = time.perf_counter()
    texts = host.transcribe_files([wav["h1"], wav["h2"]])
    host_ms = (time.perf_counter() - t0) * 1e3
    # One batched forward each time, so the same logits and texts (a B=1
    # forward rounds bf16 otherwise, and may move a beam).
    if texts != host.transcribe_files([wav["h1"], wav["h2"]]) or not all(
            isinstance(t, str) for t in texts):
        raise AssertionError(f"the host beam's texts are not repeatable: {texts}")
    print(f"host beam (no LM), two 1 s files in one batch: {host_ms:.2f} ms, "
          f"texts {[t[:20] for t in texts]}", flush=True)

    # Log-probs: B tones of 8 s through the served model's bf16 forward.
    tok = TurkishTokenizer()
    lps = {}
    for B in BEAM_BATCHES:
        x = np.stack([_tone(BEAM_SECONDS, 1000 + i) for i in range(B)])
        logits, out_lens = asr._forward_batch(x, np.full((B,), x.shape[1], np.int32))
        lps[B] = (logits.float().log_softmax(-1), out_lens)
    T = lps[BEAM_BATCHES[0]][0].shape[1]

    t0 = time.perf_counter()
    arpa100k = os.path.join(workdir, "words100k.arpa")
    synthetic_word_arpa(arpa100k, **PRODUCTION)
    gen_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    model100k = lmmod.ArpaLanguageModel(arpa100k)
    parse_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    hashed = lmmod.build_hash_fusion_tables(model100k, tok, 56)
    build_s = time.perf_counter() - t0
    trie = lmmod.build_trie_fusion_tables(lmmod.ArpaLanguageModel(arpa400), tok, 56)
    table_mb = sum(hashed[k].nbytes for k in ("keys", "vals", "pnext", "wq", "tok_kind", "qwid"))
    print(f"beam (c) ARPA: {len(model100k.logprob)} n-grams, {hashed['n_words']} words; "
          f"generated {gen_s:.3f} s, parsed {parse_s:.3f} s, hash tables built {build_s:.3f} s "
          f"({hashed['table_size']} slots, {hashed['trie_nodes']} trie nodes, "
          f"{table_mb / 1e6:.1f} MB as built)", flush=True)

    decoders = {"a_no_lm": {},
                "b_trie_400": {"lm_trie": trie, "lm_start_state": int(trie["start_h"])},
                "c_hash_100k": {"lm_hash": hashed}}
    numbers = {"served": served, "host_beam_ms": host_ms, "T": T,
               "arpa_100k": {"parse_s": parse_s, "build_s": build_s, "gen_s": gen_s}}
    for name, kw in decoders.items():
        on = {}
        for dev in ("cuda", "cpu"):
            mode, tables = prepare_lm(torch.device(dev), lm_trie=kw.get("lm_trie"),
                                      lm_hash=kw.get("lm_hash"))
            on[dev] = dict(kw, **{f"lm_{mode}": tables}) if mode else {}
        lp, lens = lps[BEAM_BATCHES[0]]
        n_close, score_err = _beam_against_cpu(name, lp, lens, on["cuda"], on["cpu"])

        def search(lp=lp, lens=lens, kw=on["cuda"]):
            return ctc_beam_search(lp, lens, beam_width=BEAM_WIDTH, return_all_beams=True,
                                   max_prefix_len=min(lp.shape[1], 512), **kw)

        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")  # a host sync in the search raises
        try:
            search()
        finally:
            torch.cuda.set_sync_debug_mode(0)
        entry = {"n_close": n_close, "score_err": score_err}
        for B in BEAM_BATCHES:
            lp, lens = lps[B]
            t = _beam_times(lambda lp=lp, lens=lens: search(lp, lens), B)
            entry[f"B{B}"] = t
            extra = ""
            if "kernels" in t:
                extra = (f", busy {t['busy_ms']:.3f} ms (idle {1 - t['busy_ms'] / t['device_ms']:.3f}),"
                         f" {t['kernels']:.0f} kernels a decode = {t['kernels'] / T:.1f} a frame")
            print(f"beam {name} B={B} x {BEAM_SECONDS} s (T'={T}): wall {t['wall_ms']:.3f} ms, "
                  f"device {t['device_ms']:.3f} ms{extra}; decode RTFx {t['rtfx']:.1f}; no host "
                  f"sync in the search", flush=True)
        numbers[name] = entry
    print(f"beam phase: {time.perf_counter() - start_phase:.3f} s", flush=True)
    return launches, numbers


# ---------------------------------------------------------------------------
# Phases 9-13: the JAX checkpoint boundary, remat policies, the trace
# hook, torch.export, memorization.

FLAGSHIP = dict(n_mels=80, d_model=256, n_heads=4, n_blocks=8)
REMAT_POLICIES = ("none", "full", "dots")
REMAT_REPS = 5
PROFILED_KERNELS = {"flash_attention_fwd": ("flash_fwd_kernel",),
                    "flash_attention_bwd": ("flash_bwd_dq", "flash_bwd_dkdv"),
                    "ctc_fwd": ("ctc_fwd_kernel",), "ctc_bwd": ("ctc_bwd_kernel",)}


def _train_batch(B, seed, seconds=8):
    """A training batch of B tones of 4 to ``seconds`` s in the ``seconds``
    bucket (T' <= 200 at 8 s), ragged targets of up to 64 labels."""
    rng = np.random.default_rng(seed)
    wav = np.zeros((B, seconds * SR), np.float32)
    lens = np.zeros(B, np.int32)
    for i, s in enumerate(rng.uniform(4.0, seconds, B)):
        x = _tone(s, seed * 100 + i)
        wav[i, :x.size], lens[i] = x, x.size
    return {"waveforms": wav, "wav_lengths": lens,
            "targets": rng.integers(1, 56, (B, 64)).astype(np.int32),
            "target_lengths": rng.integers(10, 64, B).astype(np.int32),
            "sample_mask": np.ones(B, np.float32)}


def _flagship_trainer(argv, model=None, steps=100, mesh=None):
    """A Trainer built as turkish_asr_torch.main builds one (flagship, char
    tokenizer, bf16 unless argv says fp32), without data loaders; on
    ``mesh``, with the model sharded for it."""
    from turkish_asr_torch.data.tokenizer import CharTokenizer
    from turkish_asr_torch.models.conformer import ModelConfig, init_model
    from turkish_asr_torch.parallel.mesh import shard_model
    from turkish_asr_torch.train.optim import make_optimizer
    from turkish_asr_torch.train.trainer import Trainer
    from turkish_asr_torch.utils.config import get_config
    config = get_config(["--d_model", "256", "--n_heads", "4", "--n_blocks", "8",
                         "--learning_rate", "1e-3", *argv])
    tok = CharTokenizer()
    if model is None:
        cfg = ModelConfig(**FLAGSHIP, n_classes=tok.vocab_size, dropout=config.encoder_dropout)
        model = init_model(cfg, torch.Generator().manual_seed(config.seed))
    model = shard_model(model, mesh).cuda()
    optimizer, schedule = make_optimizer(
        [p for p in model.parameters() if p.requires_grad], config.learning_rate,
        config.weight_decay, steps, pct_start=0.1, gradient_clip=config.gradient_clip,
        accumulation_steps=config.accumulation_steps)
    return Trainer(model, optimizer, schedule, config, logging.getLogger("chip_smoke"),
                   tokenizer=tok, device="cuda", accumulation_steps=config.accumulation_steps,
                   compute_dtype=torch.bfloat16 if config.precision == "bf16" else torch.float32,
                   augment=config.augment, mesh=mesh)


def ckpt_phase(workdir, trained):
    """The trained model as a JAX .ckpt written by the port: served through
    ASRInference and the HTTP server with the .pt path's logits and texts,
    and resumed with the .pt resume's state, bit for bit."""
    import shutil
    from turkish_asr_torch.audio.wavio import write_wav
    from turkish_asr_torch.inference import ASRInference
    from turkish_asr_torch.serve.server import ASRService, ServerConfig, make_stdlib_server
    from turkish_asr_torch.train.checkpoint import save_jax_checkpoint_file
    from turkish_asr_torch.utils.weights import jax_trees_from_state_dict, opt_named_from_optimizer

    tr = trained
    epoch = tr.config.epochs
    pt_dir, ckpt_dir = os.path.join(workdir, "resume_pt"), os.path.join(workdir, "resume_ckpt")
    os.makedirs(pt_dir)
    os.makedirs(ckpt_dir)
    src = os.path.join(tr.config.checkpoint_dir, f"checkpoint_epoch_{epoch}.pt")
    pt = os.path.join(pt_dir, os.path.basename(src))
    shutil.copy(src, pt)
    ckpt = os.path.join(ckpt_dir, f"checkpoint_epoch_{epoch}.ckpt")
    params, state = jax_trees_from_state_dict(tr.model.state_dict())
    cfg = tr.cfg
    meta = {"epoch": epoch, "global_step": tr.global_step, "best_val_loss": tr.best_val_loss,
            "config": {k: v for k, v in vars(tr.config).items()
                       if isinstance(v, (int, float, str, bool, type(None)))},
            "model_config": {"n_mels": cfg.n_mels, "d_model": cfg.d_model,
                             "n_heads": cfg.n_heads, "n_blocks": cfg.n_blocks,
                             "n_classes": cfg.n_classes, "dropout": cfg.dropout,
                             "masked_norm": cfg.masked_norm}}
    start = time.perf_counter()
    save_jax_checkpoint_file(ckpt, meta, params, state,
                             opt_named_from_optimizer(tr.optimizer, tr.model))
    write_s = time.perf_counter() - start
    numbers = {"ckpt_mb": os.path.getsize(ckpt) / 2 ** 20, "write_s": write_s}

    # Served: ASRInference logits and the HTTP server's text, .ckpt against .pt.
    start = time.perf_counter()
    from_ckpt = ASRInference(ckpt, device="cuda")
    numbers["load_s"] = time.perf_counter() - start
    from_pt = ASRInference(pt, device="cuda")
    for name, seconds in (("8 s", 8), ("24 s", 24)):
        wav = _tone(seconds, 40 + seconds)
        a, na = from_ckpt._forward_padded(wav)
        b, nb = from_pt._forward_padded(wav)
        if na != nb or not np.array_equal(a, b):
            raise AssertionError(f".ckpt and .pt logits differ at {name}: frames {na} vs "
                                 f"{nb}, max diff {float(np.abs(a - b).max())}")
    texts = []
    for path in (ckpt, pt):
        server_cfg = ServerConfig()
        server_cfg.MODEL_PATH = path
        service = ASRService(server_cfg, warmup=False, device="cuda")
        if service.asr is None:
            raise AssertionError(f"the service did not load {path}")
        server = make_stdlib_server(service, "127.0.0.1", 0)
        thread = threading.Thread(target=server.serve_forever, daemon=True)
        thread.start()
        try:
            with tempfile.NamedTemporaryFile(suffix=".wav") as f:
                write_wav(f.name, _tone(6, 41), SR)
                with open(f.name, "rb") as fh:
                    status, payload, _ = _post(
                        f"http://127.0.0.1:{server.server_address[1]}/transcribe",
                        [("file", "x.wav", fh.read())])
        finally:
            server.shutdown()
            server.server_close()
            thread.join(timeout=60)
        if status != 200:
            raise AssertionError(f"/transcribe with {path}: {status} {payload}")
        texts.append(payload["text"])
    if texts[0] != texts[1]:
        raise AssertionError(f"served texts differ: .ckpt {texts[0]!r}, .pt {texts[1]!r}")
    print(f"ckpt: wrote {numbers['ckpt_mb']:.2f} MB in {write_s:.3f} s; served through "
          f"ASRInference (load {numbers['load_s']:.3f} s) with the .pt's logits bit for bit at "
          f"8 s and 24 s; POST /transcribe texts equal ({texts[0][:30]!r})", flush=True)

    # Resumed: the newest checkpoint of each directory, state bit for bit.
    resumed = {}
    for kind, directory in (("ckpt", ckpt_dir), ("pt", pt_dir)):
        t = _flagship_trainer(["--checkpoint_dir", directory, "--resume", "--augment",
                               "--precision", "bf16", "--epochs", str(epoch + 1)])
        t.load_checkpoint()
        resumed[kind] = t
    a, b = resumed["ckpt"], resumed["pt"]
    if (a.start_epoch, a.global_step) != (b.start_epoch, b.global_step) \
            or a.start_epoch != epoch + 1:
        raise AssertionError(f"resume: .ckpt epoch/step {a.start_epoch}/{a.global_step}, "
                             f".pt {b.start_epoch}/{b.global_step}")
    sa, sb = a.optimizer.state_dict(), b.optimizer.state_dict()
    if sa["count"] != sb["count"] or not all(
            torch.equal(x, y) for x, y in zip(sa["mu"] + sa["nu"], sb["mu"] + sb["nu"])):
        raise AssertionError("the .ckpt resume's Adam state differs from the .pt resume's")
    for k, v in b.model.state_dict().items():
        if not torch.equal(a.model.state_dict()[k], v):
            raise AssertionError(f"the .ckpt resume's {k} differs from the .pt resume's")
    losses = [a.train_step(_train_batch(32, 70 + i), seed=70 + i) for i in range(2)]
    if not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"steps after the .ckpt resume: losses {losses}")
    a.sync_global_step()
    print(f"ckpt resume: epoch {a.start_epoch}, global step {b.global_step}, Adam count "
          f"{sa['count']}, {len(sa['mu'])} moments equal to the .pt resume's bit for bit; "
          f"2 steps: losses {[round(x, 4) for x in losses]}, global step {a.global_step}",
          flush=True)
    numbers.update(resume_epoch=a.start_epoch, resume_global_step=b.global_step,
                   steps_after=losses)
    return ckpt, numbers


def remat_phase():
    """One bf16 training step at B=32, T' <= 200 for each recomputation
    policy: peak memory, wall ms (median of REMAT_REPS), forward launches;
    and the fp32 gradients of dots against full."""
    batch = _train_batch(32, 60)
    out = {}
    for policy in REMAT_POLICIES:
        argv = ["--no_remat"] if policy == "none" else ["--remat_policy", policy]
        tr = _flagship_trainer(argv + ["--augment"])
        seed = iter(range(10 ** 6))
        for _ in range(2):
            tr.train_step(batch, next(seed))
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        times, launches = [], []
        for _ in range(REMAT_REPS):
            before = _counts()["flash_attention_fwd"]
            torch.cuda.synchronize()
            start = time.perf_counter()
            tr.train_step(batch, next(seed))  # ends in a host read of the loss
            times.append((time.perf_counter() - start) * 1e3)
            launches.append(_counts()["flash_attention_fwd"] - before)
        out[policy] = {"wall_ms": statistics.median(times),
                       "peak_mb": torch.cuda.max_memory_allocated() / 2 ** 20,
                       "peak_over_state_mb": (torch.cuda.max_memory_allocated() - base) / 2 ** 20,
                       "fwd_launches": launches[0]}
        want = 8 if policy == "none" else 16
        if set(launches) != {want}:
            raise AssertionError(f"remat {policy}: forward kernel launches a step {launches}, "
                                 f"expected {want}")
        print(f"remat {policy}: wall {out[policy]['wall_ms']:.3f} ms a step (median of "
              f"{REMAT_REPS}), peak {out[policy]['peak_mb']:.1f} MB "
              f"({out[policy]['peak_over_state_mb']:.1f} MB over weights and optimizer state), "
              f"{want} forward launches a step", flush=True)
        del tr
        torch.cuda.empty_cache()

    grads = {}
    for policy in ("full", "dots"):
        tr = _flagship_trainer(["--remat_policy", policy, "--precision", "fp32"])
        loss, _, _, _ = tr._loss(tr._to_device(batch), True, seed=5)
        grads[policy] = torch.autograd.grad(loss, tr.params)
        del tr
    floor = 1e-4 * max(g.abs().max().item() for g in grads["full"])
    worst = max((a - b).abs().max().item() / max(b.abs().max().item(), floor)
                for a, b in zip(grads["dots"], grads["full"]))
    out["dots_vs_full_grad"] = worst
    print(f"remat dots vs full, fp32 gradients: max|dots - full| / max|full| = {worst:.3e} "
          f"(tolerance 1e-3)", flush=True)
    if worst > 1e-3:
        raise AssertionError("dots gradients disagree with full")
    return out


def profile_phase(workdir):
    """Three steps with --profile_dir: the Chrome trace names the attention
    and CTC kernels."""
    trace_dir = os.path.join(workdir, "trace")
    tr = _flagship_trainer(["--profile_dir", trace_dir, "--augment", "--log_interval", "100",
                            "--checkpoint_dir", os.path.join(workdir, "run_profile")])
    tr.train_loader = [_train_batch(32, 80 + i) for i in range(3)]
    tr.train_epoch(1)
    files = os.listdir(trace_dir)
    if len(files) != 1 or tr.profile_trace is None:
        raise AssertionError(f"--profile_dir wrote {files}")
    with open(tr.profile_trace) as f:
        names = {e.get("name", "") for e in json.load(f)["traceEvents"]
                 if e.get("cat") == "kernel"}
    found = {k: sorted({n for n in names if any(p in n for p in pats)})
             for k, pats in PROFILED_KERNELS.items()}
    missing = [k for k, v in found.items() if not v]
    print(f"profile: {os.path.getsize(tr.profile_trace) / 2 ** 20:.2f} MB trace, "
          f"{len(names)} kernel names; {', '.join(f'{k}: {len(v)}' for k, v in found.items())}",
          flush=True)
    if missing:
        raise AssertionError(f"the trace names no {missing} kernels")
    return {"trace_mb": os.path.getsize(tr.profile_trace) / 2 ** 20, "kernel_names": len(names)}


def export_phase(workdir, ckpt):
    """python -m turkish_asr_torch.export_model on the card from the .ckpt:
    the loaded program against the eager model, and its launches."""
    from turkish_asr_torch import export_model
    from turkish_asr_torch.audio.features import log_mel_spectrogram
    from turkish_asr_torch.scripts.ab_attention import _wall_ms
    from turkish_asr_torch.utils.weights import load_ckpt

    out = os.path.join(workdir, "model.pt2")
    start = time.perf_counter()
    export_model.main(["--checkpoint", ckpt, "--output", out, "--device", "cuda"])
    numbers = {"export_s": time.perf_counter() - start, "pt2_mb": os.path.getsize(out) / 2 ** 20}
    start = time.perf_counter()
    program = torch.export.load(out).module()
    numbers["load_s"] = time.perf_counter() - start
    cfg, model = load_ckpt(ckpt, "cuda")
    rng = np.random.default_rng(0)
    wav = np.stack([_tone(24, 90 + i) for i in range(16)])
    feats, _ = log_mel_spectrogram(torch.from_numpy(wav).cuda(),
                                   torch.full((16,), wav.shape[1], dtype=torch.int32).cuda())
    inputs = {"B=2 x T=200": torch.from_numpy(
                  rng.standard_normal((2, 200, cfg.n_mels)).astype(np.float32)).cuda(),
              "B=16 x 24 s": feats[:, :feats.shape[1] // 4 * 4].contiguous()}
    launches = 0
    for name, x in inputs.items():
        with torch.no_grad():
            before = _counts()["flash_attention_fwd"]
            got = program(x)
            torch.cuda.synchronize()
            n = _counts()["flash_attention_fwd"] - before
            want = model(x, None, torch.float32)
            err = (got - want).abs().max().item()
            numbers[name] = {"max_abs_err": err, "fwd_launches": n,
                             "program_ms": _wall_ms(lambda x=x: program(x)),
                             "eager_ms": _wall_ms(lambda x=x: model(x, None, torch.float32))}
        launches += n
        print(f"export {name} (T={x.shape[1]}): max|program - eager| = {err:.3e} (fp32, "
              f"tolerance 1e-4), {n} flash_attention_fwd launches a forward; wall "
              f"{numbers[name]['program_ms']:.3f} ms program, {numbers[name]['eager_ms']:.3f} "
              f"ms eager (median of 10)", flush=True)
        if err > 1e-4 or n != cfg.n_blocks or not torch.isfinite(got).all():
            raise AssertionError(f"the exported program at {name}: err {err}, {n} launches")
    export_model.main(["--checkpoint", ckpt, "--output", os.path.join(workdir, "from_ckpt.pt"),
                       "--format", "torch", "--device", "cuda"])
    numbers["export_launches"] = launches
    return numbers


def memorize_phase():
    """The five-word memorization of tests/test_torch_overfit.py on the
    card, bf16, through the kernels."""
    from turkish_asr_torch.scripts.overfit import STEPS, WORDS, memorize
    before = _counts()["flash_attention_fwd"]
    result = memorize("cuda", torch.bfloat16)
    launches = _counts()["flash_attention_fwd"] - before
    print(f"memorization: loss {result['first_loss']:.4f} -> {result['final_loss']:.4f} in "
          f"{STEPS} steps ({result['seconds']:.3f} s), texts {result['texts']}, "
          f"{launches} attention forward launches", flush=True)
    if not (result["final_loss"] < 0.1 and result["texts"] == list(WORDS)
            and launches >= 2 * STEPS):
        raise AssertionError(f"memorization failed: {result}")
    return result


# (orig, new, the route resample takes): a CD rate to 16 kHz; speed
# perturbation 0.9, whose native polyphase bank exceeds NATIVE_BANK_MAX.
DATA_RATIOS = ((44100, 16000, "native"), (16000, 17777, "taps"))
DATA_PAIRS = 200  # seeded token-id pairs for the edit distance
DATA_REPS = 5  # timed passes of the metrics over the validation batches


def data_phase(trained, workdir, card):
    """The host data path on the card's machine: the native library, the
    AudioPreprocessor on the card against the CPU, the resampler's routes,
    the edit distance, and the validation metrics' host seconds."""
    from turkish_asr_torch.audio import wavio
    from turkish_asr_torch.audio.features import AudioPreprocessor
    from turkish_asr_torch.native import loader
    from turkish_asr_torch.utils import metrics

    if not loader.native_available():
        raise AssertionError("the host C++ library did not build or load (g++)")
    numbers = {"library": os.path.basename(loader.get_lib()._name)}

    path = os.path.join(workdir, "data_phase.wav")
    rng = np.random.default_rng(17)
    wavio.write_wav(path, np.stack([_tone(8.0, 17), 0.1 * rng.standard_normal(8 * SR)])
                    .astype(np.float32), SR)
    card_pre, cpu_pre = AudioPreprocessor(), AudioPreprocessor(device="cpu")
    if card_pre.device.type != "cuda":
        raise AssertionError(f"AudioPreprocessor() chose {card_pre.device}, not the card")
    got, want = card_pre(path), cpu_pre(path)
    err = float(np.abs(got - want).max())
    numbers["preprocessor"] = {"shape": list(got.shape), "max_abs_err": err}
    print(f"data: AudioPreprocessor() on {card_pre.device} against device='cpu' on an 8 s "
          f"stereo file: {got.shape}, max |card - cpu| {err:.3e}", flush=True)
    if got.shape != want.shape or not np.isfinite(got).all() or not err <= 1e-4:
        raise AssertionError(f"AudioPreprocessor on the card: {got.shape} against "
                             f"{want.shape}, max error {err}")

    numbers["resample"] = {}
    real_native = loader.resample_native
    for orig, new, want_route in DATA_RATIOS:
        x = (0.3 * rng.standard_normal(orig)).astype(np.float32)
        calls = []

        def counted(*args):
            calls.append(args[1:3])
            return real_native(*args)

        with mock.patch.object(loader, "resample_native", counted):
            t0 = time.perf_counter()
            out = wavio.resample(x, orig, new)
            port_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        native = loader.resample_native(x, orig, new)
        native_s = time.perf_counter() - t0
        with mock.patch.dict(os.environ, {"TASR_NATIVE": "0"}):
            fallback = wavio.resample(x, orig, new)
        route = "native" if calls else "taps"
        fb_err = float(np.abs(out - fallback).max())
        numbers["resample"][f"{orig}->{new}"] = {
            "route": route, "bit_equal_native": bool(np.array_equal(out, native)),
            "max_abs_err_fallback": fb_err, "port_s": port_s, "native_s": native_s}
        print(f"data: resample {orig} -> {new} (1 s): route {route}, bit-equal to "
              f"resample_native {np.array_equal(out, native)}, max |port - numpy fallback| "
              f"{fb_err:.3e}; host s: port {port_s:.4f}, resample_native {native_s:.4f}",
              flush=True)
        if route != want_route or not np.array_equal(out, native) or not fb_err <= 1e-5:
            raise AssertionError(f"resample {orig} -> {new}: {numbers['resample']}")

    pairs = [[rng.integers(0, 40, rng.integers(0, 60)).tolist() for _ in range(2)]
             for _ in range(DATA_PAIRS)]
    t0 = time.perf_counter()
    native = [loader.levenshtein_native(a, b) for a, b in pairs]
    t1 = time.perf_counter()
    dp = [metrics._levenshtein_dp(a, b) for a, b in pairs]
    t2 = time.perf_counter()
    numbers["levenshtein"] = {"pairs": DATA_PAIRS, "native_s": t1 - t0, "dp_s": t2 - t1}
    print(f"data: levenshtein_native against the DP on {DATA_PAIRS} seeded pairs of 0-59 ids: "
          f"equal {native == dp}; host s: native {t1 - t0:.6f}, DP {t2 - t1:.6f}", flush=True)
    if native != dp:
        raise AssertionError("levenshtein_native differs from the DP")

    batches = []
    real_compute = metrics.ASRMetrics.compute_from_ids

    def recorded(self, *args):
        batches.append((self, args))
        return real_compute(self, *args)

    with mock.patch.object(metrics.ASRMetrics, "compute_from_ids", recorded):
        trained.validate(trained.start_epoch)
    if not batches:
        raise AssertionError("the validation pass computed no metrics")

    def seconds():
        start = time.perf_counter()
        results = [real_compute(m, *args) for m, args in batches]
        return time.perf_counter() - start, results

    timed = {}
    for name, env in (("native", "1"), ("dp", "0")):
        with mock.patch.dict(os.environ, {"TASR_NATIVE": env}):
            runs = [seconds() for _ in range(DATA_REPS)]
        timed[name] = (statistics.median(r[0] for r in runs), runs[0][1])
    if timed["native"][1] != timed["dp"][1]:
        raise AssertionError("the native and DP metrics disagree")
    rows = sum(len(args[1]) for _, args in batches)
    hyp_chars = sum(len(t) for _, preds, _ in timed["native"][1] for t in preds)
    ref_chars = sum(len(t) for _, _, refs in timed["native"][1] for t in refs)
    numbers["metrics"] = {"batches": len(batches), "rows": rows, "hyp_chars": hyp_chars,
                          "ref_chars": ref_chars, "native_s": timed["native"][0],
                          "dp_s": timed["dp"][0]}
    print(f"data: ASRMetrics.compute_from_ids over one validation pass of the training run "
          f"({len(batches)} batches, {rows} rows, {hyp_chars} hypothesis and {ref_chars} "
          f"reference characters), median of {DATA_REPS}: native "
          f"{timed['native'][0]:.6f} s, DP {timed['dp'][0]:.6f} s (host seconds on the CPU "
          f"of the machine holding {card})", flush=True)
    return numbers


# ---------------------------------------------------------------------------
# Phase 14: the parallel layer on one card.

PARALLEL_MESHES = ("data=2", "model=2", "seq=2")
PARALLEL_MESHES_4 = ("model=2,seq=2",)  # four gloo ranks on cuda:0
PARALLEL_STEPS = 3
PARALLEL_B = 32
PARALLEL_FP32 = ["--precision", "fp32", "--encoder_dropout", "0"]
PARALLEL_TIMEOUT = 300  # seconds for the two ranks; a hung collective fails the phase


def _parallel_batches():
    return [_train_batch(PARALLEL_B, 700 + i) for i in range(PARALLEL_STEPS)]


def _parallel_init():
    """The flagship model's seeded state dict, dropout 0 (its dropout rate
    is the trainer's flag, not a weight)."""
    from turkish_asr_torch.data.tokenizer import CharTokenizer
    from turkish_asr_torch.models.conformer import ModelConfig, init_model
    cfg = ModelConfig(**FLAGSHIP, n_classes=CharTokenizer().vocab_size, dropout=0.0)
    return cfg, init_model(cfg, torch.Generator().manual_seed(11)).state_dict()


def _parallel_run(argv, mesh, batches, cfg, init, profile=False):
    """PARALLEL_STEPS trainer steps on this rank's rows of ``batches`` (all
    rows without a mesh): the losses, wall ms a step, the kernel launches,
    the all-reduce traffic a step, the full weights and Adam's second
    moments after the steps, whether the gathered initial state equals
    ``init``, and the rank's device; with ``profile`` the device kernels of
    the last step by name (torch.profiler)."""
    import dataclasses
    from turkish_asr_torch.models.conformer import ConformerCTC
    from turkish_asr_torch.parallel.collectives import traffic
    from turkish_asr_torch.parallel.mesh import gather_state_dict
    from turkish_asr_torch.train.checkpoint import gather_optimizer_state
    dropout = float(argv[argv.index("--encoder_dropout") + 1]) if "--encoder_dropout" in argv \
        else 0.1
    model = ConformerCTC(dataclasses.replace(cfg, dropout=dropout))
    model.load_state_dict(init)
    tr = _flagship_trainer(argv, model=model, mesh=mesh)
    init_equal = all(torch.equal(v.cpu(), init[k]) for k, v in
                     gather_state_dict(tr.model.state_dict(), mesh).items())
    d, n = (0, 1) if mesh is None else (mesh.index("data"), mesh.size("data"))
    losses, ms, kernels = [], [], {}
    _reset_counts()
    traffic.reset()
    for i, batch in enumerate(batches):
        local = {k: v[d::n] for k, v in batch.items()}
        last = profile and i == len(batches) - 1
        prof = torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                                  torch.profiler.ProfilerActivity.CUDA]) \
            if last else None
        start = time.perf_counter()
        if prof is not None:
            with prof:
                losses.append(tr.train_step(local, seed=i))
                torch.cuda.synchronize()
        else:
            losses.append(tr.train_step(local, seed=i))
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - start) * 1e3)
        if prof is not None:
            for name, names in PROFILED_KERNELS.items():
                kernels[name] = sum(e.count for e in prof.key_averages()
                                    if any(k in e.key for k in names))
    out = {"losses": losses, "ms": ms, "launches": _counts(),
           "traffic": {k: v / len(batches) for k, v in traffic.snapshot().items()},
           "profiled_kernels": kernels, "init_equal": init_equal,
           "device": str(next(tr.model.parameters()).device)}
    out["state"] = {k: v.cpu() for k, v in gather_state_dict(tr.model.state_dict(), mesh).items()}
    out["local_state"] = {k: v.cpu() for k, v in tr.model.state_dict().items()}
    out["nu"] = dict(zip(tr.names, (v.cpu() for v in gather_optimizer_state(
        tr.optimizer.state_dict(), tr.names, mesh)["nu"])))
    return out


def _ranks_run(tmp, specs, bf16_spec=None, profile=False):
    """This rank's part, once its process group exists: PARALLEL_STEPS fp32
    steps at dropout 0 on each mesh of ``specs``, then ``bf16_spec`` in
    bf16 with dropout 0.1 and --augment (with the first attention call's
    keep mask under this rank's kernel seed); saved as ``rank<R>.pt``."""
    import torch.distributed as dist
    from turkish_asr_torch.models import attention
    from turkish_asr_torch.ops.flash_attention import dump_keep_mask
    from turkish_asr_torch.parallel.mesh import make_mesh, shard_seed
    world = dist.get_world_size()
    cfg, init = torch.load(os.path.join(tmp, "init.pt"), weights_only=False)
    batches = torch.load(os.path.join(tmp, "batches.pt"), weights_only=False)
    out = {}
    for spec in specs:
        out[spec] = _parallel_run(PARALLEL_FP32, make_mesh(spec, world), batches, cfg, init,
                                  profile=profile)
        torch.cuda.empty_cache()
    if bf16_spec is not None:
        seeds = []
        real = attention.flash_attention

        def recording(q, k, v, mask, rate, seed, data_rank=0):
            seeds.append((q.shape, rate, seed, data_rank))
            return real(q, k, v, mask, rate, seed, data_rank=data_rank)

        with mock.patch.object(attention, "flash_attention", recording):
            bf16 = _parallel_run(["--augment"], make_mesh(bf16_spec, world), batches, cfg, init)
        (B, H, T, _), rate, seed, data_rank = seeds[0]  # the first block's call, first step
        kernel_seed = shard_seed(seed, data_rank, bits=32)
        bf16["keep_mask"] = dump_keep_mask(B, H, T, kernel_seed, rate, "cuda").cpu()
        bf16["kernel_seed"] = kernel_seed
        out["bf16"] = bf16
    torch.save(out, os.path.join(tmp, f"rank{dist.get_rank()}.pt"))


def _parallel_rank(rank, world, tmp, specs):
    """One of the gloo ranks on cuda:0 (``python3 chip_smoke.py
    --parallel-rank RANK WORLD DIR SPEC...``): the fp32 meshes ``specs``,
    then at two ranks data=2 in bf16 with dropout and --augment."""
    import torch.distributed as dist
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.cuda.set_device(0)
    dist.init_process_group("gloo", store=dist.FileStore(os.path.join(tmp, f"store{world}"),
                                                         world),
                            rank=rank, world_size=world)
    try:
        _ranks_run(tmp, specs, "data=2" if world == 2 else None, profile=world == 2)
    finally:
        dist.destroy_process_group()


def _noise_elements(nu, count):
    """Elements whose Adam gradient scale sqrt(nu / (1 - b2^count)) is under
    1e-7 (ten times eps): their update is lr * g / (|g| + eps) with g made
    of rounding noise, so it follows the rounding (tests/test_torch_parallel.py)."""
    return {k: torch.sqrt(v / (1 - 0.999 ** count)) < 1e-7 for k, v in nu.items()}


def _weights_err(got, want, noise, lr=1e-3):
    """(max |got - want| over the trainable elements whose gradient is not
    rounding noise, max over those that are, the count of the latter)."""
    main, rest, marked = 0.0, 0.0, 0
    for k, n in noise.items():
        d = (got[k].float() - want[k].float()).abs()
        main = max(main, float(d[~n].max()) if (~n).any() else 0.0)
        rest = max(rest, float(d[n].max()) if n.any() else 0.0)
        marked += int(n.sum())
    return main, rest, marked


def _parallel_inputs(tmp):
    """The seeded init and batches the ranks and the one-process run share,
    saved into ``tmp``."""
    os.makedirs(tmp)
    cfg, init = _parallel_init()
    batches = _parallel_batches()
    torch.save((cfg, init), os.path.join(tmp, "init.pt"))
    torch.save(batches, os.path.join(tmp, "batches.pt"))
    return cfg, init, batches


def _gloo_ranks(tmp, world, specs):
    """``world`` gloo ranks on cuda:0 (``--parallel-rank``) over ``specs``;
    their results in rank order and the seconds they took. A rank that
    fails or outlasts PARALLEL_TIMEOUT fails the phase."""
    start = time.perf_counter()
    procs = [subprocess.Popen([sys.executable, os.path.abspath(__file__), "--parallel-rank",
                               str(r), str(world), tmp, *specs], stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True) for r in range(world)]
    logs = []
    try:
        deadline = time.monotonic() + PARALLEL_TIMEOUT
        for p in procs:
            logs.append(p.communicate(timeout=max(deadline - time.monotonic(), 1))[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    seconds = time.perf_counter() - start
    for r, (p, log) in enumerate(zip(procs, logs)):
        if p.returncode != 0:
            raise AssertionError(f"parallel rank {r} exited {p.returncode}:\n{log[-4000:]}")
    return [torch.load(os.path.join(tmp, f"rank{r}.pt"), weights_only=False)
            for r in range(world)], seconds


def _after_first(ms):
    """The median wall ms of the steps after the first (CUDA warm-up)."""
    return statistics.median(ms[1:])


def _check_mesh(spec, runs, one, noise, label="parallel"):
    """Hold every rank's run of mesh ``spec`` to the one-process run:
    losses within 1e-4 relative, the gathered weights within 1e-4 (the
    rounding-noise elements within 3 lr), the gathered initial state equal
    to the init, and the attention and CTC kernels launched on every rank.
    Prints the mesh's line; returns its numbers."""
    loss_err = max(abs(a - b) / abs(b) for r in runs for a, b in zip(r["losses"],
                                                                    one["losses"]))
    main, rest, marked = _weights_err(runs[0]["state"], one["state"], noise)
    launches = [{k: r["launches"][k] for k in _TRAIN} for r in runs]
    numbers = {
        "losses": runs[0]["losses"], "loss_rel_err": loss_err, "weights_err": main,
        "noise_weights_err": rest, "noise_elements": marked,
        "init_equal": [r["init_equal"] for r in runs], "devices": [r["device"] for r in runs],
        "ms": [r["ms"] for r in runs], "median_ms": [_after_first(r["ms"]) for r in runs],
        "allreduce": [r["traffic"] for r in runs], "launches": launches,
        "profiled_kernels": [r["profiled_kernels"] for r in runs]}
    print(f"{label} {spec}: losses {[round(x, 6) for x in runs[0]['losses']]} (one process "
          f"{[round(x, 6) for x in one['losses']]}), max rel err {loss_err:.2e}; weights "
          f"after {PARALLEL_STEPS} steps max|diff| {main:.2e} ({marked} rounding-noise "
          f"elements: {rest:.2e}); initial state gathered equal {all(numbers['init_equal'])}; "
          f"devices {numbers['devices']}; ms a step "
          f"{[[round(x, 1) for x in r['ms']] for r in runs]}; all-reduce a step "
          f"{runs[0]['traffic']}; launches {launches}; profiled kernels "
          f"{numbers['profiled_kernels'][0]}", flush=True)
    if loss_err > 1e-4 or main > 1e-4 or rest > 3e-3 or not all(numbers["init_equal"]):
        raise AssertionError(f"{label} {spec} differs from the one-process run: {loss_err}, "
                             f"{main}, {rest}, initial state equal {numbers['init_equal']}")
    profiled = numbers["profiled_kernels"]
    if not all(n > 0 for r in launches + profiled for n in r.values()):
        raise AssertionError(f"{label} {spec}: a rank launched no kernel of the path: "
                             f"wrappers {launches}, torch.profiler {profiled}")
    return numbers


def _check_bf16(ranks, label="parallel"):
    """The bf16 run with dropout and --augment: finite losses, every data
    replica's weights bit-equal to rank 0's, every rank's attention keep
    mask (its own kernel seed) different from every other's."""
    runs = [r["bf16"] for r in ranks]
    b0 = runs[0]
    equal = all(torch.equal(v, b["local_state"][k]) for b in runs[1:]
                for k, v in b0["local_state"].items())
    masks_differ = all(not torch.equal(a["keep_mask"], b["keep_mask"])
                       for i, a in enumerate(runs) for b in runs[i + 1:])
    numbers = {"losses": b0["losses"], "ms": [b["ms"] for b in runs],
               "median_ms": [_after_first(b["ms"]) for b in runs],
               "replicas_equal": equal, "keep_masks_differ": masks_differ,
               "kernel_seeds": [b["kernel_seed"] for b in runs],
               "launches": [b["launches"] for b in runs],
               "allreduce": [b["traffic"] for b in runs], "devices": [b["device"] for b in runs]}
    print(f"{label} bf16 dropout 0.1 --augment on {len(runs)} ranks: losses "
          f"{[round(x, 4) for x in b0['losses']]}, replicas bit-equal {equal}, kernel seeds "
          f"{numbers['kernel_seeds']}, keep masks differ {masks_differ}, ms a step "
          f"{[[round(x, 1) for x in b['ms']] for b in runs]}", flush=True)
    if not (all(math.isfinite(x) for x in b0["losses"]) and equal and masks_differ):
        raise AssertionError(f"{label} bf16: {numbers}")
    return numbers


def parallel_phase(workdir, pt):
    """The parallel layer on the card: gloo ranks on cuda:0 against the
    one-process trainer on the same global batch (two ranks: data=2,
    model=2, seq=2 in fp32 with dropout 0, then data=2 in bf16 with
    dropout and --augment; four ranks: model=2,seq=2 in fp32), a one-rank
    NCCL group (the trainer's steps, then dryrun_multichip(1)), and served
    data parallelism."""
    import torch.distributed as dist
    from turkish_asr_torch import multichip
    from turkish_asr_torch.inference import ASRInference
    from turkish_asr_torch.audio.wavio import write_wav
    from turkish_asr_torch.parallel.mesh import init_distributed, make_mesh

    tmp = os.path.join(workdir, "parallel")
    cfg, init, batches = _parallel_inputs(tmp)
    ranks, ranks_s = _gloo_ranks(tmp, 2, PARALLEL_MESHES)
    ranks4, ranks4_s = _gloo_ranks(tmp, 4, PARALLEL_MESHES_4)

    one = _parallel_run(PARALLEL_FP32, None, batches, cfg, init)
    noise = _noise_elements(one["nu"], PARALLEL_STEPS)
    numbers = {"ranks_s": ranks_s, "ranks4_s": ranks4_s, "one_process_ms": one["ms"],
               "meshes": {}}
    for spec in PARALLEL_MESHES:
        numbers["meshes"][spec] = _check_mesh(spec, [r[spec] for r in ranks], one, noise)
    for spec in PARALLEL_MESHES_4:
        numbers["meshes"][spec] = _check_mesh(spec, [r[spec] for r in ranks4], one, noise,
                                              "parallel (4 gloo ranks)")
    numbers["bf16"] = _check_bf16(ranks)

    # One rank over NCCL: the trainer's step through init_distributed().
    env = {"RANK": "0", "WORLD_SIZE": "1", "LOCAL_RANK": "0", "MASTER_ADDR": "127.0.0.1",
           "MASTER_PORT": str(multichip.free_port())}
    with mock.patch.dict(os.environ, env):
        init_distributed("cuda", required=True)
    try:
        backend = dist.get_backend()
        nccl = _parallel_run(PARALLEL_FP32, make_mesh(None, 1), batches, cfg, init)
        _reset_counts()
        dryrun = multichip.dryrun_multichip(1, torch.device("cuda", 0))
        dryrun_launches = _counts()
    finally:
        dist.destroy_process_group()
    loss_err = max(abs(a - b) / abs(b) for a, b in zip(nccl["losses"], one["losses"]))
    main, rest, marked = _weights_err(nccl["state"], one["state"], noise)
    numbers["nccl"] = {"backend": backend, "losses": nccl["losses"], "loss_rel_err": loss_err,
                       "weights_err": main, "noise_weights_err": rest, "ms": nccl["ms"],
                       "allreduce": nccl["traffic"]}
    print(f"one rank over {backend}: losses {[round(x, 6) for x in nccl['losses']]}, max rel err "
          f"{loss_err:.2e}, weights max|diff| {main:.2e} (noise elements {rest:.2e}), all-reduce "
          f"a step {nccl['traffic']}, ms a step {[round(x, 1) for x in nccl['ms']]}", flush=True)
    if backend != "nccl" or loss_err > 1e-5 or main > 1e-4 or rest > 3e-3:
        raise AssertionError(f"one-rank NCCL run differs: {numbers['nccl']}")
    numbers["dryrun"] = {"mesh": dryrun["mesh"], "loss": dryrun["loss"], "B": dryrun["B"],
                         "launches": dryrun_launches}
    print(f"dryrun_multichip(1) over {backend}: launches {dryrun_launches}", flush=True)
    if not all(dryrun_launches[k] > 0 for k in _TRAIN):
        raise AssertionError(f"dryrun_multichip(1) launched no kernel of the path: "
                             f"{dryrun_launches}")

    # Served data parallelism: the rows of a batch split over two replicas.
    files = []
    for i, seconds in enumerate((1, 3, 5, 8, 2, 6)):
        files.append(os.path.join(tmp, f"req{i}.wav"))
        write_wav(files[-1], _tone(seconds, 300 + i), SR)
    texts = {}
    for name, kw in (("one", {"data_parallel": False}), ("visible", {"data_parallel": True}),
                     ("two", {"data_parallel": True, "devices": ["cuda:0", "cuda:0"]})):
        asr = ASRInference(pt, compute_dtype=torch.float32, **kw)
        texts[name] = (asr.transcribe_files(files, batch_size=4), len(asr.replicas))
    numbers["served"] = {k: {"replicas": n} for k, (_, n) in texts.items()}
    print(f"served data parallelism: replicas {[n for _, n in texts.values()]}, texts equal "
          f"{texts['two'][0] == texts['visible'][0] == texts['one'][0]}", flush=True)
    if not texts["two"][0] == texts["visible"][0] == texts["one"][0] or texts["two"][1] != 2:
        raise AssertionError(f"served data parallelism: {texts}")
    return numbers


# ---------------------------------------------------------------------------
# --multichip: the parallel layer on four cards over NCCL.

MULTICHIP_CARDS = 4
MULTICHIP_MESHES = ("data=4", "data=2,model=2", "model=2,seq=2", "seq=2,data=2")
MULTICHIP_BF16 = "data=4"
MULTICHIP_TIMEOUT = 300  # seconds for a set of ranks (~90 s); a hung collective fails the run
MULTICHIP_CLI = ("data=2,model=2", "data=4")  # trained on the first, resumed on the second
MULTICHIP_SERVED = dict(B=128, seconds=8, reps=5)  # the headline's served shape
MULTICHIP_FILES = (1, 3, 5, 8, 2, 6, 4, 7)  # seconds of the served texts' files


def _multichip_rank(tmp):
    """One NCCL rank of the meshes phase (``python3 chip_smoke.py
    --multichip-rank DIR`` under ``multichip.launch``): its own card,
    ``cuda:LOCAL_RANK``."""
    import torch.distributed as dist
    from turkish_asr_torch.parallel.mesh import init_distributed
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    init_distributed("cuda", required=True)
    try:
        _ranks_run(tmp, MULTICHIP_MESHES, MULTICHIP_BF16)
    finally:
        dist.destroy_process_group()


def multichip_meshes(workdir):
    """MULTICHIP_CARDS NCCL ranks, one a card, against the one-process
    trainer on cuda:0 (the same init and batches): the fp32
    MULTICHIP_MESHES held by ``_check_mesh``, then MULTICHIP_BF16 in bf16
    with dropout and --augment by ``_check_bf16``; every rank on its own
    card."""
    from turkish_asr_torch import multichip
    cards = MULTICHIP_CARDS
    tmp = os.path.join(workdir, "meshes")
    cfg, init, batches = _parallel_inputs(tmp)
    start = time.perf_counter()
    multichip.launch([sys.executable, os.path.abspath(__file__), "--multichip-rank", tmp], cards,
                     "cuda", MULTICHIP_TIMEOUT)
    ranks_s = time.perf_counter() - start
    ranks = [torch.load(os.path.join(tmp, f"rank{r}.pt"), weights_only=False)
             for r in range(cards)]
    one = _parallel_run(PARALLEL_FP32, None, batches, cfg, init)
    noise = _noise_elements(one["nu"], PARALLEL_STEPS)
    numbers = {"ranks_s": ranks_s, "one_process_ms": one["ms"],
               "one_process_median_ms": _after_first(one["ms"]), "meshes": {}}
    for spec in MULTICHIP_MESHES:
        runs = [r[spec] for r in ranks]
        numbers["meshes"][spec] = _check_mesh(spec, runs, one, noise, "multichip")
        devices = [r["device"] for r in runs]
        if devices != [f"cuda:{r}" for r in range(cards)]:
            raise AssertionError(f"multichip {spec}: ranks on {devices}, not one card each")
    numbers["bf16"] = _check_bf16(ranks, "multichip")
    return numbers


def _log_losses(path):
    """The step losses a train.log records."""
    with open(path, encoding="utf-8") as f:
        return [float(x) for x in re.findall(r"\] Loss: (\S+) LR", f.read())]


def _ranks_agree(text, cards, label):
    """Every rank logs each step's global loss to its output: ``cards``
    equal values a step, else the ranks trained on different rows."""
    steps = {}
    for epoch, batch, loss in re.findall(r"Epoch \[(\d+)/\d+\] Batch \[(\d+)/\d+\] Loss: (\S+) LR",
                                         text):
        steps.setdefault((int(epoch), int(batch)), []).append(loss)
    if not steps or any(len(v) != cards or len(set(v)) != 1 for v in steps.values()):
        raise AssertionError(f"{label}: the ranks' step losses differ: {steps}")


def _write_ckpt_of(pt, ckpt):
    """The .pt checkpoint ``pt`` (weights, Adam state, epoch, step) written
    as the JAX package's .ckpt by the port, as the ckpt phase writes one."""
    from turkish_asr_torch.models.conformer import ConformerCTC, ModelConfig
    from turkish_asr_torch.train.checkpoint import load_checkpoint_file, save_jax_checkpoint_file
    from turkish_asr_torch.train.optim import make_optimizer
    from turkish_asr_torch.utils.weights import jax_trees_from_state_dict, opt_named_from_optimizer
    payload = load_checkpoint_file(pt)
    model = ConformerCTC(ModelConfig(**payload["model_config"]))
    model.load_state_dict(payload["model_state_dict"], strict=True)
    optimizer, _ = make_optimizer([p for p in model.parameters() if p.requires_grad], 1.0, 0.0, 10)
    optimizer.load_state_dict(payload["optimizer_state_dict"])
    params, state = jax_trees_from_state_dict(payload["model_state_dict"])
    meta = {k: payload[k] for k in ("epoch", "global_step", "best_val_loss", "config",
                                    "model_config")}
    save_jax_checkpoint_file(ckpt, meta, params, state, opt_named_from_optimizer(optimizer, model))


def multichip_cli(workdir):
    """``python -m turkish_asr_torch.main`` on MULTICHIP_CARDS NCCL ranks: 2
    epochs on MULTICHIP_CLI[0] under torchrun (rank 0 writes the .pt
    checkpoints), the last epoch's .pt written as a JAX .ckpt, then
    ``--resume`` on MULTICHIP_CLI[1] through ``multichip.launch`` continues
    from that .ckpt for a third epoch; every rank logs the same loss at
    every step. Returns the numbers and the final .pt."""
    from turkish_asr_torch import multichip
    cards, meshes = MULTICHIP_CARDS, MULTICHIP_CLI
    corpus = os.path.join(workdir, "corpus_mc")
    _write_corpus(corpus, 140)  # 105 train (3 global batches of 32), 35 valid (1)
    run = os.path.join(workdir, "run_mc")
    argv = ["-m", "turkish_asr_torch.main", "--data_path", corpus, "--val_split", "0.25",
            "--test_split", "0.0", "--n_mel_channels", "80", "--d_model", "256", "--n_heads",
            "4", "--n_blocks", "8", "--encoder_dropout", "0.1", "--augment", "--precision",
            "bf16", "--batch_size", "32", "--learning_rate", "1e-3", "--save_interval", "1",
            "--log_interval", "1", "--num_workers", "2", "--device", "cuda",
            "--checkpoint_dir", run]
    numbers = {}
    log = os.path.join(workdir, "cli_mc.log")
    start = time.perf_counter()
    with open(log, "w") as out:
        # A session of its own: at the timeout torchrun and its ranks go together.
        proc = subprocess.Popen([sys.executable, "-m", "torch.distributed.run", "--standalone",
                                 "--nproc_per_node", str(cards), *argv, "--epochs", "2",
                                 "--mesh_shape", meshes[0]], stdout=out,
                                stderr=subprocess.STDOUT, start_new_session=True)
        try:
            rc = proc.wait(timeout=MULTICHIP_TIMEOUT)
        finally:
            if proc.poll() is None:
                os.killpg(proc.pid, 9)
                proc.wait()
    numbers["train_s"] = time.perf_counter() - start
    if rc != 0:
        with open(log) as f:
            raise AssertionError(f"torchrun main on {meshes[0]} exited {rc}:\n{f.read()[-6000:]}")
    with open(log) as f:
        first = f.read()
    _ranks_agree(first, cards, f"torchrun main on {meshes[0]}")
    names = set(os.listdir(run))
    want = {"checkpoint_epoch_1.pt", "checkpoint_epoch_2.pt", "best_model.pt",
            "turkish_conformer_final.pt", "train.log"}
    losses = _log_losses(os.path.join(run, "train.log"))
    if not want <= names or not losses or not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"torchrun main on {meshes[0]}: files {sorted(names)}, losses "
                             f"{losses}")
    start = time.perf_counter()
    _write_ckpt_of(os.path.join(run, "checkpoint_epoch_2.pt"),
                   os.path.join(run, "checkpoint_epoch_2.ckpt"))
    numbers["ckpt_write_s"] = time.perf_counter() - start
    start = time.perf_counter()
    with open(log, "a") as out:
        multichip.launch([sys.executable, *argv, "--epochs", "3", "--mesh_shape", meshes[1],
                          "--resume"], cards, "cuda", MULTICHIP_TIMEOUT, stdout=out)
    numbers["resume_s"] = time.perf_counter() - start
    with open(log) as f:
        _ranks_agree(f.read()[len(first):], cards, f"--resume on {meshes[1]}")
    with open(os.path.join(run, "train.log"), encoding="utf-8") as f:
        text = f.read()
    resumed = _log_losses(os.path.join(run, "train.log"))[len(losses):]
    if ("Resuming from: " + os.path.join(run, "checkpoint_epoch_2.ckpt") not in text
            or "Resuming from Epoch 3" not in text
            or f"Mesh: {multichip_mesh_dict(meshes[1])}" not in text
            or "checkpoint_epoch_3.pt" not in os.listdir(run)
            or not resumed or not all(math.isfinite(x) for x in resumed)):
        raise AssertionError(f"--resume on {meshes[1]} from the .ckpt: losses {resumed}, files "
                             f"{sorted(os.listdir(run))}")
    numbers.update(losses=losses, resumed_losses=resumed, files=sorted(os.listdir(run)))
    print(f"multichip CLI: {meshes[0]} under torchrun, 2 epochs in {numbers['train_s']:.3f} s, "
          f"losses {[round(x, 4) for x in losses]}; epoch 2 as a .ckpt; --resume on {meshes[1]} "
          f"from it, epoch 3 in {numbers['resume_s']:.3f} s, losses "
          f"{[round(x, 4) for x in resumed]}", flush=True)
    return numbers, os.path.join(run, "turkish_conformer_final.pt")


def multichip_mesh_dict(spec):
    """The shape of mesh ``spec`` as the trainer logs it, e.g. {'data': 4}."""
    return {k: int(v) for k, v in (part.split("=") for part in spec.split(","))}


def _all_cards_sync():
    for i in range(torch.cuda.device_count()):
        torch.cuda.synchronize(i)


def multichip_served(workdir, pt):
    """The trained model served by ASRInference with a replica on each of
    the MULTICHIP_CARDS visible cards against one replica: the same texts, greedy
    and W=16 trie beam with bench config 4's 400-word ARPA (fp32, as the
    one-card phase holds served data parallelism), and the fp32 logits of
    the files within 1e-3 (the serving phase's gate); then the wall ms of a
    bf16 batched forward at MULTICHIP_SERVED's shape with 1 and with
    MULTICHIP_CARDS replicas (median of ``reps`` after two warm-ups)."""
    from turkish_asr_torch.audio.wavio import write_wav
    from turkish_asr_torch.inference import ASRInference
    from turkish_asr_torch.scripts.synthetic_arpa import synthetic_word_arpa
    cards = MULTICHIP_CARDS
    tmp = os.path.join(workdir, "served_mc")
    os.makedirs(tmp)
    files = []
    for i, seconds in enumerate(MULTICHIP_FILES):
        files.append(os.path.join(tmp, f"req{i}.wav"))
        write_wav(files[-1], _tone(seconds, 500 + i), SR)
    arpa = os.path.join(tmp, "words.arpa")
    synthetic_word_arpa(arpa)
    wav8 = np.zeros((len(files), max(MULTICHIP_FILES) * SR), np.float32)
    lens8 = np.zeros(len(files), np.int32)
    for i, seconds in enumerate(MULTICHIP_FILES):
        x = _tone(seconds, 500 + i)
        wav8[i, :x.size], lens8[i] = x, x.size
    numbers = {}
    texts, logits = {}, {}
    for mode, kw in (("greedy", {}), ("beam", {"use_beam_search": True, "beam_width": BEAM_WIDTH,
                                               "lm_path": arpa})):
        for name, dp in (("one", False), ("all", True)):
            asr = ASRInference(pt, compute_dtype=torch.float32, data_parallel=dp, **kw)
            devices = [str(next(m.parameters()).device) for m in asr.replicas]
            texts[mode, name] = asr.transcribe_files(files, batch_size=len(files))
            numbers[f"{mode}_{name}_devices"] = devices
            if mode == "greedy":
                logits[name] = asr._forward_batch(wav8, lens8)[0].cpu()
            del asr
            torch.cuda.empty_cache()
        if texts[mode, "one"] != texts[mode, "all"]:
            raise AssertionError(f"served {mode}: {cards} replicas gave {texts[mode, 'all']}, "
                                 f"one replica {texts[mode, 'one']}")
    if numbers["greedy_all_devices"] != [f"cuda:{i}" for i in range(cards)]:
        raise AssertionError(f"replicas on {numbers['greedy_all_devices']}")
    numbers["texts"] = {mode: texts[mode, "one"] for mode in ("greedy", "beam")}
    numbers["logits_max_abs_diff"] = (logits["all"] - logits["one"]).abs().max().item()
    print(f"multichip served: {cards} replicas on {numbers['greedy_all_devices']} give one "
          f"replica's texts, greedy {texts['greedy', 'one']} and W={BEAM_WIDTH} trie beam "
          f"{texts['beam', 'one']}; fp32 logits of the {len(files)} files max|diff| "
          f"{numbers['logits_max_abs_diff']:.3e}", flush=True)
    if not numbers["logits_max_abs_diff"] <= 1e-3:  # the serving phase's fp32 gate
        raise AssertionError(f"served logits: {cards} replicas differ from one by "
                             f"{numbers['logits_max_abs_diff']}")

    B, seconds, reps = (MULTICHIP_SERVED[k] for k in ("B", "seconds", "reps"))
    wav = np.stack([_tone(seconds, 600 + i)[:seconds * SR] for i in range(B)])
    lens = np.full(B, seconds * SR, np.int32)
    numbers["forward"] = {"B": B, "seconds": seconds}
    for name, dp in (("one", False), ("all", True)):
        asr = ASRInference(pt, data_parallel=dp)  # bf16, as served
        for _ in range(2):
            asr._forward_batch(wav, lens)
        _all_cards_sync()
        ms = []
        launches = _counts()["flash_attention_fwd"]
        for _ in range(reps):
            start = time.perf_counter()
            logits, _ = asr._forward_batch(wav, lens)
            _all_cards_sync()
            ms.append((time.perf_counter() - start) * 1e3)
        numbers["forward"][name] = {"replicas": len(asr.replicas), "ms": ms,
                                    "median_ms": statistics.median(ms),
                                    "attention_launches": (_counts()["flash_attention_fwd"]
                                                           - launches) // reps}
        if tuple(logits.shape[:1]) != (B,) or not torch.isfinite(logits).all():
            raise AssertionError(f"served forward with {name} replicas: {logits.shape}")
        del asr, logits
        torch.cuda.empty_cache()
    f = numbers["forward"]
    print(f"multichip served forward B={B} x {seconds} s (bf16): 1 replica "
          f"{f['one']['median_ms']:.3f} ms, {f['all']['replicas']} replicas "
          f"{f['all']['median_ms']:.3f} ms (medians of {reps}; attention launches a forward "
          f"{f['one']['attention_launches']} and {f['all']['attention_launches']})", flush=True)
    return numbers


def multichip_dryrun():
    """``python -m turkish_asr_torch.multichip 4``: the module's own
    launcher, NCCL, one rank a card; its two lines must say the JAX
    dryrun's mesh, a finite loss and trie == hash with the kernel on."""
    from turkish_asr_torch import multichip
    cards = MULTICHIP_CARDS
    start = time.perf_counter()
    out = subprocess.run([sys.executable, "-m", "turkish_asr_torch.multichip", str(cards),
                          "--timeout", str(MULTICHIP_TIMEOUT)], capture_output=True, text=True,
                         timeout=MULTICHIP_TIMEOUT + 60)
    seconds = time.perf_counter() - start
    lines = [x for x in out.stdout.splitlines() if x.startswith(f"dryrun_multichip({cards})")]
    for line in lines:
        print(line, flush=True)
    mesh = str(multichip_mesh_dict(multichip.choose_mesh(cards)))
    step = re.search(r"mesh=(\{.*\}) loss=(\S+)$", lines[0]) if lines else None
    launches = re.search(r"flash kernel on, (\d+) launches", out.stdout)
    if (out.returncode != 0 or not step or step.group(1) != mesh
            or not math.isfinite(float(step.group(2))) or not launches
            or int(launches.group(1)) == 0):
        raise AssertionError(f"python -m turkish_asr_torch.multichip {cards} exited "
                             f"{out.returncode}:\n{out.stdout[-3000:]}\n{out.stderr[-6000:]}")
    return {"mesh": mesh, "loss": float(step.group(2)), "seconds": seconds,
            "attention_launches_rank0": int(launches.group(1))}


def multichip_main():
    """``python3 chip_smoke.py --multichip``: the parallel layer on
    MULTICHIP_CARDS cards over NCCL; raises with fewer visible cards."""
    if not torch.cuda.is_available():
        print("chip_smoke --multichip: torch.cuda.is_available() is False; this mode needs "
              f"{MULTICHIP_CARDS} CUDA cards", file=sys.stderr)
        return 1
    import turkish_asr_torch  # noqa: F401 — fails outside a checkout of the repo
    count = torch.cuda.device_count()
    if count < MULTICHIP_CARDS:
        raise RuntimeError(f"chip_smoke --multichip needs {MULTICHIP_CARDS} visible CUDA cards, "
                           f"{count} visible")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True, check=True)
    cards = smi.stdout.strip().splitlines()
    for card in cards:
        print(card, flush=True)
    nccl = ".".join(str(x) for x in torch.cuda.nccl.version())
    print(f"python {sys.version.split()[0]}, torch {torch.__version__}, cuda {torch.version.cuda}, "
          f"nccl {nccl}, {count} cards", flush=True)
    start = time.perf_counter()
    _phase("build", build_phase)
    with tempfile.TemporaryDirectory() as workdir:
        numbers = {"cards": cards, "nccl": nccl, "count": count,
                   "meshes": _phase("multichip meshes", multichip_meshes, workdir)}
        numbers["cli"], pt = _phase("multichip cli", multichip_cli, workdir)
        numbers["served"] = _phase("multichip served", multichip_served, workdir, pt)
        numbers["dryrun"] = _phase("multichip dryrun", multichip_dryrun)
    print(f"all phases: {time.perf_counter() - start:.3f} s", flush=True)
    print(json.dumps({"multichip": numbers}))
    for card in cards:
        print(card)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": count}}))
    return 0


# ---------------------------------------------------------------------------
# Phase 15: the port's bench (turkish_asr_torch/bench.py).


def _longform_check(bench):
    """Config 5's forward (Conformer-L, B=16 x 64 s, T'=1601, seeded random
    weights) with the attention kernel against the same model with the
    plain core (``attn_kernel=False``), by the serving phase's bars: fp32
    logits within 1e-3 at 0.99 frame-argmax agreement; bf16 logits within
    bf16's own noise of the plain path's (max|plain bf16 - plain fp32|),
    their frame argmaxes agreeing at 0.99, or, where bf16 itself moves more
    of the plain path's argmaxes than that (16 blocks of random weights put
    them at the noise floor), as often as the plain bf16 and fp32 argmaxes
    agree."""
    cfg = bench._flagship_cfg(**bench.CONFORMER_L)
    model = bench._model(cfg, "cuda")
    B, seconds = bench.LONGFORM
    w, n = bench._waves(B, seconds, device="cuda")
    out = {}
    with torch.inference_mode():
        for dtype in (torch.bfloat16, torch.float32):
            for kernel in (True, False):
                out[dtype, kernel] = bench._logits(cfg, model, w, n, dtype, kernel)[0].float()
    torch.cuda.synchronize()
    kernel16, plain16 = out[torch.bfloat16, True], out[torch.bfloat16, False]
    kernel32, plain32 = out[torch.float32, True], out[torch.float32, False]
    frames = 1 + int(seconds * SR) // 160  # mel frames; two stride-2 convs, padding 1
    T = ((frames - 1) // 2) // 2 + 1
    if kernel16.shape != (B, T, cfg.n_classes) or not all(
            torch.isfinite(x).all() for x in out.values()):
        raise AssertionError(f"long-form logits: shape {tuple(kernel16.shape)}, expected "
                             f"{(B, T, cfg.n_classes)}, or not finite")
    numbers = {"B": B, "T": T,
               "diff_bf16": (kernel16 - plain16).abs().max().item(),
               "bf16_noise": (plain16 - plain32).abs().max().item(),
               "agree_bf16": (kernel16.argmax(-1) == plain16.argmax(-1)).float().mean().item(),
               "agree_noise": (plain16.argmax(-1) == plain32.argmax(-1)).float().mean().item(),
               "diff_fp32": (kernel32 - plain32).abs().max().item(),
               "agree_fp32": (kernel32.argmax(-1) == plain32.argmax(-1)).float().mean().item()}
    print(f"long-form Conformer-L B={B} x {seconds:g} s (T'={T}), kernel vs plain core: bf16 "
          f"max|diff| {numbers['diff_bf16']:.4e} (bf16 noise {numbers['bf16_noise']:.4e}), "
          f"argmax agreement {numbers['agree_bf16']:.4f} (plain bf16 vs fp32 "
          f"{numbers['agree_noise']:.4f}); fp32 max|diff| "
          f"{numbers['diff_fp32']:.4e}, agreement {numbers['agree_fp32']:.4f}", flush=True)
    if (numbers["diff_bf16"] > numbers["bf16_noise"]
            or numbers["agree_bf16"] < max(AGREE_BF16_FLOOR, min(0.99, numbers["agree_noise"]))
            or numbers["diff_fp32"] > 1e-3 or numbers["agree_fp32"] < 0.99):
        raise AssertionError(f"the long-form forward disagrees with its plain core: {numbers}")
    return numbers


def bench_phase():
    """Config 5's forward against its plain core, then every configuration
    of ``turkish_asr_torch.bench.run`` at full shapes and widths with
    BENCH_CAP iterations: no error line, the headline last, bench.py's
    fields on every line, and each configuration's kernel launches
    (BENCH_KERNELS; the counts set to 0 before it and read after it)."""
    from turkish_asr_torch import bench
    numbers = {"longform": _longform_check(bench)}
    torch.cuda.empty_cache()
    launches = {}

    @contextlib.contextmanager
    def counted(name):
        _reset_counts()
        try:
            yield
        finally:
            launches[name] = _counts()

    lines = bench.run("cuda", BENCH_CAP, counted)
    errors = [d for d in lines if d["metric"].startswith("error_")]
    if errors:
        raise AssertionError(f"bench configurations failed: {errors}")
    metrics = [d["metric"] for d in lines]
    if metrics[-1] != "rtfx_greedy_batch" or sorted(metrics) != sorted(bench.FIELDS):
        raise AssertionError(f"bench lines {metrics}: every configuration once, the headline "
                             f"last")
    name = torch.cuda.get_device_name(0)
    for d in lines:
        want = {"metric", "value", "unit", "device", "power_limit_w", *bench.FIELDS[d["metric"]]}
        if (set(d) != want or d["device"] != name or d["power_limit_w"] is None
                or not (d["value"] > 0)):
            raise AssertionError(f"bench line {d}: fields {sorted(set(d) ^ want)} differ from "
                                 f"bench.py's, or device/power limit/value wrong")
    missing = {cfg: [k for k in kernels if launches[cfg][k] == 0]
               for cfg, kernels in BENCH_KERNELS.items()}
    missing = {k: v for k, v in missing.items() if v}
    print("bench launches: " + "; ".join(
        f"{cfg} " + ", ".join(f"{k} {launches[cfg][k]}" for k in kernels)
        for cfg, kernels in BENCH_KERNELS.items()), flush=True)
    if missing:
        raise AssertionError(f"bench configurations launched no {missing}")
    numbers.update(lines=lines, launches=launches)
    return numbers


def _phase(name, fn, *args):
    start = time.perf_counter()
    out = fn(*args)
    print(f"phase {name}: {time.perf_counter() - start:.3f} s", flush=True)
    return out


def main():
    if sys.argv[1:2] == ["--multichip"]:
        return multichip_main()
    if sys.argv[1:2] == ["--multichip-rank"]:
        _multichip_rank(sys.argv[2])
        return 0
    if sys.argv[1:2] == ["--parallel-rank"]:
        _parallel_rank(int(sys.argv[2]), int(sys.argv[3]), sys.argv[4], sys.argv[5:])
        return 0
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script needs a CUDA card",
              file=sys.stderr)
        return 1
    import turkish_asr_torch  # noqa: F401 — fails outside a checkout of the repo

    # Full fp32 for the fp32 comparisons (cuDNN convolutions default to TF32).
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True, check=True)
    card = smi.stdout.strip().splitlines()[0]
    print(card, flush=True)
    print(f"python {sys.version.split()[0]}, torch {torch.__version__}, "
          f"cuda {torch.version.cuda}", flush=True)
    start = time.perf_counter()
    _phase("build", build_phase)
    err, times = _phase("attention", attention_phase)
    ctc_err, ctc_times = _phase("ctc", ctc_phase)
    err.update(ctc_err)
    times.update(ctc_times)
    swiglu_launches, err["swiglu_fwd"], times["swiglu_fwd"] = _phase("swiglu", swiglu_phase)
    with tempfile.TemporaryDirectory() as workdir:
        counts, pt, trained = _phase("training", train_phase, workdir)
        _phase("gradient check", gradient_check)
        _phase("serve trained", serve_trained, pt)
        _reset_counts()
        serving_launches = _phase("serving", serving_phase, workdir)
        beam_launches, beam = _phase("beam", beam_phase, workdir)
        ckpt, numbers = _phase("ckpt", ckpt_phase, workdir, trained)
        numbers = {"ckpt": numbers, "remat": _phase("remat", remat_phase),
                   "profile": _phase("profile", profile_phase, workdir),
                   "export": _phase("export", export_phase, workdir, ckpt)}
        parallel = _phase("parallel", parallel_phase, workdir, pt)
        numbers["memorization"] = _phase("memorization", memorize_phase)
        numbers["data"] = _phase("data", data_phase, trained, workdir, card)
    bench = _phase("bench", bench_phase)
    print(f"all phases: {time.perf_counter() - start:.3f} s", flush=True)

    replaces = {
        "flash_attention_fwd": ("turkish_asr_tpu/ops/_flash_attention_impl.py:244",
                                "turkish_asr_torch/csrc/flash_attention_fwd.cu"),
        "flash_attention_bwd": ("turkish_asr_tpu/ops/_flash_attention_impl.py:422",
                                "turkish_asr_torch/csrc/flash_attention_bwd.cu"),
        "dropout_mask": ("turkish_asr_tpu/ops/_flash_attention_impl.py:170",
                         "turkish_asr_torch/csrc/dropout_mask.cu"),
        "ctc_fwd": ("turkish_asr_tpu/ops/_ctc_pallas_impl.py:196",
                    "turkish_asr_torch/csrc/ctc_fwd.cu"),
        "ctc_bwd": ("turkish_asr_tpu/ops/_ctc_pallas_impl.py:223",
                    "turkish_asr_torch/csrc/ctc_bwd.cu"),
        "swiglu_fwd": ("scripts/ab_swiglu.py:71", "turkish_asr_torch/csrc/swiglu_fwd.cu"),
    }
    also = {"flash_attention_fwd": ["turkish_asr_tpu/ops/_flash_attention_impl.py:290",
                                    "turkish_asr_tpu/ops/_flash_attention_impl.py:62"],
            "flash_attention_bwd": ["turkish_asr_tpu/ops/_flash_attention_impl.py:491",
                                    "turkish_asr_tpu/ops/_flash_attention_impl.py:62"],
            "dropout_mask": ["turkish_asr_tpu/ops/_flash_attention_impl.py:189"],
            "swiglu_fwd": ["scripts/ab_swiglu.py:56"]}
    counts["swiglu_fwd"] = swiglu_launches
    # Each kernel's times at its main-path shape (the attention kernels at
    # the training step's; the forward also at the long served bucket's).
    times["flash_attention_fwd"] = times["train"]["flash_attention_fwd"]
    times["flash_attention_bwd"] = times["train"]["flash_attention_bwd"]
    keys = ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms", "chained_ms")
    attention_keys = keys + ("library_kernels",)
    kernels = []
    for name, (tpu, source) in replaces.items():
        t = times[name]
        entry = {"name": name, "route": "cuda", "source": source, "replaces": tpu,
                 "launches": counts[name], "max_abs_err": err[name],
                 **{k: t[k] for k in keys}, "median_ms": t["median_ms"]}
        if name in also:
            entry["also_replaces"] = also[name]
        if name == "dropout_mask":
            entry["on_main_path"] = False  # a test helper, as the TPU's dump_keep_mask
        if name in ("flash_attention_fwd", "flash_attention_bwd"):
            entry["library_kernels"] = t["library_kernels"]
            entry["mha"] = {k: times["mha"][name][k] for k in attention_keys}
            entry["longform"] = {w: {k: times[w][name][k] for k in attention_keys}
                                 for w in LONGFORM_ATTENTION}
            entry["sass"] = times["sass"][name]
        if name in ("flash_attention_fwd", "flash_attention_bwd", "ctc_fwd", "ctc_bwd"):
            # each bench configuration's launches (BENCH_CAP iterations)
            entry["bench_launches"] = {cfg: n[name] for cfg, n in bench["launches"].items()}
        if name == "flash_attention_fwd":
            entry["export_launches"] = numbers["export"]["export_launches"]
            entry["serving_launches"] = serving_launches
            entry["beam_serving_launches"] = beam_launches
            entry["serving"] = {k: times["serve"][name][k] for k in keys}
        if name in ("ctc_fwd", "ctc_bwd"):
            entry["kernel_ms"] = t["kernel_ms"]
        if name in ("flash_attention_fwd", "flash_attention_bwd", "ctc_fwd", "ctc_bwd"):
            # each rank's launches in the parallel phase's 3 data=2 steps
            entry["parallel_launches"] = [r[name] for r in
                                          parallel["meshes"]["data=2"]["launches"]]
        if name in ("ctc_fwd", "ctc_bwd", "dropout_mask", "swiglu_fwd"):
            entry["device_kernels_per_call"] = t["device_kernels_per_call"]
        if name == "dropout_mask":
            entry["large_ms"] = t["large"]
        if name == "swiglu_fwd":
            entry.update(chain_ms=t["chain_ms"], cublas_products_ms=t["cublas_products_ms"],
                         on_main_path=False, sass=t["sass"],
                         path="python turkish_asr_torch/scripts/ab_swiglu.py",
                         conformer_l={k: t["conformer_l"][k] for k in
                                      ("M", "C", "F", "tm", "ms", "plain_ms", "bound_ms",
                                       "bound_by", "chain_ms", "cublas_products_ms")})
        kernels.append(entry)
    print(json.dumps({"beam": beam}))
    print(json.dumps(numbers))
    print(json.dumps({"parallel": parallel}))
    print(json.dumps({"bench": bench}))
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
