"""One sharded train step and a mesh beam+LM decode on N ranks.

Counterpart of ``__graft_entry__.dryrun_multichip`` (:80-204), run as::

    python -m turkish_asr_torch.multichip N [--device cuda|cpu] [--timeout S]
    torchrun --nproc_per_node N -m turkish_asr_torch.multichip [--device cuda|cpu]

Without torchrun's environment the module starts its N ranks itself
(``launch``): one subprocess a rank with ``RANK``, ``WORLD_SIZE``,
``LOCAL_RANK``, ``MASTER_ADDR=127.0.0.1`` and a free ``MASTER_PORT``; on
CUDA, NCCL with one card a rank (fewer visible cards than N raise), with
``--device cpu`` gloo. Every rank is killed when one fails or at the
timeout, and the command exits non-zero. Under torchrun (``RANK`` set)
each process is one rank. Nothing switches to gloo or to the CPU on its
own: the backend follows ``--device``.

Each rank runs ``dryrun_multichip(N)``:

- the JAX dryrun's mesh (``choose_mesh``): ``data=N/4,model=2,seq=2`` when
  8 divides N, ``data=N/2,model=2`` at even N >= 4, else ``data=N``;
- the same tiny model (``__graft_entry__._flagship_cfg`` at d_model 64,
  4 heads, 2 blocks, dropout 0.1, the char tokenizer), seeded with 0, and
  one bf16 train step with ``--augment`` and accumulation 2 on the same
  seeded batch (B = max(2 data, 4) waveforms of 16000 samples, 8 targets),
  each data rank on its interleaved rows (the sampler's slice); the
  global loss must be finite;
- the stepped model's eval forward with the attention kernel on each data
  rank's rows, then W=4 beam decodes with trie fusion and with hash
  fusion over the dryrun's two-gram ARPA (``decode/lm.py`` builds both);
  rank 0 gathers every rank's texts, which must agree within a data line
  and give trie == hash over all B rows.

Rank 0 prints the JAX dryrun's two lines. The model's weights come from
the port's own seeded init, not from JAX's PRNGKey(0): the dryrun checks
that the sharded step and decode run and agree with themselves, as the
JAX one does.
"""

import argparse
import os
import socket
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch
import torch.distributed as dist

ARPA = ("\\data\\\nngram 1=5\nngram 2=2\n\n\\1-grams:\n"
        "-1.0\t<unk>\t-0.3\n-0.8\t<s>\t-0.4\n-0.9\t</s>\n"
        "-0.5\tbir\t-0.2\n-0.6\tiki\n\n\\2-grams:\n"
        "-0.2\t<s> bir\n-0.3\tbir iki\n\n\\end\\\n")  # __graft_entry__.py:160-164
SAMPLES, TARGETS = 16000, 8
BEAM_WIDTH = 4


def choose_mesh(n):
    """The JAX dryrun's mesh spec for ``n`` devices (__graft_entry__.py:106-113)."""
    if n % 8 == 0:
        return f"data={n // 4},model=2,seq=2"
    if n % 2 == 0 and n >= 4:
        return f"data={n // 2},model=2"
    return f"data={n}"


def dryrun_batch(B, n_classes):
    """The JAX dryrun's seeded global batch (__graft_entry__.py:141-148)."""
    rng = np.random.default_rng(0)
    return {"waveforms": (rng.standard_normal((B, SAMPLES)) * 0.1).astype(np.float32),
            "wav_lengths": np.full((B,), SAMPLES, dtype=np.int32),
            "targets": rng.integers(2, n_classes, (B, TARGETS)).astype(np.int32),
            "target_lengths": np.full((B,), TARGETS, dtype=np.int32),
            "sample_mask": np.ones((B,), dtype=np.float32)}


def dryrun_multichip(n, device="cuda"):
    """The dryrun on this rank of an ``n``-rank process group (no group
    at ``n`` = 1 runs it alone); ``device`` is this rank's
    (``init_distributed``'s). Returns {"mesh", "loss", "texts", "B"} (the
    texts of every row on rank 0, this rank's elsewhere); raises on a
    non-finite loss or texts that disagree."""
    from turkish_asr_torch.audio.features import log_mel_spectrogram
    from turkish_asr_torch.data.tokenizer import load_tokenizer
    from turkish_asr_torch.decode.factory import DeviceBeamDecoder
    from turkish_asr_torch.decode.lm import (
        KenLMModel, build_hash_fusion_tables, build_trie_fusion_tables)
    from turkish_asr_torch.main import build_kernels_once
    from turkish_asr_torch.models.conformer import ModelConfig, init_model
    from turkish_asr_torch.ops.flash_attention import flash_attention
    from turkish_asr_torch.parallel.mesh import make_mesh, shard_model
    from turkish_asr_torch.train.optim import make_optimizer
    from turkish_asr_torch.train.trainer import Trainer
    from turkish_asr_torch.utils.config import get_config
    from turkish_asr_torch.utils.logger import get_logger

    world = dist.get_world_size() if dist.is_initialized() else 1
    if world != n:
        raise ValueError(f"dryrun_multichip({n}) on a process group of {world} ranks")
    device = torch.device(device)
    mesh = make_mesh(choose_mesh(n), n)
    build_kernels_once(device, mesh)

    tokenizer = load_tokenizer(None)
    cfg = ModelConfig(n_mels=80, d_model=64, n_heads=4, n_blocks=2,
                      n_classes=tokenizer.vocab_size, dropout=0.1)
    model = shard_model(init_model(cfg, torch.Generator().manual_seed(0)), mesh).to(device)
    optimizer, schedule = make_optimizer([p for p in model.parameters() if p.requires_grad],
                                         5e-4, 1e-6, 100, accumulation_steps=2)
    trainer = Trainer(model, optimizer, schedule, get_config([]),
                      get_logger("dryrun_multichip", log_file=None), tokenizer=tokenizer,
                      device=device, accumulation_steps=2, compute_dtype=torch.bfloat16,
                      augment=True, mesh=mesh)
    d, data = mesh.index("data"), mesh.size("data")
    B = max(2 * data, 4)
    batch = dryrun_batch(B, cfg.n_classes)
    local = {k: v[d::data] for k, v in batch.items()}
    loss = trainer.train_step(local, seed=0)
    if not np.isfinite(loss):
        raise RuntimeError(f"dryrun_multichip({n}): non-finite loss {loss}")
    if mesh.rank == 0:
        print(f"dryrun_multichip({n}): mesh={dict(mesh.shape)} loss={loss:.4f}", flush=True)

    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "dryrun.arpa")
        with open(path, "w", encoding="utf-8") as f:
            f.write(ARPA)
        lm = KenLMModel(path)
    trie = build_trie_fusion_tables(lm, tokenizer, cfg.n_classes)
    hashed = build_hash_fusion_tables(lm, tokenizer, cfg.n_classes)
    launches = flash_attention.launches
    with torch.no_grad():
        wav = torch.from_numpy(local["waveforms"]).to(device)
        lens = torch.from_numpy(local["wav_lengths"]).to(device)
        feats, frames = log_mel_spectrogram(wav, lens, n_mels=cfg.n_mels)
        logits = trainer.model(feats, frames, torch.bfloat16)
    launches = flash_attention.launches - launches
    texts = [DeviceBeamDecoder(tokenizer, beam_width=BEAM_WIDTH, device=device, **{kw: tables})
             .decode_batch(logits, frames // 4) for kw, tables in (("lm_trie", trie),
                                                                   ("lm_hash", hashed))]
    mine = (d, texts[0], texts[1])
    ranks = [mine]
    if world > 1:
        ranks = [None] * world
        dist.all_gather_object(ranks, mine)
    if mesh.rank != 0:
        return {"mesh": dict(mesh.shape), "loss": loss, "texts": texts, "B": B}
    rows = {}
    for r, (dr, trie_texts, hash_texts) in enumerate(ranks):
        if rows.setdefault(dr, (trie_texts, hash_texts)) != (trie_texts, hash_texts):
            raise RuntimeError(f"dryrun_multichip({n}): rank {r} decoded other texts than "
                               f"data rank {dr}'s first rank")
    full = [[None] * B for _ in range(2)]
    for dr, pair in rows.items():
        for kind in range(2):
            full[kind][dr::data] = pair[kind]
    if len(rows) != data or full[0] != full[1]:
        raise RuntimeError(f"mesh beam decode mismatch: {full[0]!r} vs {full[1]!r}")
    kernel = "on" if device.type == "cuda" else "off (its plain version on the CPU)"
    print(f"dryrun_multichip({n}): mesh beam+LM decode ok (trie==hash over {B} sharded rows, "
          f"flash kernel {kernel}, {launches} launches on rank 0)", flush=True)
    return {"mesh": dict(mesh.shape), "loss": loss, "texts": full[0], "B": B}


def free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def launch(command, n, device="cuda", timeout=600.0, stdout=None):
    """Run ``command`` as ``n`` ranks on this host, as torchrun would:
    one subprocess a rank with ``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``,
    ``LOCAL_WORLD_SIZE``, ``MASTER_ADDR=127.0.0.1`` and a free
    ``MASTER_PORT``; their output goes to ``stdout`` (a file), by default
    this process's. A CUDA
    ``device`` needs ``n`` visible cards (one a rank). When a rank exits
    non-zero the others are killed (they would wait in a collective), as
    are all of them at ``timeout`` seconds; either raises."""
    if torch.device(device).type == "cuda":
        visible = torch.cuda.device_count() if torch.cuda.is_available() else 0
        if visible < n:
            raise RuntimeError(f"{n} ranks on CUDA need {n} visible cards, one a rank; "
                               f"{visible} visible")
    port = free_port()
    procs = []
    try:
        for r in range(n):
            env = dict(os.environ, RANK=str(r), WORLD_SIZE=str(n), LOCAL_RANK=str(r),
                       LOCAL_WORLD_SIZE=str(n), MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port))
            procs.append(subprocess.Popen(command, env=env, stdout=stdout,
                                          stderr=None if stdout is None else subprocess.STDOUT))
        deadline = time.monotonic() + timeout
        while True:
            codes = [p.poll() for p in procs]
            failed = [(r, c) for r, c in enumerate(codes) if c not in (None, 0)]
            if failed:
                raise RuntimeError(f"rank {failed[0][0]} exited {failed[0][1]}; "
                                   f"the other ranks were stopped")
            if all(c == 0 for c in codes):
                return
            if time.monotonic() > deadline:
                raise TimeoutError(f"{n} ranks outlasted {timeout:g} s; every rank was killed")
            time.sleep(0.05)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
        for p in procs:
            p.wait()


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("n", type=int, nargs="?", default=None,
                        help="ranks (default under torchrun: its WORLD_SIZE)")
    parser.add_argument("--device", default="cuda", help="cuda (NCCL) or cpu (gloo)")
    parser.add_argument("--timeout", type=float, default=600.0,
                        help="seconds before every rank is killed")
    args = parser.parse_args(argv)
    if "RANK" in os.environ:  # one rank, under torchrun or launch()
        from turkish_asr_torch.parallel.mesh import init_distributed
        from turkish_asr_torch.utils.device import resolve_device
        world = int(os.environ["WORLD_SIZE"])
        if args.n is not None and args.n != world:
            raise ValueError(f"{args.n} ranks asked, WORLD_SIZE is {world}")
        device = init_distributed(resolve_device(args.device), required=True)
        try:
            dryrun_multichip(world, device)
        finally:
            dist.destroy_process_group()
        return 0
    if args.n is None:
        parser.error("the number of ranks is needed outside torchrun")
    launch([sys.executable, "-m", "turkish_asr_torch.multichip", str(args.n),
            "--device", args.device], args.n, args.device, args.timeout)
    return 0


if __name__ == "__main__":
    sys.exit(main())
