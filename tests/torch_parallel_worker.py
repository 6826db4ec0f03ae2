"""The multi-process side of tests/test_torch_parallel*.py.

``run_ranks`` starts one process a rank, each running a scenario of this
module on a gloo group rendezvoused through a ``FileStore`` in the test's
``tmp_path`` (no TCP port: the suite runs under xdist), with one thread
each, and kills them all when they outlast ``timeout``: a hung collective
fails the test instead of holding the suite. Each rank saves what its
scenario returns; ``run_ranks`` returns the ranks' results in order.

The scenarios also run in the test's own process without a process group
(``mesh_spec=None``): that is the one-process run they are held against.

Run by the tests as ``python tests/torch_parallel_worker.py SCENARIO RANK
WORLD TMPDIR ARGS_JSON``.
"""

import json
import os
import subprocess
import sys
import time

import torch
import torch.distributed as dist

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from turkish_asr_torch.data.tokenizer import CharTokenizer  # noqa: E402
from turkish_asr_torch.models.conformer import ConformerCTC, ModelConfig  # noqa: E402
from turkish_asr_torch.parallel.mesh import (  # noqa: E402
    gather_state_dict, gather_tensor, make_mesh, param_layout, shard_model)
from turkish_asr_torch.parallel.collectives import all_reduce_  # noqa: E402
from turkish_asr_torch.train.checkpoint import gather_optimizer_state  # noqa: E402
from turkish_asr_torch.train.optim import make_optimizer  # noqa: E402
from turkish_asr_torch.train.trainer import Trainer  # noqa: E402
from turkish_asr_torch.utils.config import get_config  # noqa: E402
from turkish_asr_torch.utils.logger import get_logger  # noqa: E402


def _mesh(mesh_spec):
    if mesh_spec is None:
        return None
    return make_mesh(mesh_spec, dist.get_world_size())


def _model(cfg, init, mesh):
    """The model of config ``cfg`` with the full state dict ``init``,
    sharded for ``mesh``."""
    model = ConformerCTC(ModelConfig(**cfg))
    model.load_state_dict(torch.load(init, weights_only=True), strict=True)
    return shard_model(model, mesh)


def _trainer(tmp, cfg, init, mesh, accum=1, lr=1e-3, argv=(), device="cpu"):
    model = _model(cfg, init, mesh).to(device)
    config = get_config(["--accumulation_steps", str(accum), "--checkpoint_dir",
                         os.path.join(tmp, "runs"), "--learning_rate", str(lr), *argv])
    opt, sched = make_optimizer([p for p in model.parameters() if p.requires_grad], lr,
                                config.weight_decay, total_steps=100, accumulation_steps=accum)
    rank = 0 if mesh is None else mesh.rank
    logger = get_logger(f"torch_parallel_worker.{rank}", log_file=None)
    return Trainer(model, opt, sched, config, logger, tokenizer=CharTokenizer(), device=device,
                   accumulation_steps=accum, compute_dtype=torch.float32, mesh=mesh)


def _full_grads(tr, grads):
    """The full gradients by name, gathered over "model"."""
    group = None if tr.mesh is None else tr.mesh.group("model")
    return {n: gather_tensor(g, param_layout(n), group).cpu() for n, g in zip(tr.names, grads)}


def train(tmp, cfg, init, batches, mesh_spec=None, accum=1, flush=False, grads=False,
          seed0=0, device="cpu", by_rank=False):
    """Steps of the trainer on ``batches`` (a .pt of [step][data rank]
    batch dicts, or with ``by_rank`` [step][rank]; the one-process run
    takes rank 0's of one-rank lists).
    Returns the losses, the full state dict after the steps, the kernel
    launches, and with ``grads`` the first batch's loss and full gradients
    before any step."""
    from turkish_asr_torch.utils import tracing
    mesh = _mesh(mesh_spec)
    tr = _trainer(tmp, cfg, init, mesh, accum, device=device)
    steps = torch.load(batches, weights_only=False)
    d = 0 if mesh is None else mesh.rank if by_rank else mesh.index("data")
    out = {"state_init": {k: v.cpu().clone() for k, v in
                          gather_state_dict(tr.model.state_dict(), mesh).items()}}
    if grads:
        loss, _, _, _ = tr._loss(tr._to_device(steps[0][d]), True, seed0)
        g = torch.autograd.grad(loss, tr.params, allow_unused=True)
        g = [torch.zeros_like(p) if x is None else x for p, x in zip(tr.params, g)]
        all_reduce_(g, tr.grad_group)
        out["loss0"] = float(tr._data_sum(loss))
        out["grads0"] = _full_grads(tr, g)
    out["losses"] = [tr.train_step(step[d], seed=seed0 + i) for i, step in enumerate(steps)]
    counters = tracing.counters()
    out["launches"] = {name: counters[name] for name in
                       ("flash_attention_fwd", "flash_attention_bwd", "ctc_fwd", "ctc_bwd")}
    if flush:
        tr.flush_accumulation()
    tr.sync_global_step()
    out["global_step"] = tr.global_step
    out["names"] = tr.names
    adam = tr.optimizer.inner if accum > 1 else tr.optimizer
    out["nu"] = [n.cpu() for n in gather_optimizer_state(adam.state_dict(), tr.names,
                                                       mesh)["nu"]]
    out["state"] = {k: v.cpu() for k, v in
                    gather_state_dict(tr.model.state_dict(), mesh).items()}
    out["local_state"] = {k: v.cpu() for k, v in tr.model.state_dict().items()}
    return out


def forward(tmp, cfg, init, feats, mesh_spec=None, seed=None, data_rows=True):
    """One train-mode forward (``seed``'s dropout) of the features in
    ``feats`` (a .pt of {"x", "lengths"}); each data rank takes its
    interleaved rows unless ``data_rows`` is False. Returns the logits
    (every frame, every class) and the BatchNorm statistics."""
    mesh = _mesh(mesh_spec)
    model = _model(cfg, init, mesh)
    f = torch.load(feats, weights_only=True)
    x, lengths = f["x"], f["lengths"]
    if mesh is not None and data_rows:
        d, n = mesh.index("data"), mesh.size("data")
        x, lengths = x[d::n], lengths[d::n]
    logits, bn = model(x, lengths, torch.float32, train=True, seed=seed)
    return {"logits": logits.detach(), "bn": [(m.clone(), v.clone()) for m, v in bn]}


def fit(tmp, argv):
    """``turkish_asr_torch.main.main(argv)`` on this rank (the process
    group exists, as under torchrun). Returns the losses, the best
    validation loss, the global step, the checkpoint files this rank
    wrote and the files of the checkpoint dir."""
    from unittest import mock
    from turkish_asr_torch.main import main
    from turkish_asr_torch.train import trainer
    written = []

    def save(path, payload):
        written.append(os.path.basename(path))
        return save_file(path, payload)

    save_file = trainer.save_checkpoint_file
    with mock.patch.object(trainer, "save_checkpoint_file", save):
        tr = main(argv)
    ckpt_dir = argv[argv.index("--checkpoint_dir") + 1]
    return {"losses": tr.losses, "best_val_loss": tr.best_val_loss,
            "global_step": tr.global_step, "start_epoch": tr.start_epoch,
            "written": written, "files": sorted(os.listdir(ckpt_dir)),
            "local_state": {k: v.clone() for k, v in tr.model.state_dict().items()}}


SCENARIOS = {"train": train, "forward": forward, "fit": fit}


def run_ranks(tmp_path, scenario, world, timeout=120, **args):
    """Run ``scenario`` on ``world`` ranks; returns their results, in rank
    order. Fails (after killing every rank) when one exits non-zero or the
    ranks outlast ``timeout`` seconds."""
    tmp = os.path.join(str(tmp_path), f"{scenario}_{time.monotonic_ns()}")
    os.makedirs(tmp)
    env = dict(os.environ, OMP_NUM_THREADS="1", MKL_NUM_THREADS="1")
    procs = [subprocess.Popen([sys.executable, os.path.abspath(__file__), scenario, str(r),
                               str(world), tmp, json.dumps(args)],
                              cwd=ROOT, env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for r in range(world)]
    deadline = time.monotonic() + timeout
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=max(deadline - time.monotonic(), 1))[0])
    except subprocess.TimeoutExpired:
        for p in procs:
            p.kill()
        for p in procs:
            p.communicate()
        raise AssertionError(f"{scenario} on {world} ranks outlasted {timeout} s")
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    failed = [(r, p.returncode, log[-3000:]) for r, (p, log) in enumerate(zip(procs, logs))
              if p.returncode != 0]
    assert not failed, failed
    return [torch.load(os.path.join(tmp, f"rank{r}.pt"), weights_only=False)
            for r in range(world)]


def _rank_main():
    scenario, rank, world, tmp, args = sys.argv[1:6]
    rank, world = int(rank), int(world)
    torch.set_num_threads(1)
    torch.backends.cuda.matmul.allow_tf32 = False  # fp32 as the one-process run on a card
    torch.backends.cudnn.allow_tf32 = False
    dist.init_process_group("gloo", store=dist.FileStore(os.path.join(tmp, "store"), world),
                            rank=rank, world_size=world)
    try:
        out = SCENARIOS[scenario](tmp, **json.loads(args))
        torch.save(out, os.path.join(tmp, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    _rank_main()
