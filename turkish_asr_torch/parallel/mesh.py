"""Process mesh and tensor-parallel layout over torch.distributed.

Counterpart of turkish_asr_tpu/parallel/mesh.py. There the mesh is a
``jax.sharding.Mesh`` of devices and XLA inserts the collectives; here it
is a grid of processes, one process a GPU (``torchrun``), and the model
calls the collectives itself (``parallel/collectives.py``). Both packages
compute the same function on any mesh:

- ``data``: each data rank holds its slice of the global batch. The loss,
  its gradient and the BatchNorm statistics are those of the global batch.
- ``model``: tensor parallelism. The SwiGLU in-projection is sharded on its
  output units, the out-projection on its input units; the attention ``q``
  projection on its output heads, ``out`` on its input heads
  (``param_layout``). Everything else is replicated.
- ``seq``: sequence parallelism. Time is split between the ranks between
  the blocks; the attention kernel sees the full ``T'`` and every head,
  gathered at its entry, as JAX's ``shard_map(P("data"))`` gathers them.

Ranks are laid out as JAX lays out devices, ``np.arange(world).reshape(
sizes)``, the last axis innermost. ``make_mesh`` creates one
process group for each line of each axis, one for each (data, seq)
plane, which the BatchNorm statistics span, and one for each (model, seq)
plane: the ranks of one data line, which train on the same rows.
"""

import os

import numpy as np
import torch
import torch.distributed as dist

AXES = ("data", "model", "seq")
# Decorrelates the dropout streams of the data ranks, as JAX's
# _SHARD_SEED_MIX does in turkish_asr_tpu/ops/flash_attention.py:29-33.
SHARD_SEED_MIX = 0x6A09E667


def parse_mesh_spec(spec, world_size):
    """(names, sizes) of a spec such as ``"data=4,model=2"``; one ``-1``
    size is inferred from ``world_size``. No spec: every rank on "data"."""
    if not spec:
        return ("data",), (world_size,)
    names, sizes = [], []
    for part in spec.split(","):
        k, v = part.split("=")
        names.append(k.strip())
        sizes.append(int(v))
    if -1 in sizes:
        known = int(np.prod([s for s in sizes if s != -1]))
        sizes[sizes.index(-1)] = world_size // known
    total = int(np.prod(sizes))
    if total != world_size:
        raise ValueError(f"mesh {spec} needs {total} devices, have {world_size}")
    unknown = [n for n in names if n not in AXES]
    if unknown or len(set(names)) != len(names):
        raise ValueError(f"mesh {spec}: axes must be distinct names among {AXES}")
    return tuple(names), tuple(sizes)


class AxisGroup:
    """The line of ranks through this rank along some mesh axes: its
    ranks in order, this rank's index among them, and the process group
    (None without torch.distributed; the collectives are then the
    identity)."""

    def __init__(self, ranks, rank, group=None):
        self.ranks = tuple(int(r) for r in ranks)
        self.size = len(self.ranks)
        self.index = self.ranks.index(rank)
        self.group = group


def axis_group(mesh, *axes):
    """``mesh.group(*axes)``, or None when no mesh is given or none of
    ``axes`` is on it (the one-process model's path)."""
    if mesh is None or not any(a in mesh.names for a in axes):
        return None
    return mesh.group(*axes)


def _lines(ranks, axes):
    """Every line of ``ranks`` (the rank grid) along the axis indices
    ``axes``, as rows of ranks."""
    other = [i for i in range(ranks.ndim) if i not in axes]
    width = int(np.prod([ranks.shape[i] for i in axes]))
    return np.transpose(ranks, other + list(axes)).reshape(-1, width)


class Mesh:
    """A grid of processes with named axes. ``size``/``index`` of an axis
    not on the mesh are 1 and 0, and its ``group`` is a line of one rank."""

    def __init__(self, names, sizes, rank=0):
        self.names, self.sizes = tuple(names), tuple(sizes)
        self.shape = dict(zip(self.names, self.sizes))
        self.rank = rank
        self.ranks = np.arange(int(np.prod(self.sizes))).reshape(self.sizes)
        self.coords = dict(zip(self.names, (int(c) for c in
                                            np.unravel_index(rank, self.sizes))))
        self._groups = {}
        self.distributed = False

    @property
    def world_size(self):
        return self.ranks.size

    def size(self, axis):
        return self.shape.get(axis, 1)

    def index(self, axis):
        return self.coords.get(axis, 0)

    def group(self, *axes):
        """The ``AxisGroup`` of this rank along ``axes`` (those on the mesh)."""
        key = tuple(a for a in self.names if a in axes)
        if key not in self._groups:
            if self.distributed and key:
                raise KeyError(f"the mesh made no process group along {key}")
            if key:
                line = _lines(self.ranks, [self.names.index(a) for a in key])
                ranks = next(row for row in line if self.rank in row)
            else:
                ranks = (self.rank,)
            self._groups[key] = AxisGroup(ranks, self.rank)
        return self._groups[key]

    def _create_groups(self):
        """One process group for each line of each axis and of the (data,
        seq) and (model, seq) planes. Every rank creates every group, in the
        same order, as ``torch.distributed.new_group`` requires."""
        self.distributed = True
        keys = [(a,) for a in self.names]
        for plane in (("data", "seq"), ("model", "seq")):
            if all(a in self.names for a in plane):
                keys.append(tuple(a for a in self.names if a in plane))
        for key in keys:
            for row in _lines(self.ranks, [self.names.index(a) for a in key]):
                pg = dist.new_group([int(r) for r in row])
                if self.rank in row:
                    self._groups[key] = AxisGroup(row, self.rank, pg)


def make_mesh(spec, world_size, rank=None):
    """The ``Mesh`` of ``spec`` over ``world_size`` ranks (JAX ``make_mesh``'s
    parsing, ``-1`` and error). Under torch.distributed it creates the
    axes' process groups, a collective call of every rank; without it the
    mesh has no groups (a layout only)."""
    names, sizes = parse_mesh_spec(spec, world_size)
    if dist.is_initialized():
        if dist.get_world_size() != world_size:
            raise ValueError(f"mesh over {world_size} ranks, but the process group has "
                             f"{dist.get_world_size()}")
        mesh = Mesh(names, sizes, dist.get_rank())
        mesh._create_groups()
        return mesh
    return Mesh(names, sizes, 0 if rank is None else rank)


def init_distributed(device, required=False):
    """Join the process group ``torchrun`` describes (``RANK``,
    ``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR``, ``MASTER_PORT``) and
    return this rank's device: ``cuda:LOCAL_RANK`` over NCCL for a CUDA
    ``device``, the CPU over gloo for a CPU one. At world size 1 it does
    nothing unless ``required`` (``--distributed``). A process group that
    already exists is kept."""
    device = torch.device(device)
    world = int(os.environ.get("WORLD_SIZE", "1"))
    if world == 1 and not required and not dist.is_initialized():
        return device
    if device.type == "cuda":
        device = torch.device("cuda", int(os.environ.get("LOCAL_RANK", "0")))
        torch.cuda.set_device(device)
    if dist.is_initialized():
        return device
    dist.init_process_group("nccl" if device.type == "cuda" else "gloo",
                            init_method="env://", world_size=world,
                            rank=int(os.environ.get("RANK", "0")))
    return device


def barrier():
    """``dist.barrier`` of every rank, under NCCL on this rank's own card:
    without ``device_ids`` NCCL guesses the card from the global rank."""
    if dist.get_backend() == "nccl":
        dist.barrier(device_ids=[torch.cuda.current_device()])
    else:
        dist.barrier()


def shard_seed(seed, data_rank, bits=63):
    """``seed`` mixed with the data rank, (seed + rank * 0x6A09E667) mod
    2^bits: each data rank draws its own dropout masks; rank 0 draws those
    of a one-process run."""
    return (int(seed) + int(data_rank) * SHARD_SEED_MIX) % (1 << bits)


def check_batch(mesh, batch_size):
    """JAX ``shard_batch``'s check (:75-85) where the port needs it: one
    device a process, so the global ``--batch_size`` must split evenly
    over the "data" ranks."""
    ranks = 1 if mesh is None else mesh.size("data")
    if batch_size % ranks != 0:
        raise ValueError(
            f"global batch axis {batch_size} not divisible by the {ranks} ranks on the "
            f"mesh 'data' axis; pick --batch_size as a multiple of the data-parallel size")


def seq_bounds(length, parts):
    """(start, stop) of each of ``parts`` consecutive slices of ``length``
    frames, the first ``length % parts`` one frame longer
    (``np.array_split``'s split)."""
    base, extra = divmod(int(length), parts)
    bounds, start = [], 0
    for i in range(parts):
        stop = start + base + (1 if i < extra else 0)
        bounds.append((start, stop))
        start = stop
    return bounds


# ---------------------------------------------------------------------------
# Tensor-parallel layout

_LAYOUT = (
    # (parameter name suffix, sharded dim, parts): a "model" rank holds its
    # slice of each of the ``parts`` equal parts along ``dim``.
    ("ff1.linear1.weight", 0, 2), ("ff1.linear1.bias", 0, 2),  # SwiGLU in: h1 and h2
    ("ff2.linear1.weight", 0, 2), ("ff2.linear1.bias", 0, 2),
    ("ff1.linear2.weight", 1, 1), ("ff2.linear2.weight", 1, 1),  # SwiGLU out: d_ff
    ("attn.linear_q.weight", 0, 1), ("attn.linear_q.bias", 0, 1),  # output heads
    ("attn.linear_out.weight", 1, 1),  # input heads
)


def param_layout(name):
    """(dim, parts) of a parameter sharded over "model", or None for a
    replicated one: JAX ``_spec_for_param``'s rules on the port's names.
    JAX shards the SwiGLU in-projection's 2*d_ff outputs in one piece;
    here each half (h1, h2) is sharded on its own, so a rank holds matching
    slices of both and the gate needs no exchange. The function is the same."""
    for suffix, dim, parts in _LAYOUT:
        if name.startswith("blocks.") and name.endswith("." + suffix):
            return dim, parts
    return None


def shard_tensor(t, layout, index, size):
    """This model rank's slice of the full tensor ``t``."""
    if layout is None or size == 1:
        return t
    dim, parts = layout
    if t.shape[dim] % (parts * size) != 0:
        raise ValueError(f"dim {dim} of size {t.shape[dim]} does not split into "
                         f"{parts} x {size} model shards")
    return torch.cat([p.chunk(size, dim)[index] for p in t.chunk(parts, dim)], dim)


def gather_tensor(t, layout, group):
    """The full tensor of a model rank's slice ``t``: a collective call of
    the model group (all-reduce of the slices placed in zeros)."""
    from turkish_asr_torch.parallel.collectives import all_reduce_
    if layout is None or group is None or group.size == 1:
        return t
    dim, parts = layout
    full = list(t.shape)
    full[dim] *= group.size
    out = t.new_zeros(full)
    n = t.shape[dim] // parts
    for j, piece in enumerate(t.split(n, dim)):
        start = (j * group.size + group.index) * n
        out.narrow(dim, start, n).copy_(piece)
    return all_reduce_([out], group)[0]


def shard_state_dict(state_dict, mesh):
    """This rank's state dict of a full one (``param_layout``)."""
    if mesh is None:
        return dict(state_dict)
    index, size = mesh.index("model"), mesh.size("model")
    return {k: shard_tensor(v, param_layout(k), index, size) for k, v in state_dict.items()}


def gather_state_dict(state_dict, mesh):
    """The full state dict of this rank's: a collective call of every rank."""
    if mesh is None:
        return dict(state_dict)
    group = mesh.group("model")
    return {k: gather_tensor(v, param_layout(k), group) for k, v in state_dict.items()}


def shard_model(model, mesh):
    """Replace ``model``'s sharded parameters by this rank's slices and
    hand every module the mesh. The model computes the one-process
    model's function on the mesh (``models/conformer.py``)."""
    if mesh is None:
        return model
    if mesh.world_size > 1 and not mesh.distributed:
        raise ValueError("a mesh of more than one rank needs torch.distributed")
    m = mesh.size("model")
    if model.cfg.n_heads % m or (model.cfg.d_model * model.cfg.ff_mult) % m:
        raise ValueError(f"model={m} must divide n_heads {model.cfg.n_heads} and "
                         f"d_ff {model.cfg.d_model * model.cfg.ff_mult}")
    with torch.no_grad():
        for name, p in model.named_parameters():
            p.data = shard_tensor(p.data, param_layout(name), mesh.index("model"), m).clone()
    for module in model.modules():
        module.mesh = mesh
    return model


def grad_sq_norm(names, mesh):
    """A function of a list of gradients (one per parameter in ``names``)
    to the squared global norm of the full, unsharded gradient: the
    replicated gradients' squares plus the model-sharded ones' summed over
    the model group. Every rank gets the same value."""
    group = None if mesh is None else mesh.group("model")
    sharded = [param_layout(n) is not None for n in names]

    def sq_norm(grads):
        from turkish_asr_torch.parallel.collectives import all_reduce_
        rep = sum(torch.sum(g.float() ** 2) for g, s in zip(grads, sharded) if not s)
        shard = [torch.sum(g.float() ** 2) for g, s in zip(grads, sharded) if s]
        if not shard:
            return rep
        return rep + all_reduce_([sum(shard)], group)[0]

    return sq_norm
