"""Weight bridge between the JAX package's trees and the port's state_dict.

Counterpart of turkish_asr_tpu/utils/torch_export.py (JAX trees -> reference
keys, and back with ``jax_trees_from_state_dict``) and turkish_asr_tpu/utils/torch_import.py:53-175 (reading a
reference ``.pt``). Layout mapping, JAX -> torch:

- Linear ``w (in, out)``         -> ``weight (out, in)``
- Conv2d ``w (H, W, I, O)`` HWIO -> ``weight (O, I, H, W)``
- Conv1d ``w (K, I/g, O)`` WIO   -> ``weight (O, I/g, K)``
- ``scale`` / ``bias``           -> GroupNorm / BatchNorm ``weight`` / ``bias``
- the BatchNorm state tree       -> ``running_mean`` / ``running_var``
- stacked (n_blocks, ...) arrays -> ``blocks.{i}.*``

plus the reference-only entries a strict load needs: the RoPE ``inv_freq``
buffers, ``num_batches_tracked`` (0) and the dead ``norm_conv`` GroupNorm
(identity).

The JAX package's ``.ckpt`` (``load_ckpt``) goes through the same map, and
so does its optimizer state: each Adam moment (``mu``, ``nu``) and
MultiSteps' ``acc_grads`` is a tree of the parameters' shape and takes
exactly its parameter's transform (``params_to_state_dict``), then the
port optimizer's parameter order (``opt_named_from_optimizer``,
``restore_optimizer_from_named``: optax's key paths, as
turkish_asr_tpu/train/checkpoint.py:32-80 names them).
"""

import numpy as np
import torch

from turkish_asr_torch.models.conformer import ConformerCTC, ModelConfig


def _np(x):
    if isinstance(x, torch.Tensor):  # a bf16 leaf of a .ckpt
        return x.detach().float().cpu().numpy()
    return np.asarray(x, dtype=np.float32)


def params_to_state_dict(params):
    """A JAX params tree, or any tree of its shape (an Adam moment), ->
    {reference key: fp32 numpy array} for the trainable parameters."""
    sd = {}

    def linear(prefix, p):
        sd[prefix + ".weight"] = _np(p["w"]).T
        sd[prefix + ".bias"] = _np(p["b"])

    def norm(prefix, p):
        sd[prefix + ".weight"] = _np(p["scale"])
        sd[prefix + ".bias"] = _np(p["bias"])

    def conv1d(prefix, p):
        sd[prefix + ".weight"] = _np(p["w"]).transpose(2, 1, 0)
        sd[prefix + ".bias"] = _np(p["b"])

    def conv2d(prefix, p):
        sd[prefix + ".weight"] = _np(p["w"]).transpose(3, 2, 0, 1)
        sd[prefix + ".bias"] = _np(p["b"])

    conv2d("subsample.0", params["sub1"])
    conv2d("subsample.2", params["sub2"])
    linear("input_proj", params["input_proj"])
    blocks = params["blocks"]
    for i in range(_np(blocks["norm_ff1"]["scale"]).shape[0]):
        bp = _index_tree(blocks, i)
        p = f"blocks.{i}"
        linear(f"{p}.ff1.linear1", bp["ff1"]["in"])
        linear(f"{p}.ff1.linear2", bp["ff1"]["out"])
        norm(f"{p}.norm_ff1.norm", bp["norm_ff1"])
        for n in ("q", "k", "v", "out"):
            linear(f"{p}.attn.linear_{n}", bp["attn"][n])
        norm(f"{p}.norm_attn.norm", bp["norm_attn"])
        norm(f"{p}.conv.norm.norm", bp["conv"]["norm"])
        conv1d(f"{p}.conv.pointwise_conv1", bp["conv"]["pw1"])
        conv1d(f"{p}.conv.depthwise_conv", bp["conv"]["dw"])
        norm(f"{p}.conv.batch_norm", bp["conv"]["bn"])
        conv1d(f"{p}.conv.pointwise_conv2", bp["conv"]["pw2"])
        linear(f"{p}.ff2.linear1", bp["ff2"]["in"])
        linear(f"{p}.ff2.linear2", bp["ff2"]["out"])
        norm(f"{p}.norm_ff2.norm", bp["norm_ff2"])
        norm(f"{p}.final_norm.norm", bp["final_norm"])
    linear("fc", params["fc"])
    return sd


def default_model_state(params):
    """The JAX ``init_model``'s BatchNorm state (mean 0, variance 1) for
    a ``.ckpt`` that carries none."""
    n_blocks, d_model = _np(params["blocks"]["conv"]["bn"]["scale"]).shape
    return {"blocks": {"bn": {"mean": np.zeros((n_blocks, d_model), np.float32),
                              "var": np.ones((n_blocks, d_model), np.float32)}}}


def state_dict_from_jax(params, state, n_heads):
    """JAX (params, model_state) trees of numpy arrays -> the port's
    state_dict (torch tensors, reference keys)."""
    sd = params_to_state_dict(params)
    d_model = _np(params["input_proj"]["b"]).shape[0]
    d_head = d_model // n_heads
    inv_freq = 1.0 / (10000.0 ** (np.arange(0, d_head, 2, dtype=np.float32) / d_head))
    bstate = state["blocks"]
    i = 0
    while f"blocks.{i}.ff1.linear1.weight" in sd:
        p = f"blocks.{i}"
        sd[f"{p}.attn.rotary_emb.inv_freq"] = inv_freq
        sd[f"{p}.conv.batch_norm.running_mean"] = _np(bstate["bn"]["mean"][i])
        sd[f"{p}.conv.batch_norm.running_var"] = _np(bstate["bn"]["var"][i])
        sd[f"{p}.conv.batch_norm.num_batches_tracked"] = np.asarray(0, dtype=np.int64)
        sd[f"{p}.norm_conv.norm.weight"] = np.ones((d_model,), np.float32)
        sd[f"{p}.norm_conv.norm.bias"] = np.zeros((d_model,), np.float32)
        i += 1
    return {k: torch.from_numpy(np.array(v, copy=True)) for k, v in sd.items()}


def jax_params_from_state_dict(sd):
    """The reverse of ``params_to_state_dict``: {reference key: tensor}
    of the trainable parameters (or of tensors of their shapes) -> a JAX
    params tree of numpy arrays with stacked (n_blocks, ...) block leaves."""
    sd = {k: v.detach().float().cpu().numpy() for k, v in sd.items()
          if k.endswith((".weight", ".bias"))}

    def linear(prefix):
        return {"w": sd[prefix + ".weight"].T.copy(), "b": sd[prefix + ".bias"]}

    def norm(prefix):
        return {"scale": sd[prefix + ".weight"], "bias": sd[prefix + ".bias"]}

    def conv1d(prefix):
        return {"w": sd[prefix + ".weight"].transpose(2, 1, 0).copy(), "b": sd[prefix + ".bias"]}

    def conv2d(prefix):
        return {"w": sd[prefix + ".weight"].transpose(2, 3, 1, 0).copy(),
                "b": sd[prefix + ".bias"]}

    blocks = []
    i = 0
    while f"blocks.{i}.ff1.linear1.weight" in sd:
        p = f"blocks.{i}"
        blocks.append({
            "ff1": {"in": linear(f"{p}.ff1.linear1"), "out": linear(f"{p}.ff1.linear2")},
            "norm_ff1": norm(f"{p}.norm_ff1.norm"),
            "attn": {n: linear(f"{p}.attn.linear_{n}") for n in ("q", "k", "v", "out")},
            "norm_attn": norm(f"{p}.norm_attn.norm"),
            "conv": {"norm": norm(f"{p}.conv.norm.norm"),
                     "pw1": conv1d(f"{p}.conv.pointwise_conv1"),
                     "dw": conv1d(f"{p}.conv.depthwise_conv"),
                     "bn": norm(f"{p}.conv.batch_norm"),
                     "pw2": conv1d(f"{p}.conv.pointwise_conv2")},
            "ff2": {"in": linear(f"{p}.ff2.linear1"), "out": linear(f"{p}.ff2.linear2")},
            "norm_ff2": norm(f"{p}.norm_ff2.norm"),
            "final_norm": norm(f"{p}.final_norm.norm"),
        })
        i += 1
    return {"sub1": conv2d("subsample.0"), "sub2": conv2d("subsample.2"),
            "input_proj": linear("input_proj"), "blocks": _stack(blocks), "fc": linear("fc")}


def jax_trees_from_state_dict(sd):
    """The reverse of ``state_dict_from_jax``: the port's state_dict ->
    JAX (params, model_state) trees of numpy arrays with stacked
    (n_blocks, ...) block leaves. The reference-only entries (``inv_freq``,
    ``num_batches_tracked``, the dead ``norm_conv``) have no JAX leaf."""
    states = []
    i = 0
    while f"blocks.{i}.ff1.linear1.weight" in sd:
        p = f"blocks.{i}.conv.batch_norm"
        states.append({"bn": {"mean": sd[f"{p}.running_mean"].detach().cpu().numpy(),
                              "var": sd[f"{p}.running_var"].detach().cpu().numpy()}})
        i += 1
    return jax_params_from_state_dict(sd), {"blocks": _stack(states)}


def _stack(trees):
    if isinstance(trees[0], dict):
        return {k: _stack([t[k] for t in trees]) for k in trees[0]}
    return np.stack(trees)


def _index_tree(tree, i):
    if isinstance(tree, dict):
        return {k: _index_tree(v, i) for k, v in tree.items()}
    return np.asarray(tree)[i]


def config_from_state_dict(sd, n_heads=4, n_mels=None, masked_norm=False):
    """ModelConfig from a reference state dict's shapes. n_heads is not
    recoverable from MQA shapes and input_proj pins only n_mels // 4, so
    both come from the checkpoint's config when it has one."""
    d_model = sd["subsample.0.weight"].shape[0]
    flattened = sd["input_proj.weight"].shape[1]
    if flattened % d_model != 0:
        raise ValueError(f"input_proj in-dim {flattened} is not a multiple of "
                         f"d_model {d_model}; not a reference-shaped checkpoint")
    if n_mels is None:
        n_mels = flattened // d_model * 4
    elif int(n_mels) // 4 != flattened // d_model:
        raise ValueError(f"checkpoint config says n_mel_channels={n_mels} but "
                         f"input_proj implies n_mels // 4 == {flattened // d_model}")
    n_blocks = 0
    while f"blocks.{n_blocks}.ff1.linear1.weight" in sd:
        n_blocks += 1
    d_head = d_model // n_heads
    use_mqa = sd["blocks.0.attn.linear_k.weight"].shape[0] == d_head if n_blocks else True
    return ModelConfig(n_mels=int(n_mels), d_model=d_model, n_heads=n_heads,
                       n_blocks=n_blocks, n_classes=sd["fc.weight"].shape[0],
                       dropout=0.0, use_mqa=use_mqa, masked_norm=masked_norm)


def load_pt(path, device, n_heads=4, allow_pickle=False):
    """Read a reference-format ``.pt`` (``{"model_state_dict", "config"}``
    or a bare state dict) with ``weights_only=True``. When that fails
    and ``allow_pickle`` is set (the CLI's ``--trust_checkpoint``), the
    file is unpickled in full: only for trusted files, as
    turkish_asr_tpu/utils/torch_import.py:141-158 does.

    Returns (cfg, model): an eval-mode ConformerCTC on ``device`` loaded
    with ``strict=True``.
    """
    try:
        blob = torch.load(path, map_location="cpu", weights_only=True)
    except Exception as e:
        if not allow_pickle:
            raise RuntimeError(
                f"Safe (weights_only) load of {path} failed: {e}\n"
                "The checkpoint contains non-tensor pickled payloads (e.g. embedded "
                "config/optimizer objects). If the file is trusted, re-run with "
                "--trust_checkpoint (allow_pickle=True) to permit full unpickling.") from e
        blob = torch.load(path, map_location="cpu", weights_only=False)
    if "model_state_dict" in blob:
        sd, stored = blob["model_state_dict"], blob.get("config") or {}
    else:
        sd, stored = blob, {}
    cfg = config_from_state_dict(
        sd, n_heads=int(stored.get("n_heads", n_heads)),
        n_mels=stored.get("n_mel_channels"),
        masked_norm=bool(stored.get("masked_norm", False)))
    model = ConformerCTC(cfg)
    model.load_state_dict(sd, strict=True)
    return cfg, model.to(device).eval()


def load_ckpt(path, device, n_heads=4):
    """Read a JAX ``.ckpt`` (turkish_asr_tpu/train/checkpoint.py). The
    architecture comes from ``meta["model_config"]`` as the JAX
    inference.py:95-106 takes it (``n_heads``, ``n_mels``, ``masked_norm``;
    ``n_heads`` falls back to the argument) and from the tensor shapes; a
    file without ``model_state`` gets ``default_model_state``.

    Returns (cfg, model): an eval-mode ConformerCTC on ``device`` loaded
    with ``strict=True``."""
    # Imported here: the train package imports this module (trainer.py).
    from turkish_asr_torch.train.checkpoint import load_jax_checkpoint_file

    ckpt = load_jax_checkpoint_file(path)
    mc = ckpt["meta"].get("model_config") or {}
    if not ckpt["params"]:
        raise ValueError(f"No params found in checkpoint: {path}")
    heads = int(mc.get("n_heads", n_heads))
    sd = state_dict_from_jax(ckpt["params"],
                             ckpt["model_state"] or default_model_state(ckpt["params"]), heads)
    cfg = config_from_state_dict(sd, n_heads=heads, n_mels=mc.get("n_mels"),
                                 masked_norm=bool(mc.get("masked_norm", False)))
    if "n_classes" in mc and int(mc["n_classes"]) != cfg.n_classes:
        raise ValueError(f"{path}: model_config says n_classes={int(mc['n_classes'])} but "
                         f"the fc layer has {cfg.n_classes} outputs")
    model = ConformerCTC(cfg)
    model.load_state_dict(sd, strict=True)
    return cfg, model.to(device).eval()


def load_model(path, device, n_heads=4, allow_pickle=False):
    """(cfg, eval model on ``device``) from a JAX ``.ckpt`` (``load_ckpt``)
    or a reference-format ``.pt``/``.pth`` (``load_pt``); any other file
    raises ValueError."""
    if path.endswith(".ckpt"):
        return load_ckpt(path, device, n_heads=n_heads)
    if path.endswith((".pt", ".pth")):
        return load_pt(path, device, n_heads=n_heads, allow_pickle=allow_pickle)
    raise ValueError(f"{path}: the port reads reference-format .pt checkpoints and the JAX "
                     "package's .ckpt; python -m turkish_asr_torch.export_model --format "
                     "torch writes a .pt from either")


# ---------------------------------------------------------------------------
# optimizer state <-> optax key paths


def trainable_names(model):
    """The trainable parameters' names in the order the trainer hands
    them to the optimizer."""
    return [n for n, p in model.named_parameters() if p.requires_grad]


def _flatten(tree, prefix, out):
    if isinstance(tree, dict):
        for k, v in tree.items():
            _flatten(v, f"{prefix}['{k}']", out)
    else:
        out[prefix] = tree
    return out


def _tree_like(template, named, prefix):
    if isinstance(template, dict):
        return {k: _tree_like(v, named, f"{prefix}['{k}']") for k, v in template.items()}
    return named[prefix]


def _adam_of(optimizer):
    """(the clip + AdamW optimizer, MultiSteps or None)."""
    from turkish_asr_torch.train.optim import MultiSteps

    if isinstance(optimizer, MultiSteps):
        return optimizer.inner, optimizer
    return optimizer, None


def opt_named_from_optimizer(optimizer, model):
    """The port optimizer's state as the JAX checkpoint's ``opt_named``:
    {optax key path: numpy leaf} of ``make_optimizer``'s chain
    (``[1][0].count``, ``[1][0].mu[...]``, ``[1][0].nu[...]``,
    ``[1][2].count``), under MultiSteps prefixed ``.inner_opt_state`` and
    joined by ``.mini_step``, ``.gradient_step`` and ``.acc_grads[...]``."""
    names = trainable_names(model)
    adam, multi = _adam_of(optimizer)

    def tree(tensors):
        return jax_params_from_state_dict(dict(zip(names, tensors)))

    pre = ".inner_opt_state" if multi is not None else ""
    count = np.asarray(adam.count, np.int32)
    named = {f"{pre}[1][0].count": count, f"{pre}[1][2].count": count.copy()}
    _flatten(tree(adam.mu), f"{pre}[1][0].mu", named)
    _flatten(tree(adam.nu), f"{pre}[1][0].nu", named)
    if multi is not None:
        named[".mini_step"] = np.asarray(multi.mini_step, np.int32)
        named[".gradient_step"] = count.copy()
        _flatten(tree(multi.acc), ".acc_grads", named)
    return named


def restore_optimizer_from_named(optimizer, model, named):
    """Load a JAX checkpoint's ``opt_named`` into the port optimizer: each
    moment tree through ``params_to_state_dict`` (its parameter's layout
    transform), then the trainer's parameter order. Missing or extra key
    paths raise KeyError and a shape mismatch ValueError, as
    turkish_asr_tpu/train/checkpoint.py:60-80 does, before anything is
    written."""
    template = opt_named_from_optimizer(optimizer, model)
    missing, extra = sorted(set(template) - set(named)), sorted(set(named) - set(template))
    if missing or extra:
        raise KeyError("optimizer state structure mismatch between checkpoint and current "
                       f"optimizer: missing={missing[:5]} extra={extra[:5]} (another "
                       "accumulation setting or optimizer chain?)")
    for k, want in template.items():
        if tuple(np.shape(named[k])) != tuple(np.shape(want)):
            raise ValueError(f"optimizer leaf {k} shape {tuple(np.shape(named[k]))} != "
                             f"expected {tuple(np.shape(want))}")
    adam, multi = _adam_of(optimizer)
    pre = ".inner_opt_state" if multi is not None else ""
    counts = {k: int(np.asarray(named[k])) for k in template if k.endswith(("count", "_step"))}
    count = counts[f"{pre}[1][0].count"]
    if counts[f"{pre}[1][2].count"] != count or (multi is not None
                                                 and counts[".gradient_step"] != count):
        raise ValueError(f"the checkpoint's step counts disagree ({counts}); the port keeps "
                         "one count for Adam, the schedule and MultiSteps")
    params_tree = jax_params_from_state_dict(dict(model.named_parameters()))
    names = trainable_names(model)

    def load(dst, prefix):
        sd = params_to_state_dict(_tree_like(params_tree, named, prefix))
        for t, name in zip(dst, names):
            t.copy_(torch.tensor(sd[name], dtype=t.dtype))

    with torch.no_grad():
        load(adam.mu, f"{pre}[1][0].mu")
        load(adam.nu, f"{pre}[1][0].nu")
        adam.count = count
        if multi is not None:
            load(multi.acc, ".acc_grads")
            multi.mini_step = counts[".mini_step"]
