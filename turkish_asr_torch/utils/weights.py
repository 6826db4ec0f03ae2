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
(identity). Reading the JAX package's msgpack ``.ckpt`` is not ported yet
(ROADMAP.md); the port serves reference-format ``.pt`` files.
"""

import numpy as np
import torch

from turkish_asr_torch.models.conformer import ConformerCTC, ModelConfig


def _np(x):
    return np.asarray(x, dtype=np.float32)


def state_dict_from_jax(params, state, n_heads):
    """JAX (params, model_state) trees of numpy arrays -> the port's
    state_dict (torch tensors, reference keys)."""
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
    linear("fc", params["fc"])

    d_model = _np(params["input_proj"]["b"]).shape[0]
    d_head = d_model // n_heads
    inv_freq = 1.0 / (10000.0 ** (np.arange(0, d_head, 2, dtype=np.float32) / d_head))
    blocks, bstate = params["blocks"], state["blocks"]
    n_blocks = _np(blocks["norm_ff1"]["scale"]).shape[0]
    for i in range(n_blocks):
        bp = _index_tree(blocks, i)
        p = f"blocks.{i}"
        linear(f"{p}.ff1.linear1", bp["ff1"]["in"])
        linear(f"{p}.ff1.linear2", bp["ff1"]["out"])
        norm(f"{p}.norm_ff1.norm", bp["norm_ff1"])
        sd[f"{p}.attn.rotary_emb.inv_freq"] = inv_freq
        linear(f"{p}.attn.linear_q", bp["attn"]["q"])
        linear(f"{p}.attn.linear_k", bp["attn"]["k"])
        linear(f"{p}.attn.linear_v", bp["attn"]["v"])
        linear(f"{p}.attn.linear_out", bp["attn"]["out"])
        norm(f"{p}.norm_attn.norm", bp["norm_attn"])
        norm(f"{p}.conv.norm.norm", bp["conv"]["norm"])
        conv1d(f"{p}.conv.pointwise_conv1", bp["conv"]["pw1"])
        conv1d(f"{p}.conv.depthwise_conv", bp["conv"]["dw"])
        norm(f"{p}.conv.batch_norm", bp["conv"]["bn"])
        sd[f"{p}.conv.batch_norm.running_mean"] = _np(bstate["bn"]["mean"][i])
        sd[f"{p}.conv.batch_norm.running_var"] = _np(bstate["bn"]["var"][i])
        sd[f"{p}.conv.batch_norm.num_batches_tracked"] = np.asarray(0, dtype=np.int64)
        conv1d(f"{p}.conv.pointwise_conv2", bp["conv"]["pw2"])
        sd[f"{p}.norm_conv.norm.weight"] = np.ones((d_model,), np.float32)
        sd[f"{p}.norm_conv.norm.bias"] = np.zeros((d_model,), np.float32)
        linear(f"{p}.ff2.linear1", bp["ff2"]["in"])
        linear(f"{p}.ff2.linear2", bp["ff2"]["out"])
        norm(f"{p}.norm_ff2.norm", bp["norm_ff2"])
        norm(f"{p}.final_norm.norm", bp["final_norm"])
    return {k: torch.from_numpy(np.array(v, copy=True)) for k, v in sd.items()}


def jax_trees_from_state_dict(sd):
    """The reverse of ``state_dict_from_jax``: the port's state_dict ->
    JAX (params, model_state) trees of numpy arrays with stacked
    (n_blocks, ...) block leaves. The reference-only entries (``inv_freq``,
    ``num_batches_tracked``, the dead ``norm_conv``) have no JAX leaf."""
    sd = {k: v.detach().cpu().numpy() for k, v in sd.items()}

    def linear(prefix):
        return {"w": sd[prefix + ".weight"].T.copy(), "b": sd[prefix + ".bias"]}

    def norm(prefix):
        return {"scale": sd[prefix + ".weight"], "bias": sd[prefix + ".bias"]}

    def conv1d(prefix):
        return {"w": sd[prefix + ".weight"].transpose(2, 1, 0).copy(), "b": sd[prefix + ".bias"]}

    def conv2d(prefix):
        return {"w": sd[prefix + ".weight"].transpose(2, 3, 1, 0).copy(),
                "b": sd[prefix + ".bias"]}

    blocks, states = [], []
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
        states.append({"bn": {"mean": sd[f"{p}.conv.batch_norm.running_mean"],
                              "var": sd[f"{p}.conv.batch_norm.running_var"]}})
        i += 1
    params = {"sub1": conv2d("subsample.0"), "sub2": conv2d("subsample.2"),
              "input_proj": linear("input_proj"), "blocks": _stack(blocks), "fc": linear("fc")}
    return params, {"blocks": _stack(states)}


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
