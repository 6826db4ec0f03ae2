"""The port imports torch and never jax, flax, optax, msgpack or the JAX
package; importing it builds nothing; and each subpackage exports the
counterpart of every name its JAX ``__init__.py`` exports, or states that
the name has none."""

import ast
import importlib
import os
import subprocess
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

SLICE_MODULES = [
    "turkish_asr_torch",
    "turkish_asr_torch.audio.wavio",
    "turkish_asr_torch.audio.flacio",
    "turkish_asr_torch.audio.features",
    "turkish_asr_torch.data.tokenizer",
    "turkish_asr_torch.data.bpe",
    "turkish_asr_torch.data.buckets",
    "turkish_asr_torch.models.attention",
    "turkish_asr_torch.models.conformer",
    "turkish_asr_torch.ops._build",
    "turkish_asr_torch.ops._flash_attention",
    "turkish_asr_torch.ops.flash_attention",
    "turkish_asr_torch.decode.greedy",
    "turkish_asr_torch.utils.device",
    "turkish_asr_torch.utils.errors",
    "turkish_asr_torch.utils.weights",
    "turkish_asr_torch.inference",
    "turkish_asr_torch.serve.server",
    "turkish_asr_torch.audio.augment",
    "turkish_asr_torch.data.dataset",
    "turkish_asr_torch.models.conformer",
    "turkish_asr_torch.ops._ctc",
    "turkish_asr_torch.ops._dropout",
    "turkish_asr_torch.ops.ctc",
    "turkish_asr_torch.train",
    "turkish_asr_torch.train.checkpoint",
    "turkish_asr_torch.train.optim",
    "turkish_asr_torch.train.trainer",
    "turkish_asr_torch.utils.config",
    "turkish_asr_torch.utils.logger",
    "turkish_asr_torch.utils.metrics",
    "turkish_asr_torch.main",
    "turkish_asr_torch.native",
    "turkish_asr_torch.native.loader",
    "turkish_asr_torch.ops._swiglu",
    "turkish_asr_torch.ops.swiglu",
    "turkish_asr_torch.scripts",
    "turkish_asr_torch.scripts.ab_swiglu",
    "turkish_asr_torch.scripts.ab_attention",
    "turkish_asr_torch.scripts.ab_ctc",
    "turkish_asr_torch.scripts.dump_floor",
    "turkish_asr_torch.decode",
    "turkish_asr_torch.decode.lm",
    "turkish_asr_torch.decode.beam",
    "turkish_asr_torch.decode.factory",
    "turkish_asr_torch.ops.beam_search",
    "turkish_asr_torch.scripts.synthetic_arpa",
    "turkish_asr_torch.utils.msgpack_read",
    "turkish_asr_torch.utils.runtime",
    "turkish_asr_torch.utils.tracing",
    "turkish_asr_torch.export_model",
    "turkish_asr_torch.scripts.overfit",
    "turkish_asr_torch.parallel",
    "turkish_asr_torch.parallel.mesh",
    "turkish_asr_torch.parallel.collectives",
    "turkish_asr_torch.bench",
    "turkish_asr_torch.spm_train",
    "turkish_asr_torch.multichip",
    "turkish_asr_torch.audio",
    "turkish_asr_torch.data",
    "turkish_asr_torch.models",
    "turkish_asr_torch.ops",
    "turkish_asr_torch.serve",
    "turkish_asr_torch.utils",
]

SUBPACKAGES = ("audio", "data", "decode", "models", "native", "ops", "parallel", "serve", "train",
               "utils")
# The JAX package's exports with no counterpart in the port: XLA shardings
# (the port slices weights with parallel.shard_model and batches with the
# sampler's process slices) and functional forms of what the port's
# nn.Modules do in forward.
NO_COUNTERPART = {
    "models": {"apply_model", "mqa_attention", "init_attention"},
    "parallel": {"batch_sharding", "replicated_sharding", "param_shardings", "shard_batch",
                 "activation_constraint"},
}


def test_slice_imports_no_jax():
    code = ("import importlib, sys\n"
            f"for m in {SLICE_MODULES!r}:\n"
            "    importlib.import_module(m)\n"
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'flax', 'optax', 'msgpack', 'turkish_asr_tpu'))\n"
            "assert not bad, bad\n"
            "from turkish_asr_torch.native import loader\n"
            "from turkish_asr_torch.ops import _build\n"
            "assert not loader._tried and not _build._loaded, 'an import built a library'\n"
            "print('ok')\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                          text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "ok"


def test_every_port_module_is_listed():
    pkg = os.path.join(ROOT, "turkish_asr_torch")
    found = set()
    for dirpath, _, files in os.walk(pkg):
        for f in files:
            if f.endswith(".py"):
                rel = os.path.relpath(os.path.join(dirpath, f), ROOT)[:-3]
                mod = rel.replace(os.sep, ".")
                found.add(mod[:-len(".__init__")] if mod.endswith(".__init__") else mod)
    listed = set(SLICE_MODULES)
    subpackages = {m for m in found if os.path.isdir(os.path.join(ROOT, *m.split(".")))}
    assert found - subpackages <= listed, sorted(found - subpackages - listed)


_FIRST_IMPORT = """
import importlib, os, sys
import numpy, torch  # loaded once; every child below imports the port afresh
bad = []
for m in {modules!r}:
    r, w = os.pipe()
    pid = os.fork()
    if pid == 0:
        os.close(r)
        try:
            importlib.import_module(m)
            msg = ""
        except BaseException as e:  # reported to the parent, which fails
            msg = type(e).__name__ + ": " + str(e)
        os.write(w, msg.encode()[:4000])
        os._exit(0)
    os.close(w)
    with os.fdopen(r, "rb") as f:
        msg = f.read().decode()
    os.waitpid(pid, 0)
    if msg:
        bad.append((m, msg))
print(bad)
"""


def test_every_module_imports_first():
    """Each port module imported first in a fresh process (forked after
    torch), so that no order of imports meets a cycle between the
    subpackages' exports."""
    modules = sorted(set(SLICE_MODULES))
    proc = subprocess.run([sys.executable, "-c", _FIRST_IMPORT.format(modules=modules)],
                          cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "[]", proc.stdout


def _jax_all(sub):
    """The names in turkish_asr_tpu/<sub>/__init__.py's ``__all__``, read
    without importing it."""
    path = os.path.join(ROOT, "turkish_asr_tpu", sub, "__init__.py")
    with open(path, encoding="utf-8") as f:
        tree = ast.parse(f.read())
    for node in tree.body:
        if isinstance(node, ast.Assign) and any(getattr(t, "id", None) == "__all__"
                                                for t in node.targets):
            return ast.literal_eval(node.value)
    raise AssertionError(f"{path} has no __all__")


@pytest.mark.parametrize("sub", SUBPACKAGES)
def test_subpackage_exports_the_jax_names(sub):
    port = importlib.import_module(f"turkish_asr_torch.{sub}")
    names = _jax_all(sub)
    missing = [n for n in names if not hasattr(port, n) and n not in NO_COUNTERPART.get(sub, ())]
    assert not missing, missing
    assert not NO_COUNTERPART.get(sub, set()) - set(names)
    assert set(port.__all__) >= set(names) - NO_COUNTERPART.get(sub, set())
    for n in port.__all__:
        assert getattr(port, n) is not None, n
