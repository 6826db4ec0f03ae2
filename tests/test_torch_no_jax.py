"""The port imports torch and never jax, flax, optax, msgpack or the JAX
package."""

import os
import subprocess
import sys

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
    "turkish_asr_torch.audio.native",
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
    "turkish_asr_torch.export_model",
    "turkish_asr_torch.scripts.overfit",
]


def test_slice_imports_no_jax():
    code = ("import importlib, sys\n"
            f"for m in {SLICE_MODULES!r}:\n"
            "    importlib.import_module(m)\n"
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'flax', 'optax', 'msgpack', 'turkish_asr_tpu'))\n"
            "assert not bad, bad\n"
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
