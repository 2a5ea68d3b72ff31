"""The PyTorch port stands alone: every module of ``chimera_st_tpu_torch``
imports with ``jax``, ``flax`` and the JAX package made unimportable (and with
the optional ``yaml``, ``sacrebleu`` and ``sentencepiece`` wheels unimportable
as well), and importing it builds no kernel."""

import pkgutil
import subprocess
import sys
from pathlib import Path

import chimera_st_tpu_torch

ROOT = Path(__file__).resolve().parent.parent

_PROBE = """
import importlib, sys
blocked, mods = sys.argv[1].split(","), sys.argv[2:]
for name in blocked:
    sys.modules[name] = None  # any import of these raises ImportError
for m in mods:
    importlib.import_module(m)
import chimera_st_tpu_torch.ops._build as b
assert not b._loaded, "a kernel library was loaded at import time"
leaked = sorted(k for k in sys.modules if k.split(".")[0] in ("jax", "flax", "chimera_st_tpu")
                and sys.modules[k] is not None)
assert not leaked, leaked
if "yaml" in blocked:
    # the registered names exist without the optional wheels; only building
    # the sacrebleu scorer needs its wheel
    from chimera_st_tpu_torch.scoring import build_scorer
    build_scorer({"_name": "bleu"})
    try:
        build_scorer({"_name": "sacrebleu"})
    except ImportError:
        pass
    else:
        raise AssertionError("the sacrebleu scorer was built without its wheel")
print(len(mods))
"""


def _port_modules():
    pkg = chimera_st_tpu_torch
    names = [pkg.__name__]
    for info in pkgutil.walk_packages(pkg.__path__, prefix=pkg.__name__ + "."):
        names.append(info.name)
    return names


JAX_NAMES = ("jax", "jaxlib", "flax", "chimera_st_tpu")
OPTIONAL_WHEELS = ("yaml", "sacrebleu", "sentencepiece")


def _import_all_with_blocked(blocked):
    mods = _port_modules()
    assert len(mods) >= 44
    for sub in ("checkpoint.store", "checkpoint.torch_import", "cli.generate", "cli.interactive",
                "cli.options", "config.registry", "data.manifests", "data.spm",
                "scoring.bleu", "tasks.triplet", "tasks.speech_to_text"):
        assert f"chimera_st_tpu_torch.{sub}" in mods
    proc = subprocess.run([sys.executable, "-c", _PROBE, ",".join(blocked), *mods], cwd=ROOT,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.split()[-1] == str(len(mods))


def test_every_port_module_imports_without_jax():
    _import_all_with_blocked(JAX_NAMES)


def test_every_port_module_imports_without_optional_wheels():
    """The card's machine has no ``sacrebleu`` or ``sentencepiece`` and may
    have no ``yaml``: they are imported inside the functions that need them."""
    _import_all_with_blocked(JAX_NAMES + OPTIONAL_WHEELS)


def test_chip_smoke_imports_no_jax():
    """chip_smoke.py names nothing of JAX or the JAX package."""
    src = (ROOT / "chip_smoke.py").read_text()
    for word in ("import jax", "from jax", "flax", "chimera_st_tpu.", "chimera_st_tpu "):
        assert word not in src, word
