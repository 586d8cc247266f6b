"""The PyTorch port's import boundary: ``elasticdl_tpu_torch``,
``chip_smoke.py`` and the port's scripts
(``scripts/torch_*.py``) import torch and numpy, never JAX,
flax, optax or any module of the JAX package ``elasticdl_tpu``; nor
``grpc`` or ``msgpack``, which the card's machine lacks (the port's
control plane rides the standard library)."""

from __future__ import annotations

import os
import re
import shutil
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = os.path.join(REPO, "elasticdl_tpu_torch")

# run in a fresh interpreter where the forbidden packages cannot be
# imported at all, then import every module of the port
_PROBE = r"""
import importlib, pkgutil, sys

FORBIDDEN = ("jax", "flax", "optax", "elasticdl_tpu", "grpc", "msgpack")

class _Block:
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in FORBIDDEN:
            raise ImportError(f"blocked import of {name}")
        return None

sys.meta_path.insert(0, _Block())
import elasticdl_tpu_torch as port

names = [m.name for m in pkgutil.walk_packages(port.__path__, "elasticdl_tpu_torch.")]
# the streaming slice's modules are among them
assert {"elasticdl_tpu_torch.streaming." + m for m in ("source", "reader", "live_push")} <= set(names)
for name in names:
    importlib.import_module(name)
leaked = sorted(n for n in sys.modules if n.split(".")[0] in FORBIDDEN)
print(len(names), leaked)
sys.exit(1 if leaked else 0)
"""

_FORBIDDEN_IMPORT = re.compile(
    r"^\s*(import\s+(jax|flax|optax|grpc|msgpack)\b"
    r"|from\s+(jax|flax|optax|grpc|msgpack)\b"
    r"|from\s+elasticdl_tpu(\.|\s+import\b)"
    r"|import\s+elasticdl_tpu(\.|\s|,|$))",
    re.MULTILINE,
)


def _port_sources():
    for root, _dirs, files in os.walk(PORT):
        for name in files:
            if name.endswith(".py"):
                yield os.path.join(root, name)
    yield os.path.join(REPO, "chip_smoke.py")
    scripts = os.path.join(REPO, "scripts")
    for name in os.listdir(scripts):
        if name.startswith("torch_") and name.endswith(".py"):
            yield os.path.join(scripts, name)


def test_port_imports_with_jax_absent():
    proc = subprocess.run(
        [sys.executable, "-c", _PROBE], cwd=REPO, capture_output=True,
        text=True, timeout=120,
    )
    assert proc.returncode == 0, proc.stdout + proc.stderr
    count, leaked = proc.stdout.split(" ", 1)
    assert int(count) >= 132  # every module of the slices so far was imported
    assert leaked.strip() == "[]"


@pytest.mark.parametrize(
    "path", sorted(_port_sources()), ids=lambda p: os.path.relpath(p, REPO)
)
def test_port_source_has_no_forbidden_import(path):
    with open(path) as f:
        text = f.read()
    found = [m.group(0).strip() for m in _FORBIDDEN_IMPORT.finditer(text)]
    assert not found, f"{path}: {found}"


def test_forbidden_import_pattern_catches_each_form():
    for line in (
        "import jax", "import jax.numpy as jnp", "from flax import linen",
        "import optax", "from elasticdl_tpu.ops import attention",
        "from elasticdl_tpu import serving", "import elasticdl_tpu",
        "    import elasticdl_tpu.layers", "import grpc", "import msgpack",
        "from grpc import aio",
    ):
        assert _FORBIDDEN_IMPORT.search(line), line
    for line in (
        "import elasticdl_tpu_torch", "from elasticdl_tpu_torch.ops import x",
        "from jaxtyping import Array",
    ):
        assert not _FORBIDDEN_IMPORT.search(line), line


@pytest.mark.parametrize("alone", [False, True], ids=["checkout", "alone"])
def test_chip_smoke_fails_without_a_gpu_or_the_checkout(tmp_path, alone):
    """Without CUDA, or copied into a directory that holds nothing else
    of the repo, the smoke exits non-zero and prints no result line."""
    script = os.path.join(REPO, "chip_smoke.py")
    if alone:
        shutil.copy(script, tmp_path / "chip_smoke.py")
        script, cwd = str(tmp_path / "chip_smoke.py"), str(tmp_path)
    else:
        cwd = REPO
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["CUDA_VISIBLE_DEVICES"] = ""  # no card, even on a machine with one
    proc = subprocess.run(
        [sys.executable, script], cwd=cwd, capture_output=True, text=True,
        timeout=120, env=env,
    )
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout
