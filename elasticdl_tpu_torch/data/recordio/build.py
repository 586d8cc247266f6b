"""Build the native EDLIO codec; the counterpart of
``elasticdl_tpu/data/recordio/build.py``::

    python -m elasticdl_tpu_torch.data.recordio.build

compiles ``_native.cc`` with ``g++`` (linking zlib for CRC-32) into
``build/`` beside this file (listed in ``.gitignore``), under a name
that carries a hash of the source and the flags, so an edited source is
never served by a stale library.  The codec also builds itself at first
use (``recordio.ensure_native_codec``).  A failed build raises with the
compiler's output.
"""

from __future__ import annotations

import hashlib
import os
import subprocess
from pathlib import Path

_HERE = Path(__file__).resolve().parent
SOURCE = _HERE / "_native.cc"
BUILD_DIR = _HERE / "build"
CXX_FLAGS = ("-O2", "-std=c++17", "-shared", "-fPIC")
LIBS = ("-lz",)


def library_path() -> Path:
    digest = hashlib.sha256(SOURCE.read_bytes())
    digest.update(" ".join(CXX_FLAGS + LIBS).encode())
    return BUILD_DIR / f"_native-{digest.hexdigest()[:16]}.so"


def build() -> Path:
    """The built library's path, compiling it first if it is missing;
    raises ``RuntimeError`` with the compiler's output if that fails."""
    target = library_path()
    if target.exists():
        return target
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    # concurrent builds (test workers) each write their own file and
    # rename it into place, so a reader never sees half a library
    tmp = target.with_name(f"{target.name}.{os.getpid()}.tmp")
    cmd = ["g++", *CXX_FLAGS, str(SOURCE), *LIBS, "-o", str(tmp)]
    try:
        proc = subprocess.run(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
        )
    except FileNotFoundError as e:
        raise RuntimeError(
            f"the native EDLIO codec cannot be built: {e}"
        ) from e
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(
            f"g++ failed to build the native EDLIO codec (exit "
            f"{proc.returncode}): {' '.join(cmd)}\n{proc.stdout}"
        )
    os.replace(tmp, target)
    return target


if __name__ == "__main__":
    print(build())
