"""Versioned checkpoints on disk; the counterpart of
``elasticdl_tpu/utils/save_utils.py``, for dense values.

The directory scheme and files are the JAX package's::

    {dir}/version-{v}/variables-{i}-of-{N}.npz   (``dense/<name>`` arrays)
    {dir}/version-{v}/manifest.json              (version, parts, names)

so either package restores the other's checkpoints.  Sharded embedding
tables (``(ids, rows)`` parts) raise until the port's sharded embeddings
(``ROADMAP.md`` queue 1, slice 9).
"""

from __future__ import annotations

import json
import os
import shutil

import numpy as np

from elasticdl_tpu_torch.utils.log_utils import default_logger as logger

_MANIFEST = "manifest.json"
_EMBEDDINGS_NOT_PORTED = (
    "sharded embedding tables in checkpoints come with the port's sharded "
    "embeddings (ROADMAP.md queue 1, slice 9)"
)


def _version_dir(checkpoint_dir: str, version: int) -> str:
    return os.path.join(checkpoint_dir, f"version-{version}")


def _part_file(i: int, n: int) -> str:
    return f"variables-{i}-of-{n}.npz"


class CheckpointSaver:
    """Writes checkpoints; enforces retention."""

    def __init__(self, checkpoint_dir: str, keep_checkpoint_max: int = 3):
        if not checkpoint_dir:
            raise ValueError("checkpoint_dir must be set")
        self._dir = checkpoint_dir
        self._keep_max = keep_checkpoint_max
        os.makedirs(checkpoint_dir, exist_ok=True)

    @property
    def directory(self) -> str:
        return self._dir

    def save(
        self,
        version: int,
        dense: dict[str, np.ndarray],
        embeddings: dict | None = None,
        part: int = 0,
        num_parts: int = 1,
        extra: dict | None = None,
        enforce_retention: bool = True,
    ):
        """Save one part of checkpoint ``version``.

        dense: name -> array (only part 0 should carry dense params).
        enforce_retention: pass False on parts written concurrently with
        part 0 (exactly one writer should delete old versions).
        """
        if embeddings:
            raise NotImplementedError(_EMBEDDINGS_NOT_PORTED)
        vdir = _version_dir(self._dir, version)
        os.makedirs(vdir, exist_ok=True)
        payload = {f"dense/{name}": np.asarray(arr) for name, arr in dense.items()}
        # atomic publish: a process killed mid-save must never leave a
        # torn npz behind a complete-looking file set, so write to a
        # temporary name (keeping the .npz suffix, or np.savez appends
        # one), then rename
        final = os.path.join(vdir, _part_file(part, num_parts))
        tmp = os.path.join(
            vdir, f".tmp-{os.getpid()}-{_part_file(part, num_parts)}"
        )
        np.savez(tmp, **payload)
        os.replace(tmp, final)
        if part == 0:
            manifest = {
                "version": version,
                "num_parts": num_parts,
                "names": {"dense": sorted(dense), "embeddings": []},
                "extra": extra or {},
            }
            with open(os.path.join(vdir, _MANIFEST), "w") as f:
                json.dump(manifest, f)
        if enforce_retention:
            self._enforce_retention()
        logger.info(
            "Saved checkpoint version %d part %d/%d to %s",
            version, part, num_parts, vdir,
        )

    def _enforce_retention(self):
        if self._keep_max <= 0:
            return
        versions = _list_versions(self._dir)
        while len(versions) > self._keep_max:
            victim = versions.pop(0)
            shutil.rmtree(_version_dir(self._dir, victim), ignore_errors=True)
            logger.info("Evicted checkpoint version %d", victim)


def checkpoint_is_valid(checkpoint_dir: str, version: int) -> bool:
    """All parts present."""
    vdir = _version_dir(checkpoint_dir, version)
    manifest_path = os.path.join(vdir, _MANIFEST)
    if not os.path.exists(manifest_path):
        return False
    with open(manifest_path) as f:
        manifest = json.load(f)
    n = manifest["num_parts"]
    return all(
        os.path.exists(os.path.join(vdir, _part_file(i, n)))
        for i in range(n)
    )


def latest_version(checkpoint_dir: str) -> int | None:
    valid = [
        v
        for v in _list_versions(checkpoint_dir)
        if checkpoint_is_valid(checkpoint_dir, v)
    ]
    return max(valid) if valid else None


def restore_checkpoint(
    checkpoint_dir: str, version: int | None = None
) -> tuple[dict[str, np.ndarray], dict]:
    """``(dense, extra)`` of a checkpoint.  ``checkpoint_dir`` may name a
    version directory (``{root}/version-N``) itself.

    With ``version=None``, versions are tried newest-first: a torn or
    unreadable version (a save cut short by a kill) falls back to the
    next older intact one instead of failing the restore.
    """
    base = os.path.basename(os.path.normpath(checkpoint_dir))
    if version is None and base.startswith("version-"):
        try:
            version = int(base.split("-", 1)[1])
            checkpoint_dir = os.path.dirname(os.path.normpath(checkpoint_dir))
        except ValueError:
            pass
    if version is not None:
        if not checkpoint_is_valid(checkpoint_dir, version):
            raise FileNotFoundError(
                f"checkpoint version {version} under {checkpoint_dir} "
                f"is invalid"
            )
        return _load_version(checkpoint_dir, version)
    candidates = [
        v
        for v in _list_versions(checkpoint_dir)
        if checkpoint_is_valid(checkpoint_dir, v)
    ]
    if not candidates:
        raise FileNotFoundError(f"no valid checkpoint under {checkpoint_dir}")
    last_error: Exception | None = None
    for v in reversed(candidates):
        try:
            return _load_version(checkpoint_dir, v)
        except NotImplementedError:
            raise
        except Exception as ex:  # noqa: BLE001 — torn files fall through
            logger.warning(
                "Checkpoint version %d under %s unreadable (%s); "
                "falling back to an older version",
                v, checkpoint_dir, ex,
            )
            last_error = ex
    raise FileNotFoundError(
        f"all checkpoint versions under {checkpoint_dir} unreadable"
    ) from last_error


def _load_version(checkpoint_dir: str, version: int):
    vdir = _version_dir(checkpoint_dir, version)
    with open(os.path.join(vdir, _MANIFEST)) as f:
        manifest = json.load(f)
    n = manifest["num_parts"]
    dense: dict[str, np.ndarray] = {}
    for i in range(n):
        with np.load(os.path.join(vdir, _part_file(i, n))) as z:
            for key in z.files:
                kind, name = key.split("/", 1)
                if kind != "dense":
                    raise NotImplementedError(_EMBEDDINGS_NOT_PORTED)
                dense[name] = z[key]
    return dense, manifest.get("extra", {})


def _list_versions(checkpoint_dir: str) -> list[int]:
    out = []
    if not os.path.isdir(checkpoint_dir):
        return out
    for name in os.listdir(checkpoint_dir):
        if name.startswith("version-"):
            try:
                out.append(int(name.split("-", 1)[1]))
            except ValueError:
                continue
    return sorted(out)
