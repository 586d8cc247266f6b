"""Versioned checkpoints on disk; the counterpart of
``elasticdl_tpu/utils/save_utils.py``.

The directory scheme and files are the JAX package's::

    {dir}/version-{v}/variables-{i}-of-{N}.npz   (``dense/<name>``,
                                                  ``emb_ids/<name>``,
                                                  ``emb_rows/<name>``)
    {dir}/version-{v}/manifest.json              (version, parts, names)

so either package restores the other's checkpoints.  A row-sharded
table is written as ``(ids, rows)`` parts, one part a process, each
carrying its global row ids; :func:`restore_checkpoint_parts` reads them
back filtered to the rows a process keeps, so a restore under another
world size re-shards by row id and no process holds a whole table.
"""

from __future__ import annotations

import json
import os
import shutil

import numpy as np

from elasticdl_tpu_torch.utils.log_utils import default_logger as logger

_MANIFEST = "manifest.json"


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
        embeddings: table name -> (ids [n], rows [n, dim]) this part owns.
        enforce_retention: pass False on parts written concurrently with
        part 0 (exactly one writer should delete old versions).
        """
        vdir = _version_dir(self._dir, version)
        os.makedirs(vdir, exist_ok=True)
        payload = {f"dense/{name}": np.asarray(arr) for name, arr in dense.items()}
        names = {"dense": sorted(dense), "embeddings": []}
        for name, (ids, rows) in (embeddings or {}).items():
            names["embeddings"].append(name)
            payload[f"emb_ids/{name}"] = np.asarray(ids, dtype=np.int64)
            payload[f"emb_rows/{name}"] = np.asarray(rows)
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
                "names": names,
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
    """``(dense, extra)`` of a checkpoint, its row-sharded tables
    assembled whole into ``dense`` under their names
    (:func:`assemble_embedding_tables`).  ``checkpoint_dir`` may name a
    version directory (``{root}/version-N``) itself.  A process that
    holds a shard reads :func:`restore_checkpoint_parts` instead."""
    dense, embeddings, extra = restore_checkpoint_parts(checkpoint_dir, version)
    dense.update(assemble_embedding_tables(embeddings))
    return dense, extra


def restore_checkpoint_parts(
    checkpoint_dir: str,
    version: int | None = None,
    num_shards: int = 1,
    shard_id: int = 0,
    table_row_ranges: dict[str, list[tuple[int, int]]] | None = None,
) -> tuple[dict[str, np.ndarray], dict[str, tuple[np.ndarray, np.ndarray]], dict]:
    """``(dense, embeddings, extra)`` of a checkpoint, the JAX package's
    ``restore_checkpoint`` (:151): ``embeddings`` maps a table to the
    ``(ids, rows)`` of every part, concatenated, whatever part count the
    writer had; ``num_shards > 1`` keeps the ids with ``id % num_shards
    == shard_id`` (the reference's hash re-partitioning).

    ``table_row_ranges``: per-table ``[(lo, hi), ...]`` keep filters,
    applied while the parts are read, so a process restoring its shard
    never holds the whole table.

    With ``version=None``, versions are tried newest-first: a torn or
    unreadable version (a save cut short by a kill) falls back to the
    next older intact one instead of failing the restore."""
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
        return _load_version(
            checkpoint_dir, version, num_shards, shard_id, table_row_ranges
        )
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
            return _load_version(
                checkpoint_dir, v, num_shards, shard_id, table_row_ranges
            )
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


def _load_version(
    checkpoint_dir: str,
    version: int,
    num_shards: int,
    shard_id: int,
    table_row_ranges: dict[str, list[tuple[int, int]]] | None,
):
    vdir = _version_dir(checkpoint_dir, version)
    with open(os.path.join(vdir, _MANIFEST)) as f:
        manifest = json.load(f)
    n = manifest["num_parts"]
    dense: dict[str, np.ndarray] = {}
    emb_ids: dict[str, list[np.ndarray]] = {}
    emb_rows: dict[str, list[np.ndarray]] = {}
    for i in range(n):
        with np.load(os.path.join(vdir, _part_file(i, n))) as z:
            part_ids: dict[str, np.ndarray] = {}
            part_rows: dict[str, np.ndarray] = {}
            for key in z.files:
                kind, name = key.split("/", 1)
                if kind == "dense":
                    dense[name] = z[key]
                elif kind == "emb_ids":
                    part_ids[name] = z[key]
                elif kind == "emb_rows":
                    part_rows[name] = z[key]
                else:
                    raise ValueError(f"unknown checkpoint entry {key!r}")
        # filter each part as it is read, so only kept rows accumulate
        for name, ids in part_ids.items():
            rows = part_rows[name]
            if table_row_ranges and name in table_row_ranges:
                keep = np.zeros(ids.shape, dtype=bool)
                for lo, hi in table_row_ranges[name]:
                    keep |= (ids >= lo) & (ids < hi)
                ids, rows = ids[keep], rows[keep]
            emb_ids.setdefault(name, []).append(ids)
            emb_rows.setdefault(name, []).append(rows)
    embeddings: dict[str, tuple[np.ndarray, np.ndarray]] = {}
    for name in emb_ids:
        ids = np.concatenate(emb_ids[name])
        rows = np.concatenate(emb_rows[name], axis=0)
        if num_shards > 1:
            # the reference's int_to_id: id mod N
            mask = (ids % num_shards) == shard_id
            ids, rows = ids[mask], rows[mask]
        embeddings[name] = (ids, rows)
    return dense, embeddings, manifest.get("extra", {})


def select_rows(
    name: str, ids: np.ndarray, rows: np.ndarray, lo: int, hi: int
) -> np.ndarray:
    """Rows ``[lo, hi)`` of table ``name``, picked from its ``(ids,
    rows)`` by global row id; raises when any is missing."""
    ids = np.asarray(ids)
    order = np.argsort(ids, kind="stable")
    ids_sorted = ids[order]
    want = np.arange(lo, hi, dtype=ids_sorted.dtype)
    pos = np.searchsorted(ids_sorted, want)
    if pos.size and (
        pos.max() >= len(ids_sorted) or not np.array_equal(ids_sorted[pos], want)
    ):
        raise ValueError(f"parts of {name!r} lack rows of [{lo}, {hi})")
    return np.asarray(rows)[order[pos]]


def assemble_embedding_tables(
    embeddings: dict[str, tuple[np.ndarray, np.ndarray]],
) -> dict[str, np.ndarray]:
    """Whole tables from ``(ids, rows)`` parts: the ids must cover
    ``0..V-1`` exactly once, whatever layout wrote them."""
    out: dict[str, np.ndarray] = {}
    for name, (ids, rows) in embeddings.items():
        order = np.argsort(ids)
        ids_sorted = ids[order]
        expected = np.arange(len(ids_sorted), dtype=ids_sorted.dtype)
        if len(ids_sorted) == 0 or not np.array_equal(ids_sorted, expected):
            raise ValueError(
                f"embedding parts for {name!r} do not cover a full "
                f"contiguous table (got {len(ids_sorted)} ids)"
            )
        out[name] = rows[order]
    return out


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
