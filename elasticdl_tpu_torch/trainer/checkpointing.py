"""Periodic checkpoints and resume; the counterpart of
``elasticdl_tpu/trainer/checkpointing.py`` for dense state.  In a
multi-process world process 0 writes every checkpoint as one part, and
restores it for all (``worker/lockstep.py``).  Saves and restores call
the chaos hooks (``chaos/hooks.py``), a no-op without a fault plan.

The host snapshot of the weights (``state_to_checkpoint``: device to
host copies, flax names and layouts) is taken on the training thread;
only the disk write moves to a writer thread, which touches numpy arrays
and never the device.
"""

from __future__ import annotations

import threading

from elasticdl_tpu_torch.chaos import hooks as chaos_hooks
from elasticdl_tpu_torch.trainer.state import checkpoint_to_state, state_to_checkpoint
from elasticdl_tpu_torch.utils import save_utils
from elasticdl_tpu_torch.utils.log_utils import default_logger as logger


class PeriodicCheckpointer:
    """Milestone-crossing periodic saver: task boundaries are not step
    multiples, so an exact-multiple check would skip saves."""

    def __init__(
        self,
        checkpoint_dir: str,
        checkpoint_steps: int,
        keep_checkpoint_max: int = 3,
    ):
        self._saver = (
            save_utils.CheckpointSaver(checkpoint_dir, keep_checkpoint_max)
            if checkpoint_dir
            else None
        )
        self._steps = checkpoint_steps or 0
        self._last_milestone = 0
        self._last_saved_version = -1
        # one write in flight at most: the next save (or flush) joins the
        # previous one first, which bounds host memory and surfaces write
        # errors on the training thread
        self._writer: threading.Thread | None = None
        self._write_error: BaseException | None = None

    @property
    def enabled(self) -> bool:
        return self._saver is not None

    def note_restored_version(self, version: int):
        if self._steps:
            self._last_milestone = version // self._steps

    def maybe_save(self, trainer) -> bool:
        """Save if a ``checkpoint_steps`` milestone was crossed."""
        if self._saver is None or not self._steps or trainer is None:
            return False
        milestone = trainer.step // self._steps
        if milestone <= self._last_milestone:
            return False
        self._last_milestone = milestone
        self.save_now(trainer)
        return True

    def save_now(self, trainer, skip_if_current: bool = False):
        """``skip_if_current``: no-op when this version was already saved
        (the end-of-training save after a milestone save of the final
        step would write the same checkpoint twice)."""
        version = trainer.step
        if skip_if_current and version == self._last_saved_version:
            return
        chaos_hooks.notify_checkpoint_save(int(version))
        dense = state_to_checkpoint(trainer.state)  # host arrays, owned
        self._last_saved_version = version
        self.flush()
        self._writer = threading.Thread(
            target=self._write_guarded,
            args=(version, dense),
            name=f"ckpt-writer-{version}",
            daemon=True,
        )
        self._writer.start()

    def flush(self):
        """Join the in-flight write (if any) and re-raise its error on
        the caller's thread, so a job never 'completes' with an unwritten
        checkpoint."""
        writer, self._writer = self._writer, None
        if writer is not None:
            writer.join()
        error, self._write_error = self._write_error, None
        if error is not None:
            raise error

    def flush_on_unwind(self, clean_exit: bool):
        """``flush()`` for ``finally`` blocks: when the body raised
        (``clean_exit=False``) a failed write is logged instead of raised,
        so it cannot replace the root cause; on a clean exit it raises
        exactly like ``flush()``."""
        try:
            self.flush()
        except Exception:
            if clean_exit:
                raise
            logger.exception(
                "Async checkpoint write failed during error unwind "
                "(original exception follows)"
            )

    def _write_guarded(self, version, dense):
        try:
            self._saver.save(version, dense=dense, extra={"model_version": version})
        except BaseException as e:  # noqa: BLE001 — re-raised in flush()
            self._write_error = e


def apply_restored_values(trainer, dense: dict, parts: dict, restored_step: int):
    """Load restored values into the trainer: the shared back half of the
    disk restore and the peer-replica hot restore
    (``replication/replicator.py``).  ``dense`` holds checkpoint-named
    arrays (loaded in place, ``checkpoint_to_state``); the step counter
    lands at ``restored_step`` exactly.  ``parts`` (row-sharded table
    rows) raise until sharded tables come (slice 9), as in
    ``utils/save_utils.py``."""
    if parts:
        raise NotImplementedError(
            f"sharded table parts {sorted(parts)} are not ported: they come "
            "with slice 9 (ROADMAP.md queue 1)"
        )
    checkpoint_to_state(trainer.state, dense)
    trainer.state.step = int(restored_step)


def restore_trainer_state(trainer, args) -> int | None:
    """Resume from ``--checkpoint_dir`` when it holds a checkpoint, else
    warm-start from ``--checkpoint_dir_for_init``.  Returns the restored
    step (0 for a warm start: the old job's step count must not trigger
    this job's step milestones), or None if nothing was restored.  The
    weights are restored and the optimizer starts fresh, as in the
    reference."""
    ckpt_dir = getattr(args, "checkpoint_dir", "") or ""
    resume = bool(ckpt_dir) and save_utils.latest_version(ckpt_dir) is not None
    restore_dir = (
        ckpt_dir
        if resume
        else (getattr(args, "checkpoint_dir_for_init", "") or "")
    )
    if not restore_dir:
        return None
    dense, extra = save_utils.restore_checkpoint(restore_dir)
    version = int(extra.get("model_version", 0) or 0)
    restored_step = version if resume else 0
    apply_restored_values(trainer, dense, {}, restored_step)
    chaos_hooks.notify_checkpoint_restore(version)
    logger.info(
        "Restored state at version %d from %s%s",
        version,
        restore_dir,
        "" if resume else " (warm start; step reset to 0)",
    )
    return restored_step
