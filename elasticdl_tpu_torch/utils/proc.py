"""Signalling a process that this code still holds, never a stranger.

A process id is free again the moment the process is reaped, and Linux
hands it to the next process or thread it makes.  ``kill()`` on a
thread's id signals that thread's whole process, so a SIGKILL sent to
the id of a process someone else already reaped (a serving replica its
frontend waited on, an orphan init collected) can end an unrelated
process on the host.  :class:`HeldProcess` names a process by its pid
and its start time, read from ``/proc`` at the hold and again before
each signal: a later holder of the pid has another start time.  (A
pidfd would close the instant between that check and the ``kill()``,
but some sandboxes answer ``pidfd_open`` with ENOSYS; one mechanism that
runs everywhere is kept instead.  For a child not yet reaped the instant
is closed anyway: its pid cannot be reused before the reap.)
"""

from __future__ import annotations

import os


def _start_and_state(pid: int) -> tuple | None:
    """``(start time in clock ticks since boot, state letter)`` of
    ``pid`` from ``/proc/<pid>/stat``, or None when there is no such
    process."""
    try:
        with open(f"/proc/{pid}/stat", encoding="ascii") as f:
            fields = f.read().rpartition(")")[2].split()
        # past the command: the state is field 3, the start time field 22
        return int(fields[19]), fields[0]
    except (OSError, IndexError, ValueError):
        return None


class HeldProcess:
    """``pid``, held from now on.  ``held`` is False when the process was
    already gone at the hold: then every signal is dropped and
    :meth:`exited` is True."""

    def __init__(self, pid: int):
        self.pid = pid
        found = _start_and_state(pid)
        self._start: int | None = found[0] if found else None

    @property
    def held(self) -> bool:
        return self._start is not None

    def _same_process(self) -> tuple | None:
        found = _start_and_state(self.pid)
        return found if found is not None and found[0] == self._start else None

    def exited(self) -> bool:
        """Whether the process has exited (a zombie has; so has one that
        is reaped)."""
        if self._start is None:
            return True
        same = self._same_process()
        return same is None or same[1] == "Z"

    def signal(self, sig: int) -> bool:
        """Send ``sig`` to the held process; False when it was not sent:
        the process has exited (a zombie's reap may free its pid at any
        moment) or was never held."""
        if self._start is None:
            return False
        same = self._same_process()
        if same is None or same[1] == "Z":
            return False
        try:
            os.kill(self.pid, sig)
        except ProcessLookupError:
            return False
        return True

    def close(self):
        self._start = None
