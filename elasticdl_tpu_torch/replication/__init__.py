"""Peer state replication: in-memory hot restore for re-formed worlds;
the counterpart of ``elasticdl_tpu/replication/``.

At every ``--replication_steps`` model versions (default: every task
boundary) each lockstep process snapshots its share of the trainer
state on the host, in the split ``parallel/elastic.py::
state_checkpoint_parts`` gives (the chief's share is the name-keyed
checkpoint layout, ``batch_stats`` included; the others' are empty
until sharded tables come), keeps the snapshot in its own RAM
(:mod:`.store`) and pushes it to its ring neighbor ``(i + 1) % n`` over
the job's socket transport (:mod:`.service`), so every share of the
state lives in two hosts' RAM.

On re-formation the master harvests the freshest COMPLETE replica set
from the survivors' stores (:mod:`.directory`), stages it in its own
RAM, and the relaunched world's process 0 restores from the stage
(:func:`.replicator.restore_from_replica`) at the exact step of the
last replication, through the disk restore's own back half, then
broadcasts it, as after a disk restore.  Disk checkpoints stay the
fallback: incomplete coverage (both holders of a share lost, a torn
push, a push over the transport's cap), a stage that fails its
checksum or one older than the newest disk checkpoint restore from
disk as before.

Design: ``docs/designs/replication.md`` (the JAX package's).
"""
