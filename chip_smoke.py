#!/usr/bin/env python3
"""Smoke test of the PyTorch port on one NVIDIA GPU.

Run from the root of a checkout, with no arguments::

    python3 chip_smoke.py

Phases, in order; any failure exits non-zero, and no result line is
printed:

1. device  — require CUDA; print ``nvidia-smi``'s name and power limit.
2. build   — compile every kernel of the serving and training paths from
   ``elasticdl_tpu_torch/ops/csrc/`` (one ``nvcc`` per source, started
   together), print the build seconds and, per kernel, read from the
   built library with ``cuobjdump``: its registers, stack frame, local
   and shared memory, and the count of Hopper instructions in its SASS
   (``HGMMA``, ``UTMALDG``); the bf16 forward, dQ and dK/dV kernels must
   each hold both and have no stack frame (so nothing spills).
3. kernels — hold the flash forward against its plain PyTorch version on
   the card, at the served and the training shapes and at the edge
   cases (GQA, ragged length, non-causal, f32, other head dims, the
   edges of the bf16 kernel's 128-row tile), with the tolerance stated
   per case; time, on the device and back to back, the kernel, the
   plain version and one PyTorch library call that computes the same
   function (a yardstick only: the port never calls it), and print the
   kernel's TFLOP/s and share of its bound.
3b. backward — the same for the dQ and dK/dV kernels, at the training
   shape and the same edge cases; each kernel is timed alone on inputs
   prepared once, beside delta's own time and the whole backward
   (``flash_backward``: inputs, delta and both kernels); the yardstick is
   the backward of ``scaled_dot_product_attention``.
4. serve   — build the GPT-2-small-shaped ``TransformerLM`` (vocab 32768,
   embed 768, 12 heads, 12 layers, bf16, sequence 2048) from a seeded
   generator, export it in the JAX package's layout, serve concurrent
   requests of 1, 2, 3 and 5 rows through ``ServingReplica`` with 4
   canonical rows, and check every delivered row against the model run
   directly, and that every attention call went through the kernel.
5. train   — train the same LM through ``SPMDTrainer`` for 6 steps of 8
   canonical rows (one step carries 2 zero-weight padding rows): every
   step launches each kernel once per layer, losses are finite and fall
   on the repeated batch, and on one row the model's gradients through
   the kernels match those with the plain versions in their place.
6. local train — train the same LM through the port's CLI
   (``elasticdl_tpu_torch.client.main(["train", ...])``, the Local
   strategy) from EDLIO shards it writes first (60 training records in 4
   shards, 8 validation records), warm-started from a checkpoint of the
   same seeded weights, with periodic checkpoints, a final evaluation and
   an export.  It checks that the dispatcher handed out 4 tasks and the
   trainer took 8 steps over the 60 records, each once, with zero-weight
   padding; that every step launched each kernel once per layer and the
   evaluation batch only the forward; that losses and the evaluation are
   finite; that the recorded batches replayed through a fresh trainer
   give the same weights exactly; and that the checkpoints (versions 4
   and 8) and the export hold the trained weights.  Then it times the
   executor's steady tokens/s in two runs of 4 epochs with no checkpoint,
   evaluation or export (the tasks after the first: 30 steps each), and
   prints them beside phase 5's bare steps.
7. mnist    — train ``mnist_functional_api`` through the train CLI on
   ``gen_mnist`` shards it writes (59 968 training records in 8 shards,
   4096 validation records, 256 rows a step: bench.py's accuracy run at
   bench.py's mnist step), with checkpoints every 100 steps, a final
   evaluation and an export.  It checks the dispatcher's 16 tasks and the
   trainer's 240 steps over the records, each once, with zero-weight
   padding; that every batch came through the vectorized pipeline and
   the native EDLIO codec (built from the checkout at first use; a
   counter, not a log line) and reached the card as uint8; finite
   losses; evaluation accuracy > 0.8; BatchNorm running statistics that
   moved and are finite; and checkpoints and an export equal to the
   trained state, statistics included.  Then it times the CLI over the
   same data with nothing but training (the tasks after the first):
   records/s, the median host time per step and the device time per
   step (CUDA events), beside bare ``SPMDTrainer`` steps on one placed
   256-row batch.
8. deepfm   — the same checks for ``deepfm_edl_embedding`` on
   bench.py's accuracy recipe (vocabulary 512, 131 072 training records,
   8192 validation records, 512 rows a step; int16 ids on the card;
   accuracy > 0.8), then the CLI timed at full width (input_dim 5383,
   4096 rows a step, 35 steps in the window) beside bare steps, and ids
   past the table or below 0 fed straight to the model on the card:
   zero lookup rows, no table gradient, and the model's output and
   gradients those of the padding id in their place.
9. stacked — ``--steps_per_dispatch k`` through the train CLI, each full
   group of k one CUDA graph replay (the first group of a shape eager,
   the second captured): mnist on phase 7's data with 8 steps a dispatch
   and ``--device_prefetch``, DeepFM on phase 8's accuracy recipe and at
   full width on phase 8's timed data with ``--device_prefetch``,
   ``--boundary_fusion`` and ``--pipeline_depth 3``, and the LM with 4
   steps a dispatch and ``--remat`` on 304 records in tasks of 60 and
   16.  Each run is checked as its single-step phase checks it (tasks,
   every record once, finite losses, accuracy > 0.8 or a finite
   evaluation, checkpoints at the crossed milestones and an export equal
   to the trained state), and further: the trainer's counters show every
   full group replayed and every trailing partial run as single steps;
   the recorded batches replayed as single eager steps through a fresh
   trainer give the same weights and statistics exactly (the zoo models'
   checked runs hold cuDNN to its deterministic algorithms, on both
   sides: its default convolution weight gradients are not); for the
   LM, the flash kernels of every replayed graph, counted as its capture
   records them, are each kernel's launches per step times k (the
   forward twice with remat), every replay's profiler trace shows each
   of them and no more, and at most a tenth fewer
   (``TRACE_DROP_MAX_SHARE``: the trace can drop a record), and the wrappers'
   counts are those of the eager steps and the evaluation.  mnist runs again, checked and timed,
   with ``bench.py``'s e2e flags (``--steps_per_dispatch auto
   --device_prefetch true``; ``auto`` gives k = 1 on the card, so every
   step is single), and is timed with 8 steps a dispatch and no staging
   as well, each timed run twice, in turn.  Then it times each model's
   CLI (records/s or tokens/s, host ms per step, and the idle share its
   window leaves beside the graph's or the single step's busy time) and
   its graph replayed alone, prints the ``auto`` probe's dispatch
   overhead and the k it resolves to, and the LM's peak memory with and
   without remat.

10. elastic — ``AllreduceStrategy`` through the train CLI: the port's
   master in this process, two worker processes that form one
   ``torch.distributed`` world (gloo on CUDA tensors: the two ranks share
   the card, and NCCL refuses two ranks on one device).  (a) mnist at
   bench.py's width and step, two epochs of 16 384 records, under the
   ``preempt_one_worker`` plan (process 1 SIGKILLs itself at step 6): the
   master fences the world, re-queues its tasks and relaunches it from
   the newest checkpoint; gated on rc 0, one re-formation with a
   latency, the dispatcher's records exactly epochs x records, no
   invariant violation, the last world's two final states bitwise
   equal, and accuracy > 0.8 from the evaluate CLI on the final
   checkpoint.  (b) the same for DeepFM's accuracy recipe (one epoch),
   then a fault-free two-rank mnist run against the Local run on the same
   data (final parameters within ``PARITY_RTOL``/``PARITY_ATOL``).  (c)
   the LM at full width and 2 of its 12 layers (``dist_lm()``) in two
   ranks of 4 rows against one rank of 8 from the same weights for 2
   Adam steps, in spawned processes beside (b): the step-1 gradient
   within phase 5's ``GRAD_REL_ERR``, the updates within
   ``DP_UPDATE_REL_ERR``, and 2 launches of each flash kernel per step
   on each rank.  Every job of phases 10-12 and 14 runs with
   ``--standby_workers 0`` (cold re-formations, as PRs 8-12 measured
   them).  It prints the
   re-formation latency, the backend and each job's records/s (two
   ranks on one card: no scaling number).

11. evaluate and predict — the same jobs through the train, evaluate
   and predict CLIs with validation or prediction data.  (a) mnist at
   bench.py's width and step, one epoch of 16 384 records with 2 048
   validation records and ``--evaluation_steps 16``, two ranks with
   ``--device_prefetch true``, under ``preempt_one_worker``: the
   master's evaluation service queues each milestone once, the lockstep
   worker's evaluation batches run each rank's rows and gather them to
   process 0, which reports them; gated on rc 0, one re-formation,
   training records exact, every round's 2 048 records once, the rounds'
   milestones, staged groups on each rank, and the final round within
   one record of the Local evaluate CLI on the final checkpoint, > 0.8.
   (b) two-worker ``evaluate`` (equal to (a)'s final round) and
   ``predict`` (every record once, within ``PREDICT_MAX_ABS_ERR`` of the
   Local predict CLI) on that checkpoint, the outputs saved by a
   ``PredictionOutputsProcessor`` of a model zoo this script writes.  (c)
   the task-stream worker (``--num_workers 1``): DeepFM's accuracy recipe
   with its worker SIGKILLed at version 6 or later (one relaunch under a
   new id, its leases re-queued, records exact, the master's accuracy >
   0.8); the LM at full width and 2 of its 12 layers (``dist_lm()``)
   warm-started from seeded weights, bit for bit the Local run's, 2
   launches of each kernel per step and of the forward per evaluation
   batch (the workers dump their counts); then the LM's two-worker
   ``predict`` (rows within phase 4's served tolerance of Local's) and
   ``evaluate`` of one record a task (a record's logits are 128 MiB,
   under the 256 MiB message cap), 2 forward launches per batch on each
   rank.  It prints the evaluation
   rounds and their seconds, the largest evaluation report, the gather's
   backend, the relaunch latency, each job's records/s and the LM's
   seconds between its task reports.

12. replication — peer state replication and hot restore: the same kind
   of two-rank mnist job (bench.py's width and step, phase 10's 16 384
   records, one epoch, tasks of 4 steps, a disk checkpoint every 16
   steps) with ``--replication true``.  (a) ``preempt_after_replication``
   armed one step after the push of version 20: gated on rc 0, one
   re-formation whose harvest staged 20, the re-formed world restoring
   20 from peer RAM (``replication_no_lost_steps``: PASS, no disk read),
   the restored state's re-encoded CRC equal to the pushed shard's and
   the stage's, every record once, the ranks bitwise equal, and accuracy
   >= 0.99 from the evaluate CLI.  (b) ``kill_during_replication`` armed
   at the push of 24: the harvest skips the torn 24 and the world
   restores the complete set of 20 (it prints where the state came
   from), every record once.  (c) the fault-free job without and with
   replication (same data, flags and seed), beside (a)'s push (snapshot,
   encode with CRC, send), blob bytes, harvest, restore and re-formation
   seconds and phase 10's disk-path re-formation.  (d) the LM at full
   width in two ranks with replication, 2 tasks: every push of the
   chief's share (its f32 weights, over the 256 MiB message cap) refused
   with ``RESOURCE_EXHAUSTED`` and counted, the job ending with rc 0, 12
   launches of each kernel per step on each rank.
13. zoo — the rest of the single-device model zoo.  (a) A seeded
   ResNet-50 step on one 64-row batch in f32 held to the port's CPU run
   of it (probabilities, loss); then ``resnet50_subclass`` through the
   train CLI at bench.py's headline width and step (32 x 32 cifar images,
   2048 rows, bf16; 2 epochs of 49 152 ``gen_cifar10`` records, 2048
   validation records), checked as phase 7 checks mnist with accuracy
   >= 0.5, the trained model's bf16 forward held to the same weights in
   f32, its steady records/s, step ms, peak memory, and bare steps with
   the profiled busy and idle shares.  (b) ``imagenet_resnet50`` at
   bench.py's shape (224 x 224 x 3, 1000 classes, 128 rows, bf16)
   through ``SPMDTrainer``: 12 steps, median step ms, samples/s, peak
   memory.  (c) mnist_subclass, both CIFAR-10 CNNs, the three census
   styles, heart and iris through the CLI, one epoch of a few thousand
   synthetic records each: tasks, steps, records, the data path, the
   wire dtype, finite losses, an accuracy floor where the generator is
   learnable.
14. master HA — the master journal and master high availability: phase
   10's two-rank mnist job (bench.py's width and step, 16 384 records,
   2 epochs, tasks of 4 steps) with ``--master_journal_dir``, its master
   killed once and relaunched from the journal 2 s later
   (``chaos/harness.py::run_master_lives`` drives the train CLI, one
   ``InvariantChecker`` spanning both lives): (a) ``master_kill_mid_epoch``
   at a tick at version >= 6: both workers re-home with their own pids
   and are adopted, no generation bump; (b) ``master_kill_during_reform``:
   process 1 preempted at step 6 and the master killed inside that
   re-formation after journaling the fence: the survivor is fenced, the
   relaunched master re-forms a new generation under new worker ids; (c)
   one task-stream worker over 20 epochs (long enough for its 5 s
   heartbeat to re-home it within the job): it re-homes presenting its
   leases; (d) a real kill: ``python -m elasticdl_tpu_torch.master.main``
   SIGKILLed at version >= 6 and started again, its orphaned workers
   re-homing into the new process, which adopts them (no generation
   bump in the journal), read from the journal (every training uid done
   once) and the chaos event log; (d) runs beside (b) and (c), and
   prints its master logs' tails when it fails or is slow.  The phase
   trains on phase 10's shards.  Each is gated (``check_master_ha``) on
   rc 0, no violation, every record once, ``master_recovery`` PASS, the
   re-homes above and accuracy >= 0.99 from the Local evaluate, and
   prints the outage, the replay's seconds and bytes, each re-home's
   latency, the steps trained again, the job's seconds, the journal's
   flush time, and 14a's steady records/s before and after the kill
   beside phase 10a's.
15. slices — hot standbys, slices, parking and the autoscaler, on phase
   10's shards and cell, each job through the train CLI and gated
   (``check_slices``) on rc 0, no violation, every record once, the
   last world's ranks bitwise equal and accuracy >= 0.99 from the Local
   evaluate.  (a) phase 10a's job with the default standby pool: both
   processes of the re-formed world are the pool's
   (``standby_activations == 2``, their pids), and it prints the
   re-formation split into the assignment, the rendezvous and the state
   restore beside 10a's cold one, and a fresh process's seconds to import
   torch and the port and to make a CUDA context; (b) four ranks in two
   slices with replication under ``slice_loss_mid_epoch`` (both processes
   of slice 1 die at step 6): one ``slice_loss`` of slice 1, a
   ``mesh_resize`` from 2 to 1 slices and from 4 to 2 processes,
   ``cross_slice_replica_coverage`` and ``replication_no_lost_steps``
   PASS, the new world restored from peer RAM; (c) two ranks in two
   slices with ``--min_slices 2`` and a journal: the same loss parks the
   job (world torn down, quiesced, ``parked`` in the journaled world) and
   a capacity grant 2 s later re-forms a new generation that finishes
   it; (d) two ranks in two slices started on one, with
   ``--autoscale_backlog_tasks 4``: one autoscale decision from 1 to 2
   slices and the re-formation that realizes it.  (b), (c) and (d) run
   side by side.
16. serving over RPC — (a) the gpt2s LM of phase 4 exported twice
   (seeds 0 and 1, versions 1 and 2), served over the port's socket
   transport by two ``ServingReplica`` of one canonical row each behind a
   ``ServingRouter``: one-row requests (a row's bf16 logits are 128 MiB,
   under the 256 MiB message cap) from 4 client threads, then
   ``swap_model`` to version 2 through the router while a client keeps
   sending, then the swap again, then one two-row request.  Gated on no
   failed request, 12 ``flash_fwd`` launches per dispatch, every row
   within phase 4's ``ROW_MAX_ERR``/``ROW_MEAN_ERR`` of the direct
   forward of the version its response reports, version 2 for every
   request sent after the swap's acknowledgement, the replayed swap
   absorbed by both replicas, one input shape per replica, and the
   two-row request answered ``RESOURCE_EXHAUSTED`` once with one request
   served.  (b) beside it, ``python -m elasticdl_tpu_torch.serving.main
   --num_replicas 2 --watch_model`` over the export of a short mnist
   training through the train CLI; ``python -m elasticdl_tpu_torch.client
   predict --serving_addr`` against it equal to the Local predict CLI
   within ``PREDICT_MAX_ABS_ERR``; a newer export written into the watched
   directory while a client keeps sending: no failed request, both
   replicas at the new version; after SIGTERM the frontend and both
   replicas gone within 10 s.  It prints the requests' latencies and
   phases, each replica's swap ms and the watcher's swap latency.
17. chaos — the chaos runner CLI, ``python -m
   elasticdl_tpu_torch.chaos.runner``, six runs side by side, each a
   subprocess with its own work directory and job (two lockstep mnist
   workers with their standby pool, 1 024 records, 2 epochs, on the
   card): ``preempt_one_worker`` with its fault-free baseline (exit 0,
   every invariant PASS, ``trajectory_parity`` within 0.15, one
   re-formation); its ``--corrupt double_report`` (exit 1,
   ``exactly_once`` FAIL); ``dup_report_storm`` (exit 0,
   ``duplicate_delivery_exactly_once`` PASS, reports deduplicated) and
   its ``--corrupt drop_dedup`` (exit 1, both that and ``exactly_once``
   FAIL); ``blackhole_master_link`` (exit 0, deadlines expired, the
   first re-formation evicting the blackholed worker); and
   ``slow_network_mid_epoch`` (exit 0, no re-formation, and no call past
   its 5 s deadline though it shares the host with the other five).
   Each writes ``chaos_result.json``; one row per plan gives its wall
   seconds, re-formation, detection and kill-to-step latencies, RPC
   totals and accuracy.

18. anatomy — the step anatomy, the metrics registry and ``/metrics``.
   (a) Alone, after phase 17: phase 6's LM (gpt2s at full width, 8 rows
   of 2048 tokens, bf16) through the Local train CLI with
   ``--step_anatomy true --telemetry_dir``, one epoch (8 steps) with
   ``--device_prefetch false`` and one with ``true``: every dispatch has
   a ``step_anatomy`` event whose phases sum to its wall within 1e-3 ms,
   ``untracked`` is under 2 % of the wall, the goodput section has
   ``e2e_vs_roofline`` in (0, 1] and p50/p99 for ``device_compute`` and
   ``host_fetch``, the prefetch window's ``h2d_transfer`` share is below
   the other's or under 0.5 %, each dispatch's ``device_compute`` holds
   the device time between CUDA events around it on its stream, and each
   flash kernel launches 12 times a step; it prints each window's phase
   shares.  (b) Beside phase 11's jobs: a two-rank mnist world on phase
   10's shards with ``--step_anatomy true --telemetry_dir --metrics_port
   0``; two scrapes of the master's ``/metrics`` over HTTP show every
   tracked phase's ``elasticdl_step_phase_ms_total``, not falling;
   ``/healthz`` answers 200 with the JAX body's keys; the goodput section
   has every generation of the step samples.

Every process the smoke starts shares one bytecode cache of this run
(``_bytecode_cache``): the card's machine writes none, and each new
process would compile torch's sources again.

Before the kernels' line it prints ``{"phase_secs": {...}}``: each
phase's wall seconds and the total.  The last two lines of standard
output are the kernels' JSON line and
``{"ok": true, "device": {...}}``.  The script imports nothing of JAX
and nothing of the JAX package.
"""

from __future__ import annotations

import contextlib
import gc
import json
import os
import re
import statistics
import subprocess
import sys
import tempfile
import threading
import time

REPO = os.path.dirname(os.path.abspath(__file__))
# the script's start: the phases' seconds sum to the total from here
STARTED_AT = time.monotonic()

# the card's published peaks (NVIDIA H100 SXM data sheet, dense)
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}
PEAK_BYTES_PER_S = 3.35e12

# the served shape: gpt2s at sequence 2048, 4 canonical rows
SERVE_ROWS = 4
SEQ = 2048
GPT2S = dict(
    vocab_size=32768, embed_dim=768, num_heads=12, num_layers=12,
    dtype="bfloat16",
)
# the depth of the LM in the distributed jobs of phases 10 and 11 (10c,
# 11's task stream, predict and evaluate): gpt2s's full width at 2 of its
# 12 layers, so that the smoke fits its time limit (12d keeps all 12: its
# chief's replica share must pass the 256 MiB cap)
DIST_LM_LAYERS = 2


def dist_lm() -> dict:
    """The distributed jobs' LM: ``GPT2S`` at ``DIST_LM_LAYERS`` layers."""
    return dict(GPT2S, num_layers=min(DIST_LM_LAYERS, GPT2S["num_layers"]))
# concurrent requests' row counts: 11 rows, the 5-row one spans groups
REQUEST_ROWS = (1, 2, 3, 5)


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def fail(msg: str) -> int:
    log(f"chip_smoke: FAILED: {msg}")
    return 1


def time_cuda(fn, reps: int, warmup: int = 2, rounds: int = 3) -> float:
    """Device milliseconds per call of ``fn``: the median over ``rounds``
    of the time between two CUDA events around ``reps`` back-to-back
    calls.  Each round holds the stream on a spin kernel until every call
    is queued, so the host's time per call is left out; a round whose
    spin ended before the last call was queued is run again with a
    longer spin."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    spin_cycles = 10_000_000  # about 5 ms
    while len(times) < rounds:
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(spin_cycles)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        queued_in_time = not start.query()
        end.synchronize()
        if queued_in_time:
            times.append(start.elapsed_time(end) / reps)
        elif spin_cycles < 2_000_000_000:
            spin_cycles *= 4
        else:
            raise RuntimeError("the calls cannot be queued ahead of the device")
    return statistics.median(times)


# ---- phase 2: what the compiler made of each kernel -------------------------

# Hopper's instructions, counted in each kernel's SASS: the warpgroup
# product and the TMA load
SASS_OPS = ("HGMMA", "UTMALDG")
# the kernels that must run on them, at every head dim: the bf16 forward,
# dQ and dK/dV
HOPPER_KERNELS = (
    "flash_fwd_sm90_kernel", "flash_bwd_dq_sm90_kernel",
    "flash_bwd_dkv_sm90_kernel",
)
# per kernel, as ``cuobjdump -res-usage`` names them: registers, stack
# frame and local memory per thread (a spill needs a stack frame) and
# static shared memory per block
RES_FIELDS = {"REG": "registers", "STACK": "stack", "LOCAL": "local", "SHARED": "shared"}


def kernel_label(mangled: str) -> str:
    """``flash_fwd_sm90_kernel<64,2>`` for a mangled kernel name."""
    m = re.search(r"(flash_\w+?_kernel)I(.*?)Ev", mangled)
    if m is None:
        return mangled
    args = [
        num or ("bf16" if bf16 else "float")
        for num, bf16, _f in re.findall(r"Li(\d+)E|(13__nv_bfloat16)|(f)", m.group(2))
    ]
    name = m.group(1)[m.group(1).rfind("flash_"):]  # past the file's prefix
    return f"{name}<{','.join(args)}>"


def parse_res_usage(text: str) -> dict:
    """Per kernel label, the resources of ``RES_FIELDS`` from the output
    of ``cuobjdump -res-usage``."""
    report, kernel = {}, None
    for line in text.splitlines():
        m = re.match(r"\s*Function (\S+):\s*$", line)
        if m:
            kernel = report.setdefault(kernel_label(m.group(1)), {})
        elif kernel is not None:
            fields = dict(re.findall(r"(\w+):(\d+)", line))
            for key, label in RES_FIELDS.items():
                if key in fields:
                    kernel[label] = int(fields[key])
    return report


def count_sass_ops(text: str) -> dict:
    """Per kernel label, the count of each of ``SASS_OPS`` in the output
    of ``cuobjdump -sass``."""
    report, kernel = {}, None
    for line in text.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            kernel = report.setdefault(kernel_label(m.group(1)), dict.fromkeys(SASS_OPS, 0))
        elif kernel is not None:
            for op in SASS_OPS:
                kernel[op] += op in line
    return report


def check_hopper_kernels(report: dict) -> None:
    """Raise unless each of ``HOPPER_KERNELS`` has at least one entry and
    every entry holds both of ``SASS_OPS`` and has no stack frame and no
    local memory (so nothing spills), each read as a number."""
    hopper = {k: v for k, v in report.items() if k.startswith(HOPPER_KERNELS)}
    for name in HOPPER_KERNELS:
        if not any(label.startswith(name) for label in hopper):
            raise AssertionError(f"no {name} among {sorted(report)}")
    for label, kernel in hopper.items():
        fields = (*RES_FIELDS.values(), *SASS_OPS)
        if (
            any(not isinstance(kernel.get(f), int) for f in fields)
            or 0 in (kernel["HGMMA"], kernel["UTMALDG"])
            or kernel["stack"] or kernel["local"]
        ):
            raise AssertionError(f"{label} misses Hopper's units or spills: {kernel}")


def kernel_build_report(_build, names):
    """Per kernel of the named libraries, read from each built library
    (so one built by an earlier run is checked alike): its resources
    (``cuobjdump -res-usage``) and its count of each of ``SASS_OPS``
    (``cuobjdump -sass``).  Raises as ``check_hopper_kernels`` does."""
    cuobjdump = os.path.join(os.path.dirname(_build._nvcc()), "cuobjdump")
    if not os.access(cuobjdump, os.X_OK):
        raise RuntimeError(f"{cuobjdump} is missing: the kernels cannot be read")

    def dump(flag, name):
        return subprocess.run(
            [cuobjdump, flag, str(_build._library_path(name))],
            capture_output=True, text=True, timeout=120, check=True,
        ).stdout

    report = {}
    for name in names:
        for label, fields in parse_res_usage(dump("-res-usage", name)).items():
            report.setdefault(label, {}).update(fields)
        for label, counts in count_sass_ops(dump("-sass", name)).items():
            report.setdefault(label, {}).update(counts)
    print(json.dumps({"kernel_build": report}), flush=True)
    check_hopper_kernels(report)
    return report


# ---- phase 3: the flash forward against its plain version ------------------

# (name, B, S, H, KVH, D, dtype, causal).  Outputs are held to atol +
# rtol * |ref| elementwise, to a mean absolute error, and the lse to an
# absolute error, per dtype in FLASH_TOLS.
EDGE_CASES = (
    ("gqa", 2, 1024, 8, 2, 64, "bfloat16", True),
    ("ragged", 2, 1000, 4, 4, 64, "bfloat16", True),
    ("noncausal", 2, 1024, 4, 4, 64, "bfloat16", False),
    ("f32", 2, 1000, 4, 2, 64, "float32", True),
    ("d128", 2, 1024, 4, 4, 128, "bfloat16", True),
    ("d32_ragged", 2, 777, 4, 4, 32, "bfloat16", False),
    ("f32_d128", 1, 300, 2, 2, 128, "float32", False),
    # the edges of the bf16 kernel's 128-row q and k/v tiles
    ("one_tile", 2, 64, 4, 4, 64, "bfloat16", True),  # under one tile
    ("past_tile", 1, 2049, 4, 4, 64, "bfloat16", True),  # one row past
    ("gqa_d128", 2, 1024, 12, 4, 128, "bfloat16", True),
    ("few_blocks", 1, 512, 2, 2, 64, "bfloat16", False),  # << 132 SMs
)
# gpt2s at the served rows and at the training batch (8 canonical rows)
SERVED_CASE = ("served", 4, 2048, 12, 12, 64, "bfloat16", True)
TRAIN_CASE = ("train", 8, 2048, 12, 12, 64, "bfloat16", True)
FLASH_CASES = (SERVED_CASE, TRAIN_CASE) + EDGE_CASES
# bf16: the kernel rounds P to bf16 before the P.V product (the plain
# version keeps f32) and both round the output to bf16, so an element is
# off by about one bf16 ulp of its own size: rtol 2e-2 covers 2**-7.
# With N(0, 1) inputs an output element is ~0.05 in size at these
# lengths, so atol is 4e-3, a tenth of that.  Beside that, the mean
# absolute error over all elements is held to three to five times the
# largest reading of an H100 run at these shapes (bf16 1.0e-4, f32
# 4.4e-8).  The scores are
# exact bf16 products summed in f32 on both sides, so the lse is held
# to 1e-3.  f32: both sides sum in f32, in different orders.
FLASH_TOLS = {
    # dtype: (out atol, out rtol, out mean abs err, lse atol)
    "bfloat16": (4e-3, 2e-2, 3e-4, 1e-3),
    "float32": (1e-4, 1e-4, 2e-7, 1e-4),
}


def flash_flops(b, s, h, d, causal):
    """Operations of one forward: two products over the live (q, k)
    pairs."""
    pairs = s * (s + 1) // 2 if causal else s * s
    return 4 * b * h * d * pairs


def flash_bound(b, s, h, kvh, d, dtype, causal):
    """(bound_ms, bound_by) of one forward: its operations at the
    type's peak, against q and out (h heads), k and v (kvh heads) and
    the f32 lse each moved once at the memory rate."""
    flops = flash_flops(b, s, h, d, causal)
    itemsize = 2 if dtype == "bfloat16" else 4
    nbytes = 2 * b * s * (h + kvh) * d * itemsize + b * h * s * 4
    t_ops = flops / PEAK_FLOPS[dtype]
    t_bytes = nbytes / PEAK_BYTES_PER_S
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes else "bytes")


def check_flash_cases():
    import torch
    import torch.nn.functional as F

    from elasticdl_tpu_torch.ops import attention as attn

    results = {}
    gen = torch.Generator(device="cuda").manual_seed(0)
    for name, b, s, h, kvh, d, dtype, causal in FLASH_CASES:
        atol, rtol, mean_tol, lse_tol = FLASH_TOLS[dtype]
        dt = getattr(torch, dtype)

        def mk(heads):
            return torch.randn(
                (b, s, heads, d), generator=gen, device="cuda"
            ).to(dt)

        q, k, v = mk(h), mk(kvh), mk(kvh)
        out, lse = attn.flash_forward(q, k, v, causal)
        torch.cuda.synchronize()
        ref_out, ref_lse = attn.flash_attention_reference(q, k, v, causal)
        diff = (out.float() - ref_out.float()).abs()
        err, mean_err = diff.max().item(), diff.mean().item()
        lse_err = (lse - ref_lse).abs().max().item()
        ok = bool(
            torch.isfinite(out.float()).all().item()
            and torch.allclose(out.float(), ref_out.float(), atol=atol, rtol=rtol)
            and mean_err <= mean_tol
            and lse_err <= lse_tol
        )
        reps = 20 if name in ("served", "train") else 5
        kernel_ms = time_cuda(lambda: attn.flash_forward(q, k, v, causal), reps)
        plain_ms = time_cuda(
            lambda: attn.flash_attention_reference(q, k, v, causal), 3, 1
        )
        qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
        library_ms = time_cuda(
            lambda: F.scaled_dot_product_attention(
                qt, kt, vt, is_causal=causal, enable_gqa=kvh != h
            ),
            reps,
        )
        bound_ms, bound_by = flash_bound(b, s, h, kvh, d, dtype, causal)
        tflops = flash_flops(b, s, h, d, causal) / (kernel_ms * 1e-3) / 1e12
        row = {
            "case": name, "shape": [b, s, h, kvh, d], "dtype": dtype,
            "causal": causal, "max_abs_err": err, "mean_abs_err": mean_err,
            "lse_max_abs_err": lse_err, "atol": atol, "rtol": rtol,
            "mean_tol": mean_tol, "lse_tol": lse_tol, "ok": ok, "kernel_ms": kernel_ms,
            "plain_ms": plain_ms, "library_ms": library_ms,
            "bound_ms": bound_ms, "bound_by": bound_by, "tflops": tflops,
            "bound_share": bound_ms / kernel_ms,
            "kernel_over_library": kernel_ms / library_ms,
        }
        print(json.dumps(row), flush=True)
        if not ok:
            raise AssertionError(f"flash_fwd disagrees with its plain version: {row}")
        results[name] = row
    return results


# ---- phase 3b: the backward kernels against their plain versions ----------

# the training shape and the forward's edge cases
BWD_CASES = (TRAIN_CASE,) + EDGE_CASES
# Gradients are held relative to their own size, since dQ, dK and dV
# differ in scale from case to case: elementwise
# |err| <= atol * max|ref| + rtol * |ref|, and the mean abs error
# <= mean_tol * rms(ref).  bf16: the kernels round P and dS to bf16
# (2**-9 relative) before their products, and both sides round the
# gradient to bf16 once at the end.  Where one large term makes an
# element (a dV row near the causal end is P ~ 1 times one dO row), the
# rounding of P alone moves it by up to 2**-9 of that term, so an
# element may be off by two bf16 roundings of the gradient's largest
# element (atol 1e-2 > 2**-7) beside the rtol of the forward's checks.
# The mean error read at most 1.3e-3 of the RMS on an H100: held to 3e-3.
# f32: both sides sum in f32, in different orders.
BWD_TOLS = {
    # dtype: (atol relative to max|ref|, rtol, mean abs err relative to rms)
    "bfloat16": (1e-2, 2e-2, 3e-3),
    "float32": (1e-5, 1e-4, 1e-5),
}


# the products each backward kernel does over the live (q, k) pairs:
# dQ makes S, dP and dQ; dK/dV makes S^T, dP^T, dV and dK
BWD_PRODUCTS = {"flash_bwd_dq": 3, "flash_bwd_dkv": 4}


def backward_flops(name, b, s, h, d, causal):
    """Operations of one launch of backward kernel ``name``."""
    pairs = s * (s + 1) // 2 if causal else s * s
    return 2 * BWD_PRODUCTS[name] * b * h * d * pairs


def backward_bound(b, s, h, kvh, d, dtype, causal):
    """(bound_ms, bound_by) of each backward kernel at one shape: its
    operations at the type's peak, against what it moves at the memory
    rate: q, dO (h heads), k, v (kvh heads), lse and delta (f32), and dq
    (h heads) or dk and dv (kvh heads)."""
    itemsize = 2 if dtype == "bfloat16" else 4
    inputs = b * s * (2 * h + 2 * kvh) * d * itemsize + 2 * b * h * s * 4
    out = {}
    for name, out_bytes in (
        ("flash_bwd_dq", b * s * h * d * itemsize),
        ("flash_bwd_dkv", 2 * b * s * kvh * d * itemsize),
    ):
        t_ops = backward_flops(name, b, s, h, d, causal) / PEAK_FLOPS[dtype]
        t_bytes = (inputs + out_bytes) / PEAK_BYTES_PER_S
        out[name] = (
            max(t_ops, t_bytes) * 1e3,
            "operations" if t_ops >= t_bytes else "bytes",
        )
    return out


def grad_errors(got, ref):
    """(max abs error, mean abs error, max abs and rms of the reference)."""
    diff = (got.float() - ref.float()).abs()
    ref = ref.float()
    return (
        diff.max().item(), diff.mean().item(), ref.abs().max().item(),
        ref.pow(2).mean().sqrt().item(),
    )


def _as_tuple(x):
    return x if isinstance(x, tuple) else (x,)


def check_backward_cases():
    import torch
    import torch.nn.functional as F

    from elasticdl_tpu_torch.ops import attention as attn

    kernels = {
        # name: (kernel wrapper, its launch alone, plain version, the
        # gradients it returns)
        "flash_bwd_dq": (
            attn.flash_bwd_dq, attn._launch_bwd_dq, attn.flash_dq_reference,
            ("dq",),
        ),
        "flash_bwd_dkv": (
            attn.flash_bwd_dkv, attn._launch_bwd_dkv, attn.flash_dkv_reference,
            ("dk", "dv"),
        ),
    }
    results = {}
    gen = torch.Generator(device="cuda").manual_seed(1)
    for name, b, s, h, kvh, d, dtype, causal in BWD_CASES:
        atol, rtol, mean_tol = BWD_TOLS[dtype]
        dt = getattr(torch, dtype)

        def mk(heads):
            return torch.randn(
                (b, s, heads, d), generator=gen, device="cuda"
            ).to(dt)

        q, k, v, g = mk(h), mk(kvh), mk(kvh), mk(h)
        out, lse = attn.flash_forward(q, k, v, causal)
        args = (q, k, v, out, lse, g, causal)
        grads = {n: _as_tuple(fns[0](*args)) for n, fns in kernels.items()}
        torch.cuda.synchronize()
        # the library's backward of the same attention (dq, dk, dv and
        # delta together): a yardstick only, the port never calls it
        qt, kt, vt = (
            x.transpose(1, 2).detach().requires_grad_() for x in (q, k, v)
        )
        lib_out = F.scaled_dot_product_attention(
            qt, kt, vt, is_causal=causal, enable_gqa=kvh != h
        )
        gt = g.transpose(1, 2)
        reps = 10 if name == "train" else 3
        library_ms = time_cuda(
            lambda: torch.autograd.grad(
                lib_out, (qt, kt, vt), gt, retain_graph=True
            ),
            reps,
        )
        bounds = backward_bound(b, s, h, kvh, d, dtype, causal)
        # the kernels alone, on inputs prepared once; delta (a torch
        # reduction) and the whole backward (inputs, delta and both
        # kernels) beside them
        inputs = attn._backward_inputs(q, k, v, out, lse, g)
        sm_scale = 1.0 / d ** 0.5
        delta_ms = time_cuda(lambda: attn._delta(inputs[3], out), reps)
        backward_ms = time_cuda(lambda: attn.flash_backward(*args), reps)
        rows = {}
        for kname, (kernel, launch, plain, gnames) in kernels.items():
            errs = {}
            ok = True
            for gname, got, ref in zip(gnames, grads[kname], _as_tuple(plain(*args))):
                err, mean_err, ref_max, rms = grad_errors(got, ref)
                ok = ok and bool(
                    torch.isfinite(got.float()).all().item()
                    and got.shape == ref.shape and got.dtype == ref.dtype
                    and torch.allclose(
                        got.float(), ref.float(), atol=atol * ref_max, rtol=rtol
                    )
                    and mean_err <= mean_tol * rms
                )
                errs[gname] = {
                    "max_abs_err": err, "mean_abs_err": mean_err,
                    "ref_max_abs": ref_max, "ref_rms": rms,
                }
            kernel_ms = time_cuda(
                lambda: launch(*inputs, causal, sm_scale), reps
            )
            plain_ms = time_cuda(lambda: plain(*args), 2, 1)
            bound_ms, bound_by = bounds[kname]
            flops = backward_flops(kname, b, s, h, d, causal)
            row = {
                "kernel": kname, "case": name, "shape": [b, s, h, kvh, d],
                "dtype": dtype, "causal": causal, "errors": errs,
                "max_abs_err": max(e["max_abs_err"] for e in errs.values()),
                "atol_rel_max": atol, "rtol": rtol, "mean_tol_rel_rms": mean_tol,
                "ok": ok, "kernel_ms": kernel_ms, "plain_ms": plain_ms,
                "library_ms": library_ms, "bound_ms": bound_ms,
                "bound_by": bound_by,
                "tflops": flops / (kernel_ms * 1e-3) / 1e12,
                "bound_share": bound_ms / kernel_ms,
                "kernel_over_library": kernel_ms / library_ms,
                "delta_ms": delta_ms, "backward_ms": backward_ms,
                "backward_over_library": backward_ms / library_ms,
            }
            print(json.dumps(row), flush=True)
            rows[kname] = row
        del lib_out, qt, kt, vt, inputs
        results[name] = rows
    bad = [r for rows in results.values() for r in rows.values() if not r["ok"]]
    if bad:  # after every case has printed its row
        raise AssertionError(f"backward kernels disagree with plain: {bad}")
    return results


# ---- phase 4: serve the gpt2s-shaped LM through the replica ----------------

# served rows against the same rows run through the model directly: the
# same weights and kernels, but other batch shapes for the dense
# products (1-5 rows against 4), so bf16 roundings may land elsewhere
# and compound over 12 blocks.  Logits are ~N(0, 1) here; a bf16 ulp at
# 4 is 2**-6.  Held to 8 ulps there at worst and 1e-2 on average.
ROW_MAX_ERR = 0.125
ROW_MEAN_ERR = 1e-2
# the whole model with its attention through the kernel against the
# same model with the plain version in its place: the kernel rounds P
# to bf16 before P.V (the plain version keeps f32), and the difference
# compounds over 12 blocks
PLAIN_MAX_ERR = 0.25
PLAIN_MEAN_ERR = 2e-2


def build_export(model_dir: str, seed: int = 0, version: int = 1):
    """The gpt2s-shaped LM with weights from ``seed``, written in the JAX
    package's export layout as ``version``."""
    import torch

    from elasticdl_tpu_torch.models import long_seq_transformer as lm
    from elasticdl_tpu_torch.utils.export_utils import export_model

    model = lm.custom_model(**GPT2S)
    lm.init_weights(model, torch.Generator().manual_seed(seed))
    export_model(
        model_dir, model,
        "long_seq_transformer.long_seq_transformer.custom_model",
        model_params=GPT2S, model_version=version,
    )


def serve_round(replica, requests, tag):
    """Submit every request from its own thread at once; return the
    responses in request order, their outputs unpacked."""
    from elasticdl_tpu_torch.rpc import messages as msg

    responses = [None] * len(requests)

    def call(i):
        response = replica.predict(msg.PredictRequest(
            request_id=f"{tag}{i}", features=msg.pack_array_tree(requests[i]),
            rows=len(requests[i]["tokens"]),
        ))
        if not response.error:
            response.outputs = msg.unpack_array_tree(response.outputs)
        responses[i] = response

    threads = [threading.Thread(target=call, args=(i,)) for i in range(len(requests))]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    return responses


def max_mean_err(a, b):
    import numpy as np

    diff = np.abs(np.asarray(a, np.float32) - np.asarray(b, np.float32))
    return float(diff.max()), float(diff.mean())


def serve_lm(model_dir: str, device: str = "cuda"):
    """Phase 4.  Returns the flash kernel's launches on the served path
    (``device="cpu"`` rehearses the phase at a small size)."""
    import numpy as np
    import torch
    from unittest import mock

    from elasticdl_tpu_torch.ops import attention as attn
    from elasticdl_tpu_torch.serving.replica import ServingReplica

    rng = np.random.RandomState(0)
    requests = [
        {"tokens": rng.randint(0, GPT2S["vocab_size"], (n, SEQ)).astype(np.int32)}
        for n in REQUEST_ROWS
    ]
    replica = ServingReplica(model_dir, canonical_rows=SERVE_ROWS, device=device)
    replica.start()
    try:
        attn.reset_launch_counts()
        t0 = time.monotonic()
        cold = serve_round(replica, requests, "cold")
        cold_secs = time.monotonic() - t0
        warm = serve_round(replica, requests, "warm")
        launches = attn.launch_counts["flash_fwd"]
        dispatches = replica.engine.dispatches
    finally:
        replica.close()

    for resp, req in zip(cold + warm, requests + requests):
        n = len(req["tokens"])
        if resp.error:
            raise AssertionError(f"request failed: {resp.error}")
        if resp.outputs.shape != (n, SEQ, GPT2S["vocab_size"]):
            raise AssertionError(f"bad output shape {resp.outputs.shape}")
        if resp.outputs.dtype.name != "bfloat16":  # the model's, unwidened
            raise AssertionError(f"served {resp.outputs.dtype}, not bfloat16")
        if not np.isfinite(resp.outputs).all():
            raise AssertionError("non-finite logits served")
    layers = GPT2S["num_layers"]
    rows = 2 * sum(REQUEST_ROWS)
    if dispatches < 2 * -(-sum(REQUEST_ROWS) // SERVE_ROWS):
        raise AssertionError(f"{rows} rows in only {dispatches} dispatches")
    # a CPU rehearsal takes the plain path: no launches
    if launches != (layers * dispatches if device == "cuda" else 0):
        raise AssertionError(
            f"flash_fwd launched {launches} times for {dispatches} dispatches "
            f"of a {layers}-layer model: some attention bypassed the kernel"
        )
    for tag, responses in (("cold", cold), ("warm", warm)):
        lat = [r.phases["total_ms"] for r in responses]
        print(json.dumps({
            "serve_round": tag,
            "p50_ms": statistics.median(lat),
            "requests": [
                {"rows": r.rows, **{k: round(v, 3) for k, v in r.phases.items()}}
                for r in responses
            ],
        }), flush=True)

    # every served row against the same rows run through the model
    # directly (after the counts were read: these launches are checks)
    model = replica.engine.model
    errs = []
    with torch.inference_mode():
        for req, resp in zip(requests, warm):
            direct = model({"tokens": torch.from_numpy(req["tokens"]).to(device)})
            errs.append(max_mean_err(resp.outputs, direct.float().cpu().numpy()))
        # the model with the plain attention in the kernel's place, one row
        one = {"tokens": torch.from_numpy(requests[0]["tokens"]).to(device)}
        with mock.patch.object(
            attn, "attention",
            lambda q, k, v, causal=False, sm_scale=None:
                attn.flash_attention_reference(q, k, v, causal, sm_scale)[0],
        ):
            plain = model(one).float().cpu().numpy()
    row_max = max(e[0] for e in errs)
    row_mean = max(e[1] for e in errs)
    plain_max, plain_mean = max_mean_err(warm[0].outputs, plain)
    check = {
        "served_vs_direct_max_abs_err": row_max,
        "served_vs_direct_mean_abs_err": row_mean,
        "kernel_vs_plain_model_max_abs_err": plain_max,
        "kernel_vs_plain_model_mean_abs_err": plain_mean,
        "flash_fwd_launches": launches, "dispatches": dispatches,
        "cold_round_secs": cold_secs,
    }
    print(json.dumps(check), flush=True)
    if row_max > ROW_MAX_ERR or row_mean > ROW_MEAN_ERR:
        raise AssertionError(f"served rows disagree with the model: {check}")
    if plain_max > PLAIN_MAX_ERR or plain_mean > PLAIN_MEAN_ERR:
        raise AssertionError(f"kernel path disagrees with the plain path: {check}")
    return launches


# ---- phase 5: train the gpt2s-shaped LM ------------------------------------

# bench.py's training batch for transformer_gpt2s_seq2048 on one chip
TRAIN_ROWS = 8
WARMUP_STEPS = 2
TIMED_STEPS = 4
PADDED_STEP = 3  # this step carries PADDED_REAL real rows + zero-weight pad
PADDED_REAL = 6
# the whole model's parameter gradients on one row, through the kernels
# against the plain versions in their place: the kernels round P and dS
# to bf16 where the plain versions keep f32, and the bf16 model rounds
# its activations after every layer, so the two differ by a few bf16
# roundings compounded over 12 blocks.  Held in relative norm, over all
# parameters together and for the worst single tensor.  The key biases
# sit out of the per-tensor check: their gradient is zero in exact
# arithmetic (a key bias shifts a row's scores alike, which softmax
# ignores), so each path's is rounding noise and their ratio means
# nothing; they stay in the global norm.  An H100 run read 1.7e-3 over
# all parameters: the global limit is about six times that.
GRAD_REL_ERR = 1e-2
GRAD_TENSOR_REL_ERR = 1.5e-1
ZERO_GRAD_PARAMS = "attn.key.bias"


def _one_row_grads(model, feats, labels):
    """Parameter gradients of the mean loss on one row (dropout is 0)."""
    from elasticdl_tpu_torch.models import long_seq_transformer as lm

    model.zero_grad(set_to_none=True)
    loss = lm.loss(labels, model(feats, training=True))
    loss.backward()
    grads = {n: p.grad.float().clone() for n, p in model.named_parameters()}
    model.zero_grad(set_to_none=True)
    return grads


def train_lm(device: str = "cuda"):
    """Phase 5.  Returns each kernel's launches over the training run
    (``device="cpu"`` rehearses the phase at a small size)."""
    import numpy as np
    import torch
    from unittest import mock

    from elasticdl_tpu_torch.models import long_seq_transformer as lm
    from elasticdl_tpu_torch.ops import attention as attn
    from elasticdl_tpu_torch.parallel.distributed import SPMDTrainer
    from elasticdl_tpu_torch.trainer.step import resolve_optimizer

    model = lm.custom_model(**GPT2S)
    lm.init_weights(model, torch.Generator().manual_seed(0))
    trainer = SPMDTrainer(
        model, lm.loss, resolve_optimizer(lm.optimizer), device=device
    )
    tokens = np.random.RandomState(1).randint(
        0, GPT2S["vocab_size"], (TRAIN_ROWS, SEQ + 1)
    ).astype(np.int32)
    full = (
        trainer.place_batch({"tokens": tokens[:, :-1]}),
        trainer.place_batch(tokens[:, 1:]),
        trainer.place_mask(TRAIN_ROWS, TRAIN_ROWS),
    )
    padded = (
        trainer.place_canonical({"tokens": tokens[:PADDED_REAL, :-1]}, TRAIN_ROWS),
        trainer.place_canonical(tokens[:PADDED_REAL, 1:], TRAIN_ROWS),
        trainer.place_mask(PADDED_REAL, TRAIN_ROWS),
    )
    layers = GPT2S["num_layers"]
    per_step = layers if device == "cuda" else 0  # the CPU takes the plain path
    totals = dict.fromkeys(attn.launch_counts, 0)
    losses, step_ms = [], []
    if device == "cuda":
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    for i in range(WARMUP_STEPS + TIMED_STEPS):
        batch = padded if i == PADDED_STEP else full
        attn.reset_launch_counts()
        t0 = time.monotonic()
        loss = float(trainer.train_step(*batch)["loss"])  # waits for the step
        step_ms.append((time.monotonic() - t0) * 1e3)
        counts = dict(attn.launch_counts)
        losses.append(loss)
        if any(n != per_step for n in counts.values()):
            raise AssertionError(
                f"step {i} launched {counts}, not {per_step} of each kernel"
            )
        for name, n in counts.items():
            totals[name] += n
    peak_bytes = torch.cuda.max_memory_allocated() if device == "cuda" else None
    if not all(np.isfinite(losses)):
        raise AssertionError(f"non-finite training loss: {losses}")
    if not losses[-1] < losses[0]:  # both on the full batch
        raise AssertionError(f"loss did not fall on a repeated batch: {losses}")

    # one row through the kernels, then with the plain versions in their
    # place (after the counts were read: these launches are checks)
    feats, labels = {"tokens": full[0]["tokens"][:1]}, full[1][:1]
    got = _one_row_grads(trainer.state.model, feats, labels)
    with mock.patch.object(
        attn, "flash_forward", attn.flash_attention_reference
    ), mock.patch.object(attn, "flash_backward", attn.flash_backward_reference):
        want = _one_row_grads(trainer.state.model, feats, labels)
    diff_sq = sum((got[n] - want[n]).pow(2).sum().item() for n in want)
    norm_sq = sum(want[n].pow(2).sum().item() for n in want)
    rel = (diff_sq / norm_sq) ** 0.5
    per_tensor = {
        n: ((got[n] - want[n]).norm() / want[n].norm().clamp_min(1e-30)).item()
        for n in want
        if not n.endswith(ZERO_GRAD_PARAMS)
    }
    worst = max(per_tensor, key=per_tensor.get)
    key_bias_sq = sum(
        want[n].pow(2).sum().item() for n in want if n.endswith(ZERO_GRAD_PARAMS)
    )
    timed = step_ms[WARMUP_STEPS:]
    median_ms = statistics.median(timed)
    result = {
        "train_losses": losses, "step_ms": step_ms,
        "median_step_ms": median_ms,
        "tokens_per_s": TRAIN_ROWS * SEQ / (median_ms / 1e3),
        "max_memory_allocated_bytes": peak_bytes,
        "launches_per_step": per_step, "launches": totals,
        "grad_rel_err": rel, "grad_worst_tensor": worst,
        "grad_worst_tensor_rel_err": per_tensor[worst],
        "key_bias_grad_share_of_norm": (key_bias_sq / norm_sq) ** 0.5,
    }
    print(json.dumps(result), flush=True)
    if rel > GRAD_REL_ERR or per_tensor[worst] > GRAD_TENSOR_REL_ERR:
        raise AssertionError(f"kernel gradients disagree with plain: {result}")
    return totals, result["tokens_per_s"]


# ---- phase 6: train the gpt2s-shaped LM through the train CLI --------------

# 60 training records in 4 shards of 15, so with 16 records per task each
# shard is one task: one full batch of 8 and one of 7 real rows (one
# zero-weight padding row), 8 steps in all; 8 validation records are one
# evaluation batch
LOCAL_RECORDS, LOCAL_SHARDS, LOCAL_EVAL_RECORDS = 60, 4, 8
LOCAL_RECORDS_PER_TASK, LOCAL_CHECKPOINT_STEPS = 16, 4
LOCAL_TASKS = LOCAL_SHARDS
LOCAL_STEPS = LOCAL_SHARDS * 2
LM_DEF = "long_seq_transformer.long_seq_transformer.custom_model"
# the executor's steady pace is timed in runs of their own: the same data
# for 4 epochs (16 tasks, 32 steps) with no checkpoint, evaluation or
# export, so that no milestone falls in the window of the tasks after the
# first (30 steps); two runs, for their spread
LOCAL_TIMED_EPOCHS = 4
LOCAL_TIMED_RUNS = 2


class _Recorder:
    """What the executor's path did, gathered by wrapping its pieces:
    the training tasks each dispatcher handed out and when each was
    reported (after a device sync), every batch the trainer received
    (device copies, read after the run) with each step's kernel
    launches, the evaluation batches' launches, and the seconds spent in
    evaluation, checkpoints and the export."""

    def __init__(self, device: str):
        self.device = device
        self.tasks, self.report_times = [], []
        self.batches, self.losses, self.step_launches = [], [], []
        self.step_starts = []  # host clock at each train_step call
        self.eval_launches, self.eval_step_secs = [], 0.0
        # (start, end) of each call of the timed pieces
        self.spans = {k: [] for k in (
            "evaluate", "eval_metrics", "checkpoint", "checkpoint_flush", "export",
        )}
        self.executor = self.result = self.train_dispatcher = None

    def sync(self):
        import torch

        if self.device == "cuda":
            torch.cuda.synchronize()

    def timed(self, key, fn):
        def wrapper(*args, **kwargs):
            t0 = time.monotonic()
            try:
                return fn(*args, **kwargs)
            finally:
                self.spans[key].append((t0, time.monotonic()))
        return wrapper

    def secs(self, key) -> float:
        """Seconds spent in ``key``'s calls."""
        return sum(t1 - t0 for t0, t1 in self.spans[key])

    def patches(self):
        """The ``mock.patch`` context managers that install the wrappers."""
        from unittest import mock

        from elasticdl_tpu_torch.ops import attention as attn
        from elasticdl_tpu_torch.parallel.distributed import SPMDTrainer
        from elasticdl_tpu_torch.trainer import local_executor as le
        from elasticdl_tpu_torch.trainer.checkpointing import PeriodicCheckpointer
        from elasticdl_tpu_torch.utils.constants import TaskType

        rec = self
        train_step, eval_step = SPMDTrainer.train_step, SPMDTrainer.eval_step

        class Dispatcher(le.TaskDispatcher):
            def get(self, worker_id):
                tid, task = super().get(worker_id)
                if task is not None and task.type == TaskType.TRAINING:
                    rec.tasks.append((tid, task))
                    rec.train_dispatcher = self
                return tid, task

            def report(self, task_id, success, exec_counters=None):
                if self is rec.train_dispatcher:
                    rec.sync()
                    rec.report_times.append(time.monotonic())
                return super().report(task_id, success, exec_counters)

        def recorded_train_step(trainer, features, labels, weights=None):
            rec.step_starts.append(time.monotonic())
            before = dict(attn.launch_counts)
            metrics = train_step(trainer, features, labels, weights)
            rec.step_launches.append(
                {k: attn.launch_counts[k] - before[k] for k in before}
            )
            # device copies, read after the run: no sync inside the loop
            rec.batches.append(
                (features["tokens"].clone(), labels.clone(), weights.clone())
            )
            rec.losses.append(metrics["loss"])
            return metrics

        def recorded_eval_step(trainer, *args):
            before = dict(attn.launch_counts)
            rec.sync()
            t0 = time.monotonic()
            out = eval_step(trainer, *args)
            rec.sync()
            rec.eval_step_secs += time.monotonic() - t0
            rec.eval_launches.append(
                {k: attn.launch_counts[k] - before[k] for k in before}
            )
            return out

        run = le.LocalExecutor.run

        def recorded_run(executor):
            rec.executor = executor
            rec.result = run(executor)
            return rec.result

        return [
            mock.patch.object(le, "TaskDispatcher", Dispatcher),
            mock.patch.object(SPMDTrainer, "train_step", recorded_train_step),
            mock.patch.object(SPMDTrainer, "eval_step", recorded_eval_step),
            mock.patch.object(le.LocalExecutor, "run", recorded_run),
            mock.patch.object(
                le.LocalExecutor, "evaluate",
                self.timed("evaluate", le.LocalExecutor.evaluate),
            ),
            mock.patch.object(
                le.metrics_lib, "update_metric_tree",
                self.timed("eval_metrics", le.metrics_lib.update_metric_tree),
            ),
            mock.patch.object(
                PeriodicCheckpointer, "save_now",
                self.timed("checkpoint", PeriodicCheckpointer.save_now),
            ),
            mock.patch.object(
                PeriodicCheckpointer, "flush",
                self.timed("checkpoint_flush", PeriodicCheckpointer.flush),
            ),
            mock.patch.object(le, "export_model", self.timed("export", le.export_model)),
        ]


def _record_rows(directory: str):
    """Every record of ``directory``'s shards, as int64 token bytes, read
    back with the port's reader."""
    from elasticdl_tpu_torch.data.reader import decode_example
    from elasticdl_tpu_torch.data.recordio_reader import RecordIODataReader
    from elasticdl_tpu_torch.master.task_dispatcher import Task
    from elasticdl_tpu_torch.utils.constants import TaskType

    reader = RecordIODataReader(data_dir=directory)
    rows = []
    for shard, (start, n) in reader.create_shards().items():
        task = Task(shard, start, start + n, TaskType.TRAINING)
        for record in reader.read_records(task):
            rows.append(decode_example(record)["tokens"].astype("int64").tobytes())
    return rows


def _local_data(
    work_dir: str, records: int = LOCAL_RECORDS, shards: int = LOCAL_SHARDS, lm_cfg=None,
) -> dict:
    """The phase's EDLIO shards and its warm-start checkpoint of the
    seeded weights (of ``lm_cfg``, gpt2s by default)."""
    import torch

    from elasticdl_tpu_torch.data.recordio_gen.synthetic import gen_sequence
    from elasticdl_tpu_torch.models import long_seq_transformer as lm
    from elasticdl_tpu_torch.utils import save_utils
    from elasticdl_tpu_torch.utils.flax_weights import flax_flat_from_torch

    vocab = GPT2S["vocab_size"]
    t0 = time.monotonic()
    data = {
        "train": gen_sequence(
            os.path.join(work_dir, "train"), num_records=records,
            num_shards=shards, seed=0, seq_len=SEQ, vocab=vocab,
        ),
        "eval": gen_sequence(
            os.path.join(work_dir, "eval"), num_records=LOCAL_EVAL_RECORDS,
            num_shards=1, seed=1, seq_len=SEQ, vocab=vocab,
        ),
        "init": os.path.join(work_dir, "init"),
    }
    data["secs"] = time.monotonic() - t0
    model = lm.custom_model(**(lm_cfg or GPT2S))
    lm.init_weights(model, torch.Generator().manual_seed(0))
    init = {f"params/{k}": v for k, v in flax_flat_from_torch(model).items()}
    save_utils.CheckpointSaver(data["init"]).save(0, init, extra={"model_version": 0})
    return data


def _local_argv(
    data: dict, device: str, *extra, records_per_task: int = LOCAL_RECORDS_PER_TASK,
    lm_cfg=None,
) -> list:
    """``train`` on the phase's shards, warm-started from its checkpoint."""
    return [
        "train", "--model_def", LM_DEF,
        "--model_params", ";".join(f"{k}={v}" for k, v in (lm_cfg or GPT2S).items()),
        "--training_data", data["train"],
        "--records_per_task", str(records_per_task),
        "--minibatch_size", str(TRAIN_ROWS), "--shuffle_seed", "0",
        "--checkpoint_dir_for_init", data["init"], "--device", device, *extra,
    ]


def _checked_local_run(work_dir: str, data: dict, device: str):
    """One epoch through the train CLI with periodic checkpoints, a
    final evaluation and an export, and checks (a) to (f) of the phase
    on what it did.  Returns each kernel's launches in the run and the
    run's row of the phase's JSON line."""
    import numpy as np
    import torch

    from elasticdl_tpu_torch import client
    from elasticdl_tpu_torch.models import long_seq_transformer as lm
    from elasticdl_tpu_torch.ops import attention as attn
    from elasticdl_tpu_torch.parallel.distributed import SPMDTrainer
    from elasticdl_tpu_torch.trainer.state import checkpoint_to_state
    from elasticdl_tpu_torch.utils import save_utils
    from elasticdl_tpu_torch.utils.export_utils import load_exported_model
    from elasticdl_tpu_torch.utils.flax_weights import flax_flat_from_torch

    train_dir, init_dir = data["train"], data["init"]
    ckpt_dir, out_dir = os.path.join(work_dir, "ckpt"), os.path.join(work_dir, "out")
    argv = _local_argv(
        data, device, "--num_epochs", "1", "--validation_data", data["eval"],
        "--checkpoint_dir", ckpt_dir,
        "--checkpoint_steps", str(LOCAL_CHECKPOINT_STEPS), "--output", out_dir,
    )
    rec = _Recorder(device)
    with contextlib.ExitStack() as stack:
        for patch in rec.patches():
            stack.enter_context(patch)
        attn.reset_launch_counts()
        run_start = time.monotonic()
        rc = client.main(argv)
        run_secs = time.monotonic() - run_start
        launches = dict(attn.launch_counts)
    if rc != 0:
        raise AssertionError(f"train exited with {rc}")
    executor, result = rec.executor, rec.result
    trainer = executor.trainer
    layers = GPT2S["num_layers"]
    per_call = layers if device == "cuda" else 0  # the CPU takes the plain path

    # (a) tasks, records and steps
    tasks = [(t.shard_name, t.start, t.end) for _tid, t in rec.tasks]
    batches = [tuple(x.cpu() for x in b) for b in rec.batches]
    weights = [b[2] for b in batches]
    trained = int(sum(float(w.sum()) for w in weights))
    if (
        len(tasks) != LOCAL_TASKS
        or sum(end - start for _s, start, end in tasks) != LOCAL_RECORDS
        or trained != LOCAL_RECORDS
        or len(batches) != LOCAL_STEPS or trainer.step != LOCAL_STEPS
    ):
        raise AssertionError(
            f"tasks {tasks}, {trained} records in {len(batches)} batches, "
            f"trainer at step {trainer.step}"
        )
    # (b) the real rows are the training records, each once an epoch;
    # padding rows weigh 0
    got_rows = []
    for tokens, labels, w in batches:
        n = int(w.sum())
        if not (torch.all(w[:n] == 1) and torch.all(w[n:] == 0)):
            raise AssertionError(f"a batch's row weights are not 1s then 0s: {w}")
        for i in range(n):
            row = torch.cat([tokens[i], labels[i, -1:]]).to(torch.int64)
            if not torch.equal(row[1:-1], labels[i, :-1].to(torch.int64)):
                raise AssertionError("features and labels are not one shifted record")
            got_rows.append(row.numpy().tobytes())
    if sorted(got_rows) != sorted(_record_rows(train_dir)):
        raise AssertionError("the trained rows are not the training records, once each")
    # (c) kernel launches per training step and per evaluation batch
    want_step = dict.fromkeys(attn.launch_counts, per_call)
    want_eval = dict(dict.fromkeys(attn.launch_counts, 0), flash_fwd=per_call)
    if any(s != want_step for s in rec.step_launches) or not rec.eval_launches or any(
        e != want_eval for e in rec.eval_launches
    ):
        raise AssertionError(
            f"launches per step {rec.step_launches}, per evaluation batch "
            f"{rec.eval_launches}"
        )
    # (d) finite losses and evaluation
    losses = [float(x) for x in rec.losses]
    if not (
        all(np.isfinite(losses)) and set(result) == {"accuracy", "loss"}
        and all(np.isfinite(list(result.values())))
    ):
        raise AssertionError(f"losses {losses}, evaluation {result}")
    # (e) the recorded batches replayed from the same checkpoint through a
    # fresh trainer give the executor's weights exactly
    replay_model = lm.custom_model(**GPT2S)
    replay = SPMDTrainer(
        replay_model, lm.loss, lm.optimizer(),
        compute_dtype=torch.bfloat16, device=device,
    )
    checkpoint_to_state(replay.state, save_utils.restore_checkpoint(init_dir)[0])
    for tokens, labels, w in rec.batches:
        replay.train_step({"tokens": tokens}, labels, w)
    trained_state = trainer.state.model.state_dict()
    replay_diff = max(
        (replay.state.model.state_dict()[k].float() - v.float()).abs().max().item()
        for k, v in trained_state.items()
    )
    del replay, replay_model
    # (f) the checkpoints and the export
    versions = sorted(
        int(n.split("-")[1]) for n in os.listdir(ckpt_dir) if n.startswith("version-")
    )
    exported, _flat, _state = load_exported_model(out_dir, device=device)
    export_diff = max(
        (exported.state_dict()[k] - v).abs().max().item()
        for k, v in trained_state.items()
    )
    last = save_utils.restore_checkpoint(ckpt_dir)[0]
    ckpt_flat = {f"params/{k}": v for k, v in flax_flat_from_torch(trainer.state.model).items()}
    ckpt_exact = set(last) == set(ckpt_flat) and all(
        np.array_equal(last[k], ckpt_flat[k]) for k in ckpt_flat
    )
    del exported

    # the step gaps show what the milestones cost: a checkpoint's snapshot
    # is taken on the training thread, between two steps
    row = {
        "tasks": len(tasks), "records": trained, "steps": len(batches),
        "launches": launches, "launches_per_step": per_call,
        "losses": losses, "evaluation": result,
        "step_gaps_ms": [
            (b - a) * 1e3 for a, b in zip(rec.step_starts, rec.step_starts[1:])
        ],
        # the first task also builds the trainer and restores the
        # checkpoint
        "first_task_secs": rec.report_times[0] - run_start,
        "run_secs": run_secs, "data_secs": data["secs"],
        "evaluate_secs": rec.secs("evaluate"),
        "eval_step_secs": rec.eval_step_secs,
        "eval_metrics_secs": rec.secs("eval_metrics"),
        "checkpoint_secs": rec.secs("checkpoint"),
        "checkpoint_flush_secs": rec.secs("checkpoint_flush"),
        "export_secs": rec.secs("export"),
        "checkpoint_versions": versions, "replay_max_abs_diff": replay_diff,
        "export_max_abs_diff": export_diff, "last_checkpoint_exact": ckpt_exact,
    }
    if replay_diff != 0.0:
        raise AssertionError(f"the replayed batches gave other weights: {row}")
    if versions != [LOCAL_CHECKPOINT_STEPS, LOCAL_STEPS] or export_diff != 0.0 or not ckpt_exact:
        raise AssertionError(f"checkpoints or export disagree with the state: {row}")
    if device == "cuda" and (
        torch.backends.cuda.matmul.allow_tf32 or torch.backends.cudnn.allow_tf32
    ):
        raise AssertionError("the train CLI turned TF32 on")
    return launches, row


def _timed_local_run(data: dict, device: str) -> dict:
    """The train CLI over ``LOCAL_TIMED_EPOCHS`` epochs with nothing but
    training in it.  The window is the tasks after the first (which also
    builds the trainer and restores the checkpoint): from the device sync
    that closes the first task's report to the one that closes the
    last.  The only instruments are that sync (the step reads its tokens'
    range on the host already, so the device is idle at a report anyway)
    and a clock read at each ``train_step`` call."""
    from unittest import mock

    import torch

    from elasticdl_tpu_torch import client
    from elasticdl_tpu_torch.ops import attention as attn
    from elasticdl_tpu_torch.parallel.distributed import SPMDTrainer
    from elasticdl_tpu_torch.trainer import local_executor as le

    tasks, reports, step_starts = [], [], []
    train_step = SPMDTrainer.train_step

    class Dispatcher(le.TaskDispatcher):
        def get(self, worker_id):
            tid, task = super().get(worker_id)
            if task is not None:
                tasks.append(task)
            return tid, task

        def report(self, task_id, success, exec_counters=None):
            if device == "cuda":
                torch.cuda.synchronize()
            reports.append(time.monotonic())
            return super().report(task_id, success, exec_counters)

    def timed_train_step(trainer, *args):
        step_starts.append(time.monotonic())
        return train_step(trainer, *args)

    argv = _local_argv(data, device, "--num_epochs", str(LOCAL_TIMED_EPOCHS))
    with contextlib.ExitStack() as stack:
        stack.enter_context(mock.patch.object(le, "TaskDispatcher", Dispatcher))
        stack.enter_context(
            mock.patch.object(SPMDTrainer, "train_step", timed_train_step)
        )
        attn.reset_launch_counts()
        run_start = time.monotonic()
        rc = client.main(argv)
        launches = dict(attn.launch_counts)
    steps = len(step_starts)
    want_steps = LOCAL_TIMED_EPOCHS * LOCAL_STEPS
    per_call = GPT2S["num_layers"] if device == "cuda" else 0
    if (
        rc != 0 or len(tasks) != LOCAL_TIMED_EPOCHS * LOCAL_TASKS
        or len(reports) != len(tasks) or steps != want_steps
        or any(n != per_call * steps for n in launches.values())
    ):
        raise AssertionError(
            f"timed run: rc {rc}, {len(tasks)} tasks, {len(reports)} reports, "
            f"{steps} steps, launches {launches}"
        )
    steady = tasks[1:]
    steady_steps = sum(-(-(t.end - t.start) // TRAIN_ROWS) for t in steady)
    secs = reports[-1] - reports[0]
    # the gaps between the window's steps (from the first step after the
    # first report to the last step), inside a task and across a task
    # boundary (a report falls between the two steps)
    first = sum(1 for t0 in step_starts if t0 < reports[0])
    inside, boundary = [], []
    for a, b in zip(step_starts[first:], step_starts[first + 1:]):
        crosses = any(a < t < b for t in reports)
        (boundary if crosses else inside).append((b - a) * 1e3)
    return {
        "steady_tasks": len(steady), "steady_steps": steady_steps,
        "steady_secs": secs,
        "steady_tokens_per_s": sum(t.end - t.start for t in steady) * SEQ / secs,
        "steady_canonical_tokens_per_s": steady_steps * TRAIN_ROWS * SEQ / secs,
        "step_gap_ms_median": statistics.median(inside),
        "step_gap_ms_max": max(inside),
        "boundary_gap_ms_median": statistics.median(boundary),
        "boundary_gap_ms_max": max(boundary),
        "first_task_secs": reports[0] - run_start,
    }


def local_train_lm(work_dir: str, device: str = "cuda", bare_tokens_per_s=None):
    """Phase 6: make EDLIO data, write a warm-start checkpoint, and train
    the LM through ``elasticdl_tpu_torch.client.main(["train", ...])``:
    once with checkpoints, an evaluation and an export, checked, then
    timed (``device="cpu"`` rehearses the phase at a small size).
    Returns each kernel's launches in the checked run."""
    import torch

    data = _local_data(work_dir)
    launches, row = _checked_local_run(work_dir, data, device)
    runs = []
    for _ in range(LOCAL_TIMED_RUNS):
        # the previous run's trainer and Adam state go first
        gc.collect()
        if device == "cuda":
            torch.cuda.empty_cache()
        runs.append(_timed_local_run(data, device))
    pace = [r["steady_canonical_tokens_per_s"] for r in runs]
    mean = statistics.mean(pace)
    row["steady"] = {
        "runs": runs, "epochs": LOCAL_TIMED_EPOCHS,
        "canonical_tokens_per_s_mean": mean,
        "canonical_tokens_per_s_spread": (max(pace) - min(pace)) / mean,
        "bare_step_tokens_per_s": bare_tokens_per_s,
        "canonical_over_bare": [
            p / bare_tokens_per_s if bare_tokens_per_s else None for p in pace
        ],
    }
    print(json.dumps({"local_train": row}), flush=True)
    return launches


# ---- phases 7 and 8: mnist and DeepFM through the train CLI ---------------

MNIST_DEF = "mnist_functional_api.mnist_functional_api.custom_model"
DEEPFM_DEF = "deepfm_edl_embedding.deepfm_edl_embedding.custom_model"
# bench.py's mnist accuracy run (bench.py:931-939) at bench.py's mnist
# step of 256 rows (bench.py:175-180): about 60 000 training records in 8
# shards, 4096 validation records, 16 batches a task.  Each shard is a
# task of 4096 records and one of 3400 (13 full batches and one of 72
# real rows and 184 zero-weight padding rows): 16 tasks, 240 steps
MNIST = dict(
    name="mnist", model_def=MNIST_DEF, gen="gen_mnist", gen_kwargs={},
    model_params="", train_records=59968, eval_records=4096, shards=8,
    batch=256, records_per_task=4096, checkpoint_steps=100,
    wire=("image", "uint8"), accuracy_key="accuracy", min_accuracy=0.8,
)
# bench.py's DeepFM-frappe accuracy run (bench.py:961-969): vocabulary
# 512 in data and model, 131 072 training records in 8 shards, 8192
# validation records, 512 rows a step, 16 batches a task: 16 tasks, 256
# steps
DEEPFM_ACCURACY = dict(
    name="deepfm_frappe", model_def=DEEPFM_DEF, gen="gen_frappe",
    gen_kwargs={"vocab_size": 512}, model_params="input_dim=512",
    train_records=131072, eval_records=8192, shards=8, batch=512,
    records_per_task=8192, checkpoint_steps=100,
    wire=("feature", "int16"), accuracy_key="accuracy_logits",
    min_accuracy=0.8,
)
# DeepFM at its full width (input_dim 5383, bench.py:193-199) and
# bench.py's CTR step of 4096 rows: 8 shards of one 5-step task each, so
# the timed window (the tasks after the first) holds 35 steps
DEEPFM_WIDE = dict(
    name="deepfm_edl_embedding", model_def=DEEPFM_DEF, gen="gen_frappe",
    gen_kwargs={}, model_params="", train_records=163840, eval_records=0,
    shards=8, batch=4096, records_per_task=20480, wire=("feature", "int16"),
)
# steps of the bare loop, back-to-back steps per CUDA-event round (a step
# is about a hundred launches; the launch queue must hold a round), and
# steps in the profiled window that gives the device's busy time
ZOO_BARE_STEPS, ZOO_DEVICE_REPS, ZOO_PROFILED_STEPS = 50, 4, 10


def _device_busy_ms(fn, calls: int) -> float:
    """Device busy milliseconds per call of ``fn``: the kernels' time in
    a ``torch.profiler`` trace of ``calls`` calls, over ``calls``."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    us = 0.0
    for avg in prof.key_averages():
        # user annotations (Optimizer.step#...) are ranges over kernels
        # already counted
        if avg.device_type == torch.autograd.DeviceType.CUDA and not getattr(
            avg, "is_user_annotation", False
        ):
            us += getattr(avg, "device_time_total", None) or avg.cuda_time_total
    if not us:
        raise AssertionError("the profiler recorded no device time")
    return us / 1e3 / calls


def _zoo_data(work_dir: str, cfg: dict) -> dict:
    from elasticdl_tpu_torch.data.recordio_gen import synthetic

    gen = getattr(synthetic, cfg["gen"])
    t0 = time.monotonic()
    data = {"train": gen(
        os.path.join(work_dir, "train"), num_records=cfg["train_records"],
        num_shards=cfg["shards"], seed=0, **cfg["gen_kwargs"],
    )}
    if cfg["eval_records"]:
        data["eval"] = gen(
            os.path.join(work_dir, "eval"), num_records=cfg["eval_records"],
            num_shards=1, seed=1, **cfg["gen_kwargs"],
        )
    data["secs"] = time.monotonic() - t0
    return data


def _zoo_argv(cfg: dict, data: dict, device: str, *extra) -> list:
    argv = [
        "train", "--model_def", cfg["model_def"],
        "--training_data", data["train"],
        "--minibatch_size", str(cfg["batch"]),
        "--records_per_task", str(cfg["records_per_task"]),
        "--num_epochs", str(cfg.get("epochs", 1)), "--shuffle_seed", "0",
        "--device", device, *extra,
    ]
    if cfg["model_params"]:
        argv += ["--model_params", cfg["model_params"]]
    return argv


class _ZooRecorder:
    """What a zoo model's train CLI run did: the training tasks and the
    device-synced clock at each report, and per dispatch (one step, or a
    stacked group of k) its host clock, step count, loss and CUDA events
    around it, and per step its wire features, labels and row weights
    (device copies, read after the run)."""

    def __init__(self, device: str, wire_key: str, keep_batches: bool):
        self.device, self.wire_key, self.keep_batches = device, wire_key, keep_batches
        self.tasks, self.reports, self.step_starts, self.dispatch_steps = [], [], [], []
        self.dispatch_host_secs = []
        self.wire, self.batches, self.losses, self.events = [], [], [], []
        self.executor = self.result = self.train_dispatcher = None

    def patches(self):
        from unittest import mock

        import torch

        from elasticdl_tpu_torch.parallel.distributed import SPMDTrainer
        from elasticdl_tpu_torch.trainer import local_executor as le
        from elasticdl_tpu_torch.utils.constants import TaskType

        rec, run = self, le.LocalExecutor.run

        class Dispatcher(le.TaskDispatcher):
            def get(self, worker_id):
                tid, task = super().get(worker_id)
                if task is not None and task.type == TaskType.TRAINING:
                    rec.tasks.append(task)
                    rec.train_dispatcher = self
                return tid, task

            def report(self, task_id, success, exec_counters=None):
                if self is rec.train_dispatcher:
                    if rec.device == "cuda":
                        torch.cuda.synchronize()
                    rec.reports.append(time.monotonic())
                return super().report(task_id, success, exec_counters)

        def recording(dispatch, stacked):
            def recorded(trainer, features, labels, weights=None):
                rec.step_starts.append(time.monotonic())
                wire = features[rec.wire_key]
                rec.wire.append((wire.dtype, wire.device.type))
                steps = wire.shape[0] if stacked else 1
                rec.dispatch_steps.append(steps)
                if rec.device == "cuda":
                    start = torch.cuda.Event(enable_timing=True)
                    end = torch.cuda.Event(enable_timing=True)
                    start.record()
                metrics = dispatch(trainer, features, labels, weights)
                if rec.device == "cuda":
                    end.record()
                    rec.events.append((start, end))
                rec.dispatch_host_secs.append(time.monotonic() - rec.step_starts[-1])
                rec.losses.append(metrics["loss"])
                if rec.keep_batches:
                    parts = (wire, labels, weights)
                    rec.batches += [
                        tuple(x[j].clone() for x in parts) for j in range(steps)
                    ] if stacked else [tuple(x.clone() for x in parts)]
                return metrics

            return recorded

        def recorded_run(executor):
            rec.executor = executor
            rec.result = run(executor)
            return rec.result

        return [
            mock.patch.object(le, "TaskDispatcher", Dispatcher),
            mock.patch.object(
                SPMDTrainer, "train_step", recording(SPMDTrainer.train_step, False)
            ),
            mock.patch.object(
                SPMDTrainer, "train_steps_stacked",
                recording(SPMDTrainer.train_steps_stacked, True),
            ),
            mock.patch.object(le.LocalExecutor, "run", recorded_run),
        ]

    def run(self, argv, extra=()):
        """``client.main(argv)`` with the recorders and the ``extra``
        patches in place; returns the attention kernels' and the pipeline
        paths' counts over the run."""
        from elasticdl_tpu_torch import client
        from elasticdl_tpu_torch.data import fast_pipeline
        from elasticdl_tpu_torch.ops import attention as attn

        with contextlib.ExitStack() as stack:
            for patch in (*self.patches(), *extra):
                stack.enter_context(patch)
            attn.reset_launch_counts()
            fast_pipeline.reset_path_counts()
            self.start = time.monotonic()
            rc = client.main(argv)
            counts = dict(attn.launch_counts), dict(fast_pipeline.path_counts)
        if rc != 0:
            raise AssertionError(f"train exited with {rc}")
        return counts


def _milestone_versions(dispatch_steps, every: int, keep: int = 3) -> list:
    """The versions a milestone-crossing checkpointer saves when the
    dispatches take ``dispatch_steps`` steps each, and the final one, of
    which the checkpoint directory keeps the last ``keep``."""
    saved, version = set(), 0
    for steps in dispatch_steps:
        if (version + steps) // every > version // every:
            saved.add(version + steps)
        version += steps
    return sorted(saved | {version})[-keep:]


def _record_keys(directory: str, wire_key: str):
    """Every record of ``directory``'s shards as :func:`_row_key`, read
    back with the port's reader."""
    from elasticdl_tpu_torch.data.reader import decode_example
    from elasticdl_tpu_torch.data.recordio_reader import RecordIODataReader
    from elasticdl_tpu_torch.master.task_dispatcher import Task
    from elasticdl_tpu_torch.utils.constants import TaskType

    reader = RecordIODataReader(data_dir=directory)
    keys = []
    for shard, (start, n) in reader.create_shards().items():
        for record in reader.read_records(Task(shard, start, start + n, TaskType.TRAINING)):
            ex = decode_example(record)
            keys.append(_row_key(ex[wire_key], ex["label"]))
    return keys


def _row_key(wire, label) -> bytes:
    """A record's identity whatever its wire dtype: a digest of its
    features and label as int64."""
    import hashlib

    import numpy as np

    return hashlib.sha1(
        np.asarray(wire, np.int64).tobytes() + np.asarray(label, np.int64).tobytes()
    ).digest()


def _zoo_counts(cfg: dict) -> tuple:
    """The training tasks, steps and records of ``cfg``'s run, and its
    evaluation batches."""
    per_shard = cfg["train_records"] // cfg["shards"]
    rpt, batch = cfg["records_per_task"], cfg["batch"]
    epochs = cfg.get("epochs", 1)
    tasks = epochs * cfg["shards"] * -(-per_shard // rpt)
    steps = epochs * cfg["shards"] * sum(
        -(-min(rpt, per_shard - lo) // batch) for lo in range(0, per_shard, rpt)
    )
    return tasks, steps, epochs * cfg["train_records"], -(-cfg["eval_records"] // batch)


def _checked_zoo_run(
    work_dir: str, cfg: dict, data: dict, device: str, flags=(), rec=None
) -> dict:
    """One epoch of ``cfg``'s model through the train CLI with periodic
    checkpoints, a final evaluation and an export (and ``flags``), and
    the phase's checks (a) to (h) on what it did.  Returns the run's row
    of the phase's JSON line; ``rec`` is the recorder to use (the caller
    reads it after)."""
    import numpy as np
    import torch

    from elasticdl_tpu_torch.data import recordio
    from elasticdl_tpu_torch.trainer.state import state_to_checkpoint
    from elasticdl_tpu_torch.utils import save_utils
    from elasticdl_tpu_torch.utils.export_utils import load_exported_model
    from elasticdl_tpu_torch.utils.flax_weights import (
        flax_flat_from_torch,
        flax_state_from_torch,
    )

    ckpt_dir, out_dir = os.path.join(work_dir, "ckpt"), os.path.join(work_dir, "out")
    wire_key, wire_dtype = cfg["wire"]
    rec = rec or _ZooRecorder(device, wire_key, keep_batches=True)
    launches, paths = rec.run(_zoo_argv(
        cfg, data, device, "--validation_data", data["eval"],
        "--checkpoint_dir", ckpt_dir,
        "--checkpoint_steps", str(cfg["checkpoint_steps"]), "--output", out_dir,
        *flags,
    ))
    run_secs = time.monotonic() - rec.start
    trainer = rec.executor.trainer
    model = trainer.state.model
    steps = len(rec.batches)
    epochs = cfg.get("epochs", 1)
    want_tasks, want_steps, want_records, eval_batches = _zoo_counts(cfg)

    # (a) tasks, records and steps
    weights = [w.cpu() for _x, _l, w in rec.batches]
    trained = int(sum(float(w.sum()) for w in weights))
    if (
        len(rec.tasks) != want_tasks
        or sum(t.end - t.start for t in rec.tasks) != want_records
        or trained != want_records
        or steps != want_steps or trainer.step != want_steps
    ):
        raise AssertionError(
            f"{len(rec.tasks)} tasks, {trained} records in {steps} batches, "
            f"trainer at step {trainer.step}; want {want_tasks} tasks, "
            f"{want_steps} steps"
        )
    # (b) the real rows are the training records, each once an epoch;
    # padding rows weigh 0
    got_keys = []
    for (wire, labels, w), w_host in zip(rec.batches, weights):
        n = int(w_host.sum())
        if not (torch.all(w_host[:n] == 1) and torch.all(w_host[n:] == 0)):
            raise AssertionError(f"a batch's row weights are not 1s then 0s: {w_host}")
        wire, labels = wire[:n].cpu().numpy(), labels[:n].cpu().numpy()
        got_keys += [_row_key(wire[i], labels[i]) for i in range(n)]
    if sorted(got_keys) != sorted(_record_keys(data["train"], wire_key) * epochs):
        raise AssertionError("the trained rows are not the training records, once an epoch")
    # (c) every batch through the vectorized path and the native codec,
    # and no attention kernel on this path
    if (
        paths != {"vectorized": steps + eval_batches, "classic": 0}
        or not recordio.native_available() or any(launches.values())
    ):
        raise AssertionError(
            f"pipeline paths {paths} (want {steps + eval_batches} vectorized), "
            f"native codec {recordio.native_available()}, launches {launches}"
        )
    # (d) the wire dtype on the device
    want_wire = (getattr(torch, wire_dtype), device)
    if any(w != want_wire for w in rec.wire):
        raise AssertionError(f"features reached the trainer as {set(rec.wire)}, not {want_wire}")
    # (e) finite losses, (f) the evaluation clears the accuracy bar
    losses = [float(x) for x in rec.losses]
    accuracy = rec.result.get(cfg["accuracy_key"], 0.0)
    row = {
        "tasks": len(rec.tasks), "records": trained, "steps": steps,
        "evaluation": rec.result, "first_losses": losses[:3],
        "last_losses": losses[-3:], "paths": paths,
        "native_codec": recordio.native_available(),
        "wire": f"{wire_dtype} on {device}",
        "data_secs": data["secs"], "run_secs": run_secs,
        "first_task_secs": rec.reports[0] - rec.start,
    }
    if not all(np.isfinite(losses)):
        raise AssertionError(f"non-finite training losses: {row}")
    if not accuracy > cfg["min_accuracy"]:
        raise AssertionError(f"evaluation {rec.result} below {cfg['min_accuracy']}")
    # (g) the running statistics moved and are finite
    stats = flax_state_from_torch(model)
    if stats:
        moved = {
            k: float(np.abs(v - (0.0 if k.endswith("mean") else 1.0)).max())
            for k, v in stats.items()
        }
        row["batch_stats_moved"] = moved
        if not all(np.isfinite(v).all() for v in stats.values()) or not all(
            m > 1e-3 for m in moved.values()
        ):
            raise AssertionError(f"running statistics did not move or are not finite: {row}")
    # (h) the checkpoints and the export hold the trained state, its
    # statistics included
    versions = sorted(
        int(n.split("-")[1]) for n in os.listdir(ckpt_dir) if n.startswith("version-")
    )
    # --keep_checkpoint_max 3
    want_versions = _milestone_versions(rec.dispatch_steps, cfg["checkpoint_steps"])
    trained_flat = state_to_checkpoint(trainer.state)
    last = save_utils.restore_checkpoint(ckpt_dir)[0]
    exported, _flat, _state = load_exported_model(out_dir, device=device)
    export_flat = {
        **{f"params/{k}": v for k, v in flax_flat_from_torch(exported).items()},
        **flax_state_from_torch(exported),
    }
    row.update(checkpoint_versions=versions, state_keys=len(trained_flat))
    for what, flat in (("checkpoint", last), ("export", export_flat)):
        if set(flat) != set(trained_flat) or not all(
            np.array_equal(flat[k], trained_flat[k]) for k in trained_flat
        ):
            raise AssertionError(f"the {what} disagrees with the trained state: {row}")
    if versions != want_versions:
        raise AssertionError(f"checkpoint versions {versions}, want {want_versions}")
    return row


def _timed_zoo_run(cfg: dict, data: dict, device: str, flags=(), rec=None) -> dict:
    """The train CLI over ``cfg``'s data with nothing but training in it
    (and ``flags``).  The window is the tasks after the first: from the
    device sync that closes the first task's report to the one that
    closes the last.  Host time per step is the gap between two
    dispatches inside a task over the first one's steps (None where no
    task has two), and the host time inside a dispatch call over its
    steps; device time per step the CUDA events around a dispatch over
    its steps."""
    rec = rec or _ZooRecorder(device, cfg["wire"][0], keep_batches=False)
    rec.run(_zoo_argv(cfg, data, device, *flags))
    return _steady_window(rec)


def _steady_window(rec) -> dict:
    """:func:`_timed_zoo_run`'s numbers from a recorder after its run."""
    secs = rec.reports[-1] - rec.reports[0]
    steady = rec.tasks[1:]
    first = sum(1 for t0 in rec.step_starts if t0 < rec.reports[0])
    starts, steps = rec.step_starts[first:], rec.dispatch_steps[first:]
    inside = [
        (b - a) * 1e3 / n
        for a, b, n in zip(starts, starts[1:], steps)
        if not any(a < t < b for t in rec.reports)
    ]
    device_ms = [
        s.elapsed_time(e) / n for (s, e), n in zip(rec.events[first:], steps)
    ]
    issue_ms = [t * 1e3 / n for t, n in zip(rec.dispatch_host_secs[first:], steps)]
    return {
        "steady_tasks": len(steady), "steady_steps": sum(steps),
        "steady_secs": secs,
        "records_per_s": sum(t.end - t.start for t in steady) / secs,
        "host_ms_per_step_median": statistics.median(inside) if inside else None,
        "dispatch_host_ms_per_step_median": statistics.median(issue_ms),
        "device_ms_per_step_median": statistics.median(device_ms) if device_ms else None,
        "first_task_secs": rec.reports[0] - rec.start,
    }


def _bare_zoo_steps(cfg: dict, data: dict, device: str) -> dict:
    """``SPMDTrainer`` steps on one placed canonical batch of the first
    ``cfg["batch"]`` training records, as the CLI builds the trainer
    (bf16 float features, the model's device parse): host time to issue
    a step, wall time per step over a synced loop, device time per step
    back to back (CUDA events, the stream held until a round is queued;
    not for a ``cfg`` whose ``device_reps`` is None), and the device's
    busy time per step in a profiled window, with the idle share of the
    wall time it leaves."""
    import torch

    from elasticdl_tpu_torch.data.reader import decode_example_batch
    from elasticdl_tpu_torch.data.recordio_reader import RecordIODataReader
    from elasticdl_tpu_torch.master.task_dispatcher import Task
    from elasticdl_tpu_torch.parallel.distributed import SPMDTrainer
    from elasticdl_tpu_torch.trainer.state import Modes
    from elasticdl_tpu_torch.utils.args import parse_params_dict
    from elasticdl_tpu_torch.utils.constants import TaskType
    from elasticdl_tpu_torch.utils.model_utils import get_model_spec

    spec = get_model_spec(
        "", cfg["model_def"], model_params=parse_params_dict(cfg["model_params"])
    )
    torch.manual_seed(0)
    model = spec.build_model()
    reader = RecordIODataReader(data_dir=data["train"])
    shard = sorted(reader.create_shards())[0]
    records = list(reader.read_records(Task(shard, 0, cfg["batch"], TaskType.TRAINING)))
    features, labels = spec.batch_parse(decode_example_batch(records), Modes.TRAINING)
    trainer = SPMDTrainer(
        model, spec.loss, spec.optimizer(), compute_dtype=torch.bfloat16,
        device=device, device_parse=spec.device_parse,
    )
    rows = cfg["batch"]
    batch = (
        trainer.place_canonical(features, rows), trainer.place_canonical(labels, rows),
        trainer.place_mask(rows, rows),
    )

    def step():
        return trainer.train_step(*batch)

    def sync():
        if device == "cuda":
            torch.cuda.synchronize()

    for _ in range(3):
        step()
    sync()
    host_ms = []
    t0 = time.monotonic()
    for _ in range(ZOO_BARE_STEPS):
        t1 = time.monotonic()
        loss = step()["loss"]
        host_ms.append((time.monotonic() - t1) * 1e3)
    sync()
    wall_ms = (time.monotonic() - t0) * 1e3 / ZOO_BARE_STEPS
    if not torch.isfinite(loss):
        raise AssertionError(f"the bare loop's loss is {float(loss)}")
    device_ms = busy_ms = None
    if device == "cuda":
        reps = cfg.get("device_reps", ZOO_DEVICE_REPS)
        if reps:
            device_ms = time_cuda(step, reps=reps, rounds=5)
        busy_ms = _device_busy_ms(step, ZOO_PROFILED_STEPS)
    return {
        "rows": rows, "host_ms_per_step_median": statistics.median(host_ms),
        "wall_ms_per_step": wall_ms, "device_ms_per_step": device_ms,
        "device_busy_ms_per_step": busy_ms,
        "idle_share": 1.0 - busy_ms / wall_ms if busy_ms else None,
        "records_per_s": rows / (wall_ms / 1e3),
    }


def train_zoo_model(work_dir: str, cfg: dict, device: str = "cuda", timed=True) -> dict:
    """Phase 7 or the first half of phase 8: ``cfg``'s model through the
    train CLI, checked, then timed beside bare steps (``device="cpu"``
    rehearses it at a small size).  Returns the phase's JSON row."""
    import torch

    data = _zoo_data(work_dir, cfg)
    row = {"checked": _checked_zoo_run(work_dir, cfg, data, device)}
    if timed:
        gc.collect()
        if device == "cuda":
            torch.cuda.empty_cache()
        row["timed"] = _timed_zoo_run(cfg, data, device)
        row["bare"] = _bare_zoo_steps(cfg, data, device)
    return row


def train_deepfm(work_dir: str, device: str = "cuda", accuracy_cfg=None, wide_cfg=None) -> dict:
    """Phase 8: DeepFM through the train CLI, checked on bench.py's
    accuracy recipe, then timed at its full width beside bare steps, and
    out-of-vocab ids held on ``device``.  Returns the phase's JSON row."""
    accuracy_cfg = accuracy_cfg or DEEPFM_ACCURACY
    wide_cfg = wide_cfg or DEEPFM_WIDE
    row = train_zoo_model(
        os.path.join(work_dir, "accuracy"), accuracy_cfg, device, timed=False
    )
    data = _zoo_data(os.path.join(work_dir, "wide"), wide_cfg)
    row["timed"] = _timed_zoo_run(wide_cfg, data, device)
    row["bare"] = _bare_zoo_steps(wide_cfg, data, device)
    row["out_of_vocab"] = _deepfm_out_of_vocab(device)
    return row


def _deepfm_out_of_vocab(device: str) -> dict:
    """Ids past the padded table or below 0, fed straight to the model at
    full width on ``device``: the table lookup gives zero rows and sends
    no gradient to any row for them, and the model's output and
    gradients are those of the padding id 0 in their place."""
    import numpy as np
    import torch

    from elasticdl_tpu_torch.models import deepfm_functional_api as deepfm

    torch.manual_seed(0)
    model = deepfm.custom_model().to(device)
    rows = model.embedding.padded_input_dim
    ids = np.random.RandomState(2).randint(1, deepfm.DEFAULT_INPUT_DIM, (64, 10))
    bad = [(0, 0, rows), (1, 3, 2**15 - 1), (2, 9, -1), (3, 5, -300)]
    for r, c, v in bad:
        ids[r, c] = v
    oov = (ids < 0) | (ids >= rows)
    table = model.embedding.embedding
    lookup = model.embedding(torch.from_numpy(ids).to(device))
    (grad,) = torch.autograd.grad(lookup.sum(), table)
    counts = np.bincount(ids[~oov], minlength=rows).astype(np.float32)
    zero_rows = bool((lookup[torch.from_numpy(oov).to(device)] == 0).all())
    grad_is_counts = torch.equal(
        grad, torch.from_numpy(counts)[:, None].expand_as(grad).to(device)
    )
    clean = ids.copy()
    for r, c, _v in bad:
        clean[r, c] = 0
    out, grads = [], []
    for x in (ids, clean):
        model.zero_grad(set_to_none=True)
        logits = model({"feature": torch.from_numpy(x).to(device)})["logits"]
        logits.sum().backward()
        out.append(logits.detach())
        grads.append({n: p.grad.clone() for n, p in model.named_parameters()})
    same = torch.equal(out[0], out[1]) and all(
        torch.equal(grads[0][n], grads[1][n]) for n in grads[0]
    )
    result = {
        "oov_ids": int(oov.sum()), "zero_lookup_rows": zero_rows,
        "table_grad_is_in_range_counts": grad_is_counts,
        "model_same_as_padding_id": same,
    }
    if not (zero_rows and grad_is_counts and same):
        raise AssertionError(f"out-of-vocab ids reached the tables: {result}")
    return result


# ---- phase 9: stacked steps, remat and the device pipeline through the CLI --

# mnist on phase 7's data, 8 steps a dispatch, staged: each shard's task
# of 4096 records is two PreStacked groups of 8, and its task of 3400 one
# group of 8 and 6 single steps (5 full batches and the padded one)
STACKED_MNIST = dict(
    flags=("--steps_per_dispatch", "8", "--device_prefetch", "true"),
    group=8, groups=24, singles=48,
)
# mnist's other runs on the same data: bench.py's e2e flags
# (bench.py:863-911), checked, whose k follows the auto probe (the
# grouping is set from the k it resolves to), and 8 steps a dispatch
# without staging, timed only
STACKED_MNIST_VARIANTS = (
    ("auto_staged", dict(flags=("--steps_per_dispatch", "auto", "--device_prefetch", "true"), auto=True), True),
    ("k8_unstaged", dict(STACKED_MNIST, flags=("--steps_per_dispatch", "8")), False),
)
# timed runs of a model with variants: each flag set this many times, in
# turn (two would give a spread; one keeps the smoke in its budget)
STACKED_TIMED_ROUNDS = 1
# DeepFM staged across task boundaries, 3 dispatches in flight: checked
# on phase 8's accuracy recipe (16 tasks of 16 batches: two PreStacked
# groups of 8 each), then at full width on phase 8's timed data, whose
# one-task shards hold 5 full batches: one PreStacked group of 5 each (a
# window of fewer than k full batches groups the ones it holds).  Forty
# steps at full width are too few to learn the task, so its accuracy bar
# is held on the recipe, as in phase 8
STACKED_DEEPFM = dict(
    flags=(
        "--steps_per_dispatch", "8", "--device_prefetch", "true",
        "--boundary_fusion", "true", "--pipeline_depth", "3",
    ),
    group=8, groups=32, singles=0,
)
STACKED_DEEPFM_WIDE = dict(STACKED_DEEPFM, group=5, groups=8)
# the LM, 4 steps a dispatch with remat, on phase 6's kind of data: 4
# shards of 76 records in tasks of 60 (8 steps: two groups of 4, the
# second with 4 zero-weight padding rows) and of 16 (2 single steps)
STACKED_LM = dict(flags=("--steps_per_dispatch", "4", "--remat", "true"), group=4, groups=8, singles=8)
STACKED_LM_RECORDS, STACKED_LM_SHARDS, STACKED_LM_RECORDS_PER_TASK = 304, 4, 60
STACKED_LM_STEPS, STACKED_LM_CHECKPOINT_STEPS = 40, 16
# replays of a captured graph timed alone, and profiled for busy time
GRAPH_BARE_REPLAYS, GRAPH_PROFILED_REPLAYS = 20, 4
FLASH_NAMES = ("flash_bwd_dkv", "flash_bwd_dq", "flash_fwd")


def _check_dispatches(trainer, dispatch_steps, want: dict) -> dict:
    """Every full group of the run went through the trainer's one graph
    (the first group eager, the second captured, each one replayed) and
    every trailing partial through single steps: the trainer's counters
    against the dispatches recorded and the grouping ``want`` gives (no
    group: every step single, and no graph)."""
    counts = dict(trainer.dispatch_counts)
    groups = [n for n in dispatch_steps if n > 1]
    singles = sum(1 for n in dispatch_steps if n == 1)
    grouped = want["groups"] > 0
    want_counts = {
        "single_steps": want["singles"], "eager_groups": int(grouped),
        "graph_captures": int(grouped), "graph_replays": max(want["groups"] - 1, 0),
    }
    if (
        counts != want_counts or len(trainer._graphs) != int(grouped)
        or len(groups) != want["groups"] or singles != want["singles"]
        or any(n != want["group"] for n in groups)
    ):
        raise AssertionError(
            f"dispatch counts {counts}, want {want_counts}; groups {groups}, "
            f"{singles} single steps"
        )
    return counts


def _state_diff(a, b) -> float:
    """The largest difference between two models' parameters and
    buffers."""
    sa, sb = a.state_dict(), b.state_dict()
    return max((sa[k].float() - v.float()).abs().max().item() for k, v in sb.items())


def _replay_check(make_trainer, rec) -> dict:
    """The batches ``rec`` recorded replayed as single eager steps through
    a fresh trainer from ``make_trainer`` give the graph-replayed run's
    weights and statistics exactly.  Where the run's first dispatch, a
    stacked group, made its optimizer capturable, the fresh trainer's is
    made so before its first step (capturable Adam computes its bias
    correction on the card, in other roundings than on the host)."""
    from elasticdl_tpu_torch.trainer.state import make_capturable

    run = rec.executor.trainer
    replay = make_trainer()
    if run._graph_lr_ok is not None:
        if rec.dispatch_steps[0] == 1:
            raise AssertionError("the run's optimizer became capturable after a single step")
        make_capturable(replay.state.optimizer, replay.device)
    for wire, labels, weights in rec.batches:
        replay.train_step({rec.wire_key: wire}, labels, weights)
    row = {"replay_max_abs_diff": _state_diff(replay.state.model, run.state.model)}
    if row["replay_max_abs_diff"] != 0.0:
        raise AssertionError(f"graph replays disagree with eager steps: {row}")
    return row


@contextlib.contextmanager
def _deterministic_cudnn():
    """cuDNN held to its deterministic algorithms: its default
    convolution weight gradients are not (two eager replays of phase 9's
    mnist batches end apart), and a run checked bit for bit against
    eager steps needs both sides deterministic."""
    import torch

    before = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        yield
    finally:
        torch.backends.cudnn.deterministic = before


def _bare_graph(trainer) -> dict:
    """The run's captured graph replayed alone on its static inputs:
    host ms to issue a replay, wall ms per step over a synced loop, busy
    ms per step in a profiled window, and the idle share it leaves."""
    import torch

    graph = next(g for g in trainer._graphs.values() if g is not None)

    def replay():
        return trainer.train_steps_stacked(*graph.static)

    for _ in range(3):
        replay()
    torch.cuda.synchronize()
    host_ms = []
    t0 = time.monotonic()
    for _ in range(GRAPH_BARE_REPLAYS):
        t1 = time.monotonic()
        replay()
        host_ms.append((time.monotonic() - t1) * 1e3)
    torch.cuda.synchronize()
    wall_ms = (time.monotonic() - t0) * 1e3 / GRAPH_BARE_REPLAYS / graph.k
    busy_ms = _device_busy_ms(replay, GRAPH_PROFILED_REPLAYS) / graph.k
    return {
        "steps_per_replay": graph.k,
        "host_ms_per_replay_median": statistics.median(host_ms),
        "wall_ms_per_step": wall_ms, "device_busy_ms_per_step": busy_ms,
        "idle_share": 1.0 - busy_ms / wall_ms,
    }


def _auto_grouping(rec, device: str) -> dict:
    """The grouping ``--steps_per_dispatch auto`` gives the run ``rec``
    recorded: the k the sizing rule resolves to on ``device`` for the
    run's first wire batch, which on a local card is 1 (a sub-ms
    dispatch), so that every step is single."""
    from elasticdl_tpu_torch.trainer import stacking

    wire, labels, _weights = rec.batches[0]
    batch = ({rec.wire_key: wire.cpu().numpy()}, labels.cpu().numpy())
    k = stacking.resolve_steps_per_dispatch("auto", batch, device=device)
    if k != 1:
        raise AssertionError(f"auto resolved to k = {k} on {device}; the rule gives 1 for a sub-ms dispatch")
    return dict(group=1, groups=0, singles=len(rec.batches))


def _graph_checks(rec, cfg: dict, stacked: dict, device: str) -> dict:
    """The dispatch counters of a recorded stacked run, and its batches
    replayed as eager single steps through a fresh trainer built as the
    executor builds it."""
    import torch

    from elasticdl_tpu_torch.parallel.distributed import SPMDTrainer
    from elasticdl_tpu_torch.utils.args import parse_params_dict
    from elasticdl_tpu_torch.utils.model_utils import get_model_spec

    trainer = rec.executor.trainer
    row = {}
    if device == "cuda":
        want = _auto_grouping(rec, device) if stacked.get("auto") else stacked
        row["dispatch_counts"] = _check_dispatches(trainer, rec.dispatch_steps, want)
    spec = get_model_spec("", cfg["model_def"], model_params=parse_params_dict(cfg["model_params"]))

    def make_trainer():
        # the executor's start: its seed, its bf16 features, its parse
        with torch.random.fork_rng(devices=[]):
            torch.manual_seed(0)
            model = spec.build_model()
        return SPMDTrainer(
            model, spec.loss, spec.optimizer(), compute_dtype=torch.bfloat16,
            device=device, device_parse=spec.device_parse,
        )

    row.update(_replay_check(make_trainer, rec))
    return row


def _release_memory(device: str) -> None:
    import torch

    gc.collect()
    if device == "cuda":
        torch.cuda.empty_cache()


def stacked_zoo_run(
    work_dir: str, cfg: dict, stacked: dict, device: str = "cuda",
    wide_cfg=None, wide_stacked=None, variants=(), single_busy_ms=None,
) -> dict:
    """Phase 9 for mnist or DeepFM: ``cfg``'s model through the train CLI
    with ``stacked``'s flags, checked as phases 7 and 8 check it, its
    graph replays held against eager steps; then (DeepFM) the same at
    ``wide_cfg``; then timed at the widest, beside its graph replayed
    alone (``device="cpu"`` rehearses it, without graphs).  ``variants``
    (mnist): ``(name, flags, checked)`` runs on the same data with other
    flags, checked as the first where ``checked``, and all timed, with
    the first, ``STACKED_TIMED_ROUNDS`` times in turn; the idle share of
    a run with no graph is taken against ``single_busy_ms``, the busy
    time of a bare single step."""
    data = _zoo_data(os.path.join(work_dir, "checked"), cfg)
    with _deterministic_cudnn():
        rec = _ZooRecorder(device, cfg["wire"][0], keep_batches=True)
        row = {"checked": _checked_zoo_run(work_dir, cfg, data, device, stacked["flags"], rec)}
        row["checked"].update(_graph_checks(rec, cfg, stacked, device))
        del rec
        for name, spec, checked in variants:
            if checked:
                _release_memory(device)
                rec = _ZooRecorder(device, cfg["wire"][0], keep_batches=True)
                row[f"checked_{name}"] = _checked_zoo_run(
                    os.path.join(work_dir, name), cfg, data, device, spec["flags"], rec
                )
                row[f"checked_{name}"].update(_graph_checks(rec, cfg, spec, device))
                del rec
        if wide_cfg is not None:
            cfg, stacked = wide_cfg, wide_stacked
            data = _zoo_data(os.path.join(work_dir, "wide"), cfg)
            _release_memory(device)
            rec = _ZooRecorder(device, cfg["wire"][0], keep_batches=True)
            rec.run(_zoo_argv(cfg, data, device, *stacked["flags"]))
            row["wide"] = {"steps": len(rec.batches), **_graph_checks(rec, cfg, stacked, device)}
            del rec
    runs = [("", stacked)] + [(name, spec) for name, spec, _checked in variants]
    bare = None
    for rounds in range(STACKED_TIMED_ROUNDS if variants else 1):
        for name, spec in runs:
            _release_memory(device)
            timed_rec = _ZooRecorder(device, cfg["wire"][0], keep_batches=False)
            timed = _timed_zoo_run(cfg, data, device, spec["flags"], timed_rec)
            timed["flags"] = list(spec["flags"])
            if device == "cuda":
                graphs = timed_rec.executor.trainer._graphs
                if bare is None and graphs:
                    row["bare_graph"] = bare = _bare_graph(timed_rec.executor.trainer)
                busy = bare["device_busy_ms_per_step"] if graphs else single_busy_ms
                timed["idle_share"] = None if busy is None else 1.0 - (
                    busy * timed["steady_steps"] / (timed["steady_secs"] * 1e3)
                )
            if not name and not rounds:
                row["timed"] = timed
            else:
                row.setdefault("timed_runs", []).append(timed)
            del timed_rec
    return row


class _FlashTrace:
    """The flash kernels of every graph replay of a run (a replay runs no
    Python, so the wrappers do not count it): ``counts``, per replay, the
    kernels its graph holds, counted as the capture records them (a
    replay launches exactly what its graph holds); ``traced``, per
    replay, the kernels its device trace shows (each replay runs under
    ``torch.profiler``), the observation that they ran.  The trace can
    drop a record (on an H100 it read 92, 94, and twice 95, of a graph's
    96 forward launches), never add one: :func:`replay_trace_gaps`
    bounds the drop."""

    def __init__(self):
        self.counts = []
        self.traced = []

    @contextlib.contextmanager
    def patch(self):
        from unittest import mock

        import torch
        from torch.profiler import ProfilerActivity, profile

        from elasticdl_tpu_torch.ops import attention
        from elasticdl_tpu_torch.parallel import distributed

        trace, graphs = self, distributed._StepsGraph
        replay, capture, launch = graphs.replay, graphs.__init__, attention._launch
        captured = dict.fromkeys(FLASH_NAMES, 0)

        def counted_launch(name, *args):
            launch(name, *args)
            if torch.cuda.is_current_stream_capturing():
                captured[name] += 1

        def counted_capture(graph, *args, **kwargs):
            captured.update(dict.fromkeys(FLASH_NAMES, 0))
            capture(graph, *args, **kwargs)
            graph.flash_kernels = dict(captured)

        def traced(graph, inputs):
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                out = replay(graph, inputs)
                torch.cuda.synchronize()
            counts = dict.fromkeys(FLASH_NAMES, 0)
            for avg in prof.key_averages():
                name = next((f for f in FLASH_NAMES if f in avg.key), None)
                if name is not None:
                    counts[name] += avg.count
            trace.counts.append(dict(graph.flash_kernels))
            trace.traced.append(counts)
            return out

        with (
            mock.patch.object(attention, "_launch", counted_launch),
            mock.patch.object(graphs, "__init__", counted_capture),
            mock.patch.object(graphs, "replay", traced),
        ):
            yield


def _stacked_lm_checked(work_dir: str, data: dict, device: str) -> dict:
    """The LM through the train CLI with ``STACKED_LM``'s flags,
    periodic checkpoints, an evaluation and an export, checked."""
    import numpy as np
    import torch

    from elasticdl_tpu_torch.models import long_seq_transformer as lm
    from elasticdl_tpu_torch.parallel.distributed import SPMDTrainer
    from elasticdl_tpu_torch.trainer.state import checkpoint_to_state
    from elasticdl_tpu_torch.utils import save_utils
    from elasticdl_tpu_torch.utils.export_utils import load_exported_model
    from elasticdl_tpu_torch.utils.flax_weights import flax_flat_from_torch

    ckpt_dir, out_dir = os.path.join(work_dir, "ckpt"), os.path.join(work_dir, "out")
    argv = _local_argv(
        data, device, "--num_epochs", "1", "--validation_data", data["eval"],
        "--checkpoint_dir", ckpt_dir,
        "--checkpoint_steps", str(STACKED_LM_CHECKPOINT_STEPS), "--output", out_dir,
        *STACKED_LM["flags"], records_per_task=STACKED_LM_RECORDS_PER_TASK,
    )
    rec, trace = _ZooRecorder(device, "tokens", keep_batches=True), _FlashTrace()
    launches, _paths = rec.run(argv, extra=[trace.patch()] if device == "cuda" else [])
    trainer, result, batches = rec.executor.trainer, rec.result, rec.batches
    row = {"run_secs": time.monotonic() - rec.start, "tasks": len(rec.tasks), "steps": len(batches)}

    # (a) tasks, records, steps, and the route of every dispatch
    trained = int(sum(float(w.sum()) for _t, _l, w in batches))
    if (
        len(rec.tasks) != 2 * STACKED_LM_SHARDS
        or sum(t.end - t.start for t in rec.tasks) != STACKED_LM_RECORDS
        or trained != STACKED_LM_RECORDS
        or len(batches) != STACKED_LM_STEPS or trainer.step != STACKED_LM_STEPS
    ):
        raise AssertionError(f"{len(rec.tasks)} tasks, {trained} records, {len(batches)} steps")
    if device == "cuda":
        row["dispatch_counts"] = _check_dispatches(trainer, rec.dispatch_steps, STACKED_LM)
    # (b) the real rows are the training records, each once
    got_rows = []
    for tokens, labels, w in batches:
        n = int(w.sum())
        for i in range(n):
            row_tokens = torch.cat([tokens[i], labels[i, -1:]]).to(torch.int64)
            got_rows.append(row_tokens.cpu().numpy().tobytes())
    if sorted(got_rows) != sorted(_record_rows(data["train"])):
        raise AssertionError("the trained rows are not the training records, once each")
    # (c) kernel launches: each graph replay's from its capture (k steps,
    # the forward twice a step with remat), seen in its device trace;
    # the wrappers count
    # the eager steps (the first group and the singles) and the
    # evaluation's forward, and nothing of the capture
    layers, k = GPT2S["num_layers"], STACKED_LM["group"]
    per_step = {"flash_fwd": 2 * layers, "flash_bwd_dq": layers, "flash_bwd_dkv": layers}
    eval_batches = -(-LOCAL_EVAL_RECORDS // TRAIN_ROWS)
    replays = trainer.dispatch_counts["graph_replays"]
    eager_steps = STACKED_LM_STEPS - replays * k
    if device == "cuda":
        want_trace = [{n: c * k for n, c in per_step.items()}] * replays
        want_wrappers = {
            n: c * eager_steps + (n == "flash_fwd") * layers * eval_batches
            for n, c in per_step.items()
        }
        row.update(replay_graph=trace.counts, replay_trace=trace.traced, wrapper_counts=launches)
        unseen = replay_trace_gaps(trace.counts, trace.traced)
        row["trace_dropped"] = sum(
            c[n] - t[n] for t, c in zip(trace.traced, trace.counts) for n in FLASH_NAMES
        )
        if (
            trace.counts != want_trace or launches != want_wrappers or unseen
            or len(trace.traced) != replays
        ):
            raise AssertionError(
                f"flash launches: replayed graphs {trace.counts} (want {want_trace}), "
                f"their traces {trace.traced}, wrapper counts {launches} "
                f"(want {want_wrappers})"
            )
        # what ran on the card: the eager launches and every traced replay
        row["launches"] = {
            n: launches[n] + sum(c[n] for c in trace.counts) for n in per_step
        }
    # (d) finite losses and evaluation
    losses = [float(x) for x in rec.losses]
    row.update(losses=losses, evaluation=result)
    if not (all(np.isfinite(losses)) and all(np.isfinite(list(result.values())))):
        raise AssertionError(f"losses {losses}, evaluation {result}")

    # (e) the batches replayed as single eager steps through a fresh
    # trainer from the same checkpoint
    def make_trainer():
        replay = SPMDTrainer(
            lm.custom_model(**GPT2S), lm.loss, lm.optimizer(),
            compute_dtype=torch.bfloat16, device=device, remat=True,
        )
        checkpoint_to_state(replay.state, save_utils.restore_checkpoint(data["init"])[0])
        return replay

    row.update(_replay_check(make_trainer, rec))
    # (f) the checkpoints and the export
    versions = sorted(
        int(n.split("-")[1]) for n in os.listdir(ckpt_dir) if n.startswith("version-")
    )
    want_versions = _milestone_versions(rec.dispatch_steps, STACKED_LM_CHECKPOINT_STEPS)
    exported, _flat, _state = load_exported_model(out_dir, device=device)
    export_diff = _state_diff(exported, trainer.state.model)
    last = save_utils.restore_checkpoint(ckpt_dir)[0]
    flat = {f"params/{k}": v for k, v in flax_flat_from_torch(trainer.state.model).items()}
    exact = set(last) == set(flat) and all(np.array_equal(last[k], flat[k]) for k in flat)
    row.update(checkpoint_versions=versions, export_max_abs_diff=export_diff)
    if versions != want_versions or export_diff != 0.0 or not exact:
        raise AssertionError(f"checkpoints {versions} (want {want_versions}) or export disagree: {row}")
    return row


# the share of one kernel's captured launches that one replay's device
# trace may lack: on the H100 the profiler dropped 0, 1, 2 and 4 of a
# replay's 96 forward records in five runs (never one of a backward
# kernel's 48), while the graph replays every node it captured
TRACE_DROP_MAX_SHARE = 0.1


def replay_trace_gaps(counts: list, traced: list) -> list:
    """The replays whose device trace does not show each flash kernel its
    graph holds: more of it than the graph holds, or fewer than
    ``1 - TRACE_DROP_MAX_SHARE`` of it.  ``counts`` and ``traced`` are
    per replay ({kernel: launches}): captured, and seen in its trace."""
    return [
        (i, t) for i, (t, c) in enumerate(zip(traced, counts))
        if any(
            not (0 < t[n] <= c[n] and c[n] - t[n] <= TRACE_DROP_MAX_SHARE * c[n])
            for n in FLASH_NAMES
        )
    ]


def _stacked_lm_timed(data: dict, device: str, flags) -> dict:
    """The LM's steady pace through the train CLI with ``flags`` over 2
    epochs with nothing but training: the window is the second epoch
    (the first holds the eager group and the capture), from the device
    sync that closes the first epoch's last report to the one that closes
    the run's; and the peak device memory of the run."""
    import torch

    if device == "cuda":
        torch.cuda.reset_peak_memory_stats()
    rec = _ZooRecorder(device, "tokens", keep_batches=False)
    rec.run(_local_argv(
        data, device, "--num_epochs", "2", *flags,
        records_per_task=STACKED_LM_RECORDS_PER_TASK,
    ))
    tasks, reports = rec.tasks, rec.reports
    if len(tasks) != 4 * STACKED_LM_SHARDS:
        raise AssertionError(f"timed run: {len(tasks)} tasks")
    epoch = len(tasks) // 2
    t0, t1 = reports[epoch - 1], reports[-1]
    window = [(a, n) for a, n in zip(rec.step_starts, rec.dispatch_steps) if t0 < a < t1]
    inside = [
        (b - a) * 1e3 / n for (a, n), (b, _m) in zip(window, window[1:])
        if not any(a < t < b for t in reports)
    ]
    window_steps = sum(n for _a, n in window)
    row = {
        "flags": list(flags), "window_steps": window_steps, "window_secs": t1 - t0,
        "tokens_per_s": sum(t.end - t.start for t in tasks[epoch:]) * SEQ / (t1 - t0),
        "canonical_tokens_per_s": window_steps * TRAIN_ROWS * SEQ / (t1 - t0),
        "host_ms_per_step_median": statistics.median(inside) if inside else None,
        "peak_memory_bytes": torch.cuda.max_memory_allocated() if device == "cuda" else None,
    }
    if device == "cuda":
        bare = _bare_graph(rec.executor.trainer)
        row["bare_graph"] = bare
        row["idle_share"] = 1.0 - (
            bare["device_busy_ms_per_step"] * window_steps / ((t1 - t0) * 1e3)
        )
    return row


def stacked_lm_run(work_dir: str, device: str = "cuda", bare_tokens_per_s=None) -> dict:
    """Phase 9 for the LM: its data and warm-start checkpoint, the checked
    run with ``STACKED_LM``'s flags, then timed runs with and without
    remat (4 steps a dispatch both), each with its peak memory
    (``device="cpu"`` rehearses it at a small size, without graphs)."""
    import torch

    data = _local_data(work_dir, STACKED_LM_RECORDS, STACKED_LM_SHARDS)
    row = {"checked": _stacked_lm_checked(work_dir, data, device)}
    row["timed"] = []
    for flags in (STACKED_LM["flags"], STACKED_LM["flags"][:2]):
        gc.collect()
        if device == "cuda":
            torch.cuda.empty_cache()
        row["timed"].append(_stacked_lm_timed(data, device, flags))
    row["bare_step_tokens_per_s"] = bare_tokens_per_s
    return row


def auto_probe() -> dict:
    """The dispatch overhead the ``auto`` sizing measures on the card, and
    the k it resolves to for phase 7's and phase 8's wire batches."""
    import numpy as np

    from elasticdl_tpu_torch.trainer import stacking

    overhead = stacking.measured_dispatch_overhead("cuda")
    batches = {
        "mnist_256_rows": ({"image": np.zeros((256, 28, 28), np.uint8)}, np.zeros(256, np.int32)),
        "deepfm_4096_rows": ({"feature": np.zeros((4096, 10), np.int16)}, np.zeros(4096, np.int32)),
    }
    return {
        "dispatch_overhead_secs": overhead,
        "cheap_dispatch_secs": stacking.CHEAP_DISPATCH_SECS,
        "auto_k": {
            name: stacking.resolve_steps_per_dispatch("auto", batch, device="cuda")
            for name, batch in batches.items()
        },
    }


# ---- phase 10: AllreduceStrategy worlds, preemption and re-formation -------

# mnist at bench.py's width and step (bench.py:175: 28x28, 256 rows), two
# epochs of 16 384 records in 8 shards; tasks of 1024 records are 4 steps,
# so with a checkpoint every 2 steps one exists by step 6, where the
# preempt_one_worker plan kills process 1 (chaos/plan.py:243); 128 steps
# in all, plus the steps the re-formed world takes again from its restore
ELASTIC_MNIST = dict(
    MNIST, name="mnist_elastic", train_records=16384, eval_records=4096,
    shards=8, records_per_task=1024, checkpoint_steps=2, epochs=2,
)
# DeepFM on the accuracy recipe (bench.py:961-969, vocabulary 512, 512 rows
# a step), one epoch, tasks of 2048 records (4 steps)
ELASTIC_DEEPFM = dict(
    DEEPFM_ACCURACY, name="deepfm_elastic", records_per_task=2048,
    checkpoint_steps=2, epochs=1,
)
ELASTIC_WORKERS = 2
# the fault-free two-rank world against the Local run on the same data:
# tests/test_lockstep.py:131-139's tolerances (8-device against 2-device
# reduction orders through BatchNorm there; here cuDNN's algorithms on
# 128 against 256 rows, in bf16)
PARITY_RTOL, PARITY_ATOL = 5e-3, 3e-2
# the two-rank LM against one rank on the same 8 rows, 2 Adam steps:
# the summed gradient of step 1 within phase 5's bf16 tolerance on
# gradients (GRAD_REL_ERR); the parameters' two-step updates within
# DP_UPDATE_REL_ERR of each other in relative norm (Adam's first update
# is lr * sign(g) elementwise, so gradients that round differently near
# 0 flip whole-lr steps, about 0.1 of the norm per percent flipped; a
# world that trained each half apart flips about half of them); every
# element within 2 * lr * steps (Adam's bound)
DP_LM_ROWS, DP_LM_STEPS = 8, 2
DP_UPDATE_REL_ERR = 0.25


class _ReportClock:
    """Dispatcher observer: the monotonic time and records of every
    successful training report (the steady rate of a world), and the
    count of failed reports (leases a recovery re-queued)."""

    def __init__(self):
        self.reports: list = []
        self.failed_reports = 0

    def on_task_reported(self, task_id, task, success, counted):
        if counted and not success:
            self.failed_reports += 1
        elif counted and int(task.type) == 0:  # TaskType.TRAINING
            self.reports.append((time.monotonic(), task.end - task.start))

    def steady_records_per_s(self, after: float) -> float | None:
        """Records over the reports after the first one past ``after``
        (the tasks after the first of the last world), per second."""
        window = [r for r in self.reports if r[0] > after]
        if len(window) < 2:
            return None
        return sum(n for _t, n in window[1:]) / (window[-1][0] - window[0][0])


def _job_recorder(expected_records=None, kill_at_version=None, on_build=None):
    """A ``build_master`` (for :func:`_cli_job`) that keeps the CLI's
    master, with: an invariant checker (``expected_records``), a clock of
    its task reports, every evaluation round
    (its summary and the label rows accepted for it), the largest
    evaluation report (bytes, and the seconds the master's handler took),
    each re-formed world's ``{worker_id: pid}`` (``worlds``);
    with ``kill_at_version``, a version observer that SIGKILLs the
    reporting worker's process once, at the first version at or past it;
    then ``on_build(master)``."""
    import signal

    from elasticdl_tpu_torch.chaos.invariants import InvariantChecker

    built = {"rounds": [], "largest_report": None, "killed": None, "worlds": []}
    original = _real_build_master()

    def build(args):
        master = original(args)
        built["master"] = master
        im = master.instance_manager
        if im is not None:
            master.reform_callbacks.append(lambda *_a: built["worlds"].append(
                {w: im.worker_pid(w) for w in im.worker_ids()}
            ))
        if expected_records is not None:
            checker = InvariantChecker(expected_records=expected_records)
            master.task_d.add_observer(checker)
            master.servicer.add_version_observer(checker.on_version_report)
            master.reform_callbacks.append(checker.on_reform)
            built["checker"] = checker
        built["clock"] = _ReportClock()
        master.task_d.add_observer(built["clock"])
        svc = master.evaluation_service
        if svc is not None:
            lock = threading.Lock()
            rows = [0]
            report, complete = svc.report_evaluation_metrics, svc.complete_task

            def counted(model_outputs, labels, evaluated_version=-1):
                ok = report(model_outputs, labels, evaluated_version=evaluated_version)
                if ok:
                    with lock:
                        rows[0] += int(labels.values.shape[0])
                return ok

            def completed(eval_job_id=None):
                # jobs run one at a time: the rows accepted since the last
                # completion are this job's
                with lock:
                    n, rows[0] = rows[0], 0
                summary = complete(eval_job_id=eval_job_id)
                with lock:
                    if summary is None:
                        rows[0] += n
                    else:
                        built["rounds"].append(
                            {"summary": summary, "rows": n, "at": time.monotonic()}
                        )
                return summary

            svc.report_evaluation_metrics, svc.complete_task = counted, completed
        serve = master.servicer.report_evaluation_metrics

        def timed(request):
            t0 = time.monotonic()
            serve(request)
            secs = time.monotonic() - t0
            nbytes = sum(t.values.nbytes for t in request.model_outputs.values())
            nbytes += request.labels.values.nbytes
            largest = built["largest_report"]
            if largest is None or nbytes > largest["bytes"]:
                built["largest_report"] = {"bytes": nbytes, "handler_secs": secs}

        master.servicer.report_evaluation_metrics = timed
        if kill_at_version is not None:
            def kill(worker_id, version):
                if built["killed"] is None and version >= kill_at_version:
                    pid = master.instance_manager.worker_pid(worker_id)
                    built["killed"] = {
                        "worker_id": worker_id, "version": version, "at": time.monotonic(),
                    }
                    os.kill(pid, signal.SIGKILL)

            master.servicer.add_version_observer(kill)
        if on_build is not None:
            on_build(master)
        return master

    return built, build


# the CLI jobs running now, by thread: one router stands in for
# ``master.main.build_master`` while any runs, so that jobs can run side
# by side, each with its own build
_ROUTES: dict = {}  # thread ident -> build
_ROUTES_LOCK = threading.Lock()
_REAL_BUILD: list = []  # the real build_master while the router stands in


def _real_build_master():
    from elasticdl_tpu_torch.master import main as master_main

    with _ROUTES_LOCK:
        return _REAL_BUILD[0] if _REAL_BUILD else master_main.build_master


def _cli_job(argv: list, build) -> tuple:
    """``client.main(argv)`` with the master built by ``build``; returns
    its exit code and wall seconds.  Safe beside another thread's job."""
    from elasticdl_tpu_torch import client
    from elasticdl_tpu_torch.master import main as master_main

    me = threading.get_ident()
    with _ROUTES_LOCK:
        if not _ROUTES:
            real = master_main.build_master
            _REAL_BUILD.append(real)
            master_main.build_master = lambda args: _ROUTES.get(threading.get_ident(), real)(args)
        _ROUTES[me] = build
    t0 = time.monotonic()
    try:
        rc = client.main(argv)
    finally:
        with _ROUTES_LOCK:
            del _ROUTES[me]
            if not _ROUTES:
                master_main.build_master = _REAL_BUILD.pop()
    return rc, time.monotonic() - t0


def _in_background(fn, name: str):
    """Start ``fn`` on a thread of its own; the returned callable waits for
    it and returns its result, or raises its failure."""
    out: dict = {}

    def run():
        try:
            out["result"] = fn()
        except BaseException as ex:  # noqa: BLE001 — re-raised by the join
            out["error"] = ex

    thread = threading.Thread(target=run, name=name, daemon=True)
    thread.start()

    def join():
        thread.join()
        if "error" in out:
            raise AssertionError(f"{name} failed: {out['error']!r}") from out["error"]
        return out["result"]

    return join


def _beside(**jobs) -> dict:
    """Run each job (a callable) on a thread of its own, side by side;
    returns their results by name, or raises the first failure."""
    out, errors = {}, {}

    def run(name, fn):
        try:
            out[name] = fn()
        except BaseException as ex:  # noqa: BLE001 — re-raised below
            errors[name] = ex

    threads = [threading.Thread(target=run, args=item, name=item[0]) for item in jobs.items()]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    for name, ex in errors.items():
        raise AssertionError(f"{name} failed: {ex!r}") from ex
    return out


def _elastic_argv(
    cfg: dict, data: dict, device: str, work_dir: str, envs: dict, tag: str,
    num_workers: int = ELASTIC_WORKERS,
):
    """A distributed job's argv.  No standbys unless the caller's extra
    flags ask (phases 10-12 measure cold re-formations, as PRs 8-10 did)."""
    env = ",".join(f"{k}={v}" for k, v in envs.items())
    return _zoo_argv(cfg, data, device) + [
        "--num_epochs", str(cfg["epochs"]),
        "--distribution_strategy", "AllreduceStrategy",
        "--num_workers", str(num_workers), "--port", "0",
        "--checkpoint_dir", os.path.join(work_dir, f"ckpt_{tag}"),
        "--checkpoint_steps", str(cfg["checkpoint_steps"]),
        "--heartbeat_timeout_secs", "30", "--standby_workers", "0", "--envs", env,
    ]


def _load_npz(path: str) -> dict:
    import numpy as np

    with np.load(path) as z:
        return {k: z[k] for k in z.files}


def _distributed_run(
    cfg: dict, data: dict, device: str, work_dir: str, tag: str, plan=None, extra=(),
    num_workers: int = ELASTIC_WORKERS, on_build=None,
) -> dict:
    """One ``AllreduceStrategy`` job of ``cfg`` through the train CLI,
    under ``plan`` (a chaos plan, or the name of a built-in one) or none:
    returns its master, the checker's violations, the last world's final
    state dumps, the chaos event log and the wall seconds of the job."""
    import glob

    import numpy as np

    from elasticdl_tpu_torch.chaos import hooks as chaos_hooks
    from elasticdl_tpu_torch.chaos.plan import builtin_plans
    from elasticdl_tpu_torch.utils.constants import TaskType
    from elasticdl_tpu_torch.worker.lockstep import DUMP_STATE_ENV

    os.makedirs(work_dir, exist_ok=True)
    dump_dir = os.path.join(work_dir, f"dump_{tag}")
    envs = {DUMP_STATE_ENV: dump_dir}
    events = os.path.join(work_dir, f"events_{tag}.jsonl")
    if plan is not None:
        plan_path = os.path.join(work_dir, f"plan_{tag}.json")
        if isinstance(plan, str):
            plan = builtin_plans(num_workers)[plan]
        plan.save(plan_path)
        envs.update({chaos_hooks.PLAN_ENV: plan_path, chaos_hooks.EVENTS_ENV: events})
    built, build = _job_recorder(
        expected_records=cfg["train_records"] * cfg["epochs"], on_build=on_build
    )
    argv = _elastic_argv(cfg, data, device, work_dir, envs, tag, num_workers) + list(extra)
    rc, secs = _cli_job(argv, build)
    master = built["master"]
    counters = master.task_d.counters(TaskType.TRAINING)
    # the last world's processes dump at the end: a world that shrank
    # has fewer than the first
    dumps = [
        _load_npz(path)
        for path in sorted(glob.glob(os.path.join(dump_dir, "final_state_p*.npz")))
    ]
    fired = []
    if os.path.exists(events):
        with open(events) as f:
            fired = [json.loads(line) for line in f if line.strip()]
    # the first re-formed world's chief logs its restore (from peer RAM or
    # disk) on the machine-wide monotonic clock the master's detection
    # time is on
    restored_at = [
        e["monotonic"] for e in fired if e.get("cluster_version", 0) > 0
        and e.get("observation") in ("replica_restore", "checkpoint_restore")
    ]
    row = {
        "rc": rc, "job_secs": secs, "total_records": counters.total_records,
        "failed_records": counters.failed_records,
        "records_per_s_whole_job": counters.total_records / secs,
        # the last world's pace, its first task left out (its processes'
        # start and, after a re-formation, the restore)
        "steady_records_per_s": built["clock"].steady_records_per_s(
            master.reform_events[-1]["detected_at"] if master.reform_events else 0.0
        ),
        "reform_events": [
            {k: v for k, v in e.items() if k != "detected_at"} for e in master.reform_events
        ],
        # detection to the restored state: the first step-task pull (the
        # re-formation latency) comes before the trainer is built and
        # restored
        "restored_secs_after_detection": (
            restored_at[0] - master.reform_events[0]["detected_at"]
            if restored_at and master.reform_events else None
        ),
        "violations": [v.as_dict() for v in built["checker"].check(counters)],
        "fired": [e.get("fault_id") or e.get("observation") for e in fired],
        "dumps": len(dumps),
        "dumps_bitwise_equal": len(dumps) > 1 and all(
            set(d) == set(dumps[0]) and all(np.array_equal(dumps[0][k], d[k]) for k in d)
            for d in dumps[1:]
        ),
    }
    return {
        "row": row, "master": master, "dumps": dumps, "events": fired, "built": built,
        "ckpt": os.path.join(work_dir, f"ckpt_{tag}"),
    }


# one Local run (train, evaluate or predict) in this process at a time:
# distributed jobs run side by side, and a Local run holds process-wide
# state (the predictions directory's environment variable)
_LOCAL_LOCK = threading.Lock()


def _local_predict(argv: list, out_dir: str) -> None:
    """The Local predict CLI's backend with its predictions written to
    ``out_dir`` (by this script's prediction zoo)."""
    from elasticdl_tpu_torch import api
    from elasticdl_tpu_torch.utils.args import parse_master_args

    with _LOCAL_LOCK:
        os.environ[PREDICTIONS_ENV] = out_dir
        try:
            api.predict(parse_master_args(argv))
        finally:
            del os.environ[PREDICTIONS_ENV]


def _evaluate_checkpoint(cfg: dict, data: dict, device: str, ckpt: str) -> dict:
    """The port's Local evaluate CLI (``api.evaluate``, the CLI's
    backend) on a checkpoint."""
    from elasticdl_tpu_torch import api
    from elasticdl_tpu_torch.utils.args import parse_master_args

    argv = [
        "--model_def", cfg["model_def"], "--validation_data", data["eval"],
        "--minibatch_size", str(cfg["batch"]), "--records_per_task",
        str(cfg["records_per_task"]), "--checkpoint_dir_for_init", ckpt,
        "--device", device,
    ]
    if cfg["model_params"]:
        argv += ["--model_params", cfg["model_params"]]
    with _LOCAL_LOCK:
        return api.evaluate(parse_master_args(argv))


def elastic_preempt_run(work_dir: str, cfg: dict, device: str = "cuda", data=None) -> dict:
    """Phase 10a (mnist) or the first half of 10b (DeepFM): ``cfg``'s job
    under ``preempt_one_worker``, with its gates: rc 0, one re-formation
    with a latency, every record counted once (the dispatcher's total is
    epochs x records, and the checker finds no violation), the last
    world's two final states bitwise equal, and the evaluate CLI's
    accuracy on the final checkpoint above ``cfg["min_accuracy"]``.
    ``data``: ``cfg``'s shards, else made here."""
    from elasticdl_tpu_torch.parallel import elastic

    data = data or _zoo_data(work_dir, cfg)
    run = _distributed_run(cfg, data, device, work_dir, "preempt", plan="preempt_one_worker")
    row = dict(run["row"], backend=elastic.choose_backend(device, ELASTIC_WORKERS))
    results = _evaluate_checkpoint(cfg, data, device, run["ckpt"])
    row["accuracy"] = results.get(cfg["accuracy_key"])
    row["reform_latency_secs"] = (
        row["reform_events"][0].get("latency_secs") if row["reform_events"] else None
    )
    print(json.dumps({f"{cfg['name']}_preempt": row}), flush=True)
    want_records = cfg["train_records"] * cfg["epochs"]
    if (
        row["rc"] != 0 or len(row["reform_events"]) != 1
        or not row["reform_latency_secs"] or row["reform_latency_secs"] <= 0
        or row["total_records"] != want_records or row["violations"]
        or not row["dumps_bitwise_equal"]
        or row["accuracy"] is None or not row["accuracy"] > cfg["min_accuracy"]
        or row["fired"][:1] != [f"preempt-p{ELASTIC_WORKERS - 1}"]
    ):
        raise AssertionError(f"{cfg['name']}: the preempted job failed its gates: {row}")
    return {"row": row, "data": data, "ckpt": run["ckpt"]}


def elastic_parity_run(
    work_dir: str, cfg: dict, data: dict, init_ckpt: str, device: str = "cuda"
) -> dict:
    """The second half of phase 10b: a fault-free two-rank run of ``cfg``
    (one epoch) against the Local run on the same data, task order and
    global batch, both warm-started from ``init_ckpt`` (phase 10a's final
    checkpoint: from flax's initial BatchNorm, mnist turns the two runs'
    reduction-order noise of about 1e-7 a step into differences up to
    O(1) within a few steps, a trained model does not): final parameters
    and statistics within ``PARITY_RTOL``/``PARITY_ATOL``, and the two
    ranks bitwise equal."""
    import numpy as np

    from elasticdl_tpu_torch import client
    from elasticdl_tpu_torch.utils import save_utils

    cfg = dict(cfg, epochs=1)
    init = ("--checkpoint_dir_for_init", init_ckpt)
    run = _distributed_run(cfg, data, device, work_dir, "parity", extra=init)
    local_ckpt = os.path.join(work_dir, "ckpt_local")
    t0 = time.monotonic()
    with _LOCAL_LOCK:
        rc = client.main(_zoo_argv(cfg, data, device, *init) + ["--checkpoint_dir", local_ckpt])
    local_secs = time.monotonic() - t0
    local, _extra = save_utils.restore_checkpoint(local_ckpt)
    world, _extra = save_utils.restore_checkpoint(run["ckpt"])
    dump = run["dumps"][0]
    worst = {}
    for key, want in local.items():
        got = dump[key]
        worst[key] = float(np.max(np.abs(got.astype(np.float64) - want)))
        np.testing.assert_allclose(
            got.astype(np.float64), want.astype(np.float64),
            rtol=PARITY_RTOL, atol=PARITY_ATOL, err_msg=key,
        )
        if not np.array_equal(world[key], got):
            raise AssertionError(f"{key}: the world's final checkpoint is not its final state")
    row = dict(
        run["row"], local_rc=rc, local_secs=local_secs,
        local_records_per_s_whole_job=cfg["train_records"] / local_secs,
        max_abs_diff_to_local=max(worst.values()), worst_key=max(worst, key=worst.get),
    )
    print(json.dumps({f"{cfg['name']}_parity": row}), flush=True)
    if rc != 0 or row["rc"] != 0 or row["reform_events"] or not row["dumps_bitwise_equal"] \
            or row["total_records"] != cfg["train_records"]:
        raise AssertionError(f"the fault-free two-rank run failed its gates: {row}")
    return row


def _grads_recorder(trainer, into: list):
    """Wraps ``trainer.state.apply_gradients`` to keep a copy of each
    step's gradients (the all-reduced ones in a world)."""
    apply = trainer.state.apply_gradients

    def recording(grads):
        into.append({n: g.detach().clone() for n, g in grads.items() if g is not None})
        return apply(grads)

    trainer.state.apply_gradients = recording


def _lm_trainer(cfg: dict, device, process_group=None):
    import torch

    from elasticdl_tpu_torch.models import long_seq_transformer as lm
    from elasticdl_tpu_torch.parallel.distributed import SPMDTrainer
    from elasticdl_tpu_torch.trainer.step import resolve_optimizer

    model = lm.custom_model(**cfg)
    lm.init_weights(model, torch.Generator().manual_seed(0))
    return SPMDTrainer(
        model, lm.loss, resolve_optimizer(lm.optimizer), device=device,
        process_group=process_group,
    )


def _lm_batch(cfg: dict, seq: int):
    import numpy as np

    tokens = np.random.RandomState(1).randint(
        0, cfg["vocab_size"], (DP_LM_ROWS, seq + 1)
    ).astype(np.int32)
    return {"tokens": tokens[:, :-1]}, tokens[:, 1:], np.ones(DP_LM_ROWS, np.float32)


def _dp_lm_child(rank, world_size, port, device, cfg, seq, out_dir):
    """One rank of phase 10c (run by ``torch.multiprocessing``): two Adam
    steps of its rows of the LM's batch, its kernel launches per step,
    and on rank 0 the one-rank run on the whole batch it is held to.
    ``cfg`` and ``seq``: the LM's config and sequence length (passed, as
    a spawned process imports this module afresh)."""
    import torch

    from elasticdl_tpu_torch.ops import attention as attn
    from elasticdl_tpu_torch.parallel import elastic

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    world = elastic.initialize_world(f"localhost:{port}", world_size, rank, device=device)
    out = {"rank": rank, "backend": world.backend, "device": str(world.device)}
    trainer = _lm_trainer(cfg, world.device, world.group)
    trainer.broadcast_state()
    start = {n: p.detach().clone() for n, p in trainer.state.model.named_parameters()}
    grads: list = []
    _grads_recorder(trainer, grads)
    batch = _lm_batch(cfg, seq)
    out["losses"], out["launches_per_step"] = [], []
    out["step_secs"] = []
    for _ in range(DP_LM_STEPS):
        attn.reset_launch_counts()
        t0 = time.monotonic()
        placed = trainer.place_step(*batch)
        out["rows"] = int(placed[0]["tokens"].shape[0])
        out["losses"].append(float(trainer.train_step(*placed)["loss"]))  # waits
        out["step_secs"].append(time.monotonic() - t0)
        out["launches_per_step"].append(dict(attn.launch_counts))
    if rank == 0:
        ref = _lm_trainer(cfg, world.device)
        ref_grads: list = []
        _grads_recorder(ref, ref_grads)
        out["ref_losses"] = [
            float(ref.train_step(*ref.place_step(*batch))["loss"]) for _ in range(DP_LM_STEPS)
        ]
        g, h = grads[0], ref_grads[0]
        out["grad_rel_err"] = (
            sum((g[n] - h[n]).double().pow(2).sum().item() for n in h)
            / sum(h[n].double().pow(2).sum().item() for n in h)
        ) ** 0.5
        params = dict(trainer.state.model.named_parameters())
        ref_params = dict(ref.state.model.named_parameters())
        diff_sq = upd_sq = 0.0
        max_abs = 0.0
        for n, p0 in start.items():
            d = (params[n] - ref_params[n]).double()
            diff_sq += d.pow(2).sum().item()
            upd_sq += (ref_params[n] - p0).double().pow(2).sum().item()
            max_abs = max(max_abs, d.abs().max().item())
        out["update_rel_err"] = (diff_sq / upd_sq) ** 0.5
        out["param_max_abs_diff"] = max_abs
        out["lr"] = trainer.state.optimizer.param_groups[0]["lr"]
    with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
        json.dump(out, f)
    elastic.shutdown_world()


def dp_lm_run(device: str = "cuda") -> dict:
    """Phase 10c: the LM in a two-rank world (2 x 4 rows) against one
    rank on the same 8 rows, from the same seeded weights, for 2 Adam
    steps; each rank's wrappers count each flash kernel's launches per
    step (``dist_lm()["num_layers"]`` on the card; the CPU takes the plain
    path).  Returns the phase's row, with both ranks' launches."""
    import torch.multiprocessing as tmp

    from elasticdl_tpu_torch.parallel import elastic

    with tempfile.TemporaryDirectory(prefix="chip_smoke_dp_lm_") as out_dir:
        t0 = time.monotonic()
        tmp.spawn(
            _dp_lm_child,
            args=(ELASTIC_WORKERS, elastic.pick_coordinator_port(), device,
                  dist_lm(), SEQ, out_dir),
            nprocs=ELASTIC_WORKERS, join=True,
        )
        secs = time.monotonic() - t0
        ranks = []
        for rank in range(ELASTIC_WORKERS):
            with open(os.path.join(out_dir, f"rank{rank}.json")) as f:
                ranks.append(json.load(f))
    per_step = dist_lm()["num_layers"] if device == "cuda" else 0
    r0 = ranks[0]
    world_losses = [sum(r["losses"][i] for r in ranks) for i in range(DP_LM_STEPS)]
    launches = {
        name: sum(c[name] for r in ranks for c in r["launches_per_step"])
        for name in r0["launches_per_step"][0]
    }
    row = {
        "secs": secs, "backend": r0["backend"], "rows_per_rank": [r["rows"] for r in ranks],
        "world_losses": world_losses, "one_rank_losses": r0["ref_losses"],
        "grad_rel_err": r0["grad_rel_err"], "update_rel_err": r0["update_rel_err"],
        "param_max_abs_diff": r0["param_max_abs_diff"],
        "step_secs_per_rank": [r["step_secs"] for r in ranks],
        "launches_per_rank_step": [r["launches_per_step"] for r in ranks],
        "launches": launches,
    }
    print(json.dumps({"dp_lm": row}), flush=True)
    bound = 2 * r0["lr"] * DP_LM_STEPS
    if (
        any(n != per_step for r in ranks for c in r["launches_per_step"] for n in c.values())
        or row["rows_per_rank"] != [DP_LM_ROWS // ELASTIC_WORKERS] * ELASTIC_WORKERS
        or row["grad_rel_err"] > GRAD_REL_ERR
        or row["update_rel_err"] > DP_UPDATE_REL_ERR
        or not row["param_max_abs_diff"] <= bound
        or abs(world_losses[0] - r0["ref_losses"][0]) > GRAD_REL_ERR * abs(r0["ref_losses"][0])
        or len({r["backend"] for r in ranks}) != 1
    ):
        raise AssertionError(f"the two-rank LM disagrees with one rank: {row}")
    return row


# ---- phase 11: evaluate and predict in distributed jobs --------------------

# mnist at bench.py's width and step, one epoch of phase 10a's 16 384
# records (tasks of 4 steps, a checkpoint every 2), 2 048 validation
# records and an evaluation every 16 steps: milestones 16, 32, 48 and 64,
# under preempt_one_worker (process 1 SIGKILLs itself at step 6, the
# world restores version 4), with the device pipeline on
EVAL_MNIST = dict(
    MNIST, name="mnist_eval", train_records=16384, eval_records=2048, shards=8,
    records_per_task=1024, checkpoint_steps=2, epochs=1, evaluation_steps=16,
)
# DeepFM's accuracy recipe (bench.py:961-969) under one task-stream
# worker, tasks of 2048 records (4 steps); the smoke SIGKILLs the worker
# once the master has seen a version of 6 or more
TS_DEEPFM = dict(
    DEEPFM_ACCURACY, name="deepfm_task_stream", records_per_task=2048,
    checkpoint_steps=2, epochs=1, kill_at_version=6,
)
# the LM under the task-stream worker: 16 training records in 2 shards
# (tasks of 8 records, one step of 8 rows each) and 2 validation records
# in 2 shards, so that each evaluation task holds one record: one
# record's bf16 logits are 2048 x 32768 x 2 B = 128 MiB, and two would be
# over the transport's 256 MiB message cap
TS_LM_RECORDS, TS_LM_SHARDS, TS_LM_EVAL_RECORDS = 16, 2, 2
TS_LM_RECORDS_PER_TASK = 8
# the LM's two-worker prediction (8 records at 4 rows, 2 a rank) and
# evaluation (1 record a task at 2 rows, the second rank's row padding)
LM_PREDICT_RECORDS, LM_PREDICT_ROWS, LM_EVAL_ROWS = 8, 4, 2
# where the prediction zoo's processor saves each batch
PREDICTIONS_ENV = "CHIP_SMOKE_PREDICTIONS_DIR"
# full f32 convolutions and products in the worker processes, as this
# process sets them (torch.backends.*.allow_tf32): the libraries read it
TF32_OFF = {"NVIDIA_TF32_OVERRIDE": "0"}
PREDICT_MAX_ABS_ERR = 1e-5

PREDICTION_ZOO = '''"""The port's {base} with a PredictionOutputsProcessor that saves
each batch it is given as .npy under ${env} (bf16 as uint16)."""

import os

import numpy as np

from elasticdl_tpu_torch.models.{base} import *  # noqa: F401,F403
from elasticdl_tpu_torch.worker.prediction_outputs_processor import (
    BasePredictionOutputsProcessor,
)


class PredictionOutputsProcessor(BasePredictionOutputsProcessor):
    def __init__(self):
        self.batches = 0

    def process(self, predictions, worker_id):
        out = np.asarray(predictions)
        bf16 = out.dtype.name == "bfloat16"
        name = f"{{self.batches:06d}}" + (".bf16" if bf16 else "") + ".npy"
        np.save(os.path.join(os.environ["{env}"], name), out.view(np.uint16) if bf16 else out)
        self.batches += 1
'''


def write_prediction_zoo(zoo_dir: str, base: str) -> str:
    """A model zoo of one module, ``<base>_predict.py``: the port's
    ``base`` model with a processor that saves every prediction batch;
    returns the ``--model_def`` that names it."""
    os.makedirs(zoo_dir, exist_ok=True)
    with open(os.path.join(zoo_dir, f"{base}_predict.py"), "w") as f:
        f.write(PREDICTION_ZOO.format(base=base, env=PREDICTIONS_ENV))
    return f"{base}_predict.custom_model"


def load_predictions(out_dir: str) -> list:
    """The batches a prediction processor saved, in order."""
    import ml_dtypes
    import numpy as np

    out = []
    for name in sorted(os.listdir(out_dir)):
        arr = np.load(os.path.join(out_dir, name))
        out.append(arr.view(ml_dtypes.bfloat16) if name.endswith(".bf16.npy") else arr)
    return out


def eval_milestones(cfg: dict) -> list:
    """The versions at which ``cfg``'s job queues an evaluation: each
    crossing of an ``evaluation_steps`` milestone by the versions its
    task boundaries report (a task is a whole number of steps)."""
    steps = cfg["train_records"] * cfg["epochs"] // cfg["batch"]
    return list(range(cfg["evaluation_steps"], steps + 1, cfg["evaluation_steps"]))


def _dist_flags(num_workers: int, envs: dict) -> list:
    return [
        "--distribution_strategy", "AllreduceStrategy", "--num_workers", str(num_workers),
        "--port", "0", "--heartbeat_timeout_secs", "30", "--standby_workers", "0",
        "--envs", ",".join(f"{k}={v}" for k, v in envs.items()),
    ]


def _launches(out_dir: str) -> dict:
    """Each worker's kernel launches, as its launch dump holds them."""
    out = {}
    for name in sorted(os.listdir(out_dir)):
        if name.startswith("launches_"):
            with open(os.path.join(out_dir, name)) as f:
                out[name[len("launches_"):-len(".json")]] = json.load(f)
    return out


def eval_preempt_run(work_dir: str, cfg: dict, device: str = "cuda") -> dict:
    """Phase 11a: ``cfg``'s two-rank job with validation data, the
    device pipeline on and ``preempt_one_worker``.  Gates: rc 0, one
    re-formation, training records exactly epochs x records, no invariant
    violation, the last world's ranks bitwise equal and each with staged
    groups, every evaluation round's rows exactly the validation set's,
    the rounds' milestones those of :func:`eval_milestones`, and the
    final round, at the final checkpoint's version, within one record of
    the Local evaluate CLI on that checkpoint and above
    ``cfg["min_accuracy"]``."""
    from elasticdl_tpu_torch.chaos import hooks as chaos_hooks
    from elasticdl_tpu_torch.chaos.plan import builtin_plans
    from elasticdl_tpu_torch.parallel import elastic
    from elasticdl_tpu_torch.utils import save_utils
    from elasticdl_tpu_torch.utils.constants import TaskType
    from elasticdl_tpu_torch.worker.lockstep import DUMP_STATE_ENV

    import numpy as np

    os.makedirs(work_dir, exist_ok=True)
    data = _zoo_data(work_dir, cfg)
    plan_path = os.path.join(work_dir, "plan.json")
    builtin_plans(ELASTIC_WORKERS)["preempt_one_worker"].save(plan_path)
    dump_dir = os.path.join(work_dir, "dump")
    envs = {
        DUMP_STATE_ENV: dump_dir, chaos_hooks.PLAN_ENV: plan_path,
        chaos_hooks.EVENTS_ENV: os.path.join(work_dir, "events.jsonl"), **TF32_OFF,
    }
    expected = cfg["train_records"] * cfg["epochs"]
    built, build = _job_recorder(expected_records=expected)
    argv = _elastic_argv(cfg, data, device, work_dir, envs, "eval") + [
        "--validation_data", data["eval"],
        "--evaluation_steps", str(cfg["evaluation_steps"]), "--device_prefetch", "true",
    ]
    rc, secs = _cli_job(argv, build)
    master = built["master"]
    ckpt = os.path.join(work_dir, "ckpt_eval")
    _state, extra = save_utils.restore_checkpoint(ckpt)
    dumps = [_load_npz(os.path.join(dump_dir, f"final_state_p{p}.npz")) for p in range(ELASTIC_WORKERS)]
    # worker ids are claimed in order: the last world's are the last ones
    first_id = ELASTIC_WORKERS * len(master.reform_events)
    prefetch = master.servicer.prefetch_stats()
    staged = [prefetch.get(w, {}).get("groups", 0) for w in range(first_id, first_id + ELASTIC_WORKERS)]
    rounds = built["rounds"]
    final = master.job_summary().get("evaluation_metrics", {})
    local = _evaluate_checkpoint(cfg, data, device, ckpt)
    key = cfg["accuracy_key"]
    row = {
        "rc": rc, "job_secs": secs, "backend": elastic.choose_backend(device, ELASTIC_WORKERS),
        "total_records": master.task_d.counters(TaskType.TRAINING).total_records,
        "eval_records": master.task_d.counters(TaskType.EVALUATION).total_records,
        "records_per_s_whole_job": expected / secs,
        "reforms": len(master.reform_events),
        "reform_latency_secs": master.reform_events[0].get("latency_secs") if master.reform_events else None,
        "violations": [v.as_dict() for v in built["checker"].check(master.task_d.counters(TaskType.TRAINING))],
        "dumps_bitwise_equal": all(np.array_equal(dumps[0][k], dumps[1][k]) for k in dumps[0]),
        "staged_groups_last_world": staged,
        "rounds": [
            {"milestone": r["summary"].get("model_version"),
             "evaluated_version": r["summary"].get("evaluated_version"),
             "accuracy": r["summary"].get(key), "rows": r["rows"]} for r in rounds
        ],
        "round_secs": [b["at"] - a["at"] for a, b in zip(rounds, rounds[1:])],
        "largest_report": built["largest_report"],
        "final": final, "final_checkpoint_version": extra.get("model_version"),
        "local_accuracy": local.get(key),
    }
    print(json.dumps({f"{cfg['name']}_preempt": row}), flush=True)
    if (
        rc != 0 or row["reforms"] != 1 or row["total_records"] != expected or row["violations"]
        or not row["dumps_bitwise_equal"] or not all(n > 0 for n in staged)
        or any(r["rows"] != cfg["eval_records"] for r in row["rounds"])
        or row["eval_records"] != cfg["eval_records"] * len(rounds)
        or sorted(r["milestone"] for r in row["rounds"]) != eval_milestones(cfg)
        or final.get("evaluated_version") != row["final_checkpoint_version"]
        or final.get(key) is None or row["local_accuracy"] is None
        or abs(final[key] - row["local_accuracy"]) > 1.0 / cfg["eval_records"] + 1e-12
        or not final[key] > cfg["min_accuracy"]
    ):
        raise AssertionError(f"{cfg['name']}: the evaluating job failed its gates: {row}")
    return {"row": row, "data": data, "ckpt": ckpt, "final": final}


def eval_predict_run(
    work_dir: str, cfg: dict, data: dict, ckpt: str, final: dict, device: str = "cuda"
) -> dict:
    """Phase 11b: two-worker ``evaluate`` and ``predict`` of ``cfg`` on
    phase 11a's final checkpoint.  The evaluation equals 11a's final round
    (the same world layout on the same weights); every prediction record
    comes back once, within ``PREDICT_MAX_ABS_ERR`` of the Local predict
    CLI at the rows a rank holds."""
    import numpy as np

    from elasticdl_tpu_torch.utils.constants import TaskType

    key = cfg["accuracy_key"]
    common = [
        "--validation_data", data["eval"], "--minibatch_size", str(cfg["batch"]),
        "--records_per_task", str(cfg["records_per_task"]),
        "--checkpoint_dir_for_init", ckpt, "--device", device,
    ]
    built, build = _job_recorder()
    rc_eval, eval_secs = _cli_job(
        ["evaluate", "--model_def", cfg["model_def"], *common,
         *_dist_flags(ELASTIC_WORKERS, TF32_OFF)], build,
    )
    summary = built["master"].job_summary().get("evaluation_metrics", {})
    zoo = os.path.join(work_dir, "zoo")
    model_def = write_prediction_zoo(zoo, "mnist_functional_api")
    world_out, local_out = os.path.join(work_dir, "pred_world"), os.path.join(work_dir, "pred_local")
    os.makedirs(world_out)
    os.makedirs(local_out)
    pred = [
        "--model_zoo", zoo, "--model_def", model_def, "--prediction_data", data["eval"],
        "--records_per_task", str(cfg["records_per_task"]),
        "--checkpoint_dir_for_init", ckpt, "--device", device,
    ]
    built_p, build_p = _job_recorder()
    rc_pred, pred_secs = _cli_job(
        ["predict", *pred, "--minibatch_size", str(cfg["batch"]),
         *_dist_flags(ELASTIC_WORKERS, {PREDICTIONS_ENV: world_out, **TF32_OFF})], build_p,
    )
    # a rank's rows a call, so that each convolution sees the shapes a
    # rank's did
    _local_predict([*pred, "--minibatch_size", str(cfg["batch"] // ELASTIC_WORKERS)], local_out)
    world = np.concatenate(load_predictions(world_out))
    local = np.concatenate(load_predictions(local_out))
    row = {
        "rc_evaluate": rc_eval, "evaluate_secs": eval_secs, "evaluation": summary,
        "evaluate_records_per_s": cfg["eval_records"] / eval_secs,
        "rc_predict": rc_pred, "predict_secs": pred_secs,
        "predict_records_per_s": cfg["eval_records"] / pred_secs,
        "predicted_rows": int(world.shape[0]),
        "prediction_records": built_p["master"].task_d.counters(TaskType.PREDICTION).total_records,
        "max_abs_err_to_local": float(np.max(np.abs(world - local))) if world.shape == local.shape else None,
    }
    print(json.dumps({f"{cfg['name']}_evaluate_predict": row}), flush=True)
    if (
        rc_eval != 0 or rc_pred != 0 or summary.get(key) != final[key]
        or row["predicted_rows"] != cfg["eval_records"]
        or row["prediction_records"] != cfg["eval_records"]
        or row["max_abs_err_to_local"] is None
        or row["max_abs_err_to_local"] > PREDICT_MAX_ABS_ERR
    ):
        raise AssertionError(f"{cfg['name']}: evaluate or predict failed its gates: {row}")
    return row


def task_stream_zoo_run(work_dir: str, cfg: dict, device: str = "cuda") -> dict:
    """Phase 11c, first job: ``cfg`` under one task-stream worker with
    validation data, its process SIGKILLed at the first version report at
    or past ``cfg["kill_at_version"]``.  Gates: rc 0, exactly one
    relaunch under a new worker id, the dead worker's leases re-queued,
    training records exactly epochs x records (each task once), and the
    master's final evaluation above ``cfg["min_accuracy"]``."""
    from elasticdl_tpu_torch.utils.constants import TaskType

    data = _zoo_data(work_dir, cfg)
    expected = cfg["train_records"] * cfg["epochs"]
    built, build = _job_recorder(expected_records=expected, kill_at_version=cfg["kill_at_version"])
    argv = _zoo_argv(cfg, data, device) + [
        "--num_epochs", str(cfg["epochs"]), "--validation_data", data["eval"],
        "--checkpoint_dir", os.path.join(work_dir, "ckpt"),
        "--checkpoint_steps", str(cfg["checkpoint_steps"]), *_dist_flags(1, TF32_OFF),
    ]
    rc, secs = _cli_job(argv, build)
    master = built["master"]
    relaunches = master.relaunch_events
    final = master.job_summary().get("evaluation_metrics", {})
    row = {
        "rc": rc, "job_secs": secs, "records_per_s_whole_job": expected / secs,
        "killed": {k: v for k, v in (built["killed"] or {}).items() if k != "at"},
        "relaunches": [{k: v for k, v in e.items() if k != "detected_at"} for e in relaunches],
        "requeued_leases": built["clock"].failed_reports,
        "total_records": master.task_d.counters(TaskType.TRAINING).total_records,
        "violations": [v.as_dict() for v in built["checker"].check(master.task_d.counters(TaskType.TRAINING))],
        "rounds": [r["rows"] for r in built["rounds"]], "final": final,
    }
    print(json.dumps({f"{cfg['name']}_killed": row}), flush=True)
    killed = built["killed"]
    if (
        rc != 0 or killed is None or len(relaunches) != 1
        or relaunches[0]["dead_worker"] != killed["worker_id"]
        or relaunches[0]["worker_id"] == killed["worker_id"]
        or relaunches[0].get("latency_secs") is None
        or row["requeued_leases"] < 1 or row["total_records"] != expected or row["violations"]
        or row["rounds"] != [cfg["eval_records"]]
        or not final.get(cfg["accuracy_key"], 0.0) > cfg["min_accuracy"]
    ):
        raise AssertionError(f"{cfg['name']}: the task-stream job failed its gates: {row}")
    return row


def _lm_data_11(work_dir: str) -> dict:
    """Phase 6's kind of shards and warm start, at phase 11's counts."""
    from elasticdl_tpu_torch.data.recordio_gen.synthetic import gen_sequence

    data = _local_data(work_dir, records=TS_LM_RECORDS, shards=TS_LM_SHARDS, lm_cfg=dist_lm())
    vocab = dist_lm()["vocab_size"]
    data["eval"] = gen_sequence(
        os.path.join(work_dir, "eval_one"), num_records=TS_LM_EVAL_RECORDS,
        num_shards=TS_LM_EVAL_RECORDS, seed=1, seq_len=SEQ, vocab=vocab,
    )
    data["predict"] = gen_sequence(
        os.path.join(work_dir, "predict"), num_records=LM_PREDICT_RECORDS,
        num_shards=1, seed=2, seq_len=SEQ, vocab=vocab,
    )
    return data


def _lm_flags(data: dict, device: str) -> list:
    return [
        "--model_params", ";".join(f"{k}={v}" for k, v in dist_lm().items()),
        "--records_per_task", str(TS_LM_RECORDS_PER_TASK), "--device", device,
    ]


def task_stream_lm_run(work_dir: str, device: str = "cuda") -> dict:
    """Phase 11c, the LM: ``train --num_workers 1`` with validation data,
    warm-started from phase 6's seeded weights, against the Local run of
    the same data and flags: the final weights bit for bit, and the
    worker's launches ``dist_lm()["num_layers"]`` (0 on the CPU) per step
    of each kernel and of the forward per evaluation batch.  Then
    two-worker ``predict`` (rows within phase 4's served tolerance of
    Local's) and ``evaluate`` (accuracy within 1e-3 of Local's) from the
    worker's final checkpoint, as many forward launches per batch on
    each rank.  Returns the phase's row, with every worker's launches."""
    import numpy as np
    import torch

    from elasticdl_tpu_torch import api, client
    from elasticdl_tpu_torch.ops.attention import LAUNCH_DUMP_ENV
    from elasticdl_tpu_torch.utils import save_utils
    from elasticdl_tpu_torch.utils.args import parse_master_args
    from elasticdl_tpu_torch.utils.constants import TaskType

    per = dist_lm()["num_layers"] if device == "cuda" else 0
    data = _lm_data_11(work_dir)
    steps = TS_LM_RECORDS // TRAIN_ROWS
    # (a) one task-stream worker against Local
    launch_dir = os.path.join(work_dir, "launches_train")
    ts_ckpt, local_ckpt = os.path.join(work_dir, "ckpt_ts"), os.path.join(work_dir, "ckpt_local")
    built, build = _job_recorder(expected_records=TS_LM_RECORDS)
    rc, secs = _cli_job(
        _local_argv(data, device, records_per_task=TS_LM_RECORDS_PER_TASK, lm_cfg=dist_lm()) + [
            "--validation_data", data["eval"], "--checkpoint_dir", ts_ckpt,
            *_dist_flags(1, {LAUNCH_DUMP_ENV: launch_dir}),
        ], build,
    )
    master = built["master"]
    reports = [t for t, _n in built["clock"].reports]
    t0 = time.monotonic()
    with _LOCAL_LOCK:
        rc_local = client.main(_local_argv(
            data, device, records_per_task=TS_LM_RECORDS_PER_TASK, lm_cfg=dist_lm(),
        ) + [
            "--validation_data", data["eval"], "--checkpoint_dir", local_ckpt,
        ])
    local_secs = time.monotonic() - t0
    got, got_extra = save_utils.restore_checkpoint(ts_ckpt)
    want, want_extra = save_utils.restore_checkpoint(local_ckpt)
    differing = sorted(k for k in want if k not in got or not np.array_equal(got[k], want[k]))
    train_launches = _launches(launch_dir)
    ts_row = {
        "rc": rc, "job_secs": secs, "local_rc": rc_local, "local_secs": local_secs,
        "tokens_per_s_whole_job": TS_LM_RECORDS * SEQ / secs,
        # a task is one step: the seconds between its reports are a step's
        # and a task's bookkeeping
        "secs_between_task_reports": [b - a for a, b in zip(reports, reports[1:])],
        "versions": [got_extra.get("model_version"), want_extra.get("model_version")],
        "total_records": master.task_d.counters(TaskType.TRAINING).total_records,
        "violations": [v.as_dict() for v in built["checker"].check(master.task_d.counters(TaskType.TRAINING))],
        "eval_rounds": [r["rows"] for r in built["rounds"]],
        "largest_report": built["largest_report"],
        "weights_differing": differing, "launches": train_launches,
    }
    print(json.dumps({"lm_task_stream": ts_row}), flush=True)
    want_launches = {
        "flash_fwd": per * (steps + TS_LM_EVAL_RECORDS),
        "flash_bwd_dq": per * steps, "flash_bwd_dkv": per * steps,
    }
    if (
        rc != 0 or rc_local != 0 or differing or set(got) != set(want)
        or ts_row["versions"] != [steps, steps] or ts_row["total_records"] != TS_LM_RECORDS
        or ts_row["violations"] or ts_row["eval_rounds"] != [TS_LM_EVAL_RECORDS]
        or list(train_launches.values()) != [want_launches]
    ):
        raise AssertionError(f"the task-stream LM failed its gates: {ts_row}")
    del got, want
    gc.collect()

    # (b) two-worker prediction against Local, from the worker's checkpoint
    zoo = os.path.join(work_dir, "zoo")
    model_def = write_prediction_zoo(zoo, "long_seq_transformer")
    world_out, local_out = os.path.join(work_dir, "pred_world"), os.path.join(work_dir, "pred_local")
    os.makedirs(world_out)
    os.makedirs(local_out)
    predict_launches_dir = os.path.join(work_dir, "launches_predict")
    pred = [
        "--model_zoo", zoo, "--model_def", model_def, "--prediction_data", data["predict"],
        "--minibatch_size", str(LM_PREDICT_ROWS), "--checkpoint_dir_for_init", ts_ckpt,
        *_lm_flags(data, device),
    ]
    built_p, build_p = _job_recorder()
    rc_pred, pred_secs = _cli_job(
        ["predict", *pred, *_dist_flags(ELASTIC_WORKERS, {
            PREDICTIONS_ENV: world_out, LAUNCH_DUMP_ENV: predict_launches_dir,
        })], build_p,
    )
    _local_predict(pred, local_out)
    worst_max, worst_mean, rows = 0.0, 0.0, 0
    world_batches, local_batches = load_predictions(world_out), load_predictions(local_out)
    dev = torch.device(device)
    for a, b in zip(world_batches, local_batches):
        if a.shape != b.shape:
            raise AssertionError(f"prediction batches of {a.shape} and {b.shape}")
        ta = torch.from_numpy(a.astype(np.float32)).to(dev)
        tb = torch.from_numpy(b.astype(np.float32)).to(dev)
        err = (ta - tb).abs()
        worst_max = max(worst_max, float(err.max()))
        worst_mean = max(worst_mean, float(err.mean()))
        rows += a.shape[0]
        del ta, tb, err
    predict_launches = _launches(predict_launches_dir)
    batches = LM_PREDICT_RECORDS // LM_PREDICT_ROWS
    pred_row = {
        "rc": rc_pred, "job_secs": pred_secs, "records_per_s": LM_PREDICT_RECORDS / pred_secs,
        "rows": rows, "batches": [len(world_batches), len(local_batches)],
        "prediction_records": built_p["master"].task_d.counters(TaskType.PREDICTION).total_records,
        "max_err": worst_max, "mean_err": worst_mean, "launches": predict_launches,
    }
    print(json.dumps({"lm_predict_two_workers": pred_row}), flush=True)
    if (
        rc_pred != 0 or rows != LM_PREDICT_RECORDS or pred_row["batches"] != [batches, batches]
        or pred_row["prediction_records"] != LM_PREDICT_RECORDS
        or worst_max > ROW_MAX_ERR or worst_mean > ROW_MEAN_ERR
        or len(predict_launches) != ELASTIC_WORKERS
        or any(c != {"flash_fwd": per * batches, "flash_bwd_dq": 0, "flash_bwd_dkv": 0}
               for c in predict_launches.values())
    ):
        raise AssertionError(f"the two-worker LM prediction failed its gates: {pred_row}")
    del world_batches, local_batches
    gc.collect()

    # (c) two-worker evaluation against Local, one record a task
    eval_launches_dir = os.path.join(work_dir, "launches_eval")
    ev = [
        "--model_def", LM_DEF, "--validation_data", data["eval"],
        "--minibatch_size", str(LM_EVAL_ROWS), "--checkpoint_dir_for_init", ts_ckpt,
        *_lm_flags(data, device),
    ]
    built_e, build_e = _job_recorder()
    rc_eval, eval_secs = _cli_job(
        ["evaluate", *ev, *_dist_flags(ELASTIC_WORKERS, {LAUNCH_DUMP_ENV: eval_launches_dir})],
        build_e,
    )
    summary = built_e["master"].job_summary().get("evaluation_metrics", {})
    with _LOCAL_LOCK:
        local = api.evaluate(parse_master_args(ev))
    eval_launches = _launches(eval_launches_dir)
    eval_row = {
        "rc": rc_eval, "job_secs": eval_secs, "records_per_s": TS_LM_EVAL_RECORDS / eval_secs,
        "accuracy": summary.get("accuracy"), "local_accuracy": local.get("accuracy"),
        "rounds": [r["rows"] for r in built_e["rounds"]],
        "largest_report": built_e["largest_report"], "launches": eval_launches,
    }
    print(json.dumps({"lm_evaluate_two_workers": eval_row}), flush=True)
    if (
        rc_eval != 0 or eval_row["accuracy"] is None or eval_row["local_accuracy"] is None
        or abs(eval_row["accuracy"] - eval_row["local_accuracy"]) > 1e-3
        or eval_row["rounds"] != [TS_LM_EVAL_RECORDS]
        or len(eval_launches) != ELASTIC_WORKERS
        or any(c != {"flash_fwd": per * TS_LM_EVAL_RECORDS, "flash_bwd_dq": 0, "flash_bwd_dkv": 0}
               for c in eval_launches.values())
    ):
        raise AssertionError(f"the two-worker LM evaluation failed its gates: {eval_row}")
    launches = {
        name: sum(c[name] for part in (train_launches, predict_launches, eval_launches)
                  for c in part.values())
        for name in want_launches
    }
    return {"task_stream": ts_row, "predict": pred_row, "evaluate": eval_row, "launches": launches}


# ---- phase 12: peer replication and hot restore ---------------------------

# mnist at bench.py's width and step, phase 10's 16 384 records for one
# epoch (64 steps), tasks of 1024 records (4 steps), with --replication
# (a push at every task boundary) and a disk checkpoint every 16 steps
REPLICA_MNIST = dict(
    ELASTIC_MNIST, name="mnist_replica", checkpoint_steps=16, epochs=1,
    min_accuracy=0.99,
)
REPLICATION = ("--replication", "true")
# (a) preempt_after_replication's SIGKILL of process 1 one step after the
# push of version 20, which lies past the disk checkpoint of 16 and
# before the next: the replica is strictly newer than the disk
REPLICA_KILL_STEP = 21
# (b) kill_during_replication: process 1 dies inside its push of version
# 24, after committing it locally; the newest complete set is 20
REPLICA_TORN_STEP = 24


def replication_plan(name: str, at_step: int):
    """The built-in plan ``name`` (``chaos/plan.py``) with its fault armed
    at ``at_step``: the step fits this phase's tasks of 4 steps."""
    import dataclasses

    from elasticdl_tpu_torch.chaos.plan import builtin_plans

    plan = builtin_plans(ELASTIC_WORKERS)[name]
    return dataclasses.replace(
        plan, faults=[dataclasses.replace(f, at_step=at_step) for f in plan.faults]
    )


def _observed(events: list, what: str) -> list:
    return [e for e in events if e.get("observation") == what]


def _restored_from(events: list) -> str:
    """Where the re-formed world's state came from, as its chief logged it."""
    for e in events:
        if e.get("observation") == "replica_restore":
            return f"replica@{e['step']}"
        if e.get("observation") == "checkpoint_restore":
            return f"disk@{e['version']}"
    return "initial weights"


def _last_push_is_the_final_state(run: dict) -> bool:
    """The chief's last push (at the last task boundary) carries the
    state its process dumped at the end of the job, bit for bit: the
    snapshot saw the finished step."""
    from elasticdl_tpu_torch.replication import blob

    pushes = [e for e in _observed(run["events"], "replica_push") if e["process_id"] == 0]
    final = blob.blob_checksum(blob.encode_snapshot(run["dumps"][0], {}))
    return bool(pushes) and pushes[-1]["checksum"] == final


def _push_costs(pushes: list) -> dict:
    """The chief's pushes (the shards that carry the state): the median
    and the largest of each part of one push, and the blob's bytes."""
    out = {"pushes": len(pushes), "bytes": sorted({e["bytes"] for e in pushes})}
    for part in ("snapshot_ms", "encode_ms", "send_ms"):
        values = [e[part] for e in pushes]
        out[part] = {"median": statistics.median(values), "max": max(values)} if values else None
    return out


def replica_preempt_run(work_dir: str, cfg: dict, device: str = "cuda", data=None) -> dict:
    """Phase 12a: ``cfg``'s two-rank job with ``--replication`` under
    ``preempt_after_replication`` armed at ``REPLICA_KILL_STEP``.  Gates:
    rc 0, one re-formation whose harvest staged the last accepted push's
    version; the re-formed world restored that version from peer RAM
    (``replication_no_lost_steps``: PASS; no disk read), with the CRC of
    the pushed shard; every record once; ranks bitwise equal; accuracy
    >= ``cfg["min_accuracy"]`` from the evaluate CLI on the final
    checkpoint.  Returns the row, with the costs of (c).  ``data``:
    ``cfg``'s shards, else made here."""
    from elasticdl_tpu_torch.chaos.invariants import check_replication_no_lost_steps

    data = data or _zoo_data(work_dir, cfg)
    plan = replication_plan("preempt_after_replication", REPLICA_KILL_STEP)
    run = _distributed_run(cfg, data, device, work_dir, "hot", plan=plan, extra=REPLICATION)
    events, row = run["events"], dict(run["row"])
    kill = next(e for e in events if e.get("fault_id"))
    pushed = [e for e in _observed(events, "replica_push") if e["monotonic"] <= kill["monotonic"]]
    accepted = [e["step"] for e in pushed if e["ok"]]
    last = {p: max((e["step"] for e in pushed if e["process_id"] == p and e["ok"]), default=None)
            for p in range(ELASTIC_WORKERS)}
    chief_push = next((e for e in pushed if e["process_id"] == 0 and e["step"] == last[0]), {})
    restores = _observed(events, "replica_restore")
    harvest = row["reform_events"][0].get("harvest", {}) if row["reform_events"] else {}
    row.update(
        kill_step=kill["step"], last_accepted_push=last,
        pushes_before_kill=len(pushed), harvest=harvest, restored_from=_restored_from(events),
        restore=restores[0] if restores else None,
        pushed_checksum=chief_push.get("checksum"),
        no_lost_steps=check_replication_no_lost_steps(events),
        push_costs=_push_costs([e for e in pushed if e["process_id"] == 0]),
        reform_latency_secs=(
            row["reform_events"][0].get("latency_secs") if row["reform_events"] else None
        ),
        coverage=run["master"].job_summary().get("replication"),
        last_push_is_final_state=_last_push_is_the_final_state(run),
    )
    row["accuracy"] = _evaluate_checkpoint(cfg, data, device, run["ckpt"]).get(cfg["accuracy_key"])
    print(json.dumps({"replica_hot_restore": row}), flush=True)
    want_records = cfg["train_records"] * cfg["epochs"]
    version = REPLICA_KILL_STEP - 1
    restore = row["restore"] or {}
    if (
        row["rc"] != 0 or len(row["reform_events"]) != 1 or kill["step"] != REPLICA_KILL_STEP
        or last != {p: version for p in range(ELASTIC_WORKERS)}
        or not harvest.get("complete") or harvest.get("version") != version
        or row["restored_from"] != f"replica@{version}" or len(restores) != 1
        or _observed(events, "checkpoint_restore")
        or (row["no_lost_steps"] or {}).get("status") != "PASS"
        or not restore.get("restored_checksum")
        or not restore["restored_checksum"] == restore["checksum"] == harvest.get("checksum")
        == row["pushed_checksum"]
        or row["total_records"] != want_records or row["violations"]
        or not row["dumps_bitwise_equal"] or not row["last_push_is_final_state"]
        or row["accuracy"] is None or row["accuracy"] < cfg["min_accuracy"]
        or version not in accepted
    ):
        raise AssertionError(f"{cfg['name']}: the hot restore failed its gates: {row}")
    return {"row": row, "data": data}


def replica_torn_run(work_dir: str, cfg: dict, data: dict, device: str = "cuda") -> dict:
    """Phase 12b: the same job under ``kill_during_replication`` armed at
    ``REPLICA_TORN_STEP``.  Gates: rc 0, one re-formation whose harvest
    skipped the torn version and staged the older complete set (20, newer
    than the disk's 16), the world restored from it, and every record
    once.  Prints where the restored state came from."""
    plan = replication_plan("kill_during_replication", REPLICA_TORN_STEP)
    run = _distributed_run(cfg, data, device, work_dir, "torn", plan=plan, extra=REPLICATION)
    events, row = run["events"], dict(run["row"])
    kill = next(e for e in events if e.get("fault_id"))
    torn = [e for e in _observed(events, "replica_push")
            if e["step"] == REPLICA_TORN_STEP and e["cluster_version"] == 0]
    harvest = row["reform_events"][0].get("harvest", {}) if row["reform_events"] else {}
    row.update(
        kill=kill, harvest=harvest, restored_from=_restored_from(events),
        torn_pushes_by=[e["process_id"] for e in torn],
    )
    print(json.dumps({"replica_torn_push": row}), flush=True)
    want = REPLICA_TORN_STEP - 4
    if (
        row["rc"] != 0 or len(row["reform_events"]) != 1
        or (kill.get("phase"), kill.get("step")) != ("replica_push", REPLICA_TORN_STEP)
        or row["torn_pushes_by"] != [0]
        or harvest.get("version") != want or row["restored_from"] != f"replica@{want}"
        or row["total_records"] != cfg["train_records"] * cfg["epochs"] or row["violations"]
        or not row["dumps_bitwise_equal"]
    ):
        raise AssertionError(f"{cfg['name']}: the torn push failed its gates: {row}")
    return row


def replica_cost_run(
    work_dir: str, cfg: dict, data: dict, hot: dict, disk: dict, device: str = "cuda"
) -> dict:
    """Phase 12c: the fault-free job's records/s without and with
    ``--replication`` (same data, flags and seed, in that order; both
    with ``--device_prefetch true``, whose stager's stream is busy at the
    boundaries the snapshots are taken at), beside (a)'s push, harvest,
    restore and re-formation costs and phase 10's disk-path
    re-formation (``disk``: phase 10a's row).  Gates: rc 0, no re-formation and every record once in
    both; every push of the replicated run accepted, its last one the
    final state bit for bit."""
    rates = {}
    for tag, extra in (("plain", ()), ("replicated", REPLICATION)):
        # the plan without a fault, for the replicated run's event log
        plan = "none" if extra else None
        run = _distributed_run(
            cfg, data, device, work_dir, f"ff_{tag}", plan=plan,
            extra=("--device_prefetch", "true", *extra),
        )
        r = run["row"]
        pushes = _observed(run["events"], "replica_push")
        rates[tag] = {
            "rc": r["rc"], "job_secs": r["job_secs"], "reforms": len(r["reform_events"]),
            "total_records": r["total_records"],
            "records_per_s_whole_job": r["records_per_s_whole_job"],
            "steady_records_per_s": r["steady_records_per_s"],
            "pushes": len(pushes), "pushes_accepted": sum(e["ok"] for e in pushes),
            "last_push_is_final_state": _last_push_is_the_final_state(run) if extra else None,
        }
    row = {
        "fault_free": rates, "push": hot["push_costs"],
        "harvest_secs": hot["harvest"].get("secs"), "harvest_bytes": hot["harvest"].get("bytes"),
        "restore_ms": (hot["restore"] or {}).get("restore_ms"),
        "reform_latency_secs": hot["reform_latency_secs"],
        "restored_secs_after_detection": hot["restored_secs_after_detection"],
        "phase10_disk": {
            k: disk.get(k) for k in ("reform_latency_secs", "restored_secs_after_detection")
        },
    }
    print(json.dumps({"replica_costs": row}), flush=True)
    want = cfg["train_records"] * cfg["epochs"]
    if any(r["rc"] != 0 or r["reforms"] or r["total_records"] != want for r in rates.values()) \
            or rates["replicated"]["pushes"] == 0 \
            or rates["replicated"]["pushes_accepted"] != rates["replicated"]["pushes"] \
            or not rates["replicated"]["last_push_is_final_state"]:
        raise AssertionError(f"the fault-free replication runs failed their gates: {row}")
    return row


def replica_lm_run(work_dir: str, device: str = "cuda") -> dict:
    """Phase 12d: the LM at full width in two ranks with
    ``--replication``, 2 tasks of one step.  The chief's share (every
    f32 weight, ~0.5 GB) is over the transport's 256 MiB message cap:
    each of its pushes is refused by its client (``RESOURCE_EXHAUSTED``)
    and counted, and the job goes on; the other rank's share is empty
    until sharded tables come, and its pushes are accepted.  Gates: rc 0,
    every record once, no re-formation, each chief push refused by the
    cap exactly when its shard is over it (on the card every one is, and
    none is accepted), and 12 launches of each kernel per step on each
    rank (``GPT2S["num_layers"]``; 0 on the CPU)."""
    from elasticdl_tpu_torch.chaos import hooks as chaos_hooks
    from elasticdl_tpu_torch.chaos.invariants import read_event_log
    from elasticdl_tpu_torch.chaos.plan import builtin_plans
    from elasticdl_tpu_torch.ops.attention import LAUNCH_DUMP_ENV
    from elasticdl_tpu_torch.rpc.service import MAX_MESSAGE_BYTES
    from elasticdl_tpu_torch.utils.constants import TaskType

    per = GPT2S["num_layers"] if device == "cuda" else 0
    data = _local_data(work_dir, records=TS_LM_RECORDS, shards=TS_LM_SHARDS)
    steps = TS_LM_RECORDS // TRAIN_ROWS
    launch_dir = os.path.join(work_dir, "launches")
    events = os.path.join(work_dir, "events.jsonl")
    plan = os.path.join(work_dir, "plan.json")
    builtin_plans(ELASTIC_WORKERS)["none"].save(plan)
    envs = {LAUNCH_DUMP_ENV: launch_dir, chaos_hooks.PLAN_ENV: plan, chaos_hooks.EVENTS_ENV: events}
    built, build = _job_recorder(expected_records=TS_LM_RECORDS)
    rc, secs = _cli_job(
        _local_argv(data, device, records_per_task=TS_LM_RECORDS_PER_TASK)
        + [*REPLICATION, *_dist_flags(ELASTIC_WORKERS, envs)], build,
    )
    master = built["master"]
    counters = master.task_d.counters(TaskType.TRAINING)
    pushes = _observed(read_event_log(events), "replica_push")
    chief = [e for e in pushes if e["process_id"] == 0]
    launches = _launches(launch_dir)
    row = {
        "rc": rc, "job_secs": secs, "total_records": counters.total_records,
        "violations": [v.as_dict() for v in built["checker"].check(counters)],
        "reforms": len(master.reform_events),
        "chief_pushes": [{k: e[k] for k in ("step", "ok", "reason", "bytes", "snapshot_ms",
                                            "encode_ms", "send_ms")} for e in chief],
        "other_pushes_accepted": [e["ok"] for e in pushes if e["process_id"] != 0],
        "launches": launches,
    }
    print(json.dumps({"replica_lm": row}), flush=True)
    want_launches = {name: per * steps for name in FLASH_NAMES}
    over_cap = [e["bytes"] > MAX_MESSAGE_BYTES for e in chief]
    if (
        rc != 0 or row["total_records"] != TS_LM_RECORDS or row["violations"] or row["reforms"]
        or len(chief) != steps or (device == "cuda" and not all(over_cap))
        or any(e["ok"] == over or (e["reason"] == "RESOURCE_EXHAUSTED") != over
               for e, over in zip(chief, over_cap))
        or not all(row["other_pushes_accepted"]) or len(row["other_pushes_accepted"]) != steps
        or len(launches) != ELASTIC_WORKERS
        or any(c != want_launches for c in launches.values())
    ):
        raise AssertionError(f"the replicated LM failed its gates: {row}")
    row["launches"] = {name: sum(c[name] for c in launches.values()) for name in FLASH_NAMES}
    return row


# ---- phase 13: the rest of the single-device zoo through the train CLI -----

RESNET_DEF = "resnet50_subclass.resnet50_subclass.custom_model"
IMAGENET_DEF = "imagenet_resnet50.imagenet_resnet50.custom_model"
# bench.py's headline (bench.py:181-190): ResNet-50 on 32x32 cifar images,
# 10 classes, 2048 rows a step, bf16.  49 152 gen_cifar10 records in 8
# shards of one 3-step task each (24 steps an epoch), 2 epochs, 2048
# validation records, a checkpoint every 16 steps
RESNET_CIFAR = dict(
    name="resnet50_cifar10", model_def=RESNET_DEF, gen="gen_cifar10",
    gen_kwargs={}, model_params="dtype=bfloat16", train_records=49152,
    eval_records=2048, shards=8, batch=2048, records_per_task=6144, epochs=2,
    checkpoint_steps=16, wire=("image", "uint8"), accuracy_key="accuracy",
    min_accuracy=0.5,
    # a step is about 4 200 torch operations, more launches than the
    # launch queue holds, so steps cannot be queued behind time_cuda's
    # spin kernel: the bare loop's device time is the profiler's busy time
    device_reps=None,
)
# the step held against the port's CPU run: one 64-row batch from seeded
# weights, f32 with TF32 off.  cuDNN's convolutions and the CPU's sum in
# other orders through 53 BatchNorms: probabilities within 2e-3 and the
# loss within 1e-3.  The trained model's bf16 evaluation forward within
# 0.1 of the same weights in f32 (8-bit mantissas through 53 layers)
RESNET_HELD_ROWS = 64
RESNET_PROB_TOL, RESNET_LOSS_TOL, RESNET_BF16_TOL = 2e-3, 1e-3, 0.1
# bench.py's imagenet_resnet50 (bench.py:226-234): 224 x 224 x 3, 1000
# classes, 128 rows a step, bf16; seeded in-memory batches, 12 steps, the
# median over the steps after the first 2
IMAGENET = dict(rows=128, side=224, classes=1000, steps=12, warmup=2)
# the rest of the zoo: each model on a few thousand synthetic records,
# one epoch, a final evaluation; accuracy floors where the generator is
# learnable in that epoch (heart's SGD(1e-6) learns nothing in one)
_REST_COMMON = dict(gen_kwargs={}, model_params="", shards=4, accuracy_key="accuracy")
ZOO_REST = tuple(dict(_REST_COMMON, **cfg) for cfg in (
    dict(name="mnist_subclass", model_def="mnist_subclass.mnist_subclass.custom_model",
         gen="gen_mnist", train_records=4096, eval_records=1024, batch=128,
         records_per_task=1024, wire=("image", "uint8"), path="vectorized",
         min_accuracy=0.8),
    dict(name="cifar10_functional_api",
         model_def="cifar10_functional_api.cifar10_functional_api.custom_model",
         gen="gen_cifar10", train_records=8192, eval_records=1024, batch=128,
         records_per_task=2048, wire=("image", "uint8"), path="vectorized",
         min_accuracy=0.5),
    dict(name="cifar10_subclass", model_def="cifar10_subclass.cifar10_subclass.custom_model",
         gen="gen_cifar10", train_records=8192, eval_records=1024, batch=128,
         records_per_task=2048, wire=("image", "uint8"), path="vectorized",
         min_accuracy=0.5),
    *(
        dict(name=f"census_{style}",
             model_def=f"census_dnn_model.census_{style}.custom_model",
             gen="gen_census", train_records=8192, eval_records=2048, batch=128,
             records_per_task=2048, wire=("age", "float32"), path="vectorized",
             min_accuracy=0.6)
        for style in ("functional_api", "sequential", "subclass")
    ),
    dict(name="heart", model_def="heart_functional_api.heart_functional_api.custom_model",
         gen="gen_heart", train_records=2048, eval_records=512, batch=64,
         records_per_task=512, wire=("age", "float32"), path="dataset_fn",
         min_accuracy=None),
    dict(name="odps_iris", model_def="odps_iris_dnn_model.odps_iris_dnn_model.custom_model",
         gen="gen_iris", train_records=2048, eval_records=512, batch=64,
         records_per_task=512, wire=("features", "float32"), path="dataset_fn",
         min_accuracy=0.9),
))


def resnet_held_on_card(device: str = "cuda", rows: int = RESNET_HELD_ROWS) -> dict:
    """Phase 13a's held step: seeded ResNet-50 weights and one 64-row
    batch of uint8 images, the training-mode probabilities and the first
    SGD step's loss in f32 on ``device`` against the port's CPU run of the
    same."""
    import copy

    import numpy as np
    import torch

    from elasticdl_tpu_torch.models import resnet50_subclass as resnet
    from elasticdl_tpu_torch.trainer.state import TrainState
    from elasticdl_tpu_torch.trainer.step import build_train_step

    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(0)
        weights = resnet.custom_model().state_dict()
    rng = np.random.RandomState(0)
    images = torch.from_numpy(rng.randint(0, 256, (rows, 32, 32, 3)).astype(np.uint8))
    labels = torch.from_numpy(rng.randint(0, 10, rows).astype(np.int32))

    def run(dev):
        model = resnet.custom_model()
        model.load_state_dict(weights)
        model.to(dev)
        features = {"image": images.to(dev)}
        with torch.no_grad():
            probs = copy.deepcopy(model)(resnet.device_parse(features), training=True)
        state = TrainState.create(model, resnet.optimizer())
        _, metrics = build_train_step(resnet.loss, device_parse=resnet.device_parse)(
            state, features, labels.to(dev), torch.ones(rows, device=dev)
        )
        return probs.cpu().numpy(), float(metrics["loss"])

    cpu_probs, cpu_loss = run("cpu")
    card_probs, card_loss = run(device)
    row = {
        "rows": rows, "cpu_loss": cpu_loss, "card_loss": card_loss,
        "prob_max_abs_err": float(np.abs(card_probs - cpu_probs).max()),
        "max_prob": float(cpu_probs.max()),
    }
    if not (
        np.isfinite(card_loss) and abs(card_loss - cpu_loss) <= RESNET_LOSS_TOL
        and row["prob_max_abs_err"] <= RESNET_PROB_TOL
    ):
        raise AssertionError(f"ResNet-50 on {device} disagrees with the CPU: {row}")
    return row


def _bf16_against_f32(model, data: dict, device: str, tol: float) -> dict:
    """The trained bf16 ``model``'s evaluation-mode probabilities on the
    first 64 validation records against the same weights in f32: the
    bf16 forward held to the f32 one.  (At initialisation the network's
    probabilities on noise images are too ill-conditioned for this: bf16
    moves them by up to 0.47 at 64 x 32 x 32 on the CPU.)"""
    import numpy as np
    import torch

    from elasticdl_tpu_torch.data.reader import decode_example_batch
    from elasticdl_tpu_torch.data.recordio_reader import RecordIODataReader
    from elasticdl_tpu_torch.master.task_dispatcher import Task
    from elasticdl_tpu_torch.models import resnet50_subclass as resnet
    from elasticdl_tpu_torch.utils.constants import TaskType

    reader = RecordIODataReader(data_dir=data["eval"])
    shard, (start, n) = sorted(reader.create_shards().items())[0]
    records = list(reader.read_records(
        Task(shard, start, start + min(n, RESNET_HELD_ROWS), TaskType.EVALUATION)
    ))
    images = torch.from_numpy(decode_example_batch(records)["image"]).to(device)
    f32 = resnet.custom_model(num_classes=model.num_classes)
    f32.load_state_dict(model.state_dict())
    probs = []
    for m in (model, f32.to(device)):
        with torch.no_grad():
            probs.append(m.eval()(resnet.device_parse({"image": images})).cpu().numpy())
    row = {
        "rows": len(records), "prob_max_abs_err": float(np.abs(probs[0] - probs[1]).max()),
        "argmax_agreement": float((probs[0].argmax(1) == probs[1].argmax(1)).mean()),
    }
    if not row["prob_max_abs_err"] <= tol:
        raise AssertionError(f"the bf16 forward is not held to the f32 one: {row}")
    return row


def _channels_last_share(model, device: str) -> float:
    """The share of ``model``'s BatchNorm inputs that were
    ``channels_last`` in an evaluation forward of 8 images: the layout
    cuDNN's convolutions gave them."""
    import torch

    from elasticdl_tpu_torch.layers.normalization import BatchNorm

    seen = []
    hooks = [
        m.register_forward_pre_hook(
            lambda _m, args: seen.append(args[0].is_contiguous(memory_format=torch.channels_last))
        )
        for m in model.modules() if isinstance(m, BatchNorm)
    ]
    try:
        with torch.no_grad():
            model.eval()({"image": torch.zeros(8, 32, 32, 3, device=device)})
    finally:
        for h in hooks:
            h.remove()
    return sum(seen) / len(seen)


def train_resnet_cifar(work_dir: str, device: str = "cuda", cfg=None) -> dict:
    """Phase 13a: the held step, then ``resnet50_subclass`` through the
    train CLI at bench.py's width and step, checked as phase 7 checks
    mnist (tasks, every record once an epoch, the vectorized path, the
    uint8 wire, finite losses, the accuracy floor, statistics that moved,
    checkpoints and the export), with the steady window read off the same
    run, the peak memory and bare steps (``device="cpu"`` rehearses it at
    a small size)."""
    import torch

    cfg = cfg or RESNET_CIFAR
    row = {"held": resnet_held_on_card(device, cfg.get("held_rows", RESNET_HELD_ROWS))}
    data = _zoo_data(work_dir, cfg)
    if device == "cuda":
        torch.cuda.reset_peak_memory_stats()
    rec = _ZooRecorder(device, cfg["wire"][0], keep_batches=True)
    row["checked"] = _checked_zoo_run(work_dir, cfg, data, device, rec=rec)
    row["steady"] = _steady_window(rec)
    if device == "cuda":
        row["peak_memory_gb"] = torch.cuda.max_memory_allocated() / 2**30
    model = rec.executor.trainer.state.model
    row["bf16_against_f32"] = _bf16_against_f32(
        model, data, device, cfg.get("bf16_tol", RESNET_BF16_TOL)
    )
    row["channels_last_share"] = _channels_last_share(model, device)
    del model
    del rec
    _release_memory(device)
    row["bare"] = _bare_zoo_steps(cfg, data, device)
    return row


def imagenet_resnet_steps(device: str = "cuda", cfg=None) -> dict:
    """Phase 13b: ``imagenet_resnet50`` through ``SPMDTrainer`` on a seeded
    in-memory batch of uint8 images at bench.py's shape, as the CLI
    builds the trainer (bf16 features, the model's device parse):
    median step ms over a synced loop, samples/s and peak memory."""
    import numpy as np
    import torch

    from elasticdl_tpu_torch.parallel.distributed import SPMDTrainer
    from elasticdl_tpu_torch.trainer.local_executor import build_optimizer
    from elasticdl_tpu_torch.utils.model_utils import get_model_spec

    cfg = cfg or IMAGENET
    rows, side = cfg["rows"], cfg["side"]
    spec = get_model_spec("", IMAGENET_DEF, model_params={"dtype": "bfloat16"})
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(0)
        model = spec.build_model()
    trainer = SPMDTrainer(
        model, spec.loss, build_optimizer(spec), compute_dtype=torch.bfloat16,
        device=device, device_parse=spec.device_parse,
    )
    rng = np.random.RandomState(0)
    batch = trainer.place_batch((
        {"image": rng.randint(0, 256, (rows, side, side, 3)).astype(np.uint8)},
        rng.randint(0, cfg["classes"], rows).astype(np.int32),
        np.ones(rows, np.float32),
    ))
    if device == "cuda":
        torch.cuda.reset_peak_memory_stats()
    step_ms, losses = [], []
    for _ in range(cfg["steps"]):
        t0 = time.monotonic()
        losses.append(trainer.train_step(*batch)["loss"])
        if device == "cuda":
            torch.cuda.synchronize()
        step_ms.append((time.monotonic() - t0) * 1e3)
    losses = [float(x) for x in losses]
    median_ms = statistics.median(step_ms[cfg["warmup"]:])
    row = {
        "rows": rows, "side": side, "classes": cfg["classes"], "steps": cfg["steps"],
        "step_ms": step_ms, "median_step_ms": median_ms,
        "samples_per_s": rows / (median_ms / 1e3), "losses": losses,
        "peak_memory_gb": torch.cuda.max_memory_allocated() / 2**30 if device == "cuda" else None,
    }
    params_finite = all(torch.isfinite(p).all() for p in trainer.state.model.parameters())
    if not (all(np.isfinite(losses)) and params_finite and trainer.step == cfg["steps"]):
        raise AssertionError(f"imagenet ResNet-50 did not step cleanly: {row}")
    return row


def zoo_cli_run(work_dir: str, cfg: dict, device: str = "cuda") -> dict:
    """Phase 13c for one model: one epoch of ``cfg`` through the train CLI
    with a final evaluation.  Gates: the tasks, steps and records of the
    epoch, every batch through ``cfg["path"]`` (the vectorized pipeline
    for a model with a ``batch_parse``, else its ``dataset_fn``),
    the wire dtype on the device, finite losses and evaluation, and the
    accuracy floor where there is one."""
    import numpy as np
    import torch

    data = _zoo_data(work_dir, cfg)
    rec = _ZooRecorder(device, cfg["wire"][0], keep_batches=False)
    _launches, paths = rec.run(_zoo_argv(cfg, data, device, "--validation_data", data["eval"]))
    want_tasks, want_steps, want_records, eval_batches = _zoo_counts(cfg)
    trainer = rec.executor.trainer
    losses = [float(x) for x in rec.losses]
    accuracy = rec.result.get(cfg["accuracy_key"])
    # a model without a batch_parse takes the per-record path, which
    # fast_pipeline does not count
    vectorized = want_steps + eval_batches if cfg["path"] == "vectorized" else 0
    want_paths = {"vectorized": vectorized, "classic": 0}
    want_wire = (getattr(torch, cfg["wire"][1]), device)
    row = {
        "tasks": len(rec.tasks), "records": sum(t.end - t.start for t in rec.tasks),
        "steps": trainer.step, "evaluation": rec.result, "paths": paths,
        "first_losses": losses[:2], "last_losses": losses[-2:],
        "data_secs": data["secs"], "run_secs": time.monotonic() - rec.start,
    }
    if (
        (row["tasks"], row["records"], row["steps"], len(losses))
        != (want_tasks, want_records, want_steps, want_steps)
        or paths != want_paths or any(w != want_wire for w in rec.wire)
        or not all(np.isfinite(losses)) or not np.isfinite(rec.result.get("loss", np.nan))
        or (cfg["min_accuracy"] is not None and not accuracy >= cfg["min_accuracy"])
    ):
        raise AssertionError(
            f"{cfg['name']} failed its gates: {row} (want {want_tasks} tasks, "
            f"{want_steps} steps, paths {want_paths}, wire {want_wire} not {set(rec.wire)})"
        )
    return row


def train_zoo_rest(work_dir: str, device: str = "cuda", cfgs=None) -> dict:
    """Phase 13c: every model of :data:`ZOO_REST` in turn."""
    rows = {}
    for cfg in cfgs or ZOO_REST:
        rows[cfg["name"]] = zoo_cli_run(os.path.join(work_dir, cfg["name"]), cfg, device)
        _release_memory(device)
    return rows


# ---- phase 14: the master journal and master high availability ------------

# mnist at bench.py's width and step on phase 10's 16 384 records (8
# shards, tasks of 1024 records = 4 steps, 2 epochs = 128 steps, a disk
# checkpoint every 2 steps), with --master_journal_dir; every master-kill
# plan arms its kill at version 6 (chaos/plan.py's _KILL_STEP), and a
# killed master is relaunched after the fault's 2 s
HA_MNIST = dict(ELASTIC_MNIST, name="mnist_ha", min_accuracy=0.99)
# the restored master's wait for its journaled world to re-home: a worker
# beats, and so re-homes, as soon as its client has re-resolved the
# relaunched master (a worker that is alive but late is settled, not
# declared dead); 14b waits it out in full
HA_GRACE_SECS = 5.0
# the four jobs of the phase, by the key its report files them under
HA_CASES = ("mid_epoch", "during_reform", "task_stream", "real_kill")
# 14c's epochs: the task-stream worker re-homes at its next heartbeat
# (every 5 s), at most about 4 s after the relaunch when a beat fell in
# the outage; 20 epochs leave it over 6 s of training after the
# relaunch at 41 000 records/s, the fastest 14c ran on the H100
HA_TASK_STREAM_EPOCHS = 20
# 14d's job seconds past which it prints its master logs' tails
HA_SLOW_SECS = 90.0


def ha_case_cfg(case: str, cfg: dict) -> dict:
    """The configuration one case of phase 14 trains."""
    return dict(cfg, epochs=HA_TASK_STREAM_EPOCHS) if case == "task_stream" else cfg


def _ha_paths(work_dir: str, tag: str) -> dict:
    os.makedirs(work_dir, exist_ok=True)
    return {k: os.path.join(work_dir, f"{k}_{tag}") for k in ("journal", "ckpt", "dump")} | {
        "events": os.path.join(work_dir, f"events_{tag}.jsonl"),
        "plan": os.path.join(work_dir, f"plan_{tag}.json"),
    }


def _ha_argv(cfg: dict, data: dict, device: str, paths: dict, num_workers: int) -> list:
    """The train CLI's argv for a phase-14 job (``argv[0]`` is ``train``),
    with the plan and the chaos event log in the workers' environment."""
    from elasticdl_tpu_torch.chaos import hooks as chaos_hooks
    from elasticdl_tpu_torch.worker.lockstep import DUMP_STATE_ENV

    envs = {chaos_hooks.PLAN_ENV: paths["plan"], chaos_hooks.EVENTS_ENV: paths["events"], **TF32_OFF}
    if num_workers > 1:
        envs[DUMP_STATE_ENV] = paths["dump"]
    return _zoo_argv(cfg, data, device) + [
        "--checkpoint_dir", paths["ckpt"], "--checkpoint_steps", str(cfg["checkpoint_steps"]),
        "--master_journal_dir", paths["journal"], "--rehome_grace_secs", str(HA_GRACE_SECS),
        *_dist_flags(num_workers, envs),
    ]


def _ha_expected_steps(cfg: dict) -> int:
    """Steps a job without a retrained task takes (tasks divide evenly)."""
    per_task = -(-cfg["records_per_task"] // cfg["batch"])
    return cfg["epochs"] * (cfg["train_records"] // cfg["records_per_task"]) * per_task


def _journal_accounting(journal_dir: str) -> dict:
    """Every training task uid the journal ever held, each with exactly
    one successful report, and the replayed training total."""
    from collections import Counter

    from elasticdl_tpu_torch.master.journal import journal_path, replay
    from elasticdl_tpu_torch.telemetry.events import read_jsonl

    records = read_jsonl(journal_path(journal_dir))
    created = set()
    # each generation bump (a re-formation's fence) is journaled
    bumps = [int(r["cluster_version"]) for r in records if r.get("kind") == "generation"]
    for r in records:
        if r.get("kind") == "snapshot":
            disp = r["state"]["dispatcher"]
            tasks = disp["pending"] + [a["task"] for a in disp["active"].values()]
        elif r.get("kind") == "tasks_created":
            tasks = r["tasks"]
        else:
            continue
        created.update(int(t["uid"]) for t in tasks if int(t["type"]) == 0)
    done = Counter(
        int(r["uid"]) for r in records
        if r.get("kind") == "report" and r.get("success") and int(r.get("task_type", 0)) == 0
    )
    state = replay(records) or {}
    counters = state.get("dispatcher", {}).get("counters", {}).get("TRAINING", {})
    return {
        "model_version": state.get("servicer", {}).get("model_version"),
        "tasks": len(created),
        "done_twice": sorted(u for u, n in done.items() if n > 1),
        "never_done": sorted(created - set(done)),
        "total_records": counters.get("total_records"),
        "generation": state.get("servicer", {}).get("cluster_version"),
        "generation_bumps": bumps,
        "clean_shutdown": state.get("clean_shutdown"),
        "journal_bytes": os.path.getsize(journal_path(journal_dir)),
    }


def _ha_row(cfg: dict, out: dict, events: list, secs: float, clocks: list) -> dict:
    """What a phase-14 job through the harness's master lives did."""
    from elasticdl_tpu_torch.utils.constants import TaskType

    masters = out["masters"]
    first, last = masters[0], masters[-1]
    kill = dict(out["kills"][0]) if out["kills"] else {}
    crashed_at = kill.pop("crashed_at", 0.0)
    old_pids = kill.pop("pids", {})
    counters = last.task_d.counters(TaskType.TRAINING)
    accepted = [e for e in events if e.get("observation") == "worker_rehome" and e.get("accepted")]
    return {
        "rc": out["rc"], "timed_out": out["timed_out"], "lives": len(masters), "job_secs": secs,
        "kill": kill,
        # the kill to the relaunched master's first served RPC
        "outage_secs": last.first_rpc_at - crashed_at if last.first_rpc_at and crashed_at else None,
        "replay_secs": (last.restore_info or {}).get("replay_secs"),
        "journal_bytes": (last.restore_info or {}).get("journal_bytes"),
        # the kill to each worker's accepted rehome_worker
        "rehome_secs": {str(e["worker_id"]): e["monotonic"] - crashed_at for e in accepted},
        "rehomed": {
            str(w): {k: v for k, v in r.items() if k != "at"} for w, r in last.rehomed.items()
        },
        "fenced": sorted(
            e["worker_id"] for e in events
            if e.get("observation") == "worker_rehome" and e.get("accepted") is False
        ),
        "old_pids": {str(w): p for w, p in old_pids.items()},
        "generations": {"at_kill": first.servicer.cluster_version, "final": last.servicer.cluster_version},
        "reforms": [{k: v for k, v in e.items() if k != "detected_at"} for e in last.reform_events],
        # the last world the master journaled (its workers have exited)
        "new_world": (last._restored_world or {}).get("worker_ids", []),
        "total_records": counters.total_records,
        "steps_trained_again": last.servicer.get_model_version() - _ha_expected_steps(cfg),
        # each life's reports after its first; the relaunched life's from
        # the last re-home on (before it, the world rides out the outage)
        "steady_records_per_s": {
            "before_kill": clocks[0].steady_records_per_s(0.0),
            "after_kill": clocks[-1].steady_records_per_s(
                max((r["at"] for r in last.rehomed.values()), default=0.0)
            ) if len(clocks) > 1 else None,
        },
    }


def master_ha_run(
    work_dir: str, cfg: dict, data: dict, case: str, device: str = "cuda"
) -> dict:
    """Phase 14a-c: ``cfg``'s job through the train CLI under a master-kill
    plan (``mid_epoch``: two ranks and ``master_kill_mid_epoch``;
    ``during_reform``: two ranks and ``master_kill_during_reform``;
    ``task_stream``: one task-stream worker and ``master_kill_mid_epoch``),
    its master lives run by ``chaos/harness.py::run_master_lives`` with one
    ``InvariantChecker`` spanning them; returns the row that
    :func:`check_master_ha_case` gates."""
    from elasticdl_tpu_torch import client
    from elasticdl_tpu_torch.chaos.harness import (
        ChaosJobConfig,
        _check_master_recovery,
        run_master_lives,
    )
    from elasticdl_tpu_torch.chaos.invariants import InvariantChecker, read_event_log
    from elasticdl_tpu_torch.chaos.plan import builtin_plans
    from elasticdl_tpu_torch.utils.constants import TaskType

    cfg = ha_case_cfg(case, cfg)
    num_workers = 1 if case == "task_stream" else ELASTIC_WORKERS
    plan = builtin_plans(num_workers)[
        "master_kill_during_reform" if case == "during_reform" else "master_kill_mid_epoch"
    ]
    paths = _ha_paths(work_dir, case)
    plan.save(paths["plan"])
    argv = _ha_argv(cfg, data, device, paths, num_workers)
    expected = cfg["train_records"] * cfg["epochs"]
    checker = InvariantChecker(expected_records=expected)
    clocks: list = []

    flushes: list = []

    def on_build(master):
        clocks.append(_ReportClock())
        master.task_d.add_observer(clocks[-1])
        flush = master.journal.flush

        def timed_flush():
            t = time.perf_counter()
            flush()
            flushes.append((time.perf_counter() - t) * 1e3)

        master.journal.flush = timed_flush

    config = ChaosJobConfig(
        plan=plan, workdir=work_dir, master_ha=True, journal_dir=paths["journal"],
        run_timeout_secs=600.0,
    )
    t0 = time.monotonic()
    out = run_master_lives(
        lambda: client.main(argv), config, paths["events"], checker=checker, on_build=on_build
    )
    secs = time.monotonic() - t0
    events = read_event_log(paths["events"])
    row = _ha_row(cfg, out, events, secs, clocks)
    row["preempt_step"] = next(
        (e["step"] for e in events if e.get("kind") == "preempt_worker"), None
    )
    # the journal's flushes on this life's threads: lease, report, fence
    row["journal_flush"] = {
        "count": len(flushes), "ms_median": statistics.median(flushes) if flushes else None,
        "ms_total": sum(flushes),
    }
    counters = out["masters"][-1].task_d.counters(TaskType.TRAINING)
    row["violations"] = [v.as_dict() for v in checker.check(counters)]
    row["master_recovery"] = _check_master_recovery(config, paths["events"], len(out["masters"]), events)
    row["accuracy"] = _evaluate_checkpoint(cfg, data, device, paths["ckpt"]).get(cfg["accuracy_key"])
    return row


def _worker_children(pid: int) -> list:
    """The worker processes ``pid`` started (``/proc``: its children whose
    command line runs the port's worker)."""
    try:
        with open(f"/proc/{pid}/task/{pid}/children", encoding="ascii") as f:
            children = [int(c) for c in f.read().split()]
    except OSError:
        return []
    workers = []
    for child in children:
        try:
            with open(f"/proc/{child}/status", encoding="ascii") as f:
                tgid = next(int(line.split()[1]) for line in f if line.startswith("Tgid:"))
            with open(f"/proc/{child}/cmdline", "rb") as f:
                # a process, not one of its threads, running the worker
                if tgid == child and b"elasticdl_tpu_torch.worker.main" in f.read():
                    workers.append(child)
        except (OSError, StopIteration, ValueError):
            continue
    return workers


def _pid_alive(pid: int) -> bool:
    from elasticdl_tpu_torch.master.master import _AdoptedProcess

    return _AdoptedProcess(pid).poll() is None


def _real_kill_lives(work_dir: str, cfg: dict, data: dict, device: str = "cuda") -> dict:
    """Phase 14d's two master processes (no torch in this process, so it
    can run beside another case): the 14a job's master as a process of
    its own (``python -m elasticdl_tpu_torch.master.main``), SIGKILLed
    once the journal holds version 6, then started again with the same
    arguments; its orphaned workers re-home into the new process.
    Returns what it saw, with a timeline in seconds from the start."""
    import signal

    from elasticdl_tpu_torch.chaos.harness import _record_master_kill
    from elasticdl_tpu_torch.chaos.plan import builtin_plans
    from elasticdl_tpu_torch.master.journal import load_state

    plan = builtin_plans(ELASTIC_WORKERS)["master_kill_mid_epoch"]
    fault = plan.master_kill_faults()[0]
    paths = _ha_paths(work_dir, "real_kill")
    plan.save(paths["plan"])
    cmd = [sys.executable, "-m", "elasticdl_tpu_torch.master.main",
           *_ha_argv(cfg, data, device, paths, ELASTIC_WORKERS)[1:]]
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(p for p in (REPO, os.environ.get("PYTHONPATH")) if p))
    logs = [os.path.join(work_dir, f"master_life{i}.log") for i in (1, 2)]
    t0 = time.monotonic()
    with open(logs[0], "w") as log_file:
        first = subprocess.Popen(cmd, env=env, stdout=log_file, stderr=subprocess.STDOUT)
    version, deadline = 0, time.monotonic() + 600
    while first.poll() is None and time.monotonic() < deadline:
        state = load_state(paths["journal"])
        version = state["servicer"]["model_version"] if state else 0
        if version >= fault.at_step:
            break
        time.sleep(0.1)
    old_pids = sorted(_worker_children(first.pid))
    os.kill(first.pid, signal.SIGKILL)
    crashed_at = time.monotonic()
    first_rc = first.wait()
    _record_master_kill(paths["events"], fault, crashed_at, step=version)
    time.sleep(fault.duration_secs or 2.0)
    relaunched_at = time.monotonic()
    with open(logs[1], "w") as log_file:
        second = subprocess.Popen(cmd, env=env, stdout=log_file, stderr=subprocess.STDOUT)
        try:
            rc = second.wait(timeout=600)
        except subprocess.TimeoutExpired:
            second.kill()
            rc = second.wait()
    second_done_at = time.monotonic()
    # the workers end at the stream's end; one that re-homed as the
    # relaunched master stopped may still be on its way out
    deadline = time.monotonic() + 30.0
    while any(_pid_alive(p) for p in old_pids) and time.monotonic() < deadline:
        time.sleep(0.2)
    left = [p for p in old_pids if _pid_alive(p)]
    for pid in old_pids:
        with contextlib.suppress(OSError):
            if pid in left:
                os.kill(pid, signal.SIGKILL)
            os.waitpid(pid, os.WNOHANG)  # orphans this process may have inherited
    return {
        "paths": paths, "plan": plan, "fault": fault, "logs": logs, "version": version,
        "rc": rc, "first_rc": first_rc, "old_pids": old_pids, "left": left,
        "crashed_at": crashed_at, "secs": time.monotonic() - t0,
        "timeline": {
            "kill": crashed_at - t0, "relaunch": relaunched_at - t0,
            "second_master_exit": second_done_at - t0, "workers_gone": time.monotonic() - t0,
        },
    }


def _log_tails(logs: list, lines: int = 60) -> None:
    for path in logs:
        with contextlib.suppress(OSError), open(path, errors="replace") as f:
            tail = f.readlines()[-lines:]
            log(f"--- the last {len(tail)} lines of {os.path.basename(path)}\n{''.join(tail)}")


def master_ha_real_kill_run(cfg: dict, data: dict, lives: dict, device: str = "cuda") -> dict:
    """Phase 14d's row from :func:`_real_kill_lives`, read without an
    in-process checker: the journal (every training uid done exactly
    once, the replayed total, the generation and its bumps),
    ``master_recovery``, the chaos event log (each re-home, its pid and
    its adoption; the restarted master's generation) and the Local
    evaluate of the trained checkpoint."""
    from elasticdl_tpu_torch.chaos.harness import ChaosJobConfig, _check_master_recovery
    from elasticdl_tpu_torch.chaos.invariants import read_event_log

    paths, crashed_at = lives["paths"], lives["crashed_at"]
    events = read_event_log(paths["events"])
    accepted = [e for e in events if e.get("observation") == "worker_rehome" and e.get("accepted")]
    serving = [e["monotonic"] for e in events if e.get("observation") == "master_serving"]
    restart = next((e for e in events if e.get("observation") == "master_restart"), {})
    config = ChaosJobConfig(
        plan=lives["plan"], workdir=os.path.dirname(paths["journal"]), master_ha=True,
        journal_dir=paths["journal"],
    )
    accounting = _journal_accounting(paths["journal"])
    return {
        "rc": lives["rc"], "first_rc": lives["first_rc"], "timed_out": False, "lives": 2,
        "job_secs": lives["secs"], "timeline": lives["timeline"],
        "kill": {"fault_id": lives["fault"].fault_id, "step": lives["version"]},
        "outage_secs": serving[0] - crashed_at if serving else None,
        "replay_secs": restart.get("replay_secs"), "journal_bytes": restart.get("journal_bytes"),
        "rehome_secs": {str(e["worker_id"]): e["monotonic"] - crashed_at for e in accepted},
        "rehomed": {
            str(e["worker_id"]): {k: e.get(k) for k in ("pid", "adopted", "kept", "requeued")}
            for e in accepted
        },
        "fenced": sorted(e["worker_id"] for e in events
                         if e.get("observation") == "worker_rehome" and e.get("accepted") is False),
        "old_pids": lives["old_pids"], "left_running": lives["left"],
        # the restarted master's replayed generation, and the journal's
        "generations": {"at_kill": restart.get("cluster_version"), "final": accounting["generation"]},
        "reforms": [{"cluster_version": v} for v in accounting["generation_bumps"]],
        "journal": accounting, "total_records": accounting["total_records"],
        "steps_trained_again": accounting["model_version"] - _ha_expected_steps(cfg),
        "violations": [
            {"invariant": "exactly_once", "detail": f"uids {accounting[k]} {k}"}
            for k in ("done_twice", "never_done") if accounting[k]
        ],
        "master_recovery": _check_master_recovery(config, paths["events"], 2, events),
        "accuracy": _evaluate_checkpoint(cfg, data, device, paths["ckpt"]).get(cfg["accuracy_key"]),
        "logs": lives["logs"],
    }


def check_master_ha_case(case: str, row: dict, cfg: dict) -> list:
    """Phase 14's gates on one job's row; the failures, or []."""
    from elasticdl_tpu_torch.chaos.plan import _KILL_STEP

    bad = []

    def need(ok, what):
        if not ok:
            bad.append(what)

    cfg = ha_case_cfg(case, cfg)
    need(row.get("rc") == 0 and not row.get("timed_out"), "rc 0 within the time limit")
    need(row.get("lives") == 2, "one kill, one relaunch")
    need(not row.get("violations"), "no invariant violation across lives")
    need(row.get("total_records") == cfg["train_records"] * cfg["epochs"], "every record once")
    need((row.get("master_recovery") or {}).get("status") == "PASS", "master_recovery PASS")
    acc = row.get("accuracy")
    need(acc is not None and acc >= cfg["min_accuracy"], "accuracy from the Local evaluate")
    # the kill at version >= 6, or inside the re-formation of a
    # preemption at step 6
    fault_step = row.get("preempt_step") if case == "during_reform" else (row.get("kill") or {}).get("step")
    need((fault_step or -1) >= _KILL_STEP, "the fault at version >= 6")
    for key in ("outage_secs", "replay_secs", "journal_bytes", "job_secs"):
        need(isinstance(row.get(key), (int, float)) and row[key] > 0, f"{key} measured")
    rehomed = row.get("rehomed") or {}
    pids = {w: r["pid"] for w, r in rehomed.items()}
    if case == "during_reform":
        gens = row.get("generations") or {}
        need(gens.get("at_kill") == 1, "the master died after journaling the fence")
        need(gens.get("final", 0) > gens.get("at_kill", 0), "a new generation past the fence")
        need(len(row.get("fenced") or []) == 1 and not rehomed, "the survivor fenced, none resurrected")
        need(len(row.get("reforms") or []) == 1, "one re-formation by the relaunched master")
        new_world = set(row.get("new_world") or [])
        need(new_world and not new_world & {int(w) for w in row.get("old_pids") or {}},
             "a new world, under new worker ids")
    else:
        old = row.get("old_pids") or {}
        if isinstance(old, dict):
            need(old and pids == old, "every worker re-homed with its own pid")
        else:
            # a process's children are all the master knew of its pids:
            # the world's workers are among them
            need(len(pids) == ELASTIC_WORKERS and set(pids.values()) <= set(old),
                 "every worker re-homed with its own pid")
        need(not row.get("fenced"), "no worker fenced")
        need(rehomed and all(r.get("adopted") is True for r in rehomed.values()),
             "every re-homed worker adopted")
        gens = row.get("generations") or {}
        need(gens.get("at_kill") == 0 and gens.get("final") == 0 and row.get("reforms") == [],
             "no re-formation, no generation bump")
        if case == "real_kill":
            need(not row.get("left_running"), "no worker outlived the job")
            need(row.get("first_rc") == -9, "the first master died of SIGKILL")
        if case == "task_stream":
            need(any(r["kept"] or r["requeued"] for r in rehomed.values()),
                 "the worker presented its lease")
    return bad


def check_master_ha(report: dict, cfg: dict = HA_MNIST) -> None:
    """Every case of phase 14 reported, each passing its gates."""
    missing = [case for case in HA_CASES if case not in report]
    bad = {case: check_master_ha_case(case, report[case], cfg) for case in HA_CASES if case in report}
    bad = {case: b for case, b in bad.items() if b}
    if missing or bad:
        raise AssertionError(f"phase 14 failed: missing {missing}, gates {bad}")


def master_ha_phase(
    work_dir: str, cfg: dict = HA_MNIST, device: str = "cuda", rate_10a=None, data=None
) -> dict:
    """Phase 14: the four master-kill jobs on one set of shards (``data``,
    phase 10's, else made here), gated.  14a runs alone (its steady rate
    is read against phase 10a's); 14d's master processes run beside 14b
    and 14c."""
    import threading

    t0 = time.monotonic()
    data = data or _zoo_data(os.path.join(work_dir, "data"), cfg)
    report = {}

    def one(case):
        _release_memory(device)
        report[case] = master_ha_run(os.path.join(work_dir, case), cfg, data, case, device)
        print(json.dumps({f"master_ha_{case}": report[case]}), flush=True)

    one("mid_epoch")
    lives: dict = {}

    def real_kill():
        try:
            lives.update(_real_kill_lives(os.path.join(work_dir, "real_kill"), cfg, data, device))
        except Exception as ex:  # noqa: BLE001 — reported as 14d's failure
            lives["error"] = repr(ex)

    beside = threading.Thread(target=real_kill, name="phase14d")
    beside.start()
    try:
        one("during_reform")
        one("task_stream")
    finally:
        beside.join()
    if "error" in lives:
        raise AssertionError(f"phase 14d failed: {lives['error']}")
    report["real_kill"] = master_ha_real_kill_run(cfg, data, lives, device)
    print(json.dumps({"master_ha_real_kill": report["real_kill"]}), flush=True)
    steady = report["mid_epoch"]["steady_records_per_s"]
    report["journal_steady_cost"] = {
        **steady, "phase10a_without_journal": rate_10a,
        "after_over_10a": steady["after_kill"] / rate_10a if rate_10a and steady["after_kill"] else None,
    }
    report["secs"] = time.monotonic() - t0
    real = report["real_kill"]
    if check_master_ha_case("real_kill", real, cfg) or real["job_secs"] > HA_SLOW_SECS:
        _log_tails(real["logs"])
    check_master_ha(report, cfg)
    return report


# ---- phase 15: hot standbys, slices, parking and the autoscaler ------------

# phase 10's mnist cell and shards (bench.py's width and 256-row step,
# 16 384 records, tasks of 4 steps, a checkpoint every 2, 2 epochs), held
# to phase 14's accuracy
SLICE_MNIST = dict(ELASTIC_MNIST, name="mnist_slices", min_accuracy=0.99)
# 15b's fleet: two slices of two processes
SLICE_WORKERS = 4
# 15c's capacity grant comes this long after the park
SLICE_GRANT_SECS = 2.0
# 15d: grow while 4 or more tasks wait, at most once every 5 s
AUTOSCALE_FLAGS = ("--autoscale_backlog_tasks", "4", "--autoscale_cooldown_secs", "5")
# the four jobs of the phase, by the key its report files them under
SLICE_CASES = ("standby", "slice_loss", "park_grant", "autoscale")


def _worker_start_probe() -> dict:
    """What a warm standby saves and what it does not: a fresh process's
    seconds to import torch, then the port's lockstep chain, then to make
    a CUDA context (a standby of the port waits before the last)."""
    code = (
        "import json, time; t0 = time.monotonic(); import torch; t1 = time.monotonic(); "
        "import elasticdl_tpu_torch.worker.lockstep; t2 = time.monotonic(); "
        "torch.cuda.set_device(0); torch.empty(1, device='cuda'); torch.cuda.synchronize(); "
        "print(json.dumps({'import_torch_secs': t1 - t0, 'import_lockstep_secs': t2 - t1, "
        "'cuda_context_secs': time.monotonic() - t2}))"
    )
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(p for p in (REPO, os.environ.get("PYTHONPATH")) if p))
    t0 = time.monotonic()
    out = subprocess.run([sys.executable, "-c", code], env=env, capture_output=True, text=True,
                         timeout=300, check=True).stdout.strip().splitlines()[-1]
    return dict(json.loads(out), process_secs=time.monotonic() - t0)


def standby_run(work_dir: str, cfg: dict, data: dict, device: str = "cuda", cold=None) -> dict:
    """Phase 15a: phase 10a's job (two ranks, ``preempt_one_worker`` at
    step 6) with the default standby pool (``--standby_workers -1``: one
    per process).  Returns its row: the re-formation split into the
    assignment (detection to the last standby's assignment), the
    rendezvous (to the new world's first step-task pull) and the state
    restore (to the chief's restore), beside ``cold`` (phase 10a's row).
    (The phase measures a fresh worker process's start beside 15b-d:
    :func:`_worker_start_probe`.)"""
    run = _distributed_run(
        cfg, data, device, work_dir, "standby", plan="preempt_one_worker",
        extra=("--standby_workers", "-1"),
    )
    master, row = run["master"], dict(run["row"])
    im = master.instance_manager
    event = master.reform_events[0] if master.reform_events else {}
    latency = event.get("latency_secs")
    assigned = max((a["at"] for a in im.activations), default=None)
    restored = row["restored_secs_after_detection"]
    split = None
    if event and assigned is not None and latency is not None and restored is not None:
        assignment = assigned - event["detected_at"]
        split = {"assignment_secs": assignment, "rendezvous_secs": latency - assignment,
                 "restore_secs": restored - latency}
    row.update(
        standby_activations=im.standby_activations,
        activated_pids=sorted(a["pid"] for a in im.activations),
        reformed_world_pids=sorted(run["built"]["worlds"][0].values()) if run["built"]["worlds"] else [],
        reform_latency_secs=latency, reform_split=split,
        accuracy=_evaluate_checkpoint(cfg, data, device, run["ckpt"]).get(cfg["accuracy_key"]),
    )
    if cold is not None:
        row["cold_10a"] = {k: cold.get(k) for k in ("reform_latency_secs", "restored_secs_after_detection")}
    print(json.dumps({"slices_standby": row}), flush=True)
    return row


def slice_loss_run(work_dir: str, cfg: dict, data: dict, device: str = "cuda") -> dict:
    """Phase 15b: four ranks in two slices (``--num_slices 2 --min_slices
    1 --replication true``, no standbys) under ``slice_loss_mid_epoch``:
    both processes of slice 1 die together at step 6; the next world is
    slice 0's two processes, restored from peer RAM."""
    from elasticdl_tpu_torch.chaos.harness import ChaosJobConfig, master_flags, slice_invariants
    from elasticdl_tpu_torch.chaos.invariants import check_replication_no_lost_steps
    from elasticdl_tpu_torch.chaos.plan import builtin_plans

    config = ChaosJobConfig(
        builtin_plans(SLICE_WORKERS)["slice_loss_mid_epoch"], work_dir, replication=True,
        num_slices=2,
    )
    run = _distributed_run(
        cfg, data, device, work_dir, "slice_loss", plan=config.plan, num_workers=SLICE_WORKERS,
        extra=(*master_flags(config), "--min_slices", "1", *REPLICATION),
    )
    events, row, master = run["events"], dict(run["row"]), run["master"]
    row.update(
        slice_loss=_observed(events, "slice_loss"), mesh_resize=_observed(events, "mesh_resize"),
        invariants=slice_invariants(config, events, master.reform_events),
        no_lost_steps=check_replication_no_lost_steps(events),
        restored_from=_restored_from(events),
        harvest=row["reform_events"][0].get("harvest") if row["reform_events"] else None,
        world_after=len(run["built"]["worlds"][0]) if run["built"]["worlds"] else None,
        accuracy=_evaluate_checkpoint(cfg, data, device, run["ckpt"]).get(cfg["accuracy_key"]),
    )
    print(json.dumps({"slices_slice_loss": row}), flush=True)
    return row


def park_grant_run(work_dir: str, cfg: dict, data: dict, device: str = "cuda") -> dict:
    """Phase 15c: two ranks in two slices (``--num_slices 2 --min_slices
    2``, with ``--master_journal_dir``) under ``slice_loss_mid_epoch``:
    slice 1's loss parks the job; ``SLICE_GRANT_SECS`` later a capacity
    grant (``set_world_slices(2)`` and ``request_reform("capacity_grant")``)
    un-parks it into a new generation that finishes the job."""
    from elasticdl_tpu_torch.chaos.harness import ChaosJobConfig, master_flags
    from elasticdl_tpu_torch.chaos.plan import builtin_plans
    from elasticdl_tpu_torch.master.journal import journal_path
    from elasticdl_tpu_torch.telemetry.events import read_jsonl

    config = ChaosJobConfig(
        builtin_plans(ELASTIC_WORKERS)["slice_loss_mid_epoch"], work_dir, master_ha=True,
        num_slices=2,
    )
    park: dict = {}

    def grant_after_park(master):
        def watch():
            deadline = time.monotonic() + 300.0
            while not master._parked and time.monotonic() < deadline:
                if master.task_d.finished():
                    return
                time.sleep(0.05)
            if not master._parked:
                return
            park.update(
                parked_at=time.monotonic(), quiesced=master.servicer.is_quiescing,
                workers_while_parked=master.instance_manager.worker_ids(),
                generation=master.servicer.cluster_version,
            )
            time.sleep(SLICE_GRANT_SECS)
            master.instance_manager.set_world_slices(2)
            master.request_reform("capacity_grant")
            park["granted_at"] = time.monotonic()

        threading.Thread(target=watch, name="phase15c-grant", daemon=True).start()

    run = _distributed_run(
        cfg, data, device, work_dir, "park_grant", plan=config.plan,
        extra=(*master_flags(config), "--min_slices", "2"), on_build=grant_after_park,
    )
    events, row, master = run["events"], dict(run["row"]), run["master"]
    worlds = [r for r in read_jsonl(journal_path(config.journal_dir)) if r.get("kind") == "world"]
    row.update(
        slice_loss=_observed(events, "slice_loss"), park=park,
        journaled_parked_worlds=[
            {k: w.get(k) for k in ("cluster_version", "worker_ids", "num_slices", "parked")}
            for w in worlds if w.get("parked")
        ],
        generation=master.servicer.cluster_version,
        unparked_secs=(
            master.reform_events[0]["detected_at"] - park["parked_at"]
            if master.reform_events and "parked_at" in park else None
        ),
        accuracy=_evaluate_checkpoint(cfg, data, device, run["ckpt"]).get(cfg["accuracy_key"]),
    )
    print(json.dumps({"slices_park_grant": row}), flush=True)
    return row


def autoscale_run(work_dir: str, cfg: dict, data: dict, device: str = "cuda") -> dict:
    """Phase 15d: two ranks in two slices (``--num_slices 2``, no standbys)
    started on one slice (the harness's ``initial_slices=1``), with
    ``AUTOSCALE_FLAGS``: the backlog grows the world to both slices."""
    from elasticdl_tpu_torch.chaos.harness import ChaosJobConfig, master_flags
    from elasticdl_tpu_torch.chaos.plan import builtin_plans

    config = ChaosJobConfig(
        builtin_plans(ELASTIC_WORKERS)["none"], work_dir, num_slices=2, initial_slices=1,
    )

    def start_small(master):
        master.instance_manager.set_world_slices(config.initial_slices)

    run = _distributed_run(
        cfg, data, device, work_dir, "autoscale", plan=config.plan,
        extra=(*master_flags(config), *AUTOSCALE_FLAGS), on_build=start_small,
    )
    row, master = dict(run["row"]), run["master"]
    row.update(
        decisions=list(master.autoscaler.decisions) if master.autoscaler else [],
        decision_events=_observed(run["events"], "autoscale_decision"),
        mesh_resize=_observed(run["events"], "mesh_resize"),
        worlds=[len(w) for w in run["built"]["worlds"]],
        accuracy=_evaluate_checkpoint(cfg, data, device, run["ckpt"]).get(cfg["accuracy_key"]),
    )
    print(json.dumps({"slices_autoscale": row}), flush=True)
    return row


def check_slices_case(case: str, row: dict, cfg: dict) -> list:
    """Phase 15's gates on one job's row; the failures, or []."""
    bad = []

    def need(ok, what):
        if not ok:
            bad.append(what)

    need(row.get("rc") == 0, "rc 0")
    need(not row.get("violations"), "no invariant violation")
    need(row.get("total_records") == cfg["train_records"] * cfg["epochs"], "every record once")
    acc = row.get("accuracy")
    need(acc is not None and acc >= cfg["min_accuracy"], "accuracy from the Local evaluate")
    need(row.get("dumps_bitwise_equal") is True, "the last world's ranks bitwise equal")
    reforms = row.get("reform_events") or []
    if case == "standby":
        need(len(reforms) == 1 and (row.get("reform_latency_secs") or 0) > 0,
             "one re-formation, its latency measured")
        need((row.get("fired") or [])[:1] == [f"preempt-p{ELASTIC_WORKERS - 1}"], "the preemption fired")
        need(row.get("standby_activations") == ELASTIC_WORKERS, "both processes from the pool")
        pids = row.get("activated_pids") or []
        need(len(pids) == ELASTIC_WORKERS and pids == row.get("reformed_world_pids"),
             "the re-formed world's pids are the pool's")
        split = row.get("reform_split") or {}
        need(all(isinstance(split.get(k), (int, float)) and split[k] >= 0
                 for k in ("assignment_secs", "rendezvous_secs", "restore_secs")),
             "the re-formation split measured")
    elif case == "slice_loss":
        losses = row.get("slice_loss") or []
        need(len(losses) == 1 and losses[0].get("lost_slices") == [1]
             and losses[0].get("parked") is False, "one slice_loss of slice 1, not parked")
        resize = row.get("mesh_resize") or []
        need(len(resize) == 1 and (resize[0].get("old_slices"), resize[0].get("new_slices")) == (2, 1)
             and (resize[0].get("old_world_size"), resize[0].get("new_world_size")) == (SLICE_WORKERS, 2),
             "a mesh_resize from 2 to 1 slices and from 4 to 2 processes")
        need(len(reforms) == 1 and row.get("world_after") == 2, "one re-formation into two processes")
        inv = {i["name"]: i["status"] for i in row.get("invariants") or []}
        need(inv.get("cross_slice_replica_coverage") == "PASS", "cross_slice_replica_coverage PASS")
        need((row.get("no_lost_steps") or {}).get("status") == "PASS", "replication_no_lost_steps PASS")
        need(str(row.get("restored_from", "")).startswith("replica@"), "restored from peer RAM")
    elif case == "park_grant":
        losses = row.get("slice_loss") or []
        need(len(losses) == 1 and losses[0].get("lost_slices") == [1] and losses[0].get("parked") is True,
             "slice 1's loss parked the job")
        park = row.get("park") or {}
        need(park.get("quiesced") is True and park.get("workers_while_parked") == [],
             "parked: world torn down, quiesced")
        parked = row.get("journaled_parked_worlds") or []
        need(len(parked) == 1 and parked[0].get("worker_ids") == [] and parked[0].get("num_slices") == 1,
             "parked in the journaled world")
        need([e.get("reason") for e in reforms] == ["capacity_grant"], "one re-formation, the grant's")
        need(len(reforms) == 1 and reforms[0].get("cluster_version") == 2
             and (park.get("generation") or 0) == 1, "the grant's world a new generation past the park's")
        need((row.get("unparked_secs") or 0) >= SLICE_GRANT_SECS, "the grant after the park")
    elif case == "autoscale":
        decisions = row.get("decisions") or []
        need(len(decisions) == 1 and decisions[0].get("action") == "grow"
             and (decisions[0].get("from_slices"), decisions[0].get("to_slices")) == (1, 2),
             "one autoscale decision, 1 -> 2 slices")
        need(len(row.get("decision_events") or []) == 1, "the decision in the event log")
        need(len(reforms) == 1 and str(reforms[0].get("reason", "")).startswith("autoscale:"),
             "a re-formation realizing it")
        resize = row.get("mesh_resize") or []
        need(len(resize) == 1 and (resize[0].get("old_slices"), resize[0].get("new_slices")) == (1, 2),
             "the world resized from 1 to 2 slices")
        need(row.get("worlds") == [ELASTIC_WORKERS], "the grown world has both processes")
    return bad


def check_slices(report: dict, cfg: dict = SLICE_MNIST) -> None:
    """Every case of phase 15 the report ran, each passing its gates
    (``standby`` is left out only where the report says so)."""
    cases = [c for c in SLICE_CASES if c != "standby" or not report.get("without_standby")]
    missing = [case for case in cases if case not in report]
    bad = {case: check_slices_case(case, report[case], cfg) for case in cases if case in report}
    bad = {case: b for case, b in bad.items() if b}
    if missing or bad:
        raise AssertionError(f"phase 15 failed: missing {missing}, gates {bad}")


def slices_phase(
    work_dir: str, cfg: dict = SLICE_MNIST, device: str = "cuda", data=None, cold=None,
    with_standby: bool = True, after_standby=None,
) -> dict:
    """Phase 15: 15a (standbys) alone, its re-formation timed beside phase
    10a's; then ``after_standby()``, and 15b (the slice loss), 15c (park
    and grant) and 15d (the autoscale grow) side by side.
    ``with_standby=False`` leaves 15a out (its CPU rehearsal is
    ``tests/test_torch_standby.py``'s)."""
    t0 = time.monotonic()
    data = data or _zoo_data(os.path.join(work_dir, "data"), cfg)
    report: dict = {}
    _release_memory(device)
    if with_standby:
        report["standby"] = standby_run(os.path.join(work_dir, "standby"), cfg, data, device, cold)
    else:
        report["without_standby"] = True
    if after_standby is not None:
        after_standby()
    jobs = dict(
        slice_loss=lambda: slice_loss_run(os.path.join(work_dir, "slice_loss"), cfg, data, device),
        park_grant=lambda: park_grant_run(os.path.join(work_dir, "park_grant"), cfg, data, device),
        autoscale=lambda: autoscale_run(os.path.join(work_dir, "autoscale"), cfg, data, device),
    )
    if device == "cuda":
        jobs["worker_start_probe"] = _worker_start_probe
    report.update(_beside(**jobs))
    report["secs"] = time.monotonic() - t0
    check_slices(report, cfg)
    return report


# ---- phase 16: serving over RPC, and hot swap ------------------------------

# 16a: two replicas of one row each (a row's bf16 logits, 2048 x 32768 x
# 2 bytes = 128 MiB, is under the 256 MiB message cap; two rows' are
# not), behind a router, from SERVE_RPC_CLIENTS client threads; requests
# cycle through SERVE_RPC_POOL distinct rows, whose direct forwards of
# both versions are made first
SERVE_RPC_ROWS = 1
SERVE_RPC_POOL = 8
SERVE_RPC_CLIENTS = 4
SERVE_RPC_WARM = 16  # one-row requests before the swap
SERVE_RPC_AFTER_ACK = 4  # requests the load sends after the swap's ack
SERVE_RPC_DEADLINE_SECS = 60.0
# 16b: mnist trained briefly through the CLI (phase 7's model and step),
# served by the real frontend with two replicas
SERVE_MNIST = dict(
    MNIST, name="mnist_serve", train_records=8192, eval_records=2048,
    shards=2, records_per_task=4096, checkpoint_steps=16,
)
SERVE_CLI_UP_SECS = 120.0
SERVE_CLI_SWAP_SECS = 60.0
SERVE_CLI_EXIT_SECS = 10.0


def _served_rows(response):
    """A response's outputs as a tensor on the CPU (bf16 kept)."""
    import numpy as np
    import torch

    from elasticdl_tpu_torch.rpc import messages as msg

    out = np.asarray(msg.unpack_array_tree(response.outputs))
    if out.dtype.name == "bfloat16":
        return torch.from_numpy(out.view(np.uint16)).view(torch.bfloat16)
    return torch.from_numpy(out)


def _row_err(got, want) -> tuple:
    """Max and mean absolute difference of two tensors, on ``want``'s
    device, in f32 (elementwise ops only: no kernel of the path runs)."""
    diff = (got.to(want.device).float() - want.float()).abs()
    return float(diff.max()), float(diff.mean())


class _LmLoad:
    """One-row LM requests sent through ``client`` and each checked, on
    arrival, against the direct forward of the version it reports:
    (request index, send time, answer time, version, max and mean error,
    phases), or the failure."""

    def __init__(self, client, pool, direct):
        self.client, self.pool, self.direct = client, pool, direct
        self.rows: list = []
        self.failures: list = []
        self._lock = threading.Lock()
        self._next = 0

    def one(self) -> None:
        from elasticdl_tpu_torch.rpc import messages as msg

        with self._lock:
            i, self._next = self._next, self._next + 1
        tokens = self.pool[i % len(self.pool)]
        sent = time.monotonic()
        try:
            response = self.client.predict(msg.PredictRequest(
                request_id=f"lm{i}", features=msg.pack_array_tree({"tokens": tokens}),
                rows=1,
            ))
        except Exception as ex:  # noqa: BLE001 — a failure is recorded
            with self._lock:
                self.failures.append(f"request {i}: {ex!r}")
            return
        answered = time.monotonic()
        if response.error or response.model_version not in self.direct:
            with self._lock:
                self.failures.append(
                    f"request {i}: version {response.model_version}, {response.error!r}"
                )
            return
        err = _row_err(
            _served_rows(response)[0], self.direct[response.model_version][i % len(self.pool)]
        )
        with self._lock:
            self.rows.append({
                "i": i, "sent": sent, "answered": answered,
                "version": response.model_version, "max_err": err[0], "mean_err": err[1],
                "phases": response.phases,
            })

    def run(self, requests: int, threads: int) -> None:
        """``requests`` requests from ``threads`` threads."""
        from concurrent.futures import ThreadPoolExecutor

        with ThreadPoolExecutor(threads) as pool:
            list(pool.map(lambda _i: self.one(), range(requests)))


def _latency(rows: list) -> dict:
    lat = sorted(r["phases"]["total_ms"] for r in rows)
    walls = sorted((r["answered"] - r["sent"]) * 1e3 for r in rows)
    phases = {
        name: statistics.median(r["phases"][name] for r in rows)
        for name in rows[0]["phases"]
    }
    return {
        "requests": len(rows), "replica_p50_ms": statistics.median(lat),
        "replica_max_ms": lat[-1], "client_p50_ms": statistics.median(walls),
        "client_max_ms": walls[-1], "replica_phases_p50_ms": phases,
    }


def serve_rpc_lm(work_dir: str, device: str = "cuda") -> dict:
    """Phase 16a: gpt2s served over the socket transport by two
    ``ServingReplica`` behind a ``ServingRouter``, hot-swapped from
    version 1 to 2 under load, then a two-row request over the message
    cap.  ``device="cpu"`` rehearses it at a small size (its caller
    lowers the cap), where the launch gate expects the plain path's 0."""
    import numpy as np
    import torch

    from elasticdl_tpu_torch.ops import attention as attn
    from elasticdl_tpu_torch.rpc import messages as msg
    from elasticdl_tpu_torch.rpc import service as rpc_service
    from elasticdl_tpu_torch.rpc.deadline import DeadlinePolicy
    from elasticdl_tpu_torch.rpc.retry import RetryPolicy
    from elasticdl_tpu_torch.serving.replica import (
        SERVING_METHODS,
        SERVING_SERVICE_NAME,
        ServingClient,
        ServingReplica,
    )
    from elasticdl_tpu_torch.serving.router import ServingRouter
    from elasticdl_tpu_torch.utils.export_utils import load_exported_model

    t_phase = time.monotonic()
    exports = {v: os.path.join(work_dir, f"lm_v{v}") for v in (1, 2)}
    t0 = time.monotonic()
    _beside(**{
        f"export_v{v}": (lambda v=v: build_export(exports[v], seed=v - 1, version=v))
        for v in exports
    })
    export_secs = time.monotonic() - t0
    row_bytes = SEQ * GPT2S["vocab_size"] * 2  # one row's bf16 logits
    cap = rpc_service.MAX_MESSAGE_BYTES
    if not row_bytes < cap <= 2 * row_bytes:
        raise AssertionError(f"a row's logits ({row_bytes} bytes) must fit the cap {cap}, two must not")
    rng = np.random.RandomState(16)
    pool = [
        rng.randint(0, GPT2S["vocab_size"], (1, SEQ)).astype(np.int32)
        for _ in range(SERVE_RPC_POOL)
    ]
    # every pool row through each version's model directly, before any
    # count is read (these launches are checks)
    t0 = time.monotonic()
    direct = {}
    with torch.inference_mode():
        for version, export in exports.items():
            model, _flat, _state = load_exported_model(export, device)
            direct[version] = [
                model({"tokens": torch.from_numpy(tokens).to(device)})[0]
                for tokens in pool
            ]
            del model
    _release_memory(device)
    direct_secs = time.monotonic() - t0

    replicas = [
        ServingReplica(
            exports[1], canonical_rows=SERVE_RPC_ROWS, device=device,
            replica_id=i, port=0,
        ).start()
        for i in range(2)
    ]
    deadlines = DeadlinePolicy.from_secs(SERVE_RPC_DEADLINE_SECS)
    router = ServingRouter(deadlines=deadlines)
    server = None
    try:
        for replica in replicas:
            router.add_replica(f"localhost:{replica.port}")
        router.probe_once()
        router.start()
        server = rpc_service.create_server(
            router, 0, methods=SERVING_METHODS, service_name=SERVING_SERVICE_NAME
        )
        server.start()
        client = ServingClient(
            f"localhost:{server.port}", retry=RetryPolicy(max_attempts=5),
            deadlines=deadlines,
        )
        attn.reset_launch_counts()
        load = _LmLoad(client, pool, direct)
        t0 = time.monotonic()
        load.run(SERVE_RPC_WARM, SERVE_RPC_CLIENTS)
        warm_secs = time.monotonic() - t0
        warm_rows = list(load.rows)
        warm_failures = list(load.failures)
        warm_dispatches = sum(r.engine.dispatches for r in replicas)
        warm_launches = attn.launch_counts["flash_fwd"]

        # the swap under load: one client thread keeps sending
        stop = threading.Event()
        ack: dict = {}

        def keep_sending():
            while not stop.is_set():
                load.one()
                if "at" in ack and sum(
                    1 for r in load.rows if r["sent"] > ack["at"]
                ) >= SERVE_RPC_AFTER_ACK:
                    return

        sender = threading.Thread(target=keep_sending)
        before_swap = len(load.rows)
        sender.start()
        while len(load.rows) + len(load.failures) < before_swap + 2 and sender.is_alive():
            time.sleep(0.01)
        t0 = time.monotonic()
        swap = client.swap_model(msg.SwapModelRequest(model_dir=exports[2]))
        ack["at"] = time.monotonic()
        swap_secs = ack["at"] - t0
        sender.join(timeout=SERVE_RPC_DEADLINE_SECS * 4)
        stop.set()
        sender.join()
        replay = client.swap_model(msg.SwapModelRequest(model_dir=exports[2]))
        dispatches = sum(r.engine.dispatches for r in replicas)
        launches = attn.launch_counts["flash_fwd"]
        swap_ms = [r.engine.last_swap_ms for r in replicas]
        versions_after = [r.engine.version for r in replicas]

        # the cap: one two-row request, answered RESOURCE_EXHAUSTED once
        served_before = sum(r.engine.requests_served for r in replicas)
        cap_calls = 0
        cap_error = None
        try:
            cap_calls += 1
            client.predict(msg.PredictRequest(
                request_id="over-cap",
                features=msg.pack_array_tree({"tokens": np.concatenate(pool[:2])}),
                rows=2,
            ))
        except rpc_service.RpcError as ex:
            cap_error = ex
        cap_served = sum(r.engine.requests_served for r in replicas) - served_before
        shapes = [r.engine.shapes_dispatched for r in replicas]
    finally:
        if server is not None:
            server.stop(1.0)
        router.close()
        for replica in replicas:
            replica.close()
        direct.clear()  # the load's reference too
        _release_memory(device)

    swapped = load.rows[before_swap:]
    row = {
        "device": device, "layers": GPT2S["num_layers"],
        "export_secs": export_secs, "direct_secs": direct_secs,
        "warm": _latency(warm_rows) if warm_rows else {}, "warm_secs": warm_secs,
        "warm_failures": warm_failures,
        "warm_dispatches": warm_dispatches, "warm_flash_fwd_launches": warm_launches,
        "swap": {
            "accepted": swap.accepted, "replicas": swap.replicas, "ack_secs": swap_secs,
            "replica_swap_ms": swap_ms, "versions_after": versions_after,
            "requests_during": len(swapped),
            "versions_during": sorted({r["version"] for r in swapped}),
            "versions_after_ack": [r["version"] for r in swapped if r["sent"] > ack["at"]],
            "replay_accepted": replay.accepted,
            "replay_absorbed": [o.get("absorbed") for o in replay.replicas],
        },
        "all": _latency(load.rows) if load.rows else {},
        "requests": len(load.rows), "dispatches": dispatches,
        "flash_fwd_launches": launches, "shapes_dispatched": shapes,
        "max_abs_err": max((r["max_err"] for r in load.rows), default=None),
        "mean_abs_err": max((r["mean_err"] for r in load.rows), default=None),
        "failures": load.failures,
        "cap": {
            "calls": cap_calls,
            "code": cap_error.code().name if cap_error is not None else None,
            "details": cap_error.details()[:200] if cap_error is not None else None,
            "replica_requests_served": cap_served,
        },
        "secs": time.monotonic() - t_phase,
    }
    print(json.dumps({"serve_rpc_lm": row}), flush=True)
    bad = check_serve_rpc_lm(row)
    if bad:
        raise AssertionError(f"phase 16a failed: {bad}")
    return row


def check_serve_rpc_lm(row: dict) -> list:
    """Phase 16a's gates on its printed row; the failed ones, by name."""
    # on the card every layer's attention is one flash_fwd launch; the
    # CPU rehearsal takes the plain path
    per_dispatch = row["layers"] if row["device"] == "cuda" else 0
    swap, cap = row["swap"], row["cap"]
    bad = []
    if row["warm_failures"] or row["failures"]:
        bad.append("failed requests")
    if row["warm"].get("requests") != SERVE_RPC_WARM:
        bad.append("warm requests missing")
    if row["warm_flash_fwd_launches"] != per_dispatch * row["warm_dispatches"] \
            or row["flash_fwd_launches"] != per_dispatch * row["dispatches"]:
        bad.append("flash_fwd launches != layers x dispatches: attention bypassed the kernel")
    if row["dispatches"] < row["requests"]:
        bad.append("fewer dispatches than one-row requests")
    if row["max_abs_err"] is None or row["max_abs_err"] > ROW_MAX_ERR \
            or row["mean_abs_err"] > ROW_MEAN_ERR:
        bad.append("served rows disagree with their version's direct forward")
    if not swap["accepted"] or [o.get("accepted") for o in swap["replicas"]] != [True, True]:
        bad.append("the swap was not accepted by both replicas")
    if swap["versions_after"] != [2, 2] or not set(swap["versions_during"]) <= {1, 2}:
        bad.append("versions after the swap")
    after_ack = swap["versions_after_ack"]
    if len(after_ack) < SERVE_RPC_AFTER_ACK or set(after_ack) != {2}:
        bad.append("a request sent after the swap's ack was not served by version 2")
    if not swap["replay_accepted"] or swap["replay_absorbed"] != [True, True]:
        bad.append("the replayed swap was not absorbed by both replicas")
    if cap["code"] != "RESOURCE_EXHAUSTED" or cap["calls"] != 1 \
            or cap["replica_requests_served"] != 1:
        bad.append("the over-cap reply was not RESOURCE_EXHAUSTED once, served once")
    if row["shapes_dispatched"] != [1, 1]:
        bad.append("a replica dispatched more than one input shape")
    return bad


def _predict_batch(cfg: dict, data: dict, rows: int):
    """The first prediction batch of ``cfg``'s evaluation records, as the
    predict CLI's client decodes it."""
    from elasticdl_tpu_torch.data.factory import create_data_reader
    from elasticdl_tpu_torch.data.fast_pipeline import build_task_batches
    from elasticdl_tpu_torch.master.task_dispatcher import TaskDispatcher
    from elasticdl_tpu_torch.trainer.state import Modes
    from elasticdl_tpu_torch.utils.model_utils import get_model_spec

    spec = get_model_spec("", cfg["model_def"])
    reader = create_data_reader(data["eval"], records_per_task=cfg["records_per_task"])
    _tid, task = TaskDispatcher(
        None, prediction_shards=reader.create_shards(),
        records_per_task=cfg["records_per_task"],
    ).get(0)
    batches = build_task_batches(
        reader, task, spec, Modes.PREDICTION, reader.metadata, rows,
        dispatch_device="cpu",
    )
    return next(iter(batches))


def _serving_children(pid: int) -> list:
    """The replica processes a serving frontend ``pid`` started (``/proc``:
    its children, not their threads, whose command line is a replica's)."""
    try:
        with open(f"/proc/{pid}/task/{pid}/children", encoding="ascii") as f:
            children = [int(c) for c in f.read().split()]
    except OSError:
        return []
    out = []
    for child in children:
        try:
            with open(f"/proc/{child}/status", encoding="ascii") as f:
                tgid = next(int(line.split()[1]) for line in f if line.startswith("Tgid:"))
            with open(f"/proc/{child}/cmdline", "rb") as f:
                if tgid == child and b"--role\x00replica" in f.read():
                    out.append(child)
        except (OSError, StopIteration, ValueError):
            continue
    return out


def _proc_running(pid: int) -> bool:
    """Whether ``pid`` is a process that has not exited (a zombie has)."""
    try:
        with open(f"/proc/{pid}/stat", encoding="ascii") as f:
            return f.read().rsplit(")", 1)[1].split()[0] != "Z"
    except (OSError, IndexError):
        return False


def _gone_within(pids: list, secs: float) -> bool:
    deadline = time.monotonic() + secs
    while time.monotonic() < deadline:
        if not any(_proc_running(p) for p in pids):
            return True
        time.sleep(0.05)
    return False


def serve_cli_mnist(work_dir: str, device: str = "cuda", cfg: dict = SERVE_MNIST) -> dict:
    """Phase 16b: ``python -m elasticdl_tpu_torch.serving.main`` with two
    replicas and ``--watch_model`` over the export of a short mnist
    training through the CLI; ``python -m elasticdl_tpu_torch.client
    predict --serving_addr`` against it, held to the Local predict CLI; a
    newer export written into the watched directory under load; SIGTERM
    and no process left."""
    import signal

    import numpy as np
    import torch

    from elasticdl_tpu_torch import client
    from elasticdl_tpu_torch.rpc import messages as msg
    from elasticdl_tpu_torch.rpc.deadline import DeadlinePolicy
    from elasticdl_tpu_torch.serving.replica import ServingClient
    from elasticdl_tpu_torch.utils.export_utils import (
        export_model,
        load_exported_model,
        read_manifest,
    )

    t_phase = time.monotonic()
    data = _zoo_data(os.path.join(work_dir, "data"), cfg)
    export_dir, ckpt = os.path.join(work_dir, "export"), os.path.join(work_dir, "ckpt")
    t0 = time.monotonic()
    with _LOCAL_LOCK:
        rc_train = client.main(_zoo_argv(
            cfg, data, device, "--output", export_dir, "--checkpoint_dir", ckpt,
            "--checkpoint_steps", str(cfg["checkpoint_steps"]),
        ))
    train_secs = time.monotonic() - t0
    if rc_train != 0:
        raise AssertionError(f"phase 16b: the mnist training exited {rc_train}")
    version = int(read_manifest(export_dir)["model_version"])
    env = dict(os.environ, **TF32_OFF)
    addr_file = os.path.join(work_dir, "serving_addr")
    log_path = os.path.join(work_dir, "frontend.log")
    row: dict = {"device": device, "train_secs": train_secs, "version": version}
    t0 = time.monotonic()
    with open(log_path, "w") as log_file:
        frontend = subprocess.Popen(
            [sys.executable, "-m", "elasticdl_tpu_torch.serving.main",
             "--model_dir", export_dir, "--num_replicas", "2", "--watch_model",
             "--addr_file", addr_file, "--device", device,
             "--minibatch_size", str(cfg["batch"]),
             # the router's deadline must outlast a replica's first
             # request, which builds its model (the default 5 s, as in
             # the JAX package, re-routes it and the client retries)
             "--rpc_deadline_secs", str(SERVE_RPC_DEADLINE_SECS)],
            cwd=REPO, env=env, stdout=log_file, stderr=subprocess.STDOUT,
        )
    kids: list = []
    try:
        while not os.path.exists(addr_file):
            if frontend.poll() is not None or time.monotonic() - t0 > SERVE_CLI_UP_SECS:
                raise AssertionError(f"phase 16b: the frontend is not up (rc {frontend.poll()})")
            time.sleep(0.05)
        with open(addr_file) as f:
            addr = f.read().strip()
        row["frontend_up_secs"] = time.monotonic() - t0
        kids = _serving_children(frontend.pid)

        # the predict CLI against the frontend, and Local on the same
        # weights (the final checkpoint, which the export holds)
        zoo = os.path.join(work_dir, "zoo")
        model_def = write_prediction_zoo(zoo, "mnist_functional_api")
        remote_out, local_out = os.path.join(work_dir, "pred_remote"), os.path.join(work_dir, "pred_local")
        os.makedirs(remote_out)
        os.makedirs(local_out)
        pred = [
            "--model_zoo", zoo, "--model_def", model_def, "--prediction_data", data["eval"],
            "--minibatch_size", str(cfg["batch"]),
            "--records_per_task", str(cfg["records_per_task"]),
        ]
        t0 = time.monotonic()
        proc = subprocess.run(
            [sys.executable, "-m", "elasticdl_tpu_torch.client", "predict", *pred,
             "--serving_addr", addr],
            cwd=REPO, env=dict(env, **{PREDICTIONS_ENV: remote_out}),
            capture_output=True, text=True, timeout=300,
        )
        row["predict_cli_secs"] = time.monotonic() - t0
        log("--- predict --serving_addr, the end of its log\n" + proc.stderr[-3000:])
        if proc.returncode != 0:
            raise AssertionError(f"phase 16b: predict --serving_addr exited {proc.returncode}")
        _local_predict([*pred, "--checkpoint_dir_for_init", ckpt, "--device", device], local_out)
        remote = np.concatenate(load_predictions(remote_out))
        local = np.concatenate(load_predictions(local_out))
        row["predicted_rows"] = int(remote.shape[0])
        row["max_abs_err_to_local"] = (
            float(np.max(np.abs(remote - local))) if remote.shape == local.shape else None
        )

        # a newer export into the watched directory, under load
        features = _predict_batch(cfg, data, cfg["batch"])
        serving = ServingClient(addr, deadlines=DeadlinePolicy.from_secs(30))
        outcomes: list = []
        stop = threading.Event()

        def keep_sending():
            i = 0
            while not stop.is_set():
                i += 1
                sent = time.monotonic()
                try:
                    response = serving.predict(msg.PredictRequest(
                        request_id=f"watch{i}", features=msg.pack_array_tree(features),
                    ))
                    outcomes.append((sent, response.model_version, response.error))
                except Exception as ex:  # noqa: BLE001 — recorded
                    outcomes.append((sent, None, repr(ex)))

        sender = threading.Thread(target=keep_sending)
        sender.start()
        try:
            time.sleep(0.5)
            model, _flat, _state = load_exported_model(export_dir, "cpu")
            with torch.no_grad():
                for param in model.parameters():
                    param.mul_(1.01)
            manifest = read_manifest(export_dir)
            t_write = time.monotonic()
            export_model(
                export_dir, model, manifest["model_def"],
                model_params=manifest.get("model_params"),
                model_zoo=manifest.get("model_zoo", ""), model_version=version + 1,
            )
            written = time.monotonic()
            status = None
            while time.monotonic() - written < SERVE_CLI_SWAP_SECS:
                status = serving.serving_status(msg.ServingStatusRequest(detail=True))
                if [r["model_version"] for r in status.replicas] == [version + 1] * 2:
                    break
                time.sleep(0.05)
            converged = time.monotonic()
            time.sleep(0.5)
        finally:
            stop.set()
            sender.join()
        row["watch"] = {
            "export_write_secs": written - t_write,
            "swap_latency_secs": converged - written,
            "replica_versions": [r["model_version"] for r in status.replicas] if status else None,
            "requests": len(outcomes),
            "failures": sum(1 for o in outcomes if o[2]),
            "first_failures": [o[2] for o in outcomes if o[2]][:3],
            "versions": sorted({o[1] for o in outcomes if o[1] is not None}),
            # versions of the requests sent once both replicas reported
            # the new one
            "after_converged": sorted({o[1] for o in outcomes if o[0] > converged}),
        }

        # SIGTERM: the frontend and both replicas gone within 10 s
        pids = [frontend.pid, *kids]
        t0 = time.monotonic()
        frontend.send_signal(signal.SIGTERM)
        row["exit"] = {
            "replicas": len(kids), "gone": _gone_within(pids, SERVE_CLI_EXIT_SECS),
            "secs": time.monotonic() - t0, "rc": frontend.poll(),
        }
    finally:
        for pid in [frontend.pid, *kids]:
            with contextlib.suppress(OSError):
                os.kill(pid, signal.SIGKILL)
        frontend.wait()
    row["secs"] = time.monotonic() - t_phase
    with open(log_path) as f:
        log("--- the serving frontend's log, its end\n" + f.read()[-3000:])
    print(json.dumps({"serve_cli_mnist": row}), flush=True)
    bad = check_serve_cli_mnist(row, cfg)
    if bad:
        raise AssertionError(f"phase 16b failed: {bad}")
    return row


def check_serve_cli_mnist(row: dict, cfg: dict = SERVE_MNIST) -> list:
    """Phase 16b's gates on its printed row; the failed ones, by name."""
    bad = []
    if row.get("predicted_rows") != cfg["eval_records"] \
            or row.get("max_abs_err_to_local") is None \
            or row["max_abs_err_to_local"] > PREDICT_MAX_ABS_ERR:
        bad.append("predict --serving_addr differs from the Local predict")
    watch, new = row.get("watch", {}), row["version"] + 1
    if watch.get("failures") != 0 or watch.get("replica_versions") != [new, new] \
            or watch.get("after_converged") not in ([new], []):
        bad.append("the watcher's swap under load")
    if row.get("exit", {}).get("replicas") != 2 or not row["exit"].get("gone"):
        bad.append("processes left after SIGTERM")
    return bad


def serving_phase(work_dir: str, device: str = "cuda") -> dict:
    """Phase 16: 16a (gpt2s over RPC, in this process) beside 16b (the
    real serving CLI's processes)."""
    t0 = time.monotonic()
    out = _beside(
        lm=lambda: serve_rpc_lm(os.path.join(work_dir, "lm"), device),
        cli=lambda: serve_cli_mnist(os.path.join(work_dir, "cli"), device),
    )
    out["secs"] = time.monotonic() - t0
    return out


# ---- phase 17: the chaos runner CLI ----------------------------------------

# (name, the runner's arguments, its exit code): each run is ``python -m
# elasticdl_tpu_torch.chaos.runner`` in a subprocess of its own, with its
# own work directory; its job (two lockstep mnist workers and their
# standby pool, the master in the runner's process) trains on the card
CHAOS_RUNS = (
    ("preempt_one_worker", ("--plan", "preempt_one_worker"), 0),
    ("double_report", ("--plan", "preempt_one_worker", "--corrupt", "double_report"), 1),
    ("dup_report_storm", ("--plan", "dup_report_storm", "--no-baseline"), 0),
    ("drop_dedup", ("--plan", "dup_report_storm", "--corrupt", "drop_dedup"), 1),
    ("blackhole_master_link", ("--plan", "blackhole_master_link", "--no-baseline"), 0),
    ("slow_network_mid_epoch", ("--plan", "slow_network_mid_epoch", "--no-baseline"), 0),
)
# each job's cap (the runner's --run-timeout-secs); a run is the faulted
# job and, for preempt_one_worker, its baseline
CHAOS_RUN_TIMEOUT_SECS = 300.0
CHAOS_TRAJECTORY_TOLERANCE = 0.15  # the runner's default
# the runs at once: all six on the card's machine; on the CPU, where the
# tests rehearse the phase beside five other test workers, three (six
# take 31 processes and 8.8 GiB of RSS at their peak, and each run's 3 s
# heartbeat timeout and 5 s deadlines must hold under the host's load)
CHAOS_CPU_WIDTH = 3


# the sessions of the chaos runs still running, stopped at exit too (a
# failure elsewhere can end the smoke while they run in the background)
_CHAOS_SESSIONS: set = set()


def _stop_chaos_sessions():
    import signal

    for pid in list(_CHAOS_SESSIONS):
        with contextlib.suppress(ProcessLookupError):
            os.killpg(pid, signal.SIGKILL)


def chaos_run(work_dir: str, name: str, argv, device: str = "cuda") -> dict:
    """One chaos runner CLI run in a subprocess (and its own session, so
    that every process its job started is stopped after it); its exit
    code, wall seconds, report and ``chaos_result.json``."""
    import atexit
    import signal

    run_dir = os.path.join(work_dir, name)
    os.makedirs(run_dir, exist_ok=True)
    out = os.path.join(run_dir, "report.json")
    cmd = [
        sys.executable, "-m", "elasticdl_tpu_torch.chaos.runner", *argv,
        "--device", device, "--workdir", run_dir, "--output", out,
        "--run-timeout-secs", str(CHAOS_RUN_TIMEOUT_SECS),
    ]
    env = dict(os.environ, PYTHONPATH=REPO + os.pathsep + os.environ.get("PYTHONPATH", ""))
    t0 = time.monotonic()
    with open(os.path.join(run_dir, "log.txt"), "w") as log:
        if not _CHAOS_SESSIONS:
            atexit.register(_stop_chaos_sessions)
        proc = subprocess.Popen(
            cmd, cwd=REPO, env=env, stdout=log, stderr=subprocess.STDOUT,
            start_new_session=True,
        )
        _CHAOS_SESSIONS.add(proc.pid)
        try:
            rc = proc.wait(timeout=2 * CHAOS_RUN_TIMEOUT_SECS + 120)
        except subprocess.TimeoutExpired:
            rc = None
        finally:
            with contextlib.suppress(ProcessLookupError):
                os.killpg(proc.pid, signal.SIGKILL)
            proc.wait()
            _CHAOS_SESSIONS.discard(proc.pid)
    secs = time.monotonic() - t0
    row = {"rc": rc, "secs": secs, "result_json": os.path.exists(
        os.path.join(run_dir, "chaos_result.json"))}
    if not os.path.exists(out):
        with open(os.path.join(run_dir, "log.txt")) as f:
            row["log_tail"] = f.read()[-3000:]
        return row
    with open(out) as f:
        report = json.load(f)
    reforms = report["reforms"]
    row.update(
        invariants_ok=report["invariants_ok"],
        invariants={i["name"]: i["status"] for i in report["invariants"]},
        fired=[(e.get("fault_id"), e.get("worker_id")) for e in report["faults_injected"]],
        reforms=len(reforms),
        dead_workers=[e.get("dead_workers") for e in reforms],
        reform_latency_secs=report["reform_latency_secs"],
        detect_secs=report["detect_secs"],
        kill_to_step_secs=report["kill_to_step_secs"],
        job_secs=report["wall_secs"],
        rpc=report["rpc"],
        standby_activated=report["standby_activated"],
        accuracy=report.get("accuracy"),
        baseline_accuracy=report.get("baseline_accuracy"),
        accuracy_delta=report.get("accuracy_delta"),
    )
    return row


def check_chaos_case(name: str, row: dict, want_rc: int) -> list:
    """The gates of one phase-17 run; the problems found."""
    problems = []
    if row["rc"] != want_rc:
        problems.append(f"exit code {row['rc']}, not {want_rc}")
    if "invariants" not in row or not row["result_json"]:
        return problems + ["no report or no chaos_result.json"]
    inv = row["invariants"]
    if want_rc == 0 and (not row["invariants_ok"] or set(inv.values()) != {"PASS"}):
        problems.append(f"invariants {inv}")
    if name == "preempt_one_worker":
        delta = row["accuracy_delta"]
        if inv.get("trajectory_parity") != "PASS" or delta is None or (
            abs(delta) > CHAOS_TRAJECTORY_TOLERANCE
        ):
            problems.append(f"trajectory_parity {inv.get('trajectory_parity')}, delta {delta}")
        if row["reforms"] != 1:
            problems.append(f"{row['reforms']} re-formations, not 1")
    elif name == "double_report":
        if row["invariants_ok"] or inv.get("exactly_once") != "FAIL":
            problems.append(f"exactly_once {inv.get('exactly_once')}")
    elif name == "dup_report_storm":
        if inv.get("duplicate_delivery_exactly_once") != "PASS":
            problems.append("duplicate_delivery_exactly_once did not PASS")
        if not row["rpc"].get("reports_deduped", 0) > 0:
            problems.append(f"no report deduplicated: {row['rpc']}")
    elif name == "drop_dedup":
        if row["invariants_ok"] or {inv.get("exactly_once"),
                                    inv.get("duplicate_delivery_exactly_once")} != {"FAIL"}:
            problems.append(f"drop_dedup tripped {inv}")
    elif name == "blackhole_master_link":
        if not row["rpc"].get("deadline_exceeded", 0) > 0:
            problems.append(f"no deadline expired: {row['rpc']}")
        victims = {w for fault_id, w in row["fired"] if fault_id and fault_id.startswith("blackhole")}
        if not row["dead_workers"] or not victims or not victims <= set(row["dead_workers"][0]):
            problems.append(
                f"the re-formation {row['dead_workers']} did not evict the blackholed {victims}"
            )
    elif name == "slow_network_mid_epoch":
        if inv.get("no_false_dead") != "PASS" or row["reforms"]:
            problems.append(f"{row['reforms']} re-formations under a slow network")
        if row["rpc"].get("deadline_exceeded", 0):
            problems.append(f"a call expired its deadline: {row['rpc']}")
    return problems


def chaos_runs(work_dir: str, device: str = "cuda") -> dict:
    """Every run of :data:`CHAOS_RUNS`, side by side: all at once on the
    card, :data:`CHAOS_CPU_WIDTH` at a time on the CPU; one row per plan,
    ungated."""
    width = len(CHAOS_RUNS) if device == "cuda" else CHAOS_CPU_WIDTH
    rows = {}
    for first in range(0, len(CHAOS_RUNS), width):
        rows.update(_beside(**{
            name: (lambda name=name, args=args: chaos_run(work_dir, name, args, device))
            for name, args, _rc in CHAOS_RUNS[first:first + width]
        }))
    return rows


def chaos_phase(work_dir: str, device: str = "cuda") -> dict:
    """Phase 17: :func:`chaos_runs`, gated by :func:`check_chaos_case`;
    one row per plan.  slow_network_mid_epoch's calls must stay within
    their 5 s deadline beside the others' load: its gate shows that none
    expired and that no worker was taken for dead."""
    t0 = time.monotonic()
    rows = chaos_runs(work_dir, device)
    for name, row in rows.items():
        print(json.dumps({f"chaos_{name}": {
            k: v for k, v in row.items() if k != "log_tail"
        }}), flush=True)
    problems = {
        name: check_chaos_case(name, rows[name], rc) for name, _args, rc in CHAOS_RUNS
    }
    failed = {name: p for name, p in problems.items() if p}
    if failed:
        for name in failed:
            log(f"--- chaos {name}: {rows[name].get('log_tail', '')}")
        raise AssertionError(f"phase 17 failed its gates: {failed}")
    return {"secs": time.monotonic() - t0, "runs": rows}


# ---- phase 18: the step anatomy, the metrics registry and /metrics ----------

# the goodput smoke's gates (scripts/goodput_smoke.py): every dispatch's
# phases sum to its wall within SUM_RESIDUAL_MS, untracked stays under
# UNTRACKED_GATE of the wall, and staging lowers the consumer-visible
# h2d share or leaves it negligible
ANATOMY_SUM_RESIDUAL_MS = 1e-3
ANATOMY_UNTRACKED_GATE = 0.02
ANATOMY_H2D_NEGLIGIBLE = 0.005
# a dispatch's device_compute must hold the device time between CUDA
# events recorded around it on the stream it ran on (ms of slack for the
# events' own resolution): a wait on another stream would leave it short
ANATOMY_STREAM_SLACK_MS = 0.05
# the keys of the JAX master's /healthz body
# (elasticdl_tpu/telemetry/master_hooks.py::build_health_fn)
HEALTHZ_KEYS = frozenset({
    "status", "job_type", "generation", "model_version", "live_workers",
    "num_live_workers", "quiescing", "last_step_age_secs", "degraded_network", "memory",
})
TRACKED_PHASES = ("host_fetch", "assemble", "h2d_transfer", "device_compute", "step_bookkeeping")
ANATOMY_WINDOWS = (("prefetch_off", "false"), ("prefetch_on", "true"))
# 18b's scrapes: the poll period, and how long the first scrape may wait
# for every tracked phase to reach /metrics
SCRAPE_POLL_SECS = 0.25
SCRAPE_FIRST_SECS = 120.0


def _anatomy_window(data: dict, device: str, tel_dir: str, prefetch: str, lm_cfg=None) -> dict:
    """One Local train CLI run of phase 6's data with ``--step_anatomy``
    (one epoch, 8 steps of 8 rows); its events, goodput section, kernel
    launches and, per ``train_step`` call, the device milliseconds between
    CUDA events recorded around it on the current stream."""
    from unittest import mock

    import torch

    from elasticdl_tpu_torch import client
    from elasticdl_tpu_torch.ops import attention as attn
    from elasticdl_tpu_torch.parallel.distributed import SPMDTrainer
    from elasticdl_tpu_torch.telemetry.events import read_jsonl
    from elasticdl_tpu_torch.telemetry.report import goodput_section

    marks = []
    train_step = SPMDTrainer.train_step

    def marked(trainer, *args):
        if device != "cuda":
            return train_step(trainer, *args)
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        out = train_step(trainer, *args)
        end.record()
        marks.append((start, end))
        return out

    argv = _local_argv(
        data, device, "--num_epochs", "1", "--step_anatomy", "true",
        "--telemetry_dir", tel_dir, "--device_prefetch", prefetch, lm_cfg=lm_cfg,
    )
    with mock.patch.object(SPMDTrainer, "train_step", marked):
        attn.reset_launch_counts()
        t0 = time.monotonic()
        rc = client.main(argv)
        secs = time.monotonic() - t0
        launches = dict(attn.launch_counts)
    gpu_ms = []
    for start, end in marks:
        end.synchronize()
        gpu_ms.append(start.elapsed_time(end))
    events = read_jsonl(os.path.join(tel_dir, "events.jsonl"))
    anat = [e for e in events if e.get("event") == "step_anatomy"]
    goodput = goodput_section(events)
    return {
        "rc": rc, "secs": secs, "launches": launches, "gpu_ms": gpu_ms,
        "dispatches": len(anat), "steps": sum(e["steps"] for e in anat),
        "step_samples": sum(1 for e in events if e.get("event") == "step"),
        "max_sum_residual_ms": max(
            (abs(e["wall_ms"] - sum(e.get(f"{p}_ms", 0.0) for p in (*TRACKED_PHASES, "untracked")))
             for e in anat), default=None,
        ),
        "device_compute_ms": [e.get("device_compute_ms", 0.0) for e in anat],
        "goodput": goodput["overall"] if goodput else None,
        # the steps after the first, whose bookkeeping builds the trainer
        # and restores its checkpoint: the step's own shares
        "steady": (goodput_section(anat[1:]) or {}).get("overall"),
    }


def check_anatomy_lm(row: dict, steps: int = LOCAL_STEPS, per_step: int = 12) -> list:
    """18a's gates on its two windows; the problems found."""
    problems = []
    shares = {}
    for name, _prefetch in ANATOMY_WINDOWS:
        w = row[name]
        if w["rc"] != 0 or w["dispatches"] != steps or w["steps"] != steps:
            problems.append(f"{name}: rc {w['rc']}, {w['dispatches']} dispatches, {w['steps']} steps")
            continue
        if w["max_sum_residual_ms"] is None or w["max_sum_residual_ms"] >= ANATOMY_SUM_RESIDUAL_MS:
            problems.append(f"{name}: phases off their wall by {w['max_sum_residual_ms']} ms")
        good = w["goodput"]
        if not good["untracked_share"] < ANATOMY_UNTRACKED_GATE:
            problems.append(f"{name}: untracked share {good['untracked_share']}")
        if not (good["e2e_vs_roofline"] and 0 < good["e2e_vs_roofline"] <= 1):
            problems.append(f"{name}: e2e_vs_roofline {good['e2e_vs_roofline']}")
        for phase in ("device_compute", "host_fetch"):
            got = good["phases"].get(phase, {})
            if got.get("p50_ms") is None or got.get("p99_ms") is None:
                problems.append(f"{name}: no p50/p99 for {phase}")
        if w["gpu_ms"]:
            short = [
                (c, g) for c, g in zip(w["device_compute_ms"], w["gpu_ms"])
                if c < g - ANATOMY_STREAM_SLACK_MS
            ]
            if len(w["gpu_ms"]) != steps or short:
                problems.append(f"{name}: device_compute short of its stream's time {short}")
        want = {k: per_step * steps for k in FLASH_NAMES} if per_step else {}
        if per_step and w["launches"] != want:
            problems.append(f"{name}: launches {w['launches']}, not {want}")
        shares[name] = good["phases"].get("h2d_transfer", {}).get("share") or 0.0
    if len(shares) == 2 and not (
        shares["prefetch_on"] < shares["prefetch_off"] or shares["prefetch_on"] < ANATOMY_H2D_NEGLIGIBLE
    ):
        problems.append(f"h2d share with prefetch {shares['prefetch_on']}, off {shares['prefetch_off']}")
    return problems


def anatomy_lm_run(work_dir: str, device: str = "cuda", lm_cfg=None) -> dict:
    """18a: the LM of phase 6 (gpt2s at full width unless ``lm_cfg``)
    through the Local train CLI with ``--step_anatomy`` and
    ``--telemetry_dir``, a window with ``--device_prefetch false`` and one
    with ``true``, gated by :func:`check_anatomy_lm`.  Its row gives each
    window's phase shares of the step."""
    import torch

    data = _local_data(work_dir, lm_cfg=lm_cfg)
    row = {"secs": 0.0}
    for name, prefetch in ANATOMY_WINDOWS:
        gc.collect()
        if device == "cuda":
            torch.cuda.empty_cache()
        row[name] = _anatomy_window(
            data, device, os.path.join(work_dir, f"telemetry_{name}"), prefetch, lm_cfg=lm_cfg,
        )
        row["secs"] += row[name]["secs"]
    layers = (lm_cfg or GPT2S)["num_layers"]
    problems = check_anatomy_lm(row, per_step=layers if device == "cuda" else 0)
    if problems:
        raise AssertionError(f"phase 18a failed its gates: {problems}")
    return row


def _scrape(port: int, path: str) -> tuple:
    import urllib.request

    with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}", timeout=10) as resp:
        return resp.status, resp.read().decode("utf-8")


def _phase_totals(text: str) -> dict:
    """``elasticdl_step_phase_ms_total{phase=...}`` samples of a scrape."""
    out = {}
    for match in re.finditer(r'^elasticdl_step_phase_ms_total\{phase="(\w+)"\} (\S+)$', text, re.M):
        out[match.group(1)] = float(match.group(2))
    return out


def _scraper(master, out: dict):
    """Scrape the master's /metrics while its world trains: the first
    scrape that shows every tracked phase, then the first later one in
    which a phase total rose (or the last before the endpoint closed),
    and /healthz once."""
    try:
        deadline = time.monotonic() + SCRAPE_FIRST_SECS
        while master.metrics_port is None and time.monotonic() < deadline:
            time.sleep(SCRAPE_POLL_SECS)
        port = out["port"] = master.metrics_port
        while time.monotonic() < deadline:
            _status, text = _scrape(port, "/metrics")
            first = _phase_totals(text)
            if set(TRACKED_PHASES) <= set(first):
                out["first"] = first
                break
            time.sleep(SCRAPE_POLL_SECS)
        else:
            return
        status, body = _scrape(port, "/healthz")
        out["healthz"] = {"status": status, "body": json.loads(body)}
        while master.metrics_port is not None:
            time.sleep(SCRAPE_POLL_SECS)
            try:
                _status, text = _scrape(port, "/metrics")
            except OSError:  # the job ended and its endpoint closed
                break
            second = out["second"] = _phase_totals(text)
            if any(second.get(p, 0.0) > v for p, v in first.items()):
                break
    except Exception as ex:  # noqa: BLE001 — the gates report it
        out.setdefault("error", repr(ex))


def check_anatomy_world(row: dict) -> list:
    """18b's gates; the problems found."""
    problems = []
    if row["rc"] != 0 or row["violations"]:
        problems.append(f"rc {row['rc']}, violations {row['violations']}")
    first, second = row.get("first"), row.get("second")
    if not first or not second:
        problems.append(f"not two scrapes of every tracked phase: {row.get('error')}")
    else:
        missing = [p for p in TRACKED_PHASES if p not in first or p not in second]
        fell = [p for p in first if second.get(p, 0.0) < first[p]]
        if missing or fell:
            problems.append(f"phase totals missing {missing} or falling {fell}")
    health = row.get("healthz") or {}
    if health.get("status") != 200 or set(health.get("body", {})) != HEALTHZ_KEYS:
        problems.append(f"/healthz {health}")
    generations = row.get("goodput_generations") or {}
    if not generations or set(generations) != set(row["step_generations"]) or any(
        not g["dispatches"] for g in generations.values()
    ):
        problems.append(
            f"goodput generations {sorted(generations)}, step samples' {row['step_generations']}"
        )
    return problems


def anatomy_world_run(work_dir: str, data: dict, device: str = "cuda", cfg=None) -> dict:
    """18b: a two-rank mnist world on ``data`` (phase 10's shards) with
    ``--step_anatomy``, ``--telemetry_dir`` and ``--metrics_port 0``; the
    master's /metrics scraped over HTTP while it trains, gated by
    :func:`check_anatomy_world`."""
    from elasticdl_tpu_torch.telemetry.events import read_jsonl
    from elasticdl_tpu_torch.telemetry.report import goodput_section

    cfg = cfg or ELASTIC_MNIST
    tel_dir = os.path.join(work_dir, "telemetry")
    scraped: dict = {}
    threads = []

    def on_build(master):
        thread = threading.Thread(target=_scraper, args=(master, scraped), daemon=True)
        thread.start()
        threads.append(thread)

    t0 = time.monotonic()
    run = _distributed_run(
        cfg, data, device, work_dir, "anatomy", on_build=on_build,
        extra=("--step_anatomy", "true", "--telemetry_dir", tel_dir, "--metrics_port", "0"),
    )
    for thread in threads:
        thread.join(timeout=30)
    events = read_jsonl(os.path.join(tel_dir, "events.jsonl"))
    goodput = goodput_section(events) or {}
    row = {
        "secs": time.monotonic() - t0, "rc": run["row"]["rc"],
        "violations": run["row"]["violations"],
        **{k: scraped.get(k) for k in ("first", "second", "healthz", "error")},
        "step_generations": sorted({e.get("generation", 0) for e in events if e.get("event") == "step"}),
        "goodput_generations": goodput.get("generations"),
    }
    problems = check_anatomy_world(row)
    if problems:
        raise AssertionError(f"phase 18b failed its gates: {problems}")
    return row


class _PhaseClock:
    """Each phase's wall seconds, from the end of the one before."""

    def __init__(self):
        self.secs: dict = {}
        self._last = STARTED_AT

    def done(self, name: str):
        now = time.monotonic()
        self.secs[name] = now - self._last
        self._last = now
        log(f"phase {name}: {self.secs[name]:.1f} s ({now - STARTED_AT:.1f} s in all)")

    def line(self) -> dict:
        return {"phase_secs": dict(self.secs, total=time.monotonic() - STARTED_AT)}


def _bytecode_cache() -> str:
    """A bytecode cache for this run and every process it starts.  The
    card's machine sets ``PYTHONDONTWRITEBYTECODE`` and ships torch
    without ``.pyc`` files, so each worker, standby, runner and replica
    compiled torch's sources afresh: about 1 s of each ``import torch``,
    and 3.5 of the 8 s that a process's first optimizer takes (it imports
    ``torch._dynamo``).  The cache is a temporary directory of this run,
    removed at its exit; nothing under site-packages is written."""
    import atexit
    import shutil

    path = tempfile.mkdtemp(prefix="chip_smoke_pycache_")
    atexit.register(shutil.rmtree, path, True)
    os.environ.pop("PYTHONDONTWRITEBYTECODE", None)
    os.environ["PYTHONPYCACHEPREFIX"] = path
    sys.dont_write_bytecode = False
    sys.pycache_prefix = path
    return path


def main() -> int:
    phases = _PhaseClock()
    _bytecode_cache()
    try:
        import torch
    except ImportError as ex:
        return fail(f"torch is not importable: {ex}")
    if not torch.cuda.is_available():
        return fail("CUDA is not available; this smoke runs on a GPU")
    if not os.path.isdir(os.path.join(REPO, "elasticdl_tpu_torch")):
        return fail(f"{REPO} is not the root of a checkout of the repo")
    sys.path.insert(0, REPO)
    from elasticdl_tpu_torch.ops import _build

    # ---- 1. device
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    # state both TF32 switches: every f32 product here runs in full f32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device_name = torch.cuda.get_device_name(0)
    phases.done("1_device")

    # ---- 2. build
    t0 = time.monotonic()
    _build.build(["flash_fwd", "flash_bwd"])
    print(json.dumps({"build_secs": time.monotonic() - t0}), flush=True)
    for name, text in _build.build_logs.items():
        log(f"--- nvcc {name}.cu\n{text}")
    kernel_build_report(_build, ["flash_fwd", "flash_bwd"])
    phases.done("2_build")

    # ---- 3. kernels against their plain versions
    flash = check_flash_cases()
    phases.done("3_kernels")
    backward = check_backward_cases()
    phases.done("3b_backward")

    # ---- 4. the serving path
    with tempfile.TemporaryDirectory(prefix="chip_smoke_export_") as model_dir:
        t0 = time.monotonic()
        build_export(model_dir)
        print(json.dumps({"export_secs": time.monotonic() - t0}), flush=True)
        serve_launches = serve_lm(model_dir)
    phases.done("4_serve")

    # ---- 5. the training path
    train_launches, bare_tokens_per_s = train_lm()
    phases.done("5_train")

    # ---- 6. the train CLI (Local strategy), after phase 5's trainer and
    # its Adam state are freed
    gc.collect()
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_local_") as work_dir:
        local_launches = local_train_lm(work_dir, bare_tokens_per_s=bare_tokens_per_s)
    print(json.dumps({"launches_by_path": {
        "serve": {"flash_fwd": serve_launches}, "train": train_launches,
        "local_train": local_launches,
    }}), flush=True)
    phases.done("6_local_train")

    # ---- 7. mnist through the train CLI, after phase 6's LM is freed
    gc.collect()
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_mnist_") as work_dir:
        mnist_train = train_zoo_model(work_dir, MNIST)
        print(json.dumps({"mnist_train": mnist_train}), flush=True)
    phases.done("7_mnist")

    # ---- 8. DeepFM through the train CLI
    gc.collect()
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_deepfm_") as work_dir:
        print(json.dumps({"deepfm_train": train_deepfm(work_dir)}), flush=True)
    phases.done("8_deepfm")

    # ---- 9. stacked steps (one CUDA graph replay per group), remat and
    # the device pipeline through the train CLI
    stacked = {"device": smi, "auto": auto_probe()}
    with tempfile.TemporaryDirectory(prefix="chip_smoke_stacked_") as work_dir:
        _release_memory("cuda")
        stacked["mnist"] = stacked_zoo_run(
            os.path.join(work_dir, "mnist"), MNIST, STACKED_MNIST,
            variants=STACKED_MNIST_VARIANTS,
            single_busy_ms=mnist_train["bare"]["device_busy_ms_per_step"],
        )
        _release_memory("cuda")
        stacked["deepfm"] = stacked_zoo_run(
            os.path.join(work_dir, "deepfm"), DEEPFM_ACCURACY, STACKED_DEEPFM,
            wide_cfg=DEEPFM_WIDE, wide_stacked=STACKED_DEEPFM_WIDE,
        )
        gc.collect()
        torch.cuda.empty_cache()
        stacked["lm"] = stacked_lm_run(
            os.path.join(work_dir, "lm"), bare_tokens_per_s=bare_tokens_per_s
        )
    stacked_launches = stacked["lm"]["checked"]["launches"]
    print(json.dumps({"stacked": stacked}), flush=True)
    phases.done("9_stacked")

    # ---- 10. AllreduceStrategy: two worker processes under the port's
    # master, a preemption and the re-formed world, through the train CLI
    elastic_rows = {"device": smi}
    # phase 10's mnist shards, made once: phases 12, 14 and 15 train on
    # them too
    mnist_shards_dir = tempfile.TemporaryDirectory(prefix="chip_smoke_mnist_shards_")
    mnist_shards = _zoo_data(mnist_shards_dir.name, ELASTIC_MNIST)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_elastic_") as work_dir:
        _release_memory("cuda")
        mnist_dir = os.path.join(work_dir, "mnist")
        mnist_run = elastic_preempt_run(mnist_dir, ELASTIC_MNIST, data=mnist_shards)
        elastic_rows["mnist_preempt"] = mnist_run["row"]
        # 10b's worlds beside 10c's spawned ranks: each job leaves the
        # card idle while its processes start (10a ran alone: its rate and
        # cold re-formation are phases 14's and 15's yardsticks)
        beside = _beside(
            deepfm=lambda: elastic_preempt_run(os.path.join(work_dir, "deepfm"), ELASTIC_DEEPFM),
            dp_lm=dp_lm_run,
            parity=lambda: elastic_parity_run(
                os.path.join(work_dir, "parity"), ELASTIC_MNIST, mnist_run["data"],
                mnist_run["ckpt"],
            ),
        )
        elastic_rows["deepfm_preempt"] = beside["deepfm"]["row"]
        dp_lm = elastic_rows["dp_lm"] = beside["dp_lm"]
        elastic_rows["mnist_parity"] = beside["parity"]
    print(json.dumps({"elastic": elastic_rows}), flush=True)
    phases.done("10_elastic")

    # ---- 11. evaluate and predict in distributed jobs: the master's
    # evaluation service, the lockstep worker's evaluation and prediction
    # tasks, the task-stream worker, the device pipeline under lockstep
    eval_rows = {"device": smi}
    with tempfile.TemporaryDirectory(prefix="chip_smoke_eval_") as work_dir:
        _release_memory("cuda")

        def mnist_eval_jobs():
            mnist_eval = eval_preempt_run(os.path.join(work_dir, "mnist"), EVAL_MNIST)
            eval_rows["mnist_eval_preempt"] = mnist_eval["row"]
            eval_rows["mnist_evaluate_predict"] = eval_predict_run(
                os.path.join(work_dir, "mnist_ep"), EVAL_MNIST, mnist_eval["data"],
                mnist_eval["ckpt"], mnist_eval["final"],
            )

        # 11a-b's mnist worlds, 11c's DeepFM task stream and the LM's
        # jobs side by side, and 18b's anatomy world beside them (no rate
        # of 18b's is a yardstick: its anatomy waits on every dispatch)
        beside = _beside(
            mnist=mnist_eval_jobs,
            deepfm=lambda: task_stream_zoo_run(os.path.join(work_dir, "deepfm"), TS_DEEPFM),
            lm=lambda: task_stream_lm_run(os.path.join(work_dir, "lm")),
            anatomy=lambda: anatomy_world_run(os.path.join(work_dir, "anatomy"), mnist_shards),
        )
        eval_rows["deepfm_task_stream"] = beside["deepfm"]
        eval_lm = eval_rows["lm"] = beside["lm"]
        anatomy_world = beside["anatomy"]
    print(json.dumps({"evaluate_predict": eval_rows}), flush=True)
    phases.done("11_evaluate_predict")

    # ---- 12. peer replication and hot restore: the re-formed world
    # resumes from peer host RAM at the last replicated step
    replica_rows = {"device": smi}
    with tempfile.TemporaryDirectory(prefix="chip_smoke_replica_") as work_dir:
        _release_memory("cuda")
        # 12a-b's mnist worlds beside 12d's LM world; 12c's timed runs
        # alone
        beside = _beside(
            hot=lambda: replica_preempt_run(
                os.path.join(work_dir, "hot"), REPLICA_MNIST, data=mnist_shards
            ),
            torn=lambda: replica_torn_run(
                os.path.join(work_dir, "torn"), REPLICA_MNIST, mnist_shards
            ),
            lm=lambda: replica_lm_run(os.path.join(work_dir, "lm")),
        )
        hot = beside["hot"]
        replica_rows["hot_restore"] = hot["row"]
        replica_rows["torn_push"] = beside["torn"]
        replica_lm = replica_rows["lm"] = beside["lm"]
        _release_memory("cuda")
        replica_rows["costs"] = replica_cost_run(
            os.path.join(work_dir, "cost"), REPLICA_MNIST, hot["data"], hot["row"],
            elastic_rows["mnist_preempt"],
        )
    print(json.dumps({"replication": replica_rows}), flush=True)
    phases.done("12_replication")

    # ---- 13. the rest of the single-device zoo: ResNet-50 at bench.py's
    # headline width and step through the train CLI, the imagenet shape
    # through the trainer, and every other model of the zoo through the CLI
    zoo_rows = {"device": smi}
    t13 = time.monotonic()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_zoo_") as work_dir:
        _release_memory("cuda")
        zoo_rows["resnet50_cifar10"] = train_resnet_cifar(os.path.join(work_dir, "resnet"))
        _release_memory("cuda")
        zoo_rows["imagenet_resnet50"] = imagenet_resnet_steps()
        _release_memory("cuda")
        zoo_rows["rest"] = train_zoo_rest(os.path.join(work_dir, "rest"))
    zoo_rows["secs"] = time.monotonic() - t13
    print(json.dumps({"zoo": zoo_rows}), flush=True)
    phases.done("13_zoo")

    # ---- 14. the master journal and master high availability: a killed
    # master relaunched from --master_journal_dir, its workers re-homed
    with tempfile.TemporaryDirectory(prefix="chip_smoke_ha_") as work_dir:
        ha_rows = master_ha_phase(
            work_dir, rate_10a=elastic_rows["mnist_preempt"]["steady_records_per_s"],
            data=mnist_shards,
        )
    print(json.dumps({"master_ha": {"device": smi, **ha_rows}}), flush=True)
    phases.done("14_master_ha")

    # ---- 15. hot standbys, slice-granular elasticity and parking, and
    # the autoscaler.  Phase 17's chaos runs (subprocesses, none of whose
    # seconds is a yardstick) start once 15a, which is timed, has ended,
    # and run beside 15b-d and phase 16
    chaos_dir = tempfile.TemporaryDirectory(prefix="chip_smoke_chaos_")
    chaos: list = []

    def start_chaos():
        _release_memory("cuda")
        chaos.append(_in_background(lambda: chaos_phase(chaos_dir.name), "17_chaos"))

    with tempfile.TemporaryDirectory(prefix="chip_smoke_slices_") as work_dir:
        slice_rows = slices_phase(
            work_dir, data=mnist_shards, cold=elastic_rows["mnist_preempt"],
            after_standby=start_chaos,
        )
    mnist_shards_dir.cleanup()
    print(json.dumps({"slices": {"device": smi, **slice_rows}}), flush=True)
    phases.done("15_slices")

    # ---- 16. serving over RPC: gpt2s behind a router, hot-swapped under
    # load, beside the serving CLI with its watcher and predict
    # --serving_addr
    with tempfile.TemporaryDirectory(prefix="chip_smoke_serving_") as work_dir:
        _release_memory("cuda")
        serving_rows = serving_phase(work_dir)
    serve_rpc_launches = serving_rows["lm"]["flash_fwd_launches"]
    print(json.dumps({"serving_rpc": {
        "device": smi, "secs": serving_rows["secs"],
        "lm_secs": serving_rows["lm"]["secs"], "cli_secs": serving_rows["cli"]["secs"],
    }}), flush=True)
    phases.done("16_serving")

    # ---- 17. the chaos runner CLI: fault plans against port jobs,
    # started after 15a; its clock's seconds are what it ran past phase 16
    chaos_rows = chaos[0]()
    chaos_dir.cleanup()
    print(json.dumps({"chaos": {"device": smi, "secs": chaos_rows["secs"]}}), flush=True)
    phases.done("17_chaos")

    # ---- 18. the step anatomy: (a) the gpt2s LM through the Local CLI
    # alone, its shares being the finding; (b) ran beside phase 11
    with tempfile.TemporaryDirectory(prefix="chip_smoke_anatomy_") as work_dir:
        _release_memory("cuda")
        anatomy_lm = anatomy_lm_run(work_dir)
    anatomy_launches = {
        k: sum(anatomy_lm[name]["launches"][k] for name, _p in ANATOMY_WINDOWS)
        for k in FLASH_NAMES
    }
    print(json.dumps({"anatomy": {
        "device": smi, "lm": {
            "secs": anatomy_lm["secs"],
            **{name: {
                "secs": anatomy_lm[name]["secs"],
                "goodput": anatomy_lm[name]["goodput"],
                "steady": anatomy_lm[name]["steady"],
                "device_compute_ms": anatomy_lm[name]["device_compute_ms"],
                "stream_gpu_ms": anatomy_lm[name]["gpu_ms"],
            } for name, _p in ANATOMY_WINDOWS},
        },
        "world": anatomy_world,
    }}), flush=True)
    phases.done("18_anatomy")

    def row(name, source, replaces, measured):
        return {
            "name": name,
            "route": "cuda",
            "source": f"elasticdl_tpu_torch/ops/csrc/{source}",
            "replaces": f"elasticdl_tpu/ops/attention.py:{replaces}",
            "launches": train_launches[name] + local_launches[name]
            + stacked_launches[name] + dp_lm["launches"][name]
            + eval_lm["launches"][name] + replica_lm["launches"][name]
            + anatomy_launches[name]
            + (serve_launches + serve_rpc_launches if name == "flash_fwd" else 0),
            "max_abs_err": measured["max_abs_err"],
            "ms": measured["kernel_ms"],
            "plain_ms": measured["plain_ms"],
            "bound_ms": measured["bound_ms"],
            "bound_by": measured["bound_by"],
            "library_ms": measured["library_ms"],
        }

    train_case = backward["train"]
    kernels = [
        row("flash_fwd", "flash_fwd.cu", 182, flash["served"]),
        row("flash_bwd_dq", "flash_bwd.cu", 261, train_case["flash_bwd_dq"]),
        row("flash_bwd_dkv", "flash_bwd.cu", 335, train_case["flash_bwd_dkv"]),
    ]
    print(json.dumps(phases.line()), flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({
        "ok": True,
        "device": {
            "platform": "gpu",
            "kind": device_name,
            "count": torch.cuda.device_count(),
        },
    }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
