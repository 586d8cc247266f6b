"""The command-line flags; a copy of ``parse_master_args`` and its parser
groups from ``elasticdl_tpu/utils/args.py``, so the port's CLI takes the
JAX CLI's flags with the same types and defaults.

``--device`` (``cuda`` unless the caller asks for ``cpu``) names the
torch device a job runs on.  The JAX CLI's ``--jax_platform`` is taken
too and mapped onto it (``cpu`` to ``cpu``, ``gpu`` to ``cuda``); any
other platform is refused by name.  Every other flag is the JAX CLI's.
A flag whose feature the port does not have yet is parsed like any
other, and :func:`check_ported_flags` (called when an executor or a
master is built) raises when it is set to anything but its default,
naming the flag and the slice of ``ROADMAP.md`` queue 1 that brings it.

The master assembles each worker's argv from its own flags
(:func:`build_worker_arguments`), and the worker parses it with
:func:`parse_worker_args`, as the JAX package's do.
"""

from __future__ import annotations

import argparse
import ast
import math

from elasticdl_tpu_torch.utils.constants import (
    MASTER_DEFAULT_PORT,
    DistributionStrategy,
    JobType,
)
from elasticdl_tpu_torch.utils.log_utils import default_logger as logger


def pos_int(arg: str) -> int:
    value = int(arg)
    if value <= 0:
        raise argparse.ArgumentTypeError(f"must be a positive integer: {arg}")
    return value


def non_neg_int(arg: str) -> int:
    value = int(arg)
    if value < 0:
        raise argparse.ArgumentTypeError(f"must be >= 0: {arg}")
    return value


def non_neg_float(arg: str) -> float:
    value = float(arg)
    if value < 0:
        raise argparse.ArgumentTypeError(
            f"must be a non-negative float: {arg}"
        )
    return value


def pos_float(arg: str) -> float:
    value = float(arg)
    if value <= 0:
        raise argparse.ArgumentTypeError(f"must be a positive float: {arg}")
    return value


def parse_bool(arg) -> bool:
    if isinstance(arg, bool):
        return arg
    lowered = str(arg).lower()
    if lowered in ("true", "1", "yes"):
        return True
    if lowered in ("false", "0", "no"):
        return False
    raise argparse.ArgumentTypeError(f"not a boolean: {arg}")


def parse_params_dict(arg: str | None) -> dict:
    """Parse the ``k=v;k=v`` mini-DSL of ``--model_params`` /
    ``--data_reader_params``: values through ``ast.literal_eval`` when
    possible, else kept as strings."""
    params: dict = {}
    if not arg:
        return params
    for kv in arg.split(";"):
        if not kv.strip():
            continue
        k, sep, v = kv.partition("=")
        if not sep:
            raise ValueError(f"malformed params entry (need k=v): {kv!r}")
        k, v = k.strip(), v.strip()
        try:
            params[k] = ast.literal_eval(v)
        except (ValueError, SyntaxError):
            params[k] = v
    return params


def _add_job_params(parser: argparse.ArgumentParser):
    parser.add_argument("--job_name", default="elasticdl-job", help="Job name")
    parser.add_argument(
        "--log_level",
        default="INFO",
        choices=["DEBUG", "INFO", "WARNING", "ERROR"],
        help="Logging level (DEBUG also turns on the timing buckets)",
    )
    parser.add_argument(
        "--envs",
        type=str,
        default="",
        help="Extra environment variables of worker processes, k=v,k=v",
    )


def _add_model_spec_params(parser: argparse.ArgumentParser):
    parser.add_argument(
        "--model_zoo",
        required=False,
        default="",
        help=(
            "Directory that contains user-defined model modules; empty "
            "means the built-in elasticdl_tpu_torch.models zoo"
        ),
    )
    parser.add_argument(
        "--model_def",
        required=True,
        help=(
            "Model definition in module path form, e.g. "
            "long_seq_transformer.long_seq_transformer.custom_model"
        ),
    )
    parser.add_argument(
        "--model_params",
        default="",
        help="Keyword args for custom_model(), 'k=v;k=v' form",
    )
    parser.add_argument("--dataset_fn", default="dataset_fn")
    parser.add_argument("--loss", default="loss")
    parser.add_argument("--optimizer", default="optimizer")
    parser.add_argument("--eval_metrics_fn", default="eval_metrics_fn")
    parser.add_argument("--custom_data_reader", default="custom_data_reader")
    parser.add_argument(
        "--prediction_outputs_processor",
        default="PredictionOutputsProcessor",
        help="Class in the model module that processes prediction outputs",
    )


def _add_data_params(parser: argparse.ArgumentParser):
    parser.add_argument("--training_data", default="")
    parser.add_argument("--validation_data", default="")
    parser.add_argument("--prediction_data", default="")
    parser.add_argument(
        "--records_per_task",
        type=pos_int,
        default=4096,
        help="Records per dynamic-sharding task (the elasticity unit)",
    )
    parser.add_argument("--minibatch_size", type=pos_int, default=64)
    parser.add_argument(
        "--steps_per_dispatch",
        type=lambda v: v if v == "auto" else pos_int(v),
        default=1,
        help="Optimizer steps in one device dispatch (one CUDA graph replay "
        "on the card), or 'auto' to size them from the batch bytes and the "
        "measured dispatch cost",
    )
    parser.add_argument("--num_epochs", type=pos_int, default=1)
    parser.add_argument(
        "--data_reader_params",
        default="",
        help="Keyword args for the data reader, 'k=v;k=v' form",
    )
    parser.add_argument(
        "--shuffle_seed",
        type=int,
        default=None,
        required=False,
        help=(
            "Seed for training-task shuffling; unset = nondeterministic "
            "order (set it for reproducible runs and A/B comparisons)"
        ),
    )
    parser.add_argument(
        "--num_minibatches_per_task",
        type=pos_int,
        default=None,
        required=False,
        help="If set, records_per_task = minibatch_size * this",
    )
    parser.add_argument(
        "--serving_addr",
        default=None,
        required=False,
        help="predict only: a running serving endpoint (not ported)",
    )


def _add_train_params(parser: argparse.ArgumentParser):
    parser.add_argument("--evaluation_steps", type=non_neg_int, default=0)
    parser.add_argument(
        "--evaluation_start_delay_secs", type=non_neg_int, default=100
    )
    parser.add_argument(
        "--evaluation_throttle_secs", type=non_neg_int, default=0
    )
    parser.add_argument("--checkpoint_steps", type=non_neg_int, default=0)
    parser.add_argument("--checkpoint_dir", default="")
    parser.add_argument(
        "--checkpoint_dir_for_init",
        default="",
        help="Restore initial model state from this checkpoint directory",
    )
    parser.add_argument("--keep_checkpoint_max", type=non_neg_int, default=3)
    parser.add_argument(
        "--replication", type=parse_bool, default=None, required=False,
        help="AllreduceStrategy worlds of two or more workers: replicate "
        "each process's share of the trainer state into its ring "
        "neighbor's host RAM, so a re-formed world resumes at the last "
        "replicated step instead of the last disk checkpoint (a Local "
        "run and a single task-stream worker take it and do not read it)",
    )
    parser.add_argument(
        "--replication_steps", type=non_neg_int, default=None,
        required=False,
        help="With --replication: replicate at each crossing of a "
        "multiple of N steps (0 or unset: at every task boundary)",
    )
    parser.add_argument(
        "--output", default="", help="Directory for the exported model"
    )
    parser.add_argument("--tensorboard_log_dir", default="")
    parser.add_argument(
        "--telemetry_dir", default="",
        help="Structured event log directory (not ported)",
    )
    parser.add_argument(
        "--metrics_port", type=int, default=0,
        help="Port of the master's /metrics endpoint (not ported)",
    )
    parser.add_argument(
        "--metrics_host", default="127.0.0.1",
        help="Bind address of /metrics (not ported)",
    )
    parser.add_argument(
        "--trace_sample_rate", type=float, default=None, required=False,
        help="Fraction of hot-path spans kept in the trace (not ported)",
    )
    parser.add_argument(
        "--step_anatomy", type=parse_bool, default=None, required=False,
        help="Per-dispatch time anatomy (not ported)",
    )
    parser.add_argument(
        "--device_prefetch", type=parse_bool, default=None, required=False,
        help="Stage the next dispatch group on the device while the "
        "current one computes",
    )
    parser.add_argument(
        "--boundary_fusion", type=parse_bool, default=None, required=False,
        help="Stage across task boundaries (needs --device_prefetch)",
    )
    parser.add_argument(
        "--pipeline_depth", type=pos_int, default=None, required=False,
        help="Dispatch groups in flight before the host waits (default 2)",
    )
    parser.add_argument(
        "--profile_dir", default="",
        help="Capture a profiler trace of a few steps here (not ported)",
    )
    parser.add_argument(
        "--profile_steps", type=pos_int, default=5,
        help="How many steps the profiler window covers (not ported)",
    )
    parser.add_argument(
        "--get_model_steps",
        type=pos_int,
        default=1,
        help=(
            "Accepted for compatibility with the reference's local-SGD "
            "mode; gradients sync every step (coerced to 1, with a warning)"
        ),
    )
    parser.add_argument(
        "--use_async",
        type=parse_bool,
        default=False,
        help=(
            "Accepted for compatibility with the reference's async-SGD "
            "mode; training is synchronous (a warning when set)"
        ),
    )
    parser.add_argument(
        "--grads_to_wait",
        type=pos_int,
        default=1,
        help="Compatibility flag from the sync-PS mode; unused",
    )
    parser.add_argument("--learning_rate", type=pos_float, default=None,
                        required=False,
                        help="Override the model module's learning rate")


def _add_mesh_params(parser: argparse.ArgumentParser):
    parser.add_argument(
        "--distribution_strategy",
        default=DistributionStrategy.LOCAL,
        choices=list(DistributionStrategy.ALL),
    )
    parser.add_argument(
        "--num_workers", type=non_neg_int, default=1,
        help="Worker processes of a distributed job; 2 or more form one "
        "world that trains one model",
    )
    parser.add_argument(
        "--mesh_shape",
        default="",
        help=(
            "Logical device mesh, e.g. 'dp=8'; the port runs on one "
            "device, so '' or a mesh of size 1"
        ),
    )
    parser.add_argument(
        "--dcn_mesh_shape", default="",
        help="Mesh axes that span slices (not ported)",
    )
    parser.add_argument(
        "--compute_dtype",
        default="bfloat16",
        choices=["bfloat16", "float32"],
        help="Dtype float features are cast to before the training forward",
    )
    parser.add_argument(
        "--remat", type=parse_bool, default=False,
        help="Recompute the forward in the backward instead of keeping "
        "its activations",
    )
    parser.add_argument(
        "--donate_state", type=parse_bool, default=True,
        help=(
            "Donate train-state buffers to the step: what eager PyTorch "
            "does anyway (it updates the state in place)"
        ),
    )
    parser.add_argument(
        "--jax_platform",
        default="",
        help=(
            "The JAX CLI's platform pin, mapped onto --device: 'cpu' or "
            "'gpu' (any other platform is refused)"
        ),
    )
    parser.add_argument(
        "--device",
        default=None,
        help=(
            "The torch device the job runs on: 'cuda' (default; fails "
            "without a card) or 'cpu' when asked for"
        ),
    )
    parser.add_argument(
        "--compilation_cache_dir", default="",
        help="Persistent XLA compilation cache (no counterpart in the port)",
    )


def _add_master_params(parser: argparse.ArgumentParser):
    parser.add_argument("--port", type=non_neg_int, default=MASTER_DEFAULT_PORT)
    parser.add_argument(
        "--instance_backend", default="local", choices=["local", "k8s", "none"]
    )
    parser.add_argument("--namespace", default="default")
    parser.add_argument("--docker_image", default="")
    parser.add_argument("--docker_image_repository", default="")
    parser.add_argument("--docker_base_image", default="")
    parser.add_argument(
        "--worker_resource_request", default="cpu=1,memory=4096Mi"
    )
    parser.add_argument("--worker_resource_limit", default="")
    parser.add_argument("--worker_pod_priority", default="")
    parser.add_argument(
        "--master_resource_request", default="cpu=1,memory=4096Mi"
    )
    parser.add_argument("--master_resource_limit", default="")
    parser.add_argument("--master_pod_priority", default="")
    parser.add_argument("--volume", default="")
    parser.add_argument(
        "--image_pull_policy",
        default="Always",
        choices=["Always", "IfNotPresent", "Never"],
    )
    parser.add_argument(
        "--relaunch_on_worker_failure", type=non_neg_int, default=3
    )
    parser.add_argument(
        "--heartbeat_timeout_secs", type=non_neg_float, default=30.0
    )
    parser.add_argument("--task_timeout_secs", type=non_neg_float, default=0.0)
    parser.add_argument("--cluster_spec", default="")
    parser.add_argument("--yaml", default="")
    parser.add_argument("--master_journal_dir", default=None, required=False)
    parser.add_argument(
        "--rpc_retry_secs", type=non_neg_float, default=None, required=False
    )
    parser.add_argument(
        "--rpc_deadline_secs", type=pos_float, default=None, required=False
    )
    parser.add_argument(
        "--rehome_grace_secs", type=non_neg_float, default=None, required=False
    )
    parser.add_argument(
        "--num_slices", type=pos_int, default=None, required=False
    )
    parser.add_argument(
        "--min_slices", type=pos_int, default=None, required=False
    )
    parser.add_argument(
        "--autoscale_p95_step_ms", type=pos_float, default=None,
        required=False,
    )
    parser.add_argument(
        "--autoscale_backlog_tasks", type=pos_int, default=None,
        required=False,
    )
    parser.add_argument(
        "--autoscale_cooldown_secs", type=non_neg_float, default=None,
        required=False,
    )
    parser.add_argument(
        "--autoscale_shrink", type=parse_bool, default=None, required=False
    )
    parser.add_argument("--slo_config", default=None, required=False)
    parser.add_argument(
        "--streaming", type=parse_bool, default=None, required=False
    )
    parser.add_argument(
        "--stream_lag_tasks", type=pos_int, default=None, required=False
    )
    parser.add_argument("--live_push_addr", default=None, required=False)
    parser.add_argument("--standby_workers", type=int, default=-1)


def _add_worker_params(parser: argparse.ArgumentParser):
    parser.add_argument("--worker_id", type=non_neg_int, required=True)
    parser.add_argument("--master_addr", required=True)
    parser.add_argument(
        "--coordinator_addr",
        default="",
        help="Address of the world's store (process 0 hosts it); "
        "non-empty selects the lockstep runtime",
    )
    parser.add_argument(
        "--num_processes", type=pos_int, default=1,
        help="Processes in the distributed world this worker joins",
    )
    parser.add_argument(
        "--process_id", type=non_neg_int, default=0,
        help="This worker's process index in the distributed world",
    )
    parser.add_argument(
        "--cluster_version", type=non_neg_int, default=0,
        help="World generation assigned by the master; fences stale "
        "workers after a re-formation",
    )
    # slice coordinates of a multi-slice world, assigned by the instance
    # manager per process and per generation, and only when the world
    # spans more than one slice
    parser.add_argument(
        "--slice_id", type=non_neg_int, default=0,
        help="This worker's slice index in a multi-slice world",
    )
    parser.add_argument(
        "--num_slices", type=pos_int, default=1,
        help="Slices in the distributed world this worker joins",
    )
    parser.add_argument(
        "--standby", type=non_neg_int, default=0,
        help="1 = hot standby: pay the imports, then block until the "
        "master writes a world assignment (one JSON line) on stdin",
    )


_MASTER_GROUPS = (
    _add_job_params,
    _add_model_spec_params,
    _add_data_params,
    _add_train_params,
    _add_mesh_params,
    _add_master_params,
)

_WORKER_GROUPS = (
    _add_job_params,
    _add_model_spec_params,
    _add_data_params,
    _add_train_params,
    _add_mesh_params,
    _add_worker_params,
)


def _finalize(args: argparse.Namespace) -> argparse.Namespace:
    """Validation and coercions, as the JAX CLI makes them."""
    if getattr(args, "num_minibatches_per_task", None):
        args.records_per_task = (
            args.minibatch_size * args.num_minibatches_per_task
        )
    if getattr(args, "use_async", False):
        args.grads_to_wait = 1
        logger.warning(
            "--use_async is accepted for compatibility but training is "
            "synchronous; async staleness semantics do not apply"
        )
    if getattr(args, "get_model_steps", 1) > 1:
        logger.warning(
            "--get_model_steps=%d is accepted for compatibility but "
            "gradients sync every step; local-SGD does not apply "
            "(coerced to 1)",
            args.get_model_steps,
        )
        args.get_model_steps = 1
    args.model_params_dict = parse_params_dict(args.model_params)
    args.data_reader_params_dict = parse_params_dict(args.data_reader_params)
    args.envs_dict = parse_envs(args.envs)
    args.device = resolve_device_flags(args.device, args.jax_platform)
    return args


def parse_envs(arg: str | None) -> dict[str, str]:
    """``--envs k1=v1,k2=v2``: the extra environment of worker processes."""
    envs: dict[str, str] = {}
    for kv in (arg or "").split(","):
        if kv:
            k, _, v = kv.partition("=")
            envs[k.strip()] = v.strip()
    return envs


# the JAX platforms that have a torch device in the port
JAX_PLATFORM_DEVICES = {"cpu": "cpu", "gpu": "cuda"}


def resolve_device_flags(device: str | None, jax_platform: str) -> str:
    """The torch device of ``--device`` and ``--jax_platform`` together:
    ``--device`` when given (``cuda`` when neither is), else the
    platform's device.  A platform the port has no device for, or one
    that disagrees with ``--device``, raises ``ValueError``."""
    if not jax_platform:
        return device or "cuda"
    mapped = JAX_PLATFORM_DEVICES.get(jax_platform)
    if mapped is None:
        raise ValueError(
            f"--jax_platform={jax_platform!r} has no counterpart in the "
            f"port, which runs on torch devices: pass --device cuda or "
            f"--device cpu (--jax_platform takes "
            f"{sorted(JAX_PLATFORM_DEVICES)})"
        )
    if device is not None and device != mapped:
        raise ValueError(
            f"--jax_platform={jax_platform!r} (device {mapped!r}) disagrees "
            f"with --device={device!r}; pass one of them"
        )
    return mapped


def _master_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(description="ElasticDL (PyTorch) master")
    for group in _MASTER_GROUPS:
        group(parser)
    return parser


def _parse_known(parser: argparse.ArgumentParser, argv) -> argparse.Namespace:
    args, unknown = parser.parse_known_args(argv)
    if unknown:
        # surface typos, as the JAX CLI does
        logger.warning("Unknown arguments: %s", unknown)
    return _finalize(args)


def parse_master_args(argv=None) -> argparse.Namespace:
    return _parse_known(_master_parser(), argv)


def parse_worker_args(argv=None) -> argparse.Namespace:
    parser = argparse.ArgumentParser(description="ElasticDL (PyTorch) worker")
    for group in _WORKER_GROUPS:
        group(parser)
    return _parse_known(parser, argv)


# Flags that exist only on the master and are not forwarded to workers
# (the JAX package's list, for the flags the port parses)
_MASTER_ONLY_FLAGS = frozenset(
    {
        "port", "instance_backend", "namespace", "docker_image",
        "docker_image_repository", "docker_base_image",
        "worker_resource_request", "worker_resource_limit",
        "worker_pod_priority", "master_resource_request",
        "master_resource_limit", "master_pod_priority", "volume",
        "image_pull_policy", "relaunch_on_worker_failure",
        "heartbeat_timeout_secs", "task_timeout_secs", "standby_workers",
        "num_slices", "min_slices", "autoscale_p95_step_ms",
        "autoscale_backlog_tasks", "autoscale_cooldown_secs",
        "autoscale_shrink", "yaml", "cluster_spec",
        # workers get the retry budget and deadlines by env, never argv
        "master_journal_dir", "rpc_retry_secs", "rpc_deadline_secs",
        "rehome_grace_secs", "telemetry_dir", "metrics_port",
        "metrics_host", "trace_sample_rate", "step_anatomy",
        "device_prefetch", "boundary_fusion", "pipeline_depth",
        "slo_config", "streaming", "stream_lag_tasks", "live_push_addr",
    }
)

# namespace entries _finalize derives (not flags)
_DERIVED_KEYS = frozenset({"model_params_dict", "data_reader_params_dict", "envs_dict"})


def derive_job_type(args) -> JobType:
    """The job type from which data flags are set, shared by master and
    worker so they cannot disagree."""
    training = bool(getattr(args, "training_data", ""))
    evaluation = bool(getattr(args, "validation_data", ""))
    prediction = bool(getattr(args, "prediction_data", ""))
    if prediction and not training:
        return JobType.PREDICTION_ONLY
    if evaluation and not training:
        return JobType.EVALUATION_ONLY
    if training and evaluation:
        return JobType.TRAINING_WITH_EVALUATION
    return JobType.TRAINING_ONLY


def build_arguments_from_parsed_result(
    args: argparse.Namespace, filter_args: frozenset[str] | set[str] = frozenset()
) -> list[str]:
    """An argv list that parses back into ``args``: booleans as
    ``true``/``false``, ``None`` values dropped, derived keys skipped."""
    argv: list[str] = []
    skip = set(filter_args) | _DERIVED_KEYS
    for key, value in sorted(vars(args).items()):
        if key in skip or value is None:
            continue
        if isinstance(value, bool):
            value = "true" if value else "false"
        argv.extend([f"--{key}", str(value)])
    return argv


def build_worker_arguments(
    master_args: argparse.Namespace, worker_id: int, master_addr: str
) -> list[str]:
    """The master-to-worker argv round trip."""
    argv = build_arguments_from_parsed_result(master_args, _MASTER_ONLY_FLAGS)
    argv.extend(["--worker_id", str(worker_id), "--master_addr", master_addr])
    return argv


# Why each flag that the port parses cannot act yet: the slice of
# ROADMAP.md queue 1 that brings its feature, or why none will
def _comes_with(slice_name: str) -> str:
    return f"it comes with {slice_name} (ROADMAP.md queue 1)"


_MESH = _comes_with(
    "slice 8, sequence, tensor and pipeline parallelism (the port's "
    "world is one flat process group)"
)
_TELEMETRY = _comes_with("slice 10, telemetry, tracing and profiling")
_K8S = _comes_with("slice 9, Kubernetes submission")
_STREAMING = _comes_with("slice 9, streaming")
UNPORTED_FLAGS = {
    "mesh_shape": _MESH,
    "dcn_mesh_shape": _MESH,
    "telemetry_dir": _TELEMETRY,
    "tensorboard_log_dir": _TELEMETRY,
    "metrics_port": _TELEMETRY,
    "metrics_host": _TELEMETRY,
    "trace_sample_rate": _TELEMETRY,
    "step_anatomy": _TELEMETRY,
    "profile_dir": _TELEMETRY,
    "profile_steps": _TELEMETRY,
    "slo_config": _TELEMETRY,
    "serving_addr": _comes_with("slice 4, the gRPC face of serving"),
    "instance_backend": _K8S,
    "namespace": _K8S,
    "docker_image": _K8S,
    "docker_image_repository": _K8S,
    "docker_base_image": _K8S,
    "worker_resource_request": _K8S,
    "worker_resource_limit": _K8S,
    "worker_pod_priority": _K8S,
    "master_resource_request": _K8S,
    "master_resource_limit": _K8S,
    "master_pod_priority": _K8S,
    "volume": _K8S,
    "image_pull_policy": _K8S,
    "cluster_spec": _K8S,
    "yaml": _K8S,
    "streaming": _STREAMING,
    "stream_lag_tasks": _STREAMING,
    "live_push_addr": _STREAMING,
    "donate_state": (
        "no slice will port it: eager PyTorch always updates the state "
        "in place"
    ),
    "compilation_cache_dir": (
        "no slice will port it: the port compiles no XLA programs"
    ),
}


def _mesh_size(mesh_shape: str) -> int:
    """Devices a ``--mesh_shape`` such as ``'dp=4,tp=2'`` spans."""
    sizes = []
    for part in mesh_shape.split(","):
        if part.strip():
            _name, _, size = part.partition("=")
            sizes.append(int(size))
    return math.prod(sizes)


def check_ported_flags(args: argparse.Namespace) -> None:
    """Raise ``NotImplementedError`` naming the first flag of
    :data:`UNPORTED_FLAGS` set to anything but its default (a
    ``--mesh_shape`` of one device is allowed)."""
    parser = _master_parser()
    for flag, reason in UNPORTED_FLAGS.items():
        value = getattr(args, flag, parser.get_default(flag))
        if value == parser.get_default(flag):
            continue
        if flag == "mesh_shape" and _mesh_size(value) == 1:
            continue
        raise NotImplementedError(f"--{flag}={value!r} is not ported: {reason}")

