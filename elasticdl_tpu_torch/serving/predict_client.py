"""``predict --serving_addr``: the batch predict CLI as a client of a
serving endpoint; the counterpart of
``elasticdl_tpu/serving/predict_client.py``.

The offline predict path (``LocalExecutor``) loads the model into ITS
process; this path instead walks the same prediction shards with the
same ``dataset_fn`` decode and sends every batch to a running serving
endpoint (router or single replica — same protocol), so one exported
model serves both the online and the batch workload.  Outputs flow
through ``prediction_outputs_processor`` exactly as on the offline
path.  With a telemetry dir in the environment each request's
``predict_request`` span is the root of its trace: its context rides
the request, and the router's and the replica's spans join it.
"""

from __future__ import annotations

import os
import time

import numpy as np

from elasticdl_tpu_torch.rpc import messages as msg
from elasticdl_tpu_torch.utils.log_utils import default_logger as logger


def _client_tracer():
    """The process tracer, installing one as role ``client`` when a
    telemetry dir is configured and none is installed (the predict CLI
    has no master to do it); None when tracing is off."""
    from elasticdl_tpu_torch.telemetry import tracing, worker_hooks

    tracer = tracing.get_tracer()
    if tracer is not None:
        return tracer
    telemetry_dir = os.environ.get(worker_hooks.TELEMETRY_DIR_ENV, "")
    if not telemetry_dir:
        return None
    return tracing.install(telemetry_dir, role="client")


def run_remote_predict(args) -> dict:
    from elasticdl_tpu_torch.data.factory import create_data_reader
    from elasticdl_tpu_torch.data.fast_pipeline import build_task_batches
    from elasticdl_tpu_torch.master.task_dispatcher import TaskDispatcher
    from elasticdl_tpu_torch.rpc.deadline import DeadlinePolicy
    from elasticdl_tpu_torch.rpc.retry import RetryPolicy
    from elasticdl_tpu_torch.serving.replica import ServingClient
    from elasticdl_tpu_torch.trainer.state import Modes
    from elasticdl_tpu_torch.utils.model_utils import get_model_spec

    spec = get_model_spec(
        args.model_zoo,
        args.model_def,
        model_params=args.model_params_dict,
        dataset_fn=args.dataset_fn,
        loss=args.loss,
        optimizer=args.optimizer,
        eval_metrics_fn=args.eval_metrics_fn,
    )
    reader = create_data_reader(
        args.prediction_data,
        records_per_task=args.records_per_task,
        custom_reader=spec.custom_data_reader,
        **dict(args.data_reader_params_dict),
    )
    deadline_secs = getattr(args, "rpc_deadline_secs", None) or 30.0
    client = ServingClient(
        args.serving_addr,
        retry=RetryPolicy(total_timeout_secs=deadline_secs * 4),
        deadlines=DeadlinePolicy.from_secs(deadline_secs),
    )
    dispatcher = TaskDispatcher(
        None,
        prediction_shards=reader.create_shards(),
        records_per_task=args.records_per_task,
    )
    from elasticdl_tpu_torch.telemetry.tracing import SPAN_PREDICT_REQUEST

    tracer = _client_tracer()
    requests = rows = failures = 0
    failed_trace_ids: list[str] = []
    model_version = -1
    try:
        while True:
            tid, task = dispatcher.get(0)
            if task is None:
                break
            for features in build_task_batches(
                reader,
                task,
                spec,
                Modes.PREDICTION,
                reader.metadata,
                args.minibatch_size,
                dispatch_device="cpu",
            ):
                requests += 1
                request_id = f"predict-{tid}-{requests}"
                # the client's root span is the trace: the router's and
                # the replica's spans parent under it, so one keep-or-drop
                # decision here covers the whole trace
                span = None
                if tracer is not None and tracer.should_sample(SPAN_PREDICT_REQUEST):
                    span = tracer.start_span(SPAN_PREDICT_REQUEST, request_id=request_id)
                response = _predict_with_retry(
                    client,
                    msg.PredictRequest(
                        request_id=request_id,
                        features=msg.pack_array_tree(features),
                        trace=span.context if span is not None else {},
                    ),
                )
                if response is None or response.error:
                    failures += 1
                    if span is not None:
                        # a failed traced request stays findable: the span
                        # carries the error, the raise below the trace id
                        failed_trace_ids.append(span.trace_id)
                        span.end(error=response.error if response else "empty response")
                    logger.error(
                        "Remote predict failed: %s",
                        response.error if response else "empty response",
                    )
                    continue
                if span is not None:
                    span.end(rows=int(response.rows), model_version=int(response.model_version))
                rows += int(response.rows)
                model_version = max(model_version, response.model_version)
                if spec.prediction_outputs_processor is not None:
                    outputs = msg.unpack_array_tree(response.outputs)
                    spec.prediction_outputs_processor.process(
                        _as_numpy(outputs), worker_id=0
                    )
            dispatcher.report(tid, True)
    finally:
        client.close()
        if tracer is not None:
            tracer.flush()
    if failures:
        # the offline path processes every batch or raises; a silently
        # incomplete output set exiting 0 would be strictly worse, and
        # with tracing on the raise names the failed traces
        traced = (
            " (failed trace ids: " + ", ".join(failed_trace_ids[:8])
            + (", ..." if len(failed_trace_ids) > 8 else "") + ")"
            if failed_trace_ids else ""
        )
        raise RuntimeError(
            f"remote predict incomplete: {failures}/{requests} batches "
            f"failed against {args.serving_addr} (see log){traced}"
        )
    logger.info(
        "Remote predict: %d requests / %d rows against %s "
        "(model version %d, %d failures)",
        requests,
        rows,
        args.serving_addr,
        model_version,
        failures,
    )
    return {
        "requests": requests,
        "rows": rows,
        "failures": failures,
        "model_version": model_version,
        "serving_addr": args.serving_addr,
    }


def _predict_with_retry(client, request, attempts: int = 4):
    """Application-level retry for RETRYABLE error responses (overload
    shed, draining replica): the transport-level retry policy only sees
    raised RPC errors, not a served error payload.  Predict is
    read-only, so the re-send is safe by classification."""
    response = None
    for attempt in range(attempts):
        response = client.predict(request)
        if response is None or not response.error or not response.retryable:
            return response
        time.sleep(min(1.0, 0.1 * (2.0**attempt)))
    return response


def _as_numpy(tree):
    if isinstance(tree, dict):
        return {k: np.asarray(v) for k, v in tree.items()}
    return np.asarray(tree)
