"""Phase names of the request anatomy, copied from
``elasticdl_tpu/telemetry/anatomy.py`` so that the port's per-request
phases carry the JAX package's names.

A served request's phases are sum-exact: ``queue_wait`` + the
batch-level phases of every dispatch group its rows rode +
``untracked`` (the residual to its measured total).
"""

PHASE_ASSEMBLE = "assemble"
PHASE_H2D_TRANSFER = "h2d_transfer"
PHASE_DEVICE_COMPUTE = "device_compute"
PHASE_UNTRACKED = "untracked"
PHASE_QUEUE_WAIT = "queue_wait"
PHASE_D2H_TRANSFER = "d2h_transfer"

# a serving request's phases, in pipeline order
SERVING_REQUEST_PHASES = (
    PHASE_QUEUE_WAIT,
    PHASE_ASSEMBLE,
    PHASE_H2D_TRANSFER,
    PHASE_DEVICE_COMPUTE,
    PHASE_D2H_TRANSFER,
)
