"""Histogram bucket bounds; the constants of
``elasticdl_tpu/telemetry/registry.py`` the port uses (its Prometheus
registry comes with slice 10).

The serving engine files every completed request's phases into these
log-spaced buckets (seconds) for the ``serving_status`` probe beat: the
step buckets floor at 1 ms, where a warm in-process predict dispatch
lives, so serving extends the same 1-2.5-5 ladder two decades down
(100 us resolution) and caps at 10 s (anything slower is an outage, not
a latency).
"""

from __future__ import annotations

SERVING_LATENCY_BUCKETS = (
    0.0001,
    0.00025,
    0.0005,
    0.001,
    0.0025,
    0.005,
    0.01,
    0.025,
    0.05,
    0.1,
    0.25,
    0.5,
    1.0,
    2.5,
    5.0,
    10.0,
)
