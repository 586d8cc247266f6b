"""Streaming: continuous training over an unbounded source; the
counterpart of ``elasticdl_tpu/streaming/``.

The pieces, in data-flow order:

- ``source``: the stream's watermark publisher (how many records exist
  so far, and whether the source has closed).
  :class:`~elasticdl_tpu_torch.streaming.source.QueueStreamSource` is
  the seeded in-process source of tests, the smoke and chaos runs;
  ``OdpsTailingSource`` tails an ODPS table behind the same contract.
- ``reader``: :class:`~elasticdl_tpu_torch.streaming.reader.StreamDataReader`,
  a data reader over a ``stream://`` origin.  Record ``i`` is a pure
  function of ``(seed, i)``, so master and workers share no queue
  state and any worker can serve any leased window.
- the task dispatcher's watermark-lease mode
  (``master/task_dispatcher.py``: windows minted up to the watermark;
  ``lag = source_watermark - trained_watermark`` is the backlog), and
  the live train-to-serve push in ``live_push.py`` (the replica ring's
  freshest complete snapshot sent inline to serving's ``swap_model``).
"""

from elasticdl_tpu_torch.streaming.source import (  # noqa: F401
    QueueStreamSource,
    StreamSpec,
    parse_stream_origin,
)
