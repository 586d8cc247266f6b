"""elasticdl_tpu_torch: the PyTorch and CUDA port of ``elasticdl_tpu``.

The JAX package ``elasticdl_tpu`` beside this one is the reference: each
module here is held against its counterpart there, on the same inputs,
by the ``tests/test_torch_*.py`` tests.  This package imports ``torch``
and numpy, never JAX and never a module of ``elasticdl_tpu``: where it
needs something from a JAX-free module there, it keeps its own copy.

Module paths mirror the JAX package's, so a reader finds each
counterpart at the same relative path:

- ``ops.attention``         — flash-attention forward: a hand-written
  Hopper kernel (``ops/csrc/flash_fwd.cu``) beside its plain version
- ``layers.attention``      — ``MultiHeadSelfAttention``,
  ``TransformerBlock``
- ``models.long_seq_transformer`` — the causal ``TransformerLM``
- ``utils.export_utils``    — the JAX package's export layout, both ways
- ``utils.flax_weights``    — flax parameter names <-> torch state dicts
- ``serving``               — micro-batcher, predict engine, replica
- ``parallel.distributed``  — ``SPMDTrainer`` on one device
- ``client``, ``api``       — the ``train|evaluate|predict`` CLI (Local)
- ``trainer.local_executor`` — the Local strategy: tasks, batches,
  steps, checkpoints (``trainer.checkpointing``), evaluation, export
- ``master.task_dispatcher`` — dynamic data sharding into tasks
- ``data``                  — the EDLIO codec, readers, ``Dataset``

Entry points take ``device`` (default ``"cuda"``) and raise when CUDA is
absent unless the caller asked for ``device="cpu"``.
"""

__version__ = "0.1.0"
