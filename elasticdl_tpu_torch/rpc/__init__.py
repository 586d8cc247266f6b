"""The RPC transport of the control plane, the replica service and the
serving plane: the message dataclasses of
``elasticdl_tpu/rpc/messages.py`` that the port uses on a
standard-library codec, served over TCP sockets (``service.py``), and
the idempotency registry that says which methods a client may retry
(``idempotency.py``).

The JAX package rides gRPC with msgpack frames; the card's machine has
neither package, so the port keeps the same method names and
dataclasses and carries them in frames of its own: a JSON header plus
raw tensor frames of ``utils/tensor.py``.
"""
