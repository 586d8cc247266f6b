"""The control plane's transport: the message dataclasses of
``elasticdl_tpu/rpc/messages.py`` (the ones the lockstep path uses) on
a standard-library codec, served over TCP sockets (``service.py``).

The JAX package rides gRPC with msgpack frames; the card's machine has
neither package, so the port keeps the same method names and
dataclasses and carries them in frames of its own: a JSON header plus
raw tensor frames of ``utils/tensor.py``.
"""
