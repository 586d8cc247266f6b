"""The serving plane: the micro-batcher, the predict engine with hot
swap, the replica behind the socket transport, the router, the serving
CLI (``serving/main.py``) and the ``predict --serving_addr`` client."""
