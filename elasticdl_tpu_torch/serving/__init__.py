"""The serving plane: micro-batcher, predict engine, in-process replica."""
