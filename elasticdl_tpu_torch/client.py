"""The port's command-line client; the counterpart of
``elasticdl_tpu/client.py``, with the same subcommands and flags::

    python -m elasticdl_tpu_torch.client train \\
        --model_def long_seq_transformer.long_seq_transformer.custom_model \\
        --training_data DIR --validation_data DIR --output DIR

The job runs on the GPU (``--device cuda``, the default, which fails
without one) unless ``--device cpu`` asks for the CPU.
"""

from __future__ import annotations

import argparse
import sys

from elasticdl_tpu_torch import api
from elasticdl_tpu_torch.utils.args import parse_master_args
from elasticdl_tpu_torch.utils.log_utils import default_logger as logger

COMMANDS = ("train", "evaluate", "predict", "clean")


def _parse_clean_args(argv):
    """``clean`` takes no flags: the JAX package's select the docker
    images to remove, and the port builds none.  Any flag is refused."""
    argparse.ArgumentParser(
        prog="elasticdl_tpu_torch clean",
        description="The port builds no docker images, so there are none to remove.",
    ).parse_args(argv)


def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    if not argv or argv[0] in ("-h", "--help"):
        print(
            "usage: elasticdl_tpu_torch {train,evaluate,predict,clean} "
            "[options]\nRun '<command> --help' for command options."
        )
        return 0 if argv else 2
    command, rest = argv[0], argv[1:]
    if command not in COMMANDS:
        logger.error("Unknown command %r; expected one of %s", command, COMMANDS)
        return 2
    if command == "clean":
        _parse_clean_args(rest)
        result = api.clean()
        logger.info("clean: the port builds no images, so none were removed")
    else:
        result = getattr(api, command)(parse_master_args(rest))
    if result:
        logger.info("%s result: %s", command, result)
    return 0


if __name__ == "__main__":
    sys.exit(main())
