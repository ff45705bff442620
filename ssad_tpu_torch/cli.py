"""Command line: ``python -m ssad_tpu_torch.cli export|serve|score``.

Counterpart of ssad_tpu/cli.py for the commands of this slice (the
serving subcommands live in serving/cli.py, as in the JAX package).
"""

from __future__ import annotations

import argparse
import sys

from ssad_tpu_torch.serving import cli as serving_cli
from ssad_tpu_torch.utils.device import DeviceUnavailable


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="ssad_tpu_torch",
        description="self-supervised anomaly detection, PyTorch/CUDA port",
    )
    sub = p.add_subparsers(dest="command", required=True)
    serving_cli.register(sub)
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    try:
        return args.fn(args)
    except DeviceUnavailable as e:
        print(f"error: {e}", file=sys.stderr)
        return 2


if __name__ == "__main__":
    sys.exit(main())
