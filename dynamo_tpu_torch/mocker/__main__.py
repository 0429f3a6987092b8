"""Mocker CLI: `python -m dynamo_tpu_torch.mocker` — a worker hosting the fake
engine (reference: components/backends/mocker/src/dynamo/mocker/main.py).
Accepts every `dynamo_tpu_torch.worker` flag; forces --engine mocker."""

import sys

from dynamo_tpu_torch.worker.__main__ import main

if __name__ == "__main__":
    raise SystemExit(main(["--engine", "mocker", *sys.argv[1:]]))
