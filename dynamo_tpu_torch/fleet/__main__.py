"""``python -m dynamo_tpu_torch.fleet`` — alias for the frontend CLI with a
fleet of (at least) two processes. All frontend flags apply; see
``python -m dynamo_tpu_torch.frontend --help`` and docs/frontend-fleet.md."""

from __future__ import annotations

import sys

from dynamo_tpu_torch.frontend.__main__ import main as frontend_main


def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    if not any(a == "--fleet" or a.startswith("--fleet=") for a in argv):
        argv = ["--fleet", "2", *argv]
    return frontend_main(argv)


if __name__ == "__main__":
    raise SystemExit(main())
