"""CLI: run a standalone control-plane store server.

Usage: ``python -m dynamo_tpu_torch.runtime.store_server [--host H] [--port P]``

One per cluster (analogue of the reference's etcd; SURVEY.md §1 layer 0).
SIGINT or SIGTERM closes the server and exits 0, as the worker and the
frontend do.
"""

from __future__ import annotations

import argparse
import asyncio
import contextlib
import signal

from dynamo_tpu_torch.runtime.store_net import StoreServer


async def _main(host: str, port: int) -> None:
    server = await StoreServer(host, port).start()
    print(f"dynamo_tpu store server: {server.url}", flush=True)
    stop = asyncio.Event()
    loop = asyncio.get_running_loop()
    for sig in (signal.SIGINT, signal.SIGTERM):
        with contextlib.suppress(NotImplementedError):
            loop.add_signal_handler(sig, stop.set)
    try:
        await stop.wait()
    finally:
        # Connected clients are not waited for: their leases end with us.
        server._server.close()
        await server.store.close()


def main() -> None:
    parser = argparse.ArgumentParser(description="dynamo_tpu control-plane store server")
    parser.add_argument("--host", default="0.0.0.0")
    parser.add_argument("--port", type=int, default=3280)
    args = parser.parse_args()
    try:
        asyncio.run(_main(args.host, args.port))
    except KeyboardInterrupt:
        pass


if __name__ == "__main__":
    main()
