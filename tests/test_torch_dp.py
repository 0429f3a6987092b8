"""DP-attention through the port's worker CLI: per-rank worker processes
behind the KV router (tests/test_dp_attention.py's cases, with port
processes).

``worker --dp-size N`` spawns N independent rank processes of the same
model, as the JAX worker does; the KV router spreads load across them.
``dp_rank_ports`` is the JAX worker's port math.
"""

from __future__ import annotations

import asyncio
import re
import socket

import pytest

from dynamo_tpu.worker.__main__ import dp_rank_ports as jax_dp_rank_ports
from dynamo_tpu_torch.kv_router.router import KvPushRouter, KvRouterConfig
from dynamo_tpu_torch.llm.protocols import PreprocessedRequest
from dynamo_tpu_torch.runtime.distributed import DistributedRuntime
from dynamo_tpu_torch.runtime.engine import Context
from dynamo_tpu_torch.runtime.push_router import RouterMode
from dynamo_tpu_torch.worker.__main__ import dp_rank_ports, parse_args

from procutil import ManagedProcess


def test_dp_rank_ports_equal_jax():
    for base in (29600, 31000):
        for r in range(8):
            assert dp_rank_ports(base, r) == jax_dp_rank_ports(base, r)
            assert dp_rank_ports(base, r, stride=6) == jax_dp_rank_ports(base, r, stride=6)
    spans = [(b["system"], b["reserved"][1]) for b in (dp_rank_ports(29600, r)
                                                       for r in range(8))]
    for (_, hi1), (lo2, _) in zip(spans, spans[1:]):
        assert hi1 <= lo2


@pytest.mark.parametrize("argv, message", [
    (["--dp-size", "2", "--tp", "2", "--dist-num-processes", "2"],
     "--dp-size/--dp-rank cannot combine with --dist-num-processes > 1"),
    (["--dp-size", "2", "--dp-rank", "2"], r"--dp-rank must be in \[0, --dp-size\)"),
    (["--tp", "2", "--dist-num-processes", "3"], "--dist-num-processes must equal --tp"),
    (["--tp", "2", "--lora-slots", "2", "--lora", "a:8:1"], None),
])
def test_parallel_flag_errors(argv, message, capsys):
    """Each refused combination exits with its message; LoRA with --tp
    parses (each rank holds its shard of the adapter bank)."""
    if message is None:
        args = parse_args(argv)
        assert (args.tp, args.lora_slots, args.lora_specs) == (2, 2, [("a", 8, 1)])
        return
    with pytest.raises(SystemExit):
        parse_args(argv)
    assert re.search(message, capsys.readouterr().err)


def test_parallel_flag_defaults_equal_jax():
    from dynamo_tpu.worker.__main__ import parse_args as jax_parse_args

    port, ref = parse_args([]), jax_parse_args([])
    for name in ("tp", "dp_size", "dp_rank", "dp_base_port", "dp_chips_per_rank", "dp_restart",
                 "dist_num_processes", "dist_process_id", "dist_coordinator", "dist_step_addr"):
        assert getattr(port, name) == getattr(ref, name), name


def test_dp_spawner_ranks_serve_and_route_across():
    """``--dp-size 2`` spawns two rank processes; the KV router spreads
    distinct concurrent prompts over both; SIGTERM stops the group."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        store_port = s.getsockname()[1]
    store_url = f"tcp://127.0.0.1:{store_port}"
    with ManagedProcess(["-m", "dynamo_tpu_torch.runtime.store_server", "--host", "127.0.0.1",
                         "--port", str(store_port)], name="store") as store:
        store.wait_for(r"store server: tcp://")
        with ManagedProcess(["-m", "dynamo_tpu_torch.worker", "--store-url", store_url,
                             "--engine", "mocker", "--model-name", "dp-model",
                             "--mocker-speedup", "1000", "--dp-size", "2"],
                            name="dp-group") as group:
            group.wait_for(r"dp rank \d/2", timeout=60)
            group.wait_for(r"dp rank \d/2", timeout=60)
            ranks = {m for ln in group.lines for m in re.findall(r"dp rank (\d)/2", ln)}
            assert ranks == {"0", "1"}

            async def drive():
                rt = await DistributedRuntime.create(store_url=store_url)
                try:
                    ep = rt.namespace("dynamo").component("backend").endpoint("generate")
                    push = await ep.router(RouterMode.DIRECT)
                    await push.discovery.wait_for_instances(2)
                    router = await KvPushRouter(push, KvRouterConfig(block_size=4)).start()
                    try:
                        async def one(i):
                            r = PreprocessedRequest(model="dp-model",
                                                    token_ids=[100 * i + j for j in range(1, 13)])
                            r.stop.max_tokens = 8
                            ctx = Context()
                            out = [x async for x in router.generate(r.to_dict(), ctx)]
                            assert out[-1].get("finish_reason")
                            return ctx.metadata["worker_instance_id"]

                        placed = await asyncio.gather(*(one(i) for i in range(1, 9)))
                        assert len(set(placed)) == 2  # both ranks served traffic
                    finally:
                        await router.close()
                finally:
                    await rt.shutdown()

            asyncio.run(drive())
            group.terminate()
            assert group.proc.returncode in (0, -15)
