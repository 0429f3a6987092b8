"""One tensor-parallel worker spanning two processes, through the worker CLI
(``--tp 2 --dist-num-processes 2 --dist-process-id 0|1 --dist-coordinator
--dist-step-addr``), on the CPU over gloo.

As tests/test_multihost.py does for the JAX worker: the leader (process 0)
serves the endpoint, the follower (process 1) replays its dispatch stream,
and the leader's greedy streams must equal a one-process ``TpuEngine``'s on
the same weights (JAX ``init_params``, written as a checkpoint both port
processes load, each keeping its shards). When the leader stops, the
follower exits 0 on its own, having sampled exactly the leader's tokens
(its digest equals the leader's). And the port's ``LeaderRunner`` mirrors
every dispatch the JAX ``LeaderRunner`` mirrors.
"""

from __future__ import annotations

import ast
import asyncio
import inspect
import json
import signal
import socket

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from dynamo_tpu.engine import model as JM
from dynamo_tpu.engine import runner as jrunner
from dynamo_tpu.engine.config import EngineArgs as JArgs
from dynamo_tpu.engine.config import ModelConfig as JCfg
from dynamo_tpu.engine.engine import TpuEngine
from dynamo_tpu.runtime.engine import Context as JContext
from dynamo_tpu_torch.engine import runner as trunner
from dynamo_tpu_torch.engine.config import ModelConfig
from dynamo_tpu_torch.engine.loader import save_checkpoint
from dynamo_tpu_torch.engine.weights import params_from_numpy
from dynamo_tpu_torch.llm.protocols import PreprocessedRequest
from dynamo_tpu_torch.runtime.distributed import DistributedRuntime
from dynamo_tpu_torch.runtime.engine import Context
from dynamo_tpu_torch.runtime.push_router import RouterMode

from procutil import ManagedProcess

PROMPTS = [[1, 2, 3, 4, 5], [9, 8, 7], list(range(20, 40))]
MAX_TOKENS = [6, 3, 9]
ENGINE = dict(block_size=4, num_kv_blocks=128, max_num_seqs=4, max_model_len=128,
              decode_steps=4)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _req(prompt, n) -> PreprocessedRequest:
    r = PreprocessedRequest(model="test-tiny", token_ids=prompt)
    r.sampling.temperature = 0.0
    r.sampling.seed = 0
    r.stop.max_tokens = n
    r.stop.ignore_eos = True
    return r


def _json_line(lines: list[str], event: str) -> dict:
    for ln in reversed(lines):
        if ln.startswith("{") and f'"event": "{event}"' in ln:
            return json.loads(ln)
    raise AssertionError(f"no {event} line in:\n" + "".join(lines[-30:]))


def _drain(p: ManagedProcess, timeout: float = 60.0) -> int:
    """Read the rest of ``p``'s output until it exits → its return code."""
    out, _ = p.proc.communicate(timeout=timeout)
    p.lines.extend(out.splitlines(keepends=True))
    return p.proc.returncode


@pytest.fixture(scope="module")
def np_params():
    return jax.tree.map(np.asarray, JM.init_params(JCfg(), jax.random.PRNGKey(0), jnp.float32))


def _reference(np_params) -> list[list[int]]:
    async def go():
        eng = await TpuEngine(JArgs(model=JCfg(), attn_impl="xla", dtype="float32", **ENGINE),
                              params=np_params).start()
        try:
            async def one(p, n):
                got = []
                async for item in eng.generate(_req(p, n).to_dict(), JContext()):
                    got += item.get("token_ids") or []
                return got

            return list(await asyncio.gather(*(one(p, n) for p, n in zip(PROMPTS, MAX_TOKENS))))
        finally:
            await eng.stop()

    return asyncio.run(go())


def test_leader_and_follower_processes_match_one_process(np_params, tmp_path):
    ckpt = str(tmp_path / "ckpt")
    save_checkpoint(ckpt, ModelConfig(), params_from_numpy(np_params, "cpu", torch.float32))
    store_port = _free_port()
    store_url = f"tcp://127.0.0.1:{store_port}"
    dist = ["--tp", "2", "--dist-num-processes", "2",
            "--dist-coordinator", f"127.0.0.1:{_free_port()}",
            "--dist-step-addr", f"127.0.0.1:{_free_port()}"]
    argv = ["-m", "dynamo_tpu_torch.worker", "--store-url", store_url, "--device", "cpu",
            "--model-path", ckpt, "--tokenizer", "byte", "--dtype", "float32",
            *[x for k, v in ENGINE.items() for x in (f"--{k.replace('_', '-')}", str(v))],
            *dist]
    env = {"OMP_NUM_THREADS": "1"}
    with ManagedProcess(["-m", "dynamo_tpu_torch.runtime.store_server", "--host", "127.0.0.1",
                         "--port", str(store_port)], name="store") as store:
        store.wait_for(r"store server: tcp://")
        with ManagedProcess([*argv, "--dist-process-id", "1"], name="follower",
                            env=env) as follower, \
                ManagedProcess([*argv, "--dist-process-id", "0"], name="leader",
                               env=env) as leader:
            follower.wait_for(r"follower 1/2: tp 2 over gloo \(CPU ranks\)", 120)
            leader.wait_for(r"worker: tp 2 over gloo", 120)
            leader.wait_for(r"dynamo_tpu_torch worker: serving ", 120)

            async def drive():
                rt = await DistributedRuntime.create(store_url=store_url)
                try:
                    ep = rt.namespace("dynamo").component("backend").endpoint("generate")
                    router = await ep.router(RouterMode.ROUND_ROBIN)
                    await router.discovery.wait_for_instances(1)

                    async def one(p, n):
                        got = []
                        async for item in router.generate(_req(p, n).to_dict(), Context()):
                            got += item.get("token_ids") or []
                        return got

                    return list(await asyncio.gather(*(one(p, n) for p, n in
                                                       zip(PROMPTS, MAX_TOKENS))))
                finally:
                    await rt.shutdown()

            got = asyncio.run(drive())
            leader.proc.send_signal(signal.SIGTERM)
            assert _drain(leader) == 0, "".join(leader.lines[-30:])
            # The follower ends by itself once the leader's stream closes.
            assert _drain(follower) == 0, "".join(follower.lines[-30:])
    assert got == _reference(np_params)
    lead = _json_line(leader.lines, "engine_counters")
    fol = _json_line(follower.lines, "follower_counters")
    assert lead["tp"]["token_digest"] == fol["token_digest"]
    assert lead["tp"]["calls"] == fol["collectives"]["calls"]
    assert lead["tp"]["backend"] == fol["collectives"]["backend"] == "gloo"


def test_mirrored_operations_cover_the_jax_leader():
    """Every JAX ``LeaderRunner`` method that casts a dispatch is mirrored
    by the port's (which adds its single step and graph captures)."""
    tree = ast.parse(inspect.getsource(jrunner.LeaderRunner))
    casting = {node.name for node in ast.walk(tree) if isinstance(node, ast.FunctionDef)
               and node.name not in ("start", "stop", "_cast")
               and "_cast" in ast.unparse(node)}
    assert casting and casting <= set(trunner.MIRRORED)
    assert set(trunner.MIRRORED) - casting == {"decode_sample", "warm_windows", "warm_spec",
                                               "warm_steps"}
    for op in trunner.MIRRORED:
        assert callable(getattr(trunner.LocalRunner, op))
        assert getattr(trunner.LeaderRunner, op) is not getattr(trunner.LocalRunner, op)
