"""LocalRunner: every device dispatch the engine makes, behind one seam
(port of ``dynamo_tpu/engine/runner.py`` ``LocalRunner``).

Owns the device state (params, KV cache) and turns the engine's host
arrays into device calls. Decode windows end in one plain ``.cpu()``
fetch; asynchronous fetches and window pipelining are later work.
Thread affinity: the engine's scheduler thread only.
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch

from dynamo_tpu_torch.device import resolve_device
from dynamo_tpu_torch.engine import model as M
from dynamo_tpu_torch.engine.config import EngineArgs
from dynamo_tpu_torch.engine.sampler import (
    row_gumbel,
    sample_simple,
    token_logprobs,
    top_k_logprobs,
)
from dynamo_tpu_torch.ops.paged_attention import resolve_attn_impl

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


class LocalRunner:
    def __init__(self, args: EngineArgs, params: Any | None = None, seed: int = 0):
        self.args = args
        self.cfg = args.model
        self._seed = seed
        self.params = params
        self.cache: M.KVCache | None = None
        self.device: torch.device | None = None
        self.dtype = DTYPES[args.dtype]
        self.attn_impl = "torch"

    def start(self) -> None:
        self.device = resolve_device(self.args.device)
        self.attn_impl = resolve_attn_impl(self.args.attn_impl, self.device)
        if self.params is None:
            self.params = M.init_params(self.cfg, self.device, self.dtype, self._seed)
        self.cache = M.init_kv_cache(
            self.cfg, self.args.num_kv_blocks, self.args.block_size, self.dtype,
            self.device, kv_quant=self.args.kv_quant,
        )

    def stop(self) -> None:
        self.cache = None

    def _t(self, a, dtype=None) -> torch.Tensor:
        return torch.as_tensor(np.asarray(a), device=self.device, dtype=dtype)

    # -- dispatches -------------------------------------------------------

    def prefill_batch(self, toks, tables, starts, tlens) -> torch.Tensor:
        """→ last-token logits [Bp, V] (device)."""
        return M.prefill_batch(
            self.cfg, self.params, self.cache, self._t(toks, torch.int32),
            self._t(tables, torch.int32), self._t(starts, torch.int32),
            self._t(tlens, torch.int32),
        )

    def prefill_chunk(self, toks, table, pos: int, tlen: int) -> torch.Tensor:
        """→ last-token logits [V] (device)."""
        return M.prefill(
            self.cfg, self.params, self.cache, self._t(toks, torch.int32),
            self._t(table, torch.int32), int(pos), int(tlen),
        )

    def decode_step(self, tokens, positions, tables, active) -> torch.Tensor:
        """→ logits [B, V] (device)."""
        return M.decode_step(
            self.cfg, self.params, self.cache, self._t(tokens, torch.int32),
            self._t(positions, torch.int32), self._t(tables, torch.int32),
            self._t(active, torch.bool), self.attn_impl,
        )

    def multi_decode(self, K, mode, tokens, positions, tables, active, temps, seeds,
                     steps0, top_n=0) -> tuple[np.ndarray, ...]:
        """One fused K-step window → host arrays (tokens [K, B], logprobs
        [K, B], top_vals [K, B, n], top_ids [K, B, n]); the window's one
        host fetch."""
        out = M.multi_decode(
            self.cfg, int(K), mode, int(top_n), self.params, self.cache,
            self._t(tokens, torch.int32), self._t(positions, torch.int32),
            self._t(tables, torch.int32), self._t(active, torch.bool),
            self._t(temps, torch.float32), list(seeds), list(steps0), self.attn_impl,
        )
        return tuple(a.cpu().numpy() for a in out)

    def sample_rows(self, logits: torch.Tensor, temps, seeds, steps,
                    top_n: int = 0) -> tuple[np.ndarray, ...]:
        """Sample one token per row of ``logits`` [B, V] → host arrays
        (tokens [B], logprobs [B], top_vals [B, n], top_ids [B, n])."""
        temps_t = self._t(temps, torch.float32)
        greedy = bool((np.asarray(temps) < 1e-5).all())
        if greedy:
            toks = torch.argmax(logits, dim=-1).to(torch.int32)
        else:
            gumbel = row_gumbel(seeds, steps, logits.shape[-1], self.device)
            toks = sample_simple(logits, temps_t, gumbel)
        logps = token_logprobs(logits, toks)
        if top_n > 0:
            tv, ti = top_k_logprobs(logits, top_n)
        else:
            tv = torch.zeros((logits.shape[0], 0), dtype=torch.float32, device=self.device)
            ti = torch.zeros((logits.shape[0], 0), dtype=torch.int32, device=self.device)
        return tuple(a.cpu().numpy() for a in (toks, logps, tv, ti))
