"""LocalRunner: every device dispatch the engine makes, behind one seam
(port of ``dynamo_tpu/engine/runner.py`` ``LocalRunner``, ``LeaderRunner``
and ``follower_loop``).

Owns the device state (params, KV cache, the per-slot chain buffer) and
turns the engine's host arrays into device calls that never wait for the
device:

- Host inputs of a dispatch are packed into one int32 word buffer
  (``Layout``) and go up in one ``non_blocking`` copy from pinned memory.
  Pinned blocks come from torch's caching host allocator, which records
  the copy on the stream and hands a block out again only after that copy
  has run, so the host may build window w+2's inputs while w+1 has not
  started.
- Results come back by ``start_host_fetch``: ``non_blocking`` copies into
  pinned host memory enqueued right after the dispatch on the same
  stream, plus a recorded event. ``HostFetch.ready`` polls the event and
  ``HostFetch.wait`` blocks on it. On the CPU both are synchronous.
- Decode windows chain on the device through ``last_toks``
  ``[max_num_seqs + 1]``: each window folds its last sampled token per row
  into its sequence's slot (padding rows into the tail slot, a sink), and
  so do admission samples, so the next window can be dispatched before
  this one is fetched.
- On CUDA a K-step window is one CUDA-graph replay (``engine/graphs.py``),
  the counterpart of the JAX package's one jitted dispatch per window, and
  so is every speculative verify pass (``spec_verify``; ``warm_spec``
  captures its shape lattice) and every single step (``decode_sample``:
  the decode step and its sampling, masked for a grammar-constrained
  batch; ``warm_steps``). Grammar masks ride the packed upload as 32-bit
  words. So is every prefill dispatch: one graph per (rows, T bucket,
  table bucket, LoRA variant), the shapes the engine's prefill ladder
  gives (``prefill_batch``, ``prefill_chunk``; ``warm_prefills`` captures
  the lattice). Admission sampling and embeddings run eagerly, as the JAX
  package dispatches them separately too. ``enforce_eager`` runs every
  dispatch op by op, and each one that does on the card counts in its
  ``eager_*`` counter.
- Multi-LoRA: with ``lora_slots`` > 0 the adapter bank (``lora_bank``,
  engine/lora.py ``bank_shapes``, in the compute dtype) is allocated once
  and written in place by ``upload_adapter``, so captured graphs read what
  was uploaded. A dispatch with adapter rows carries their bank slots
  (``adapter_slots``, -1 = base) in its packed upload and replays the LoRA
  variant of its shape; one without passes None and replays the pre-LoRA
  graph, as the JAX runner's ``_lora_operands`` gives the pre-LoRA trace.

- Tensor parallelism (``args.tp`` > 1): the runner holds one rank's
  shards and cache lanes (``parallel/``), and ``LeaderRunner`` mirrors
  every dispatch to follower processes, which replay them in
  ``follower_loop`` (the JAX package's multi-host design: one scheduler,
  one dispatch stream, every rank making the same calls).

Thread affinity: the engine's scheduler thread only.
"""

from __future__ import annotations

import dataclasses
import socket
import struct
import time
from collections import OrderedDict
from typing import Any

import numpy as np
import torch

from dynamo_tpu_torch.device import resolve_device
from dynamo_tpu_torch.engine import kv_transfer
from dynamo_tpu_torch.engine import model as M
from dynamo_tpu_torch.engine.config import EngineArgs
from dynamo_tpu_torch.engine.grammar import mask_words
from dynamo_tpu_torch.engine.graphs import (
    COUNTERS,
    WindowGraphs,
    read_counts,
    set_counts,
)
from dynamo_tpu_torch.engine.lora import LORA_PAGE_KEYS, bank_shapes
from dynamo_tpu_torch.engine.quant import quantize_params_np, random_int8_params_device
from dynamo_tpu_torch.engine.sampler import (
    apply_mask,
    row_gumbel,
    sample_full,
    sample_simple,
    token_logprobs,
    top_k_logprobs,
)
from dynamo_tpu_torch.engine.weights import params_from_numpy
from dynamo_tpu_torch.ops.paged_attention import resolve_attn_impl
from dynamo_tpu_torch.parallel.mesh import ModelSharding
from dynamo_tpu_torch.runtime import msgpack_lite

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}

_RETAIN = 128  # refs kept by id


class Layout:
    """Where each host operand of one dispatch sits in a single int32 word
    buffer: one host→device copy per dispatch. Kinds: "i" int32, "f"
    float32 (bit-cast), "b" bool (one word each), "w" packed 32-bit words
    (grammar bitsets, uint32 on the host, bit-cast to int32)."""

    def __init__(self, *fields: tuple[str, tuple[int, ...], str]):
        self.fields = fields
        self.slices: dict[str, tuple[int, int, tuple[int, ...], str]] = {}
        off = 0
        for name, shape, kind in fields:
            n = int(np.prod(shape))
            self.slices[name] = (off, off + n, shape, kind)
            off += n
        self.size = off

    def pack(self, **arrays) -> np.ndarray:
        words = np.empty((self.size,), np.int32)
        for name, (lo, hi, shape, kind) in self.slices.items():
            a = np.asarray(arrays[name]).reshape(-1)
            if kind == "f":
                words[lo:hi] = a.astype(np.float32).view(np.int32)
            elif kind == "w":
                words[lo:hi] = a.astype(np.uint32).view(np.int32)
            else:
                words[lo:hi] = a.astype(np.int32)
        return words

    def unpack(self, words: torch.Tensor) -> dict[str, torch.Tensor]:
        out = {}
        for name, (lo, hi, shape, kind) in self.slices.items():
            w = words[lo:hi]
            if kind == "f":
                w = w.view(torch.float32)
            elif kind == "b":
                w = w != 0
            out[name] = w.reshape(shape)
        return out


def _aslots(B: int, lora: bool) -> list:
    """The per-row adapter slots field of a LoRA variant's layout."""
    return [("aslots", (B,), "i")] if lora else []


def window_layout(B: int, W: int, L: int, lora: bool = False) -> Layout:
    """Operands of one decode window: B rows, W-wide tables, L-wide penalty
    windows (1 outside the "full" mode), and with ``lora`` each row's
    adapter slot."""
    return Layout(
        ("tokens", (B,), "i"), ("positions", (B,), "i"), ("tables", (B, W), "i"),
        ("active", (B,), "b"), ("temps", (B,), "f"), ("seeds", (B,), "i"),
        ("steps0", (B,), "i"), ("top_k", (B,), "i"), ("top_p", (B,), "f"),
        ("freq", (B,), "f"), ("pres", (B,), "f"), ("pen", (B, L), "i"),
        ("chain_mask", (B,), "b"), ("chain_src", (B,), "i"), ("fold_slots", (B,), "i"),
        *_aslots(B, lora),
    )


def verify_layout(B: int, W: int, S1: int, tree: bool, W32: int = 0,
                  lora: bool = False) -> Layout:
    """Operands of one speculative verify pass: B rows of S1 slots, W-wide
    tables, for a draft tree its topology (parents, ancestor bits as one
    word each, depths), with ``W32`` > 0 per-node grammar masks of W32
    words each (tree passes only), and with ``lora`` each row's adapter
    slot."""
    fields = [
        ("tokens", (B, S1), "i"), ("positions0", (B,), "i"), ("draft_len", (B,), "i"),
        ("tables", (B, W), "i"), ("active", (B,), "b"), ("temps", (B,), "f"),
        ("seeds", (B,), "i"), ("steps0", (B,), "i"), ("fold_slots", (B,), "i"),
    ]
    if tree:
        fields += [("parents", (B, S1), "i"), ("anc", (B, S1, S1), "i"), ("depth", (B, S1), "i")]
    if W32:
        fields.append(("masks", (B, S1, W32), "w"))
    return Layout(*fields, *_aslots(B, lora))


def prefill_layout(Bp: int, T: int, W: int, lora: bool = False) -> Layout:
    """Operands of one prefill dispatch: Bp rows of T suffix tokens, W-wide
    tables, each row's suffix start and true length (0: an inactive row),
    and with ``lora`` each row's adapter slot."""
    return Layout(("toks", (Bp, T), "i"), ("tables", (Bp, W), "i"), ("starts", (Bp,), "i"),
                  ("tlens", (Bp,), "i"), *_aslots(Bp, lora))


def sample_layout(B: int, L: int, W32: int = 0) -> Layout:
    """Operands of one sampling dispatch over B rows (L-wide penalty
    windows; with ``W32`` > 0 per-row grammar masks)."""
    fields = [
        ("temps", (B,), "f"), ("seeds", (B,), "i"), ("steps", (B,), "i"),
        ("top_k", (B,), "i"), ("top_p", (B,), "f"), ("freq", (B,), "f"),
        ("pres", (B,), "f"), ("pen", (B, L), "i"), ("fold_slots", (B,), "i"),
    ]
    if W32:
        fields.append(("masks", (B, W32), "w"))
    return Layout(*fields)


def step_layout(B: int, W: int, L: int, W32: int = 0, lora: bool = False) -> Layout:
    """Operands of one single decode step and its sampling: the step's
    tokens, positions, W-wide tables and active rows, then
    ``sample_layout``'s, and with ``lora`` each row's adapter slot."""
    return Layout(("tokens", (B,), "i"), ("positions", (B,), "i"), ("tables", (B, W), "i"),
                  ("active", (B,), "b"), *sample_layout(B, L, W32).fields, *_aslots(B, lora))


class StepRef:
    """Handle to a dispatch's device-side results. A graph window's arrays
    are the graph's static outputs, valid until its next replay; the host
    fetch enqueued at dispatch is what the engine reads."""

    __slots__ = ("rid", "arrs")

    def __init__(self, rid: int, arrs: tuple):
        self.rid = rid
        self.arrs = arrs


class HostFetch:
    """An asynchronous device→host copy of some result tensors."""

    __slots__ = ("host", "event")

    def __init__(self, tensors):
        if tensors and tensors[0].device.type == "cuda":
            self.host = [torch.empty(t.shape, dtype=t.dtype, pin_memory=True) for t in tensors]
            for h, t in zip(self.host, tensors):
                h.copy_(t, non_blocking=True)
            self.event = torch.cuda.Event()
            self.event.record()
        else:
            self.host = list(tensors)
            self.event = None

    def ready(self) -> bool:
        """True once the copies have landed: waiting now costs nothing."""
        return self.event is None or self.event.query()

    def wait(self) -> list[np.ndarray]:
        if self.event is not None:
            self.event.synchronize()
        return [h.numpy() for h in self.host]


def start_host_fetch(tensors) -> HostFetch:
    """Begin the device→host copy of a dispatch's result tensors, right
    behind the dispatch on the current stream."""
    return HostFetch(tensors)


def host_ready(fetch: HostFetch) -> bool:
    return fetch.ready()


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    else:
        yield tree


# An adapter's factor pages ([L, in, r] / [L, r, out]) cut as the weight
# whose delta they carry: B of q/k/v on its columns, A of o on its rows.
_ADAPTER_AS = {"qb": "wq", "kb": "wk", "vb": "wv", "oa": "wo"}


def shard_adapter_pages(sharding, pages: tuple) -> tuple:
    """One adapter's factor pages (engine/lora.py ``LORA_PAGE_KEYS``
    order, full or already the rank's) → the rank's under ``sharding`` (a
    ``parallel.mesh.ModelSharding``): qb, kb, vb and oa cut as wq, wk, wv
    and wo are, the A factors of q/k/v and B of o whole."""
    return tuple(sharding.shard_leaf(("layers", _ADAPTER_AS[k]), p) if k in _ADAPTER_AS else p
                 for k, p in zip(LORA_PAGE_KEYS, pages))


class LocalRunner:
    """``params``: a tree of tensors on the device, a tree of numpy arrays
    (moved there by ``params_from_numpy``; with ``quant="int8"`` float ones
    are quantized on the host first), or None (random weights made on the
    device, int8 ones with ``quant="int8"``).

    Tensor parallelism (``args.tp`` > 1): ``group`` is this rank's
    ``parallel.comm.TpGroup``. The runner keeps the rank's shards of the
    params (a full tree is cut, random weights are drawn whole and cut, so
    every tp holds tp=1's weights) and the rank's kv-head lanes of the
    cache, and every forward runs with the rank's ``ModelSharding``.
    Captured graphs need collectives a CUDA graph can hold: under NCCL
    windows and prefills are captured as at tp=1; under gloo (ranks
    sharing a card) they run eagerly and count in ``eager_windows`` and
    ``eager_prefills``. ``extract_pages`` gathers
    every rank's lanes into the JAX layout ``[L, n, bs, KVH·hd]`` and
    ``inject_pages`` takes the rank's lanes of such pages, so tier files,
    disagg payloads and migrations read the same at any tp. Each rank
    folds the tokens it samples into ``token_digest`` on the device, so
    ranks can be shown to sample alike without a fetch per dispatch. An
    adapter bank under tp holds the rank's shard of each factor
    (``bank_shapes`` of the rank's view), and ``upload_adapter`` cuts the
    full pages it is given (``shard_adapter_pages``), so
    adapter pages, the slot pool and tier files are the same at any tp."""

    def __init__(self, args: EngineArgs, params: Any | None = None, seed: int = 0,
                 group=None):
        self.args = args
        self.cfg = args.model
        self._seed = seed
        self.params = params
        self.group = group
        self.sharding = None
        if args.tp > 1:
            if group is None or group.size != args.tp:
                raise ValueError(f"tp={args.tp} needs a TpGroup of {args.tp} ranks")
            self.sharding = ModelSharding(self.cfg, args.tp, group.rank, group)
        self.token_digest: torch.Tensor | None = None
        self.cache: M.KVCache | None = None
        self.device: torch.device | None = None
        self.dtype = DTYPES[args.dtype]
        self.attn_impl = "torch"
        self._rid = 0
        self._refs: OrderedDict[int, StepRef] = OrderedDict()
        # Per-SLOT latest sampled token, on the device (the tail slot is
        # the sink for padding rows). Allocated once: captured graphs hold
        # its address.
        self.last_toks: torch.Tensor | None = None
        self.graphs: WindowGraphs | None = None
        self.eager_windows = 0  # K-step windows run eagerly on CUDA
        self.eager_verifies = 0  # verify passes run eagerly on CUDA
        self.eager_steps = 0  # single decode steps run eagerly on CUDA
        self.eager_prefills = 0  # prefill dispatches run eagerly on CUDA
        # Verify passes dispatched, the forwards over all layers they made
        # (1 fused, S1 stepwise) and the kernel-wrapper calls they made, per
        # graphs.COUNTERS entry (attention, int8 decode-route products, int8
        # prefill route, int8 tied head, int8 wide entry, int8 decode entry
        # kernels); ``tree_verify_calls`` the same for tree passes alone.
        self.verify_passes = 0
        self.verify_forwards = 0
        self.verify_calls = (0,) * len(COUNTERS)
        self.tree_verify_calls = (0,) * len(COUNTERS)
        # Multi-LoRA adapter bank {qa..ob: [L, lora_slots, ...]} on the
        # device, allocated once at start (None when lora_slots is 0): the
        # captured graphs hold its addresses, so uploads write in place.
        self.lora_bank: dict[str, torch.Tensor] | None = None
        self.lora_windows = 0  # K-step windows dispatched in their LoRA variant
        self.adapter_uploads = 0
        self.adapter_upload_s = 0.0

    def start(self) -> None:
        self.device = resolve_device(self.args.device)
        self.attn_impl = resolve_attn_impl(self.args.attn_impl, self.device)
        leaves = list(_leaves(self.params)) if self.params is not None else []
        on_host = bool(leaves) and all(isinstance(a, np.ndarray) for a in leaves)
        if self.args.quant == "int8" and self.params is None:
            # Made on the card: int8 from birth, no weight upload.
            self.params = random_int8_params_device(self.cfg, self.device, self._seed,
                                                    self.dtype, shard=self.sharding)
        elif self.args.quant == "int8" and not any(a.dtype == np.int8 or a.dtype == torch.int8
                                                   for a in leaves):
            if not on_host:
                # Pulling float device params back to quantize them would
                # defeat the memory saving: the loader quantizes as it loads.
                raise ValueError(
                    "quant='int8' with unquantized device params — pass "
                    "quant='int8' to load_model/load_params instead"
                )
            self.params = quantize_params_np(self.params)
        if self.params is None:
            self.params = M.init_params(self.cfg, self.device, self.dtype, self._seed,
                                        shard=self.sharding)
        else:
            if self.sharding is not None:
                self.params = self.sharding.shard_params(self.params)
            if on_host:
                self.params = params_from_numpy(self.params, self.device, self.dtype)
        local = self.cfg if self.sharding is None else self.sharding.local
        self.cache = M.init_kv_cache(
            local, self.args.num_kv_blocks, self.args.block_size, self.dtype,
            self.device, kv_quant=self.args.kv_quant,
        )
        if self.sharding is not None:
            self.token_digest = torch.zeros((), dtype=torch.int64, device=self.device)
        self.last_toks = torch.zeros((self.args.max_num_seqs + 1,), dtype=torch.int32,
                                      device=self.device)
        if self.args.lora_slots > 0:
            # Zeros: a slot is garbage until its first upload, and the engine
            # never dispatches a row pointing at a slot it has not uploaded.
            self.lora_bank = {
                k: torch.zeros(shape, dtype=self.dtype, device=self.device)
                for k, shape in bank_shapes(local, self.args.lora_slots,
                                            self.args.lora_rank).items()
            }
        if (self.device.type == "cuda" and not self.args.enforce_eager
                and (self.group is None or self.group.backend == "nccl")):
            self.graphs = WindowGraphs(self.device)

    def stop(self) -> None:
        self._refs.clear()
        self.graphs = None
        self.cache = None

    # -- ref bookkeeping --------------------------------------------------

    def _new_ref(self, arrs: tuple, rid: int | None = None) -> StepRef:
        if rid is None:
            rid = self._rid
        self._rid = rid + 1
        ref = StepRef(rid, arrs)
        self._refs[rid] = ref
        while len(self._refs) > _RETAIN:
            self._refs.popitem(last=False)
        return ref

    def ref_by_id(self, rid: int) -> StepRef:
        return self._refs[rid]

    # -- host → device ----------------------------------------------------

    def upload(self, words: np.ndarray) -> torch.Tensor:
        """int32 words → a device tensor, without waiting for the device."""
        host = torch.from_numpy(words)
        if self.device.type == "cpu":
            return host
        return host.pin_memory().to(self.device, non_blocking=True)

    def _t(self, a, dtype=None) -> torch.Tensor:
        return torch.as_tensor(np.asarray(a), device=self.device, dtype=dtype)

    # -- adapters -----------------------------------------------------------

    def upload_adapter(self, slot: int, pages) -> None:
        """Write one adapter's factor pages (engine/lora.py LORA_PAGE_KEYS
        order, float host arrays) into bank slot ``slot``, in place: the
        bank keeps its addresses, which the captured graphs replay against.
        On the card each page goes up from pinned staging in a non_blocking
        copy on the compute stream, behind the windows already in flight
        (they read the slot's old occupant, as in the JAX package); torch's
        caching host allocator hands the staging out again only once its
        copy has run. Under tp the rank keeps its shard of each page."""
        if self.lora_bank is None:
            raise ValueError("upload_adapter on a runner without an adapter bank "
                             "(lora_slots == 0)")
        t0 = time.perf_counter()
        if self.sharding is not None:
            pages = shard_adapter_pages(self.sharding, pages)
        for key, arr in zip(LORA_PAGE_KEYS, pages):
            bank = self.lora_bank[key]
            host = torch.from_numpy(np.ascontiguousarray(arr)).to(bank.dtype)
            if bank.device.type == "cuda":
                host = host.pin_memory()
            bank[:, slot].copy_(host, non_blocking=True)
        self.adapter_uploads += 1
        self.adapter_upload_s += time.perf_counter() - t0

    def _lora_operands(self, aslots):
        """(bank, per-row slots) of a dispatch, or (None, None) for the
        pre-LoRA variant."""
        if aslots is None:
            return None, None
        if self.lora_bank is None:
            raise ValueError("adapter_slots passed but lora_slots == 0")
        return self.lora_bank, aslots

    # -- dispatches -------------------------------------------------------

    def prefill_batch(self, toks, tables, starts, tlens, adapter_slots=None, *,
                      eager=False) -> torch.Tensor:
        """Prefill Bp rows (``toks`` [Bp, T], ``tables`` [Bp, W], suffix
        ``starts`` and true lengths ``tlens`` [Bp], 0 for an inactive row)
        → last-token logits [Bp, V] on the device, dispatched without
        waiting for it. ``adapter_slots`` [Bp] (-1 = base) selects the LoRA
        variant; None the pre-LoRA one. On CUDA each shape is one graph
        replay; ``eager=True`` runs it op by op (the parity checks' seam)."""
        Bp, T = np.shape(toks)
        lay = prefill_layout(Bp, T, np.shape(tables)[1], adapter_slots is not None)
        return self._prefill(lay, lay.pack(toks=toks, tables=tables, starts=starts, tlens=tlens,
                                           aslots=adapter_slots), eager)

    def prefill_chunk(self, toks, table, pos: int, tlen: int, adapter_slot: int | None = None,
                      *, eager=False) -> torch.Tensor:
        """Positions [pos, tlen) of one sequence → last-token logits [V] on
        the device: the one-row ``prefill_batch``, whose graphs it shares. A
        row with an adapter passes its bank slot (the JAX
        ``prefill_chunk``'s scalar slot); None or -1 runs the pre-LoRA
        forward."""
        lora = adapter_slot is not None and adapter_slot >= 0
        lay = prefill_layout(1, len(toks), len(table), lora)
        return self._prefill(lay, lay.pack(toks=toks, tables=table, starts=pos, tlens=tlen,
                                           aslots=adapter_slot), eager)[0]

    def _prefill(self, lay: Layout, words: np.ndarray, eager: bool) -> torch.Tensor:
        if self.graphs is not None and not eager:
            (logits,) = self.graphs.run(words=words, **self._prefill_graph(lay))
            # The graph's static logits are overwritten by its next replay,
            # which may come before this wave samples (two singles of one
            # shape, a prompt whose chunks share a bucket): the copy is
            # enqueued right behind this replay, before any later one.
            return logits.clone()
        if self.device.type == "cuda":
            self.eager_prefills += 1
        return self._prefill_fn(lay)(self.upload(words))[0]

    def _prefill_graph(self, lay: Layout) -> dict:
        """``WindowGraphs.run``/``capture`` operands of a prefill layout:
        its key ("prefill", rows, T, W, lora) and the maker."""
        Bp, T = lay.slices["toks"][2]
        key = ("prefill", Bp, T, lay.slices["tables"][2][1], "aslots" in lay.slices)
        return dict(key=key, make=lambda: (self._prefill_fn(lay), self._inert_prefill(lay)))

    def _prefill_fn(self, lay: Layout):
        """The prefill as one function of its packed inputs (what a graph
        captures)."""

        def prefill(words: torch.Tensor):
            a = lay.unpack(words)
            bank, aslots = self._lora_operands(a.get("aslots"))
            return (M.prefill_batch(self.cfg, self.params, self.cache, a["toks"], a["tables"],
                                    a["starts"], a["tlens"], bank, aslots, self.sharding),)

        return prefill

    @staticmethod
    def _inert_prefill(lay: Layout) -> np.ndarray:
        """Prefill inputs that touch nothing live: every row's true length
        0, so its KV writes land in block 0, the garbage sink."""
        Bp, T = lay.slices["toks"][2]
        z = np.zeros((Bp,), np.int32)
        return lay.pack(toks=np.zeros((Bp, T), np.int32),
                        tables=np.zeros(lay.slices["tables"][2], np.int32), starts=z, tlens=z,
                        aslots=np.full((Bp,), -1, np.int32))

    def prefill_shapes(self) -> list[tuple[int, int, int]]:
        """Every (rows, T, W) a prefill dispatch of the engine can take:
        rows a power of two up to ``prefill_batch_max`` (the engine's packs;
        a chunk is one row), T a rung of the prefill ladder, W a table
        bucket that can hold a suffix of T's bucket (its shortest suffix,
        one past the rung below, fits in W blocks)."""
        args = self.args
        rows, b = [], 1
        while b <= max(1, args.prefill_batch_max):
            rows.append(b)
            b *= 2
        pairs, lo = [], 1
        for T in args.prefill_buckets:
            pairs += [(T, W) for W in args.table_buckets if -(-lo // args.block_size) <= W]
            lo = T + 1
        return [(Bp, T, W) for Bp in rows for T, W in pairs]

    def warm_prefills(self) -> int:
        """Capture, ahead of traffic, the CUDA graph of every prefill shape
        (``prefill_shapes``), and with an adapter bank each shape's LoRA
        variant too; a shape's first replay is its first real dispatch. →
        graphs newly captured (0 on the CPU or under ``enforce_eager``)."""
        if self.graphs is None:
            return 0
        before = self.graphs.captured
        # Largest first: every later capture fits in the pool segments the
        # first one freed (ascending, the pool grows by half again).
        shapes = sorted(self.prefill_shapes(), key=lambda s: (s[1], s[2], s[0]), reverse=True)
        for lora in self._lora_variants():
            for Bp, T, W in shapes:
                self.graphs.capture(**self._prefill_graph(prefill_layout(Bp, T, W, lora)))
        return self.graphs.captured - before

    def decode_step(self, tokens, positions, tables, active, adapter_slots=None) -> torch.Tensor:
        """→ logits [B, V] (device)."""
        bank, aslots = self._lora_operands(
            None if adapter_slots is None else self._t(adapter_slots, torch.int32))
        return M.decode_step(
            self.cfg, self.params, self.cache, self._t(tokens, torch.int32),
            self._t(positions, torch.int32), self._t(tables, torch.int32),
            self._t(active, torch.bool), self.attn_impl, bank, aslots, self.sharding,
        )

    def multi_decode(self, K, mode, tokens, chain, positions, tables, active, temps,
                     seeds, steps0, tks, tps, freqs, press, pen, fold_slots=None,
                     top_n=0, adapter_slots=None, *, rid=None, eager=False) -> StepRef:
        """One fused K-step window → StepRef (tokens [K, B], logprobs [K, B],
        top_vals [K, B, n], top_ids [K, B, n]) on the device.

        chain: None | (dst rows, src slots) — rows whose input token is the
        latest on-device sample of that sequence SLOT (no host sync).
        ``fold_slots`` [B] names each row's slot so the window's final
        tokens land back in ``last_toks`` (padding rows → the tail slot).
        ``pen`` [B, L] is the penalty window ("full" mode; [B, 1] of -1
        otherwise). ``adapter_slots`` [B] (-1 = base) selects the LoRA
        variant; None the pre-LoRA one. On CUDA a window replays its CUDA
        graph; ``eager=True`` runs it op by op instead (the parity checks'
        seam). The engine dispatches K > 1 only: a K=1 plan is
        ``decode_sample``."""
        B, W = np.shape(tables)
        L = np.shape(pen)[1]
        mask = np.zeros((B,), bool)
        srcmap = np.zeros((B,), np.int32)
        if chain is not None:
            dst, src = chain
            mask[np.asarray(dst, np.int64)] = True
            srcmap[np.asarray(dst, np.int64)] = src
        if fold_slots is None:
            fold_slots = np.full((B,), self.args.max_num_seqs, np.int32)
        lay = window_layout(B, W, L, adapter_slots is not None)
        self.lora_windows += adapter_slots is not None
        words = lay.pack(
            tokens=tokens, positions=positions, tables=tables, active=active, temps=temps,
            seeds=seeds, steps0=steps0, top_k=tks, top_p=tps, freq=freqs, pres=press,
            pen=pen, chain_mask=mask, chain_src=srcmap, fold_slots=fold_slots,
            aslots=adapter_slots,
        )
        if self.graphs is not None and not eager:
            outs = self._graph_window(lay, int(K), mode, int(top_n), words)
        else:
            if self.device.type == "cuda":
                self.eager_windows += 1
            outs = self._window_fn(int(K), mode, int(top_n), lay)(self.upload(words))
        self._digest(outs[0])
        return self._new_ref(tuple(outs), rid)

    def _graph_window(self, lay: Layout, K: int, mode: str, top_n: int, words: np.ndarray):
        B, W = lay.slices["tables"][2]
        key = (B, W, lay.slices["pen"][2][1], K, mode, top_n, "aslots" in lay.slices)
        return self.graphs.run(
            key, words, lambda: (self._window_fn(K, mode, top_n, lay), self._inert_window(lay)))

    def warm_windows(self, modes=("greedy", "simple"), top_ns=(0,)) -> int:
        """Capture, ahead of traffic, the CUDA graph of every window shape
        these sampler modes and top_n values can take (each decode bucket ×
        table bucket at ``decode_steps``), so that no request waits for a
        capture; each is replayed once on inert inputs. → graphs newly
        captured (0 on the CPU, or with decode_steps 1, whose every plan is
        a single step). With an adapter bank, each shape's LoRA variant
        too."""
        K = self.args.decode_steps
        if self.graphs is None or K < 2:
            return 0
        before = self.graphs.captured
        for lora in self._lora_variants():
            for mode in modes:
                L = self.args.max_model_len if mode == "full" else 1
                for top_n in top_ns:
                    for B in self.args.decode_buckets:
                        for W in self.args.table_buckets:
                            lay = window_layout(B, W, L, lora)
                            self._graph_window(lay, K, mode, top_n, self._inert_window(lay))
        return self.graphs.captured - before

    def _lora_variants(self) -> tuple[bool, ...]:
        """Graph variants warm-up captures: the pre-LoRA one, and the LoRA
        one when the runner has an adapter bank."""
        return (False, True) if self.lora_bank is not None else (False,)

    def _window_fn(self, K: int, mode: str, top_n: int, lay: Layout):
        """The window as one function of its packed inputs (what a graph
        captures): multi_decode, then the fold into ``last_toks``."""

        def window(words: torch.Tensor):
            a = lay.unpack(words)
            bank, aslots = self._lora_operands(a.get("aslots"))
            out = M.multi_decode(
                self.cfg, K, mode, top_n, self.params, self.cache, a["tokens"],
                a["positions"], a["tables"], a["active"], a["temps"], a["seeds"],
                a["steps0"], a["top_k"], a["top_p"], a["freq"], a["pres"], a["pen"],
                a["chain_mask"], a["chain_src"], self.last_toks, bank, aslots,
                attn_impl=self.attn_impl, tp=self.sharding,
            )
            self.last_toks[a["fold_slots"].long()] = out[0][-1]
            return out

        return window

    def _inert_window(self, lay: Layout) -> np.ndarray:
        """Window inputs that touch nothing live: every row inactive (its KV
        writes land in block 0), no chaining, folds into the sink slot."""
        B = lay.slices["tokens"][2][0]
        sink = self.args.max_num_seqs
        z = np.zeros((B,), np.int32)
        return lay.pack(
            tokens=z, positions=z, tables=np.zeros(lay.slices["tables"][2], np.int32),
            active=z, temps=np.ones((B,), np.float32), seeds=z, steps0=z, top_k=z,
            top_p=np.ones((B,), np.float32), freq=z, pres=z,
            pen=np.full(lay.slices["pen"][2], -1, np.int32), chain_mask=z, chain_src=z,
            fold_slots=np.full((B,), sink, np.int32), aslots=np.full((B,), -1, np.int32),
        )

    def spec_verify(self, S1, mode, tokens, positions0, draft_len, tables, active, temps,
                    seeds, steps0, fold_slots=None, top_n=0, tree=None, masks=None,
                    adapter_slots=None, *, rid=None, eager=False) -> StepRef:
        """One speculative verify pass over ``S1`` slots per row (fused: one
        weight stream; ``spec_fused=False``: S1 decode steps), acceptance
        on the device → StepRef (out [B, S1], n_emit [B], logps [B, S1],
        cand [B, S1], top_vals, top_ids). ``tree`` = None for linear
        drafts, or (parents [B, S1], anc [B, S1, S1], depth [B, S1]) numpy
        arrays for a draft tree. ``masks`` = None or [B, S1, W32] uint32
        packed per-node grammar bitsets (tree passes only: the engine
        upgrades every constrained batch to the tree op); they ride the
        packed upload, so the masked pass is one more captured shape. The
        pass's last emitted token folds into ``last_toks`` at
        ``fold_slots``, so the next window chains from it.
        ``adapter_slots`` [B] (-1 = base) selects the LoRA variant. On CUDA
        each verify shape is one graph replay; ``eager=True`` runs it op by
        op (the parity checks' seam)."""
        B, W = np.shape(tables)
        S1 = int(S1)
        if fold_slots is None:
            fold_slots = np.full((B,), self.args.max_num_seqs, np.int32)
        W32 = 0 if masks is None else np.shape(masks)[-1]
        lay = verify_layout(B, W, S1, tree is not None, W32, adapter_slots is not None)
        arrays = dict(tokens=tokens, positions0=positions0, draft_len=draft_len, tables=tables,
                      active=active, temps=temps, seeds=seeds, steps0=steps0,
                      fold_slots=fold_slots, aslots=adapter_slots)
        if tree is not None:
            arrays.update(parents=tree[0], anc=tree[1], depth=tree[2])
        if masks is not None:
            arrays["masks"] = masks
        words = lay.pack(**arrays)
        fused = self.args.spec_fused or tree is not None
        before = read_counts()
        if self.graphs is not None and not eager:
            outs = self._graph_verify(lay, S1, mode, int(top_n), fused, words)
        else:
            if self.device.type == "cuda":
                self.eager_verifies += 1
            outs = self._verify_fn(S1, mode, int(top_n), fused, lay)(self.upload(words))
        calls = tuple(b - a for a, b in zip(before, read_counts()))
        self.verify_calls = tuple(map(sum, zip(self.verify_calls, calls)))
        if tree is not None:
            self.tree_verify_calls = tuple(map(sum, zip(self.tree_verify_calls, calls)))
        self.verify_passes += 1
        self.verify_forwards += 1 if fused else S1
        self._digest(outs[0], outs[1])
        return self._new_ref(tuple(outs), rid)

    def _graph_verify(self, lay: Layout, S1: int, mode: str, top_n: int, fused: bool,
                      words: np.ndarray):
        B, W = lay.slices["tables"][2]
        key = ("verify", B, W, S1, mode, top_n, "parents" in lay.slices, fused,
               "aslots" in lay.slices, "masks" in lay.slices)
        return self.graphs.run(key, words, lambda: (
            self._verify_fn(S1, mode, top_n, fused, lay), self._inert_verify(lay)))

    def _verify_fn(self, S1: int, mode: str, top_n: int, fused: bool, lay: Layout):
        """The verify pass as one function of its packed inputs (what a
        graph captures): model.spec_verify, then the fold of each row's
        last emitted token into ``last_toks``."""

        def verify(words: torch.Tensor):
            a = lay.unpack(words)
            bank, aslots = self._lora_operands(a.get("aslots"))
            out = M.spec_verify(
                self.cfg, S1, mode, top_n, self.params, self.cache, a["tokens"],
                a["positions0"], a["draft_len"], a["tables"], a["active"], a["temps"],
                a["seeds"], a["steps0"], a.get("parents"), a.get("anc"), a.get("depth"),
                a.get("masks"), bank, aslots, fused=fused, attn_impl=self.attn_impl,
                tp=self.sharding,
            )
            self.last_toks[a["fold_slots"].long()] = out[6]
            return out[:6]

        return verify

    def _inert_verify(self, lay: Layout) -> np.ndarray:
        """Verify inputs that touch nothing live: every row inactive (KV
        writes and compaction land in block 0), folds into the sink slot;
        a tree layout carries a chain's topology, a masked one all-ones
        masks."""
        B, S1 = lay.slices["tokens"][2]
        z = np.zeros((B,), np.int32)
        arrays = dict(
            tokens=np.zeros((B, S1), np.int32), positions0=z,
            draft_len=np.full((B,), S1 - 1, np.int32),
            tables=np.zeros(lay.slices["tables"][2], np.int32), active=z,
            temps=np.ones((B,), np.float32), seeds=z, steps0=z,
            fold_slots=np.full((B,), self.args.max_num_seqs, np.int32),
            aslots=np.full((B,), -1, np.int32),
        )
        if "parents" in lay.slices:
            arrays.update(
                parents=np.broadcast_to(np.maximum(np.arange(S1) - 1, 0), (B, S1)),
                anc=np.broadcast_to(np.tril(np.ones((S1, S1), np.int32)), (B, S1, S1)),
                depth=np.broadcast_to(np.arange(S1), (B, S1)),
            )
        if "masks" in lay.slices:
            arrays["masks"] = np.full(lay.slices["masks"][2], 0xFFFFFFFF, np.uint32)
        return lay.pack(**arrays)

    def warm_spec(self, modes=("greedy", "simple"), top_ns=(0,), grammar: bool = False) -> int:
        """Capture, ahead of traffic, the CUDA graph of every verify shape
        the engine's speculation can dispatch in these sampler modes and
        top_n values (the JAX package AOT-compiles the same lattice): each
        decode bucket × table bucket × S1 (spec_tokens+1, and
        2·spec_tokens+1 under adaptive budgets) × linear, and tree when
        spec_tree_width > 1 or ``grammar``; ``grammar=True`` adds the
        masked tree shapes constrained traffic dispatches (JAX
        ``TpuEngine.warm_spec``). Each is replayed once on inert inputs. →
        graphs newly captured (0 on the CPU or with spec_tokens 0). With an
        adapter bank, each shape's LoRA variant too."""
        S = self.args.spec_tokens
        if self.graphs is None or S <= 0:
            return 0
        s1s = [S + 1] + ([2 * S + 1] if self.args.spec_budget_adaptive else [])
        shapes = [(False, False)]
        if self.args.spec_tree_width > 1 or grammar:
            shapes.append((True, False))
        if grammar:
            shapes.append((True, True))
        W32 = mask_words(self.cfg.vocab_size)
        before = self.graphs.captured
        for lora in self._lora_variants():
            for S1 in s1s:
                for tree, masked in shapes:
                    fused = self.args.spec_fused or tree
                    for mode in modes:
                        for top_n in top_ns:
                            for B in self.args.decode_buckets:
                                for W in self.args.table_buckets:
                                    lay = verify_layout(B, W, S1, tree, W32 if masked else 0,
                                                        lora)
                                    self._graph_verify(lay, S1, mode, top_n, fused,
                                                       self._inert_verify(lay))
        return self.graphs.captured - before

    # -- KV page movement (disaggregated prefill/decode) -------------------

    def extract_pages(self, block_ids: list[int]) -> tuple:
        """→ (k, v) host page arrays, plus (k_scale, v_scale) under int8 KV
        (synchronous)."""
        if self.sharding is None:
            return kv_transfer.extract_pages(self.cache, block_ids)
        arrs, n = LocalRunner.start_extract_pages(self, block_ids)  # one dispatch, not two
        return kv_transfer.finish_extract([t.cpu().numpy() for t in arrs], n)

    def start_extract_pages(self, block_ids: list[int]) -> tuple:
        """Enqueue a page gather without waiting → (device tensors, n). The
        streaming KV exporter starts their device→host copy
        (start_host_fetch) and harvests it with ``finish_extract_pages``
        once ready, so page copies overlap the remaining prefill chunks.
        Under tp every rank's lanes are gathered (a collective every rank
        makes) into the JAX layout."""
        arrs, n = kv_transfer.start_extract(self.cache, block_ids)
        if self.sharding is not None:
            arrs = tuple(self.sharding.merge_lanes(self.group.all_gather(a)) for a in arrs)
        return arrs, n

    @staticmethod
    def finish_extract_pages(fetch: HostFetch, n: int) -> tuple:
        return kv_transfer.finish_extract(fetch.wait(), n)

    def inject_pages(self, block_ids: list[int], *pages) -> None:
        """Write host pages into the named blocks, in place: the cache
        tensors keep their addresses, which the captured graphs replay
        against."""
        pages = kv_transfer.adapt_pages(pages, self.cache, self.cfg.num_kv_heads)
        if self.sharding is not None:
            pages = self.sharding.shard_pages(pages)
        kv_transfer.inject_pages(self.cache, block_ids, *pages)

    def sample_rows(self, srcs: list, mode: str, temps, tks, tps, pen, freqs,
                    press, seeds, steps, fold_slots=None, top_n: int = 0,
                    masks=None) -> StepRef:
        """Sample one token per row of the stacked logits ``srcs`` (each a
        [V] tensor, or a (logits, row) pair: row ``row`` of a packed
        prefill's [Bp, V] logits, or its [V] logits when ``row`` is None, as
        the JAX runner's sources) in sampler ``mode`` → StepRef (tokens [B],
        logprobs [B], top_vals [B, n], top_ids [B, n]). ``masks`` = None or
        [B, W32] uint32 packed grammar bitsets: each row samples from its
        legal vocabulary, while the logprobs stay the raw model's. With
        ``fold_slots`` the tokens also land in ``last_toks``, so the next
        window chains from them without a host sync (async admission)."""
        x = torch.stack([t if isinstance(t, torch.Tensor) else t[0] if t[1] is None
                         else t[0][t[1]] for t in srcs])
        B = x.shape[0]
        if fold_slots is None:
            fold_slots = np.full((B,), self.args.max_num_seqs, np.int32)
        lay = sample_layout(B, np.shape(pen)[1], 0 if masks is None else np.shape(masks)[-1])
        arrays = dict(temps=temps, seeds=seeds, steps=steps, top_k=tks, top_p=tps, freq=freqs,
                      pres=press, pen=pen, fold_slots=fold_slots)
        if masks is not None:
            arrays["masks"] = masks
        a = lay.unpack(self.upload(lay.pack(**arrays)))
        outs = self._sample(x, mode, top_n, a)
        self._digest(outs[0])
        return self._new_ref(outs)

    def _sample(self, x: torch.Tensor, mode: str, top_n: int, a: dict) -> tuple:
        """Sample ``x`` [B, V] in ``mode`` from the unpacked sampling
        operands ``a`` (with their grammar masks, if any), fold the tokens
        into ``last_toks`` → (tokens, logprobs, top_vals, top_ids)."""
        B, V = x.shape
        masks = a.get("masks")
        if mode == "greedy":
            toks = torch.argmax(apply_mask(x, masks), dim=-1).to(torch.int32)
        elif mode == "simple":
            toks = sample_simple(x, a["temps"], row_gumbel(a["seeds"], a["steps"], V), masks)
        else:
            toks = sample_full(x, a["temps"], a["top_k"], a["top_p"], a["pen"], a["freq"],
                               a["pres"], row_gumbel(a["seeds"], a["steps"], V), masks)
        self.last_toks[a["fold_slots"].long()] = toks
        if top_n > 0:
            tv, ti = top_k_logprobs(x, top_n)
        else:
            tv = torch.zeros((B, 0), dtype=torch.float32, device=x.device)
            ti = torch.zeros((B, 0), dtype=torch.int32, device=x.device)
        return toks, token_logprobs(x, toks), tv, ti

    # -- single decode step (the JAX engine's _decode_single_step) ----------

    def decode_sample(self, mode, tokens, positions, tables, active, temps, seeds, steps, tks,
                      tps, freqs, press, pen, fold_slots=None, top_n: int = 0, masks=None,
                      adapter_slots=None, *, rid=None, eager=False) -> StepRef:
        """One decode step and the sampling of its logits as one dispatch:
        ``decode_step`` then ``sample_rows`` on its rows (with their
        grammar ``masks``, [B, W32] uint32, or None) → StepRef (tokens
        [B], logprobs [B], top_vals [B, n], top_ids [B, n]). The engine's
        every K=1 plan: the end-of-life tail, ``decode_steps`` 1, and a
        batch with grammar rows, whose next mask needs this step's token
        on the host. ``adapter_slots`` [B] (-1 = base) selects the LoRA
        variant. On CUDA it is one graph replay per shape (B, W, L, mode,
        top_n, lora, masked), ``eager=True`` runs it op by op (the parity
        checks' seam)."""
        B, W = np.shape(tables)
        if fold_slots is None:
            fold_slots = np.full((B,), self.args.max_num_seqs, np.int32)
        W32 = 0 if masks is None else np.shape(masks)[-1]
        lay = step_layout(B, W, np.shape(pen)[1], W32, adapter_slots is not None)
        arrays = dict(tokens=tokens, positions=positions, tables=tables, active=active,
                      temps=temps, seeds=seeds, steps=steps, top_k=tks, top_p=tps, freq=freqs,
                      pres=press, pen=pen, fold_slots=fold_slots, aslots=adapter_slots)
        if masks is not None:
            arrays["masks"] = masks
        words = lay.pack(**arrays)
        if self.graphs is not None and not eager:
            outs = self._graph_step(lay, mode, int(top_n), words)
        else:
            if self.device.type == "cuda":
                self.eager_steps += 1
            outs = self._step_fn(mode, int(top_n), lay)(self.upload(words))
        self._digest(outs[0])
        return self._new_ref(tuple(outs), rid)

    def _graph_step(self, lay: Layout, mode: str, top_n: int, words: np.ndarray):
        B, W = lay.slices["tables"][2]
        key = ("step", B, W, lay.slices["pen"][2][1], mode, top_n, "aslots" in lay.slices,
               "masks" in lay.slices)
        return self.graphs.run(key, words, lambda: (self._step_fn(mode, top_n, lay),
                                                    self._inert_step(lay)))

    def _step_fn(self, mode: str, top_n: int, lay: Layout):
        """The single step as one function of its packed inputs (what a
        graph captures)."""

        def step(words: torch.Tensor):
            a = lay.unpack(words)
            bank, aslots = self._lora_operands(a.get("aslots"))
            logits = M.decode_step(self.cfg, self.params, self.cache, a["tokens"],
                                   a["positions"], a["tables"], a["active"], self.attn_impl,
                                   bank, aslots, self.sharding)
            return self._sample(logits, mode, top_n, a)

        return step

    def _inert_step(self, lay: Layout) -> np.ndarray:
        """Step inputs that touch nothing live: every row inactive, folds
        into the sink slot, all-ones masks."""
        B = lay.slices["tokens"][2][0]
        z = np.zeros((B,), np.int32)
        arrays = dict(
            tokens=z, positions=z, tables=np.zeros(lay.slices["tables"][2], np.int32), active=z,
            temps=np.ones((B,), np.float32), seeds=z, steps=z, top_k=z,
            top_p=np.ones((B,), np.float32), freq=z, pres=z,
            pen=np.full(lay.slices["pen"][2], -1, np.int32),
            fold_slots=np.full((B,), self.args.max_num_seqs, np.int32),
            aslots=np.full((B,), -1, np.int32),
        )
        if "masks" in lay.slices:
            arrays["masks"] = np.full(lay.slices["masks"][2], 0xFFFFFFFF, np.uint32)
        return lay.pack(**arrays)

    def warm_steps(self, modes=("greedy", "simple"), top_ns=(0,),
                   masked=(False, True)) -> int:
        """Capture, ahead of traffic, the single-step graph of every shape
        the engine can dispatch in these sampler modes and top_n values
        (each decode bucket × table bucket), unmasked (the end-of-life
        tail, ``decode_steps`` 1) and masked (grammar-constrained batches)
        as ``masked`` lists, each replayed once on inert inputs (with an
        adapter bank, each shape's LoRA variant too). → graphs newly
        captured (0 on the CPU)."""
        if self.graphs is None:
            return 0
        before = self.graphs.captured
        for lora in self._lora_variants():
            for m in masked:
                W32 = mask_words(self.cfg.vocab_size) if m else 0
                for mode in modes:
                    L = self.args.max_model_len if mode == "full" else 1
                    for top_n in top_ns:
                        for B in self.args.decode_buckets:
                            for W in self.args.table_buckets:
                                lay = step_layout(B, W, L, W32, lora)
                                self._graph_step(lay, mode, top_n, self._inert_step(lay))
        return self.graphs.captured - before

    # -- the sampled-token digest (tp ranks) ---------------------------------

    def _digest(self, *tensors: torch.Tensor) -> None:
        """Fold sampled tokens into ``token_digest`` on the device (tp > 1
        only): an order-dependent sum modulo 2^31 - 1 that two ranks agree
        on exactly when they sampled the same tokens in the same order."""
        if self.token_digest is None:
            return
        for t in tensors:
            flat = t.reshape(-1).long()
            w = torch.arange(1, flat.numel() + 1, device=flat.device)
            self.token_digest = (self.token_digest * 1_000_003 + (flat * w).sum()) % 2147483647

    def digest(self) -> int | None:
        """The sampled-token digest so far (waits for the device), None at tp=1."""
        return None if self.token_digest is None else int(self.token_digest)

    def zero_counts(self) -> None:
        """Every kernel wrapper's launch count (graphs.COUNTERS) to 0, with
        no dispatch in flight: a reading after it counts what came after."""
        set_counts(0 for _ in COUNTERS)

    # -- embeddings ---------------------------------------------------------

    def embed(self, toks, tlen: int) -> torch.Tensor:
        """Mean-pooled final hidden state of ``toks[:tlen]`` (``toks``
        padded) → [D] f32 on the device; eager, one forward."""
        return M.embed(self.cfg, self.params, self._t(toks, torch.int32), int(tlen),
                       self.sharding)


# ---------------------------------------------------------------------------
# Tensor parallelism across processes: leader broadcast + follower replay
# ---------------------------------------------------------------------------

# Every dispatch the leader mirrors, in the order the JAX LeaderRunner lists
# its own (prefill_batch … inject_pages), then the port's: the single step
# and its sampling, and the graph captures ahead of traffic (under NCCL
# every rank captures the same windows in the same order, collectives
# inside). Each dispatch's host operands travel with it, so a follower
# packs and uploads the same words the leader does.
MIRRORED = ("prefill_batch", "prefill_chunk", "upload_adapter", "multi_decode", "decode_step",
            "spec_verify", "sample_rows", "embed", "extract_pages", "start_extract_pages",
            "inject_pages", "decode_sample", "warm_windows", "warm_spec", "warm_steps",
            "warm_prefills")
# How long the leader waits for its followers to connect, and a follower
# retries while the leader starts up (it may load a checkpoint first).
CONNECT_TIMEOUT_S = 600.0


def _recv_exact(sock: socket.socket, n: int) -> bytes | None:
    buf = bytearray()
    while len(buf) < n:
        chunk = sock.recv(min(n - len(buf), 1 << 20))
        if not chunk:
            return None
        buf += chunk
    return bytes(buf)


def _recv_msg(sock: socket.socket) -> dict | None:
    hdr = _recv_exact(sock, 4)
    if hdr is None:
        return None
    (n,) = struct.unpack(">I", hdr)
    body = _recv_exact(sock, n)
    return None if body is None else msgpack_lite.unpackb(body, raw=False)


def _encode(x, rid_of):
    """A dispatch operand → msgpack-able: numpy arrays as {"nd": [dtype,
    shape, bytes]}, tensors (logits another dispatch made) as {"ref": rid}
    through ``rid_of``, tuples as lists."""
    if isinstance(x, torch.Tensor):
        return {"ref": rid_of(x)}
    if isinstance(x, np.ndarray):
        a = np.ascontiguousarray(x)
        return {"nd": [a.dtype.str, list(a.shape), a.tobytes()]}
    if isinstance(x, np.generic):
        return x.item()
    if isinstance(x, (list, tuple)):
        return [_encode(v, rid_of) for v in x]
    if isinstance(x, dict):
        return {"map": {k: _encode(v, rid_of) for k, v in x.items()}}
    return x


def _decode(x, runner: LocalRunner):
    if isinstance(x, list):
        return [_decode(v, runner) for v in x]
    if isinstance(x, dict):
        if "nd" in x:
            dt, shape, raw = x["nd"]
            return np.frombuffer(raw, np.dtype(dt)).reshape(shape)
        if "ref" in x:
            return runner.ref_by_id(x["ref"]).arrs[0]
        return {k: _decode(v, runner) for k, v in x["map"].items()}
    return x


class LeaderRunner(LocalRunner):
    """A LocalRunner that mirrors every dispatch to its follower processes
    (port of the JAX ``LeaderRunner``): ``start`` accepts
    ``num_followers`` TCP connections on ``listen_addr``, and each
    dispatch in ``MIRRORED`` is sent to every follower (framed
    ``runtime/msgpack_lite``, in dispatch order) before it runs here.
    Dispatch ids (rids) travel with each frame, so a tensor one dispatch
    returned (prefill logits) can be named by a later one (``sample_rows``).
    The scheduler exists only here; a follower never fetches a result."""

    def __init__(self, args: EngineArgs, params: Any | None = None, seed: int = 0, group=None,
                 *, listen_addr: str = "0.0.0.0:7411", num_followers: int = 0):
        super().__init__(args, params, seed, group)
        self.num_followers = num_followers
        self._listen_addr = listen_addr
        self._socks: list[socket.socket] = []
        self._tensor_rids: dict[int, int] = {}
        self.frames = 0
        self.frame_bytes = 0

    def start(self) -> None:
        host, port = self._listen_addr.rsplit(":", 1)
        srv = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        srv.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        srv.bind((host, int(port)))
        srv.listen(self.num_followers)
        srv.settimeout(CONNECT_TIMEOUT_S)
        try:
            for _ in range(self.num_followers):
                s, _peer = srv.accept()
                s.settimeout(None)
                s.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
                self._socks.append(s)
        finally:
            srv.close()
        self._cast({"op": "start"})
        super().start()

    def stop(self) -> None:
        if self._socks:
            self._cast({"op": "stop"})
        for s in self._socks:
            s.close()
        self._socks.clear()
        super().stop()

    def zero_counts(self) -> None:
        """The launch counts to 0 here and, in dispatch order, on every
        follower, which first prints what it had counted (``on_zero`` of
        ``follower_loop``). Called between dispatches (the engine thread's
        ``run_on_engine_thread``), as a dispatch is."""
        self._cast({"op": "zero_counts"})
        super().zero_counts()

    def _cast(self, desc: dict) -> None:
        body = msgpack_lite.packb(desc, use_bin_type=True)
        frame = struct.pack(">I", len(body)) + body
        for s in self._socks:
            s.sendall(frame)
        self.frames += 1
        self.frame_bytes += len(frame)

    def _rid_of(self, t: torch.Tensor) -> int:
        rid = self._tensor_rids.get(id(t))
        ref = None if rid is None else self._refs.get(rid)
        if ref is None or ref.arrs[0] is not t:
            raise RuntimeError("a dispatch operand is a tensor no mirrored dispatch returned")
        return rid

    def _mirror(self, op: str, a: tuple, kw: dict):
        rid = self._rid
        desc = {"op": op, "rid": rid, "a": _encode(a, self._rid_of),
                "kw": _encode(kw, self._rid_of)}
        if op in _SPEC_OPS:
            # The engine may change its speculation knobs between bursts
            # (TorchEngine.set_spec): the verify ops carry the leader's.
            desc["spec"] = spec_knobs(self.args)
        self._cast(desc)
        out = getattr(LocalRunner, op)(self, *a, **kw)
        if isinstance(out, torch.Tensor):
            self._new_ref((out,), rid)
            self._tensor_rids = {k: v for k, v in self._tensor_rids.items() if v in self._refs}
            self._tensor_rids[id(out)] = rid
        return out


_SPEC_OPS = ("spec_verify", "warm_spec")


def spec_knobs(args: EngineArgs) -> dict:
    """The speculative-decoding fields of ``args`` (what a verify dispatch
    reads besides its operands)."""
    return {f.name: getattr(args, f.name) for f in dataclasses.fields(args)
            if f.name.startswith("spec_")}


def _mirrored(op: str):
    def dispatch(self, *a, **kw):
        return self._mirror(op, a, kw)

    dispatch.__name__ = dispatch.__qualname__ = op
    dispatch.__doc__ = f"``LocalRunner.{op}``, sent to the followers first."
    return dispatch


for _op in MIRRORED:
    setattr(LeaderRunner, _op, _mirrored(_op))


def follower_loop(args: EngineArgs, leader_addr: str, params: Any | None = None, seed: int = 0,
                  group=None, on_zero=None) -> LocalRunner:
    """Replay the leader's dispatch stream on this rank until the leader
    stops (or its connection closes) → the rank's runner, started and not
    yet stopped (its counters and digest are the caller's to read).

    Every dispatch the leader's engine makes runs here in the same order
    with the same host operands, so the collectives of both ranks meet and
    the ranks sample the same tokens; nothing is fetched. The leader's
    ``zero_counts`` calls ``on_zero(runner)`` (when given) with the counts
    as they stand, then sets them to 0."""
    host, port = leader_addr.rsplit(":", 1)
    deadline = time.monotonic() + CONNECT_TIMEOUT_S
    while True:  # the leader may still be starting up
        try:
            sock = socket.create_connection((host, int(port)), timeout=5.0)
            break
        except OSError:
            if time.monotonic() > deadline:
                raise
            time.sleep(0.2)
    sock.settimeout(None)
    sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
    runner = LocalRunner(args, params=params, seed=seed, group=group)
    try:
        while True:
            desc = _recv_msg(sock)
            if desc is None or desc["op"] == "stop":
                return runner
            op = desc["op"]
            if op == "start":
                runner.start()
                continue
            if op == "zero_counts":
                if on_zero is not None:
                    on_zero(runner)
                runner.zero_counts()
                continue
            if op not in MIRRORED:
                raise RuntimeError(f"unknown dispatch op {op!r}")
            a, kw = _decode(desc["a"], runner), _decode(desc["kw"], runner)
            if op == "extract_pages":
                # The gather is the collective; its host copy is the leader's.
                op = "start_extract_pages"
            for name, value in desc.get("spec", {}).items():
                setattr(runner.args, name, value)
            runner._rid = desc["rid"]
            before = read_counts()
            out = getattr(runner, op)(*a, **kw)
            if op.startswith("warm_"):
                # The leader's worker zeroes its launch counts after the
                # captures; their replays on inert inputs count here neither.
                set_counts(before)
            if isinstance(out, torch.Tensor):
                runner._new_ref((out,), desc["rid"])
    finally:
        sock.close()
