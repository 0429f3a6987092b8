"""LocalRunner: every device dispatch the engine makes, behind one seam
(port of ``dynamo_tpu/engine/runner.py`` ``LocalRunner``).

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
  words. Prefill, admission sampling and embeddings run eagerly, as the
  JAX package dispatches them separately too.
- Multi-LoRA: with ``lora_slots`` > 0 the adapter bank (``lora_bank``,
  engine/lora.py ``bank_shapes``, in the compute dtype) is allocated once
  and written in place by ``upload_adapter``, so captured graphs read what
  was uploaded. A dispatch with adapter rows carries their bank slots
  (``adapter_slots``, -1 = base) in its packed upload and replays the LoRA
  variant of its shape; one without passes None and replays the pre-LoRA
  graph, as the JAX runner's ``_lora_operands`` gives the pre-LoRA trace.

Thread affinity: the engine's scheduler thread only.
"""

from __future__ import annotations

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
from dynamo_tpu_torch.engine.graphs import COUNTERS, WindowGraphs, read_counts
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


class LocalRunner:
    """``params``: a tree of tensors on the device, a tree of numpy arrays
    (moved there by ``params_from_numpy``; with ``quant="int8"`` float ones
    are quantized on the host first), or None (random weights made on the
    device, int8 ones with ``quant="int8"``)."""

    def __init__(self, args: EngineArgs, params: Any | None = None, seed: int = 0):
        self.args = args
        self.cfg = args.model
        self._seed = seed
        self.params = params
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
        # Verify passes dispatched, the forwards over all layers they made
        # (1 fused, S1 stepwise) and the kernel-wrapper calls they made, per
        # graphs.COUNTERS entry (attention, int8 kernel, int8 prefill route,
        # int8 tied head); ``tree_verify_calls`` the same for tree passes
        # alone.
        self.verify_passes = 0
        self.verify_forwards = 0
        self.verify_calls = (0,) * len(COUNTERS)
        self.tree_verify_calls = (0,) * len(COUNTERS)
        # Multi-LoRA adapter bank {qa..ob: [L, lora_slots, ...]} on the
        # device, allocated once at start (None when lora_slots is 0): the
        # captured graphs hold its addresses, so uploads write in place.
        self.lora_bank: dict[str, torch.Tensor] | None = None
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
                                                    self.dtype)
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
            self.params = M.init_params(self.cfg, self.device, self.dtype, self._seed)
        elif on_host:
            self.params = params_from_numpy(self.params, self.device, self.dtype)
        self.cache = M.init_kv_cache(
            self.cfg, self.args.num_kv_blocks, self.args.block_size, self.dtype,
            self.device, kv_quant=self.args.kv_quant,
        )
        self.last_toks = torch.zeros((self.args.max_num_seqs + 1,), dtype=torch.int32,
                                      device=self.device)
        if self.args.lora_slots > 0:
            # Zeros: a slot is garbage until its first upload, and the engine
            # never dispatches a row pointing at a slot it has not uploaded.
            self.lora_bank = {
                k: torch.zeros(shape, dtype=self.dtype, device=self.device)
                for k, shape in bank_shapes(self.cfg, self.args.lora_slots,
                                            self.args.lora_rank).items()
            }
        if self.device.type == "cuda":
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
        copy has run."""
        if self.lora_bank is None:
            raise ValueError("upload_adapter on a runner without an adapter bank "
                             "(lora_slots == 0)")
        t0 = time.perf_counter()
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

    def prefill_batch(self, toks, tables, starts, tlens, adapter_slots=None) -> torch.Tensor:
        """→ last-token logits [Bp, V] (device)."""
        bank, aslots = self._lora_operands(
            None if adapter_slots is None else self._t(adapter_slots, torch.int32))
        return M.prefill_batch(
            self.cfg, self.params, self.cache, self._t(toks, torch.int32),
            self._t(tables, torch.int32), self._t(starts, torch.int32),
            self._t(tlens, torch.int32), bank, aslots,
        )

    def prefill_chunk(self, toks, table, pos: int, tlen: int,
                      adapter_slot: int | None = None) -> torch.Tensor:
        """Positions [pos, tlen) of one sequence → last-token logits [V]
        (device), dispatched without waiting for the device. A row with an
        adapter passes its bank slot (the JAX ``prefill_chunk``'s scalar
        slot); None or -1 runs the pre-LoRA forward."""
        T, W = len(toks), len(table)
        lora = adapter_slot is not None and adapter_slot >= 0
        lay = Layout(("toks", (1, T), "i"), ("table", (1, W), "i"),
                     ("pos", (1,), "i"), ("tlen", (1,), "i"), *_aslots(1, lora))
        arrays = dict(toks=toks, table=table, pos=pos, tlen=tlen)
        if lora:
            arrays["aslots"] = adapter_slot
        a = lay.unpack(self.upload(lay.pack(**arrays)))
        bank, aslots = self._lora_operands(a.get("aslots"))
        return M.prefill_batch(self.cfg, self.params, self.cache, a["toks"], a["table"],
                               a["pos"], a["tlen"], bank, aslots)[0]

    def decode_step(self, tokens, positions, tables, active, adapter_slots=None) -> torch.Tensor:
        """→ logits [B, V] (device)."""
        bank, aslots = self._lora_operands(
            None if adapter_slots is None else self._t(adapter_slots, torch.int32))
        return M.decode_step(
            self.cfg, self.params, self.cache, self._t(tokens, torch.int32),
            self._t(positions, torch.int32), self._t(tables, torch.int32),
            self._t(active, torch.bool), self.attn_impl, bank, aslots,
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
                attn_impl=self.attn_impl,
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
        return kv_transfer.extract_pages(self.cache, block_ids)

    def start_extract_pages(self, block_ids: list[int]) -> tuple:
        """Enqueue a page gather without waiting → (device tensors, n). The
        streaming KV exporter starts their device→host copy
        (start_host_fetch) and harvests it with ``finish_extract_pages``
        once ready, so page copies overlap the remaining prefill chunks."""
        return kv_transfer.start_extract(self.cache, block_ids)

    @staticmethod
    def finish_extract_pages(fetch: HostFetch, n: int) -> tuple:
        return kv_transfer.finish_extract(fetch.wait(), n)

    def inject_pages(self, block_ids: list[int], *pages) -> None:
        """Write host pages into the named blocks, in place: the cache
        tensors keep their addresses, which the captured graphs replay
        against."""
        pages = kv_transfer.adapt_pages(pages, self.cache, self.cfg.num_kv_heads)
        kv_transfer.inject_pages(self.cache, block_ids, *pages)

    def sample_rows(self, logits: list[torch.Tensor], mode: str, temps, tks, tps, pen, freqs,
                    press, seeds, steps, fold_slots=None, top_n: int = 0,
                    masks=None) -> StepRef:
        """Sample one token per row of the stacked ``logits`` ([V] each) in
        sampler ``mode`` → StepRef (tokens [B], logprobs [B], top_vals
        [B, n], top_ids [B, n]). ``masks`` = None or [B, W32] uint32 packed
        grammar bitsets: each row samples from its legal vocabulary, while
        the logprobs stay the raw model's. With ``fold_slots`` the tokens
        also land in ``last_toks``, so the next window chains from them
        without a host sync (async admission)."""
        x = torch.stack(logits)
        B = x.shape[0]
        if fold_slots is None:
            fold_slots = np.full((B,), self.args.max_num_seqs, np.int32)
        lay = sample_layout(B, np.shape(pen)[1], 0 if masks is None else np.shape(masks)[-1])
        arrays = dict(temps=temps, seeds=seeds, steps=steps, top_k=tks, top_p=tps, freq=freqs,
                      pres=press, pen=pen, fold_slots=fold_slots)
        if masks is not None:
            arrays["masks"] = masks
        a = lay.unpack(self.upload(lay.pack(**arrays)))
        return self._new_ref(self._sample(x, mode, top_n, a))

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
                                   bank, aslots)
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

    # -- embeddings ---------------------------------------------------------

    def embed(self, toks, tlen: int) -> torch.Tensor:
        """Mean-pooled final hidden state of ``toks[:tlen]`` (``toks``
        padded) → [D] f32 on the device; eager, one forward."""
        return M.embed(self.cfg, self.params, self._t(toks, torch.int32), int(tlen))
