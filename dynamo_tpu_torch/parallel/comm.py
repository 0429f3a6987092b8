"""The collectives of a sharded forward, over ``torch.distributed``.

The JAX package gets its collectives from XLA, which derives them from the
shardings, and its neighbour exchanges from ``lax.ppermute``; here the
callers make them (engine/model.py, ops/pipeline.py, ops/ring_attention.py):
``all_reduce_`` (a sum, in place) after each row-split product,
``all_gather`` for the vocabulary-split logits and the KV lanes, and
``ppermute_start`` for a ring's exchange (send to the next rank, receive
from the previous one).

Each collective runs over one axis of the JAX mesh (``dynamo_tpu/parallel/
mesh.py``), whose ranks ``(ep, tp_kv, tp_rep)`` lie row-major:

- "tp": the rank's tensor-parallel block, its ``tp_kv × tp_rep`` ranks
  within one ep index (attention, the dense MLP, the vocabulary splits);
- "ep_tp": all ``ep × tp`` ranks (the MoE combine);
- "ring": all ranks in rank order (the ``pp`` and ``sp`` axes of the
  pipeline and ring attention).

With ep = 1 the three are the one world group. An axis of one rank makes
no collective.

The backend follows from the devices and from nothing else:

- NCCL when every rank has a card of its own (tp ranks, at least tp cards
  visible on the host; rank r takes card r mod the cards);
- gloo when ranks share a card or run on the CPU. gloo runs on host
  memory: a CUDA tensor goes to the host, through the collective and back,
  so a gloo collective waits for the card, and a CUDA graph cannot capture
  it.

A failed collective raises; nothing switches backends.
"""

from __future__ import annotations

import datetime
import time

import torch
import torch.distributed as dist

# How long a rank waits for the others to meet, or for a collective: a
# follower loading a large checkpoint arrives minutes after its leader.
TIMEOUT_S = 600.0


def choose_backend(device: torch.device, tp: int) -> str:
    """"nccl" when ``device`` is a card and every one of the ``tp`` ranks has
    a card of its own, else "gloo"."""
    if device.type == "cuda" and torch.cuda.device_count() >= tp:
        return "nccl"
    return "gloo"


def rank_device(device: str, rank: int) -> torch.device:
    """The device of ``rank``: on CUDA card ``rank`` mod the visible cards
    (made the current one, so that ``"cuda"`` names it), else the CPU."""
    dev = torch.device(device)
    if dev.type != "cuda":
        return dev
    card = rank % torch.cuda.device_count()
    torch.cuda.set_device(card)
    return torch.device("cuda", card)


class TpGroup:
    """One rank's membership of a group of ``size`` ranks meeting at
    ``coordinator`` (host:port, served by rank 0): ``ep`` expert-parallel
    blocks of ``size // ep`` tensor-parallel ranks, with a process group
    for each mesh axis (module docstring). Counts its collectives, the
    bytes each rank put in and the host seconds they took."""

    def __init__(self, rank: int, size: int, coordinator: str, device: str | torch.device,
                 ep: int = 1):
        if ep < 1 or size % ep:
            raise ValueError(f"{size} ranks do not split into ep={ep} blocks")
        self.rank, self.size, self.ep, self.tp = rank, size, ep, size // ep
        self.device = torch.device(device)
        self.backend = choose_backend(self.device, size)
        dist.init_process_group(
            self.backend, init_method=f"tcp://{coordinator}", world_size=size, rank=rank,
            timeout=datetime.timedelta(seconds=TIMEOUT_S))
        # Every rank creates every sub-group, in the same order, as
        # torch.distributed requires; None is the world group.
        blocks = [list(range(e * self.tp, (e + 1) * self.tp)) for e in range(ep)]
        tp_groups = [dist.new_group(b) for b in blocks] if ep > 1 else [None]
        world = list(range(size))
        # axis → (process group, its ranks in ring order)
        self._axes = {"tp": (tp_groups[rank // self.tp], blocks[rank // self.tp]),
                      "ep_tp": (None, world), "ring": (None, world)}
        # Host staging: gloo reduces and sends host memory.
        self._stage = self.backend == "gloo" and self.device.type == "cuda"
        self.calls = {"all_reduce": 0, "all_gather": 0, "ppermute": 0}
        self.bytes = 0
        self.host_s = 0.0

    def describe(self) -> str:
        where = "one card per rank" if self.backend == "nccl" else (
            "ranks share a card" if self.device.type == "cuda" else "CPU ranks")
        grid = f"tp {self.tp}" if self.ep == 1 else f"ep {self.ep} x tp {self.tp}"
        return f"{grid} over {self.backend} ({where})"

    def axis_size(self, axis: str = "tp") -> int:
        return len(self._axes[axis][1])

    def axis_rank(self, axis: str = "tp") -> int:
        """This rank's place on ``axis`` (its index in the axis's ring)."""
        return self._axes[axis][1].index(self.rank)

    def all_reduce_(self, x: torch.Tensor, axis: str = "tp") -> torch.Tensor:
        """Sum ``x`` over the ranks of ``axis``, in place → x."""
        group, ranks = self._axes[axis]
        if len(ranks) == 1:
            return x
        t0 = time.perf_counter()
        if self._stage:
            h = x.cpu()
            dist.all_reduce(h, group=group)
            x.copy_(h)
        else:
            dist.all_reduce(x, group=group)
        self._count("all_reduce", x, t0)
        return x

    def all_gather(self, x: torch.Tensor, axis: str = "tp", dim: int = -1) -> torch.Tensor:
        """Every rank's ``x`` on ``axis`` concatenated in rank order along
        ``dim``. int16 (bf16 pages viewed for the host) travels as float16
        bits: neither backend has an int16 type, and a gather only copies."""
        group, ranks = self._axes[axis]
        if len(ranks) == 1:
            return x
        t0 = time.perf_counter()
        src = x.cpu() if self._stage else x.contiguous()
        if src.dtype == torch.int16:
            src = src.view(torch.float16)
        parts = [torch.empty_like(src) for _ in ranks]
        dist.all_gather(parts, src, group=group)
        out = torch.cat(parts, dim=dim).view(x.dtype)
        if self._stage:
            out = out.to(x.device)
        self._count("all_gather", x, t0)
        return out

    def ppermute_start(self, xs: list[torch.Tensor]) -> "Exchange":
        """Start ``lax.ppermute`` with ``perm = [(i, (i + 1) % n)]`` on the
        n ranks of the "ring" axis: each tensor of ``xs`` goes to the next rank,
        and as many of the same shapes come from the previous one. Under
        NCCL one ``batch_isend_irecv``; under gloo an ``isend``/``irecv``
        pair a tensor (tagged by its place in ``xs``), from host copies of
        CUDA tensors. → an ``Exchange``, whose ``wait()`` gives the received
        tensors: the caller's work between the two overlaps the transfer."""
        group, ranks = self._axes["ring"]
        n = len(ranks)
        if n == 1:
            return Exchange(self, [], [], list(xs), 0, 0.0)
        t0 = time.perf_counter()
        me = ranks.index(self.rank)
        nxt, prv = ranks[(me + 1) % n], ranks[(me - 1) % n]
        srcs = [x.cpu() if self._stage else x.contiguous() for x in xs]
        bufs = [torch.empty_like(s) for s in srcs]
        if self.backend == "nccl":
            works = dist.batch_isend_irecv(
                [dist.P2POp(dist.isend, s, nxt, group) for s in srcs]
                + [dist.P2POp(dist.irecv, b, prv, group) for b in bufs])
        else:
            works = ([dist.isend(s, nxt, group=group, tag=i) for i, s in enumerate(srcs)]
                     + [dist.irecv(b, prv, group=group, tag=i) for i, b in enumerate(bufs)])
        nbytes = sum(x.numel() * x.element_size() for x in xs)
        return Exchange(self, works, srcs, bufs, nbytes, time.perf_counter() - t0)

    def _count(self, op: str, x: torch.Tensor, t0: float) -> None:
        self.calls[op] += 1
        self.bytes += x.numel() * x.element_size()
        self.host_s += time.perf_counter() - t0

    def counters(self) -> dict:
        return {"backend": self.backend, "tp": self.tp, "ep": self.ep, "rank": self.rank,
                "calls": dict(self.calls), "bytes": self.bytes,
                "host_s": round(self.host_s, 6)}

    def close(self) -> None:
        if dist.is_initialized():
            dist.destroy_process_group()


class Exchange:
    """A neighbour exchange in flight (``TpGroup.ppermute_start``)."""

    def __init__(self, group: TpGroup, works: list, srcs: list, bufs: list, nbytes: int,
                 host_s: float):
        # The sent tensors are held until the wait: a send reads them until then.
        self.group, self.works, self.srcs, self.bufs = group, works, srcs, bufs
        self.nbytes, self.host_s = nbytes, host_s

    def wait(self) -> list[torch.Tensor]:
        """The tensors received from the previous rank, on this rank's
        device. Under NCCL the wait orders the current stream after the
        transfer and returns at once; under gloo it blocks the host until
        the bytes are in. Counted as one ``ppermute`` call."""
        if not self.works:
            return self.bufs
        g = self.group
        t0 = time.perf_counter()
        for w in self.works:
            w.wait()
        out = [b.to(g.device) for b in self.bufs] if g._stage else self.bufs
        g.calls["ppermute"] += 1
        g.bytes += self.nbytes
        g.host_s += self.host_s + time.perf_counter() - t0
        return out
