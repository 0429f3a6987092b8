"""The collectives of a tensor-parallel forward, over ``torch.distributed``.

The JAX package gets its collectives from XLA, which derives them from the
shardings; here the forward calls them (engine/model.py): ``all_reduce_``
(a sum, in place) after each row-split product, and ``all_gather`` along
the last axis for the vocabulary-split logits and the KV lanes.

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
    """One rank's membership of a tensor-parallel group: ``size`` ranks
    meeting at ``coordinator`` (host:port, served by rank 0). Counts its
    collectives, the bytes each rank put in and the host seconds they
    took."""

    def __init__(self, rank: int, size: int, coordinator: str, device: str | torch.device):
        self.rank, self.size = rank, size
        self.device = torch.device(device)
        self.backend = choose_backend(self.device, size)
        dist.init_process_group(
            self.backend, init_method=f"tcp://{coordinator}", world_size=size, rank=rank,
            timeout=datetime.timedelta(seconds=TIMEOUT_S))
        # Host staging: gloo reduces host memory.
        self._stage = self.backend == "gloo" and self.device.type == "cuda"
        self.calls = {"all_reduce": 0, "all_gather": 0}
        self.bytes = 0
        self.host_s = 0.0

    def describe(self) -> str:
        where = "one card per rank" if self.backend == "nccl" else (
            "ranks share a card" if self.device.type == "cuda" else "CPU ranks")
        return f"tp {self.size} over {self.backend} ({where})"

    def all_reduce_(self, x: torch.Tensor) -> torch.Tensor:
        """Sum ``x`` over the ranks, in place → x."""
        t0 = time.perf_counter()
        if self._stage:
            h = x.cpu()
            dist.all_reduce(h)
            x.copy_(h)
        else:
            dist.all_reduce(x)
        self._count("all_reduce", x, t0)
        return x

    def all_gather(self, x: torch.Tensor) -> torch.Tensor:
        """Every rank's ``x`` concatenated in rank order along the last axis.
        int16 (bf16 pages viewed for the host) travels as float16 bits:
        neither backend has an int16 type, and a gather only copies."""
        t0 = time.perf_counter()
        src = x.cpu() if self._stage else x.contiguous()
        if src.dtype == torch.int16:
            src = src.view(torch.float16)
        parts = [torch.empty_like(src) for _ in range(self.size)]
        dist.all_gather(parts, src)
        out = torch.cat(parts, dim=-1).view(x.dtype)
        if self._stage:
            out = out.to(x.device)
        self._count("all_gather", x, t0)
        return out

    def _count(self, op: str, x: torch.Tensor, t0: float) -> None:
        self.calls[op] += 1
        self.bytes += x.numel() * x.element_size()
        self.host_s += time.perf_counter() - t0

    def counters(self) -> dict:
        return {"backend": self.backend, "tp": self.size, "rank": self.rank,
                "calls": dict(self.calls), "bytes": self.bytes,
                "host_s": round(self.host_s, 6)}

    def close(self) -> None:
        if dist.is_initialized():
            dist.destroy_process_group()
