"""Token sequences and chained block hashing (port of ``dynamo_tpu/tokens.py``).

The unit of KV-cache identity is the token block: a fixed-size run of
token ids whose hash chains in the parent block's hash. Hashes are
XXH3-64 over little-endian u32 token ids; a block's sequence hash is
XXH3-64 over (parent_seq_hash_le64 || block_local_hash_le64), seeded with
the framework constant, exactly as in the JAX package, so block hashes
are the framework's whichever package computed them.

The JAX package calls the ``xxhash`` module, which the machines this port
targets do not carry; ``xxh3_64`` below is XXH3-64 (xxHash 0.8) written in
pure Python with ``struct`` only, held bit-exact against
``xxhash.xxh3_64_intdigest`` by the tests.
"""

from __future__ import annotations

import struct
from dataclasses import dataclass
from typing import Iterable, Sequence

HASH_SEED = 0xD7A0_0001

BlockHash = int
SequenceHash = int

# ---------------------------------------------------------------------------
# XXH3-64
# ---------------------------------------------------------------------------

_M64 = (1 << 64) - 1
_P32_1 = 0x9E3779B1
_P32_2 = 0x85EBCA77
_P32_3 = 0xC2B2AE3D
_P64_1 = 0x9E3779B185EBCA87
_P64_2 = 0xC2B2AE3D27D4EB4F
_P64_3 = 0x165667B19E3779F9
_P64_4 = 0x85EBCA77C2B2AE63
_P64_5 = 0x27D4EB2F165667C5
_PMX_1 = 0x165667919E3779F9
_PMX_2 = 0x9FB21C651E98DF25

_SECRET = bytes.fromhex(
    "b8fe6c3923a44bbe7c01812cf721ad1cded46de9839097db7240a4a4b7b3671f"
    "cb79e64eccc0e578825ad07dccff7221b8084674f743248ee03590e6813a264c"
    "3c2852bb91c300cb88d0658b1b532ea371644897a20df94e3819ef46a9deacd8"
    "a8fa763fe39c343ff9dcbbc7c70b4f1d8a51e04bcdb45931c89f7ec9d9787364"
    "eac5ac8334d3ebc3c581a0fffa1363eb170ddd51b7f0da49d316552629d4689e"
    "2b16be587d47a1fc8ff8b8d17ad031ce45cb3a8f95160428afd7fbcabb4b407e"
)
_STRIPE = 64
_ACC_NB = 8


def _u64(b: bytes, off: int) -> int:
    return struct.unpack_from("<Q", b, off)[0]


def _u32(b: bytes, off: int) -> int:
    return struct.unpack_from("<I", b, off)[0]


def _mul128_fold64(a: int, b: int) -> int:
    p = a * b
    return (p ^ (p >> 64)) & _M64


def _avalanche(h: int) -> int:
    h ^= h >> 37
    h = (h * _PMX_1) & _M64
    return h ^ (h >> 32)


def _xxh64_avalanche(h: int) -> int:
    h ^= h >> 33
    h = (h * _P64_2) & _M64
    h ^= h >> 29
    h = (h * _P64_3) & _M64
    return h ^ (h >> 32)


def _rotl64(x: int, r: int) -> int:
    return ((x << r) | (x >> (64 - r))) & _M64


def _rrmxmx(h: int, n: int) -> int:
    h ^= _rotl64(h, 49) ^ _rotl64(h, 24)
    h = (h * _PMX_2) & _M64
    h ^= ((h >> 35) + n) & _M64
    h = (h * _PMX_2) & _M64
    return h ^ (h >> 28)


def _mix16(data: bytes, off: int, sec: bytes, soff: int, seed: int) -> int:
    lo = _u64(data, off) ^ ((_u64(sec, soff) + seed) & _M64)
    hi = _u64(data, off + 8) ^ ((_u64(sec, soff + 8) - seed) & _M64)
    return _mul128_fold64(lo, hi)


def _len_0to16(data: bytes, n: int, seed: int) -> int:
    s = _SECRET
    if n > 8:
        bf1 = ((_u64(s, 24) ^ _u64(s, 32)) + seed) & _M64
        bf2 = ((_u64(s, 40) ^ _u64(s, 48)) - seed) & _M64
        lo = _u64(data, 0) ^ bf1
        hi = _u64(data, n - 8) ^ bf2
        swapped = int.from_bytes(lo.to_bytes(8, "little"), "big")
        acc = (n + swapped + hi + _mul128_fold64(lo, hi)) & _M64
        return _avalanche(acc)
    if n >= 4:
        seed ^= int.from_bytes((seed & 0xFFFFFFFF).to_bytes(4, "little"), "big") << 32
        in1 = _u32(data, 0)
        in2 = _u32(data, n - 4)
        bitflip = ((_u64(s, 8) ^ _u64(s, 16)) - seed) & _M64
        return _rrmxmx(((in2 + (in1 << 32)) & _M64) ^ bitflip, n)
    if n > 0:
        combined = (data[0] << 16) | (data[n >> 1] << 24) | data[n - 1] | (n << 8)
        bitflip = ((_u32(s, 0) ^ _u32(s, 4)) + seed) & _M64
        return _xxh64_avalanche(combined ^ bitflip)
    return _xxh64_avalanche(seed ^ _u64(s, 56) ^ _u64(s, 64))


def _len_17to128(data: bytes, n: int, seed: int) -> int:
    s = _SECRET
    acc = (n * _P64_1) & _M64
    if n > 32:
        if n > 64:
            if n > 96:
                acc += _mix16(data, 48, s, 96, seed) + _mix16(data, n - 64, s, 112, seed)
            acc += _mix16(data, 32, s, 64, seed) + _mix16(data, n - 48, s, 80, seed)
        acc += _mix16(data, 16, s, 32, seed) + _mix16(data, n - 32, s, 48, seed)
    acc += _mix16(data, 0, s, 0, seed) + _mix16(data, n - 16, s, 16, seed)
    return _avalanche(acc & _M64)


def _len_129to240(data: bytes, n: int, seed: int) -> int:
    s = _SECRET
    acc = (n * _P64_1) & _M64
    for i in range(8):
        acc += _mix16(data, 16 * i, s, 16 * i, seed)
    acc = _avalanche(acc & _M64)
    for i in range(8, n // 16):
        acc += _mix16(data, 16 * i, s, 16 * (i - 8) + 3, seed)
    acc += _mix16(data, n - 16, s, 136 - 17, seed)
    return _avalanche(acc & _M64)


def _accumulate_512(acc: list[int], data: bytes, off: int, sec: bytes, soff: int) -> None:
    for i in range(_ACC_NB):
        val = _u64(data, off + 8 * i)
        key = val ^ _u64(sec, soff + 8 * i)
        acc[i ^ 1] = (acc[i ^ 1] + val) & _M64
        acc[i] = (acc[i] + (key & 0xFFFFFFFF) * (key >> 32)) & _M64


def _scramble(acc: list[int], sec: bytes, soff: int) -> None:
    for i in range(_ACC_NB):
        a = acc[i]
        a ^= a >> 47
        a ^= _u64(sec, soff + 8 * i)
        acc[i] = (a * _P32_1) & _M64


def _hash_long(data: bytes, n: int, sec: bytes) -> int:
    acc = [_P32_3, _P64_1, _P64_2, _P64_3, _P64_4, _P32_2, _P64_5, _P32_1]
    stripes_per_block = (len(sec) - _STRIPE) // 8
    block_len = _STRIPE * stripes_per_block
    nb_blocks = (n - 1) // block_len
    for blk in range(nb_blocks):
        for st in range(stripes_per_block):
            _accumulate_512(acc, data, blk * block_len + st * _STRIPE, sec, st * 8)
        _scramble(acc, sec, len(sec) - _STRIPE)
    nb_stripes = ((n - 1) - block_len * nb_blocks) // _STRIPE
    for st in range(nb_stripes):
        _accumulate_512(acc, data, nb_blocks * block_len + st * _STRIPE, sec, st * 8)
    _accumulate_512(acc, data, n - _STRIPE, sec, len(sec) - _STRIPE - 7)
    result = (n * _P64_1) & _M64
    for i in range(4):
        result += _mul128_fold64(acc[2 * i] ^ _u64(sec, 11 + 16 * i),
                                 acc[2 * i + 1] ^ _u64(sec, 11 + 16 * i + 8))
    return _avalanche(result & _M64)


def _custom_secret(seed: int) -> bytes:
    out = bytearray(len(_SECRET))
    for i in range(0, len(_SECRET), 16):
        struct.pack_into("<QQ", out, i,
                         (_u64(_SECRET, i) + seed) & _M64,
                         (_u64(_SECRET, i + 8) - seed) & _M64)
    return bytes(out)


def xxh3_64(data: bytes, seed: int = 0) -> int:
    """XXH3-64 of ``data`` with a 64-bit ``seed`` (bit-exact with
    ``xxhash.xxh3_64_intdigest(data, seed=seed)``)."""
    n = len(data)
    seed &= _M64
    if n <= 16:
        return _len_0to16(data, n, seed)
    if n <= 128:
        return _len_17to128(data, n, seed)
    if n <= 240:
        return _len_129to240(data, n, seed)
    return _hash_long(data, n, _SECRET if seed == 0 else _custom_secret(seed))


# ---------------------------------------------------------------------------
# Block hashing
# ---------------------------------------------------------------------------


def adapter_hash_seed(adapter_id: str | None, seed: int = HASH_SEED) -> int:
    """Hash seed for one (base model, LoRA adapter) identity domain: a
    prompt prefilled under an adapter has other K/V than the base model, so
    its blocks hash under a salted seed and never prefix-hit a base or
    other-adapter request. Router and workers derive the same seed from the
    same adapter id."""
    if adapter_id is None:
        return seed
    return xxh3_64(b"adapter:" + adapter_id.encode(), seed)


def hash_tokens(tokens: Sequence[int], seed: int = HASH_SEED) -> BlockHash:
    """Block-local hash: XXH3-64 over little-endian u32 token ids."""
    return xxh3_64(struct.pack(f"<{len(tokens)}I", *tokens), seed)


def chain_hash(parent: SequenceHash | None, local: BlockHash, seed: int = HASH_SEED) -> SequenceHash:
    """Sequence hash of a block given its parent's sequence hash."""
    if parent is None:
        return local
    return xxh3_64(struct.pack("<QQ", parent, local), seed)


def compute_block_hashes(
    tokens: Sequence[int], block_size: int, seed: int = HASH_SEED
) -> list[SequenceHash]:
    """Chained sequence hashes for every complete block of ``tokens``."""
    out: list[SequenceHash] = []
    parent: SequenceHash | None = None
    for start in range(0, len(tokens) - block_size + 1, block_size):
        local = hash_tokens(tokens[start : start + block_size], seed)
        parent = chain_hash(parent, local, seed)
        out.append(parent)
    return out


@dataclass(frozen=True)
class TokenBlock:
    """An immutable, complete block of tokens with its chained identity."""

    tokens: tuple[int, ...]
    block_hash: BlockHash
    sequence_hash: SequenceHash
    parent_sequence_hash: SequenceHash | None


class TokenBlockSequence:
    """Splits a growing token stream into complete blocks plus a partial tail."""

    def __init__(self, tokens: Iterable[int] = (), block_size: int = 16, seed: int = HASH_SEED):
        if block_size <= 0:
            raise ValueError("block_size must be positive")
        self.block_size = block_size
        self.seed = seed
        self.blocks: list[TokenBlock] = []
        self._partial: list[int] = []
        self.extend(tokens)

    def append(self, token: int) -> TokenBlock | None:
        """Add one token; returns the newly completed block if one closed."""
        self._partial.append(int(token))
        if len(self._partial) < self.block_size:
            return None
        return self._seal()

    def extend(self, tokens: Iterable[int]) -> list[TokenBlock]:
        completed = []
        for t in tokens:
            b = self.append(t)
            if b is not None:
                completed.append(b)
        return completed

    def _seal(self) -> TokenBlock:
        toks = tuple(self._partial)
        self._partial.clear()
        local = hash_tokens(toks, self.seed)
        parent = self.blocks[-1].sequence_hash if self.blocks else None
        block = TokenBlock(toks, local, chain_hash(parent, local, self.seed), parent)
        self.blocks.append(block)
        return block

    @property
    def total_tokens(self) -> int:
        return len(self.blocks) * self.block_size + len(self._partial)
