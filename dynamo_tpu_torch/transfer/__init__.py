"""Streaming KV data plane: chunked, flow-controlled movement of paged
KV-cache blocks between workers (the TPU-native NIXL analogue).

See :mod:`dynamo_tpu_torch.transfer.stream` for the protocol and
``docs/disagg.md`` for the end-to-end flow.
"""

from dynamo_tpu_torch.transfer.stream import (
    KvChunk,
    KvChunkAssembler,
    KvStreamExport,
    PulledKvStream,
    TransferAbortedError,
    TransferError,
    TransferTimeoutError,
    chunk_to_frames,
    inject_payload_from_chunks,
    pull_kv_stream,
    read_kv_payload_frames,
    serve_kv_window,
)

__all__ = [
    "KvChunk",
    "KvChunkAssembler",
    "KvStreamExport",
    "PulledKvStream",
    "TransferAbortedError",
    "TransferError",
    "TransferTimeoutError",
    "chunk_to_frames",
    "inject_payload_from_chunks",
    "pull_kv_stream",
    "read_kv_payload_frames",
    "serve_kv_window",
]
