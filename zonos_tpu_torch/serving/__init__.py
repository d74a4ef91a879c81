"""Serving: continuous batching and a REST front end (the port of
zonos_tpu/serving/): a scheduler that merges concurrent requests into
bucketed device batches, and a dependency-free HTTP API over it.

Run: ``python -m zonos_tpu_torch.serving [--device cuda] [--port 8600]``.
"""

from zonos_tpu_torch.serving.batching import (
    BatchKey,
    ContinuousBatcher,
    PendingResult,
    StreamHandle,
    StreamRequest,
    TTSRequest,
    build_batch_prefix,
)
from zonos_tpu_torch.serving.server import ServerState, serve, wav_bytes

__all__ = [
    "BatchKey",
    "ContinuousBatcher",
    "PendingResult",
    "StreamHandle",
    "StreamRequest",
    "TTSRequest",
    "build_batch_prefix",
    "ServerState",
    "serve",
    "wav_bytes",
]
