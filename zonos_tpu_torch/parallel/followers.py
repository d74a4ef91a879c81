"""Serving a sharded model: the leader's announcements and the followers'
loop.

Every rank of a mesh must make the same calls (``models/tts.py``), but
requests reach rank 0 only.  So before each ``generate``, each
``stream_generate_batch`` chunk and each stream's close, rank 0's
``ContinuousBatcher`` broadcasts the call over the world
(:func:`announce`), and every other rank runs :func:`follow`, which makes
the same call on its shard until the batcher's ``close`` sends a stop.

**A call that raises on any rank** may leave the others inside one of the
call's collectives, which that rank will never join: its next collective
would pair with theirs, and the world would hang or pass wrong objects.
So that rank leaves the world (:func:`abort_world`): the others' pending
collectives then raise instead ("connection closed by peer" over gloo),
their calls fail, and they leave it too.  The leader reports the error to
the requests of that call, and every later call of the model raises
(:func:`announce`); the followers' ``follow`` raises.  A sharded server
is restarted after such a failure.
"""

from __future__ import annotations

import contextlib
import logging

import torch
import torch.distributed as dist

log = logging.getLogger(__name__)


def _sharded(model) -> bool:
    mesh = getattr(model, "mesh", None)
    return mesh is not None and mesh.size() > 1


def abort_world() -> None:
    """Leave the world of processes (every group of this process), so that
    the other ranks' collectives with this one raise instead of waiting."""
    if dist.is_initialized():
        dist.destroy_process_group()


def announce(model, kind: str, sid: int | None = None, kwargs: dict | None = None) -> None:
    """Broadcast a call from rank 0 to the followers (a no-op for a model on
    one process and on the followers): ``kind`` is ``"generate"``
    (``kwargs``), ``"stream"`` (stream ``sid`` opened with ``kwargs``),
    ``"next"`` or ``"close"`` (of stream ``sid``) or ``"stop"``.  Tensors
    travel on the host; the followers move them to their own devices.
    Raises where a failed call has taken the world down (a ``"close"`` or
    ``"stop"`` then has no one to reach, and is dropped)."""
    if not _sharded(model):
        return
    if not dist.is_initialized():
        if kind in ("close", "stop"):
            return
        raise RuntimeError("a call of this sharded model failed and took its world of "
                           "processes down (parallel/followers.py): restart the server")
    if dist.get_rank() == 0:
        if kwargs is not None:
            kwargs = {k: v.cpu() if isinstance(v, torch.Tensor) else v for k, v in kwargs.items()}
        dist.broadcast_object_list([(kind, sid, kwargs)], src=0)


@contextlib.contextmanager
def leading(model):
    """Around the leader's half of an announced call: where it raises on a
    sharded model, the world is aborted before the error goes on."""
    try:
        yield
    except BaseException:
        if _sharded(model):
            log.error("a sharded call failed on the leader: leaving the world")
            abort_world()
        raise


def follow(model) -> None:
    """On a rank above 0: run the calls rank 0 announces on ``model``'s
    shard, until it sends ``"stop"``.  A call, or an announcement, that
    raises here aborts the world and raises on (module docstring)."""
    streams: dict = {}
    rank = dist.get_rank()
    try:
        while True:
            box = [None]
            dist.broadcast_object_list(box, src=0)
            kind, sid, kwargs = box[0]
            if kind == "stop":
                for gen in streams.values():
                    gen.close()
                return
            if kind == "generate":
                model.generate(**kwargs)
            elif kind == "stream":
                streams[sid] = model.stream_generate_batch(**kwargs)
            elif kind == "next":
                next(streams[sid], None)
            elif kind == "close":
                streams.pop(sid).close()
            else:
                raise ValueError(f"unknown call {kind!r}")
    except BaseException:
        log.exception("a followed call failed on rank %d: leaving the world", rank)
        abort_world()
        raise
