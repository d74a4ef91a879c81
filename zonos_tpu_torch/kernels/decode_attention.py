"""K1/K2 decode attention (csrc/decode_attention.cu) and its plain versions.

Replaces ``flash_decode_attention_pallas`` and ``decode_attention_pallas``
(zonos_tpu/ops/pallas_kernels.py:147, :58): one query token per row against
a KV cache masked to its first ``length`` rows.  ``length`` is a host int,
so a decode step never reads anything back from the card.

Over a quantized cache (f8 e4m3, or int8 with one fp32 scale per row and kv
head) the current token's k/v are held out in the compute dtype, as in
``decode_attention_split`` (zonos_tpu/ops/attention.py:119): the kernels
attend over cache rows ``[0, pos)`` plus that row, and the caller writes the
row into the cache afterwards.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from zonos_tpu_torch.kernels import launch_counts
from zonos_tpu_torch.kernels._build import check, library, sm_count

BLOCK_S = 256  # the longest cache K2 takes (staged whole); longer ones go to K1
HEAD_DIM = 128  # compiled into the kernel
GROUPS = (1, 2, 4, 8)  # query heads per kv head the kernel is instantiated for

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_SIGNATURES = {
    "zt_flash_decode_attention": [_P, _P, _P, _P] + [_I] * 7 + [_F, _P],
    "zt_decode_attention_single": [_P, _P, _P, _P] + [_I] * 7 + [_F, _P],
    "zt_flash_decode_attention_q": [_I] + [_P] * 8 + [_I] * 7 + [_F, _P],
    "zt_decode_attention_single_q": [_I] + [_P] * 8 + [_I] * 7 + [_F, _P],
    "zt_flash_max_active_clusters": [_I, _I, _I, _I, _P],
}
# quantized cache storage: the kernels' storage code and the launch-count suffix
STORAGE = {torch.float8_e4m3fn: (1, "f8"), torch.int8: (2, "int8")}
MAX_CLUSTER = 8  # CTAs in a thread-block cluster, the portable limit
CHUNK_ROWS = 32  # the fewest cache rows worth a CTA of its own in a cluster
ONE_CTA_ROWS = 64  # up to here one CTA a pair beats a cluster's fixed cost (--sweep)
ROWS_PER_PASS = 16  # cache rows a CTA covers at once (16 lanes a row); chunks are multiples
CTAS_PER_SM = 2  # the grid K2's plan stops splitting at
MAX_FLASH_CLUSTER = 16  # K1's CTAs per cluster, the largest (non-portable) size


def cluster_plan(length: int, bh_kv: int, sms: int = 132) -> tuple[int, int]:
    """K2's launch plan: ``(n, chunk)``, clusters of ``n`` CTAs (1 to 8), one
    per (batch row, kv head), rank ``r`` attending cache rows ``[r * chunk,
    min((r + 1) * chunk, length))``.  Up to ``ONE_CTA_ROWS`` rows one CTA a
    pair (a cluster's barriers and exchange cost more than they save there);
    beyond, one CTA per ``CHUNK_ROWS`` rows, at most 8, halved while the grid
    would pass two CTAs per SM, since one CTA a pair already fills the card
    there.  ``chunk`` is then rounded up to a multiple of 16 rows and ``n``
    cut to the ranks that hold rows.  Batch 1 with CFG at
    256 rows (8 pairs): 8 CTAs of 32 rows; batch 64 with CFG (512 pairs): one
    CTA of 256.  ``length`` 0 (a quantized cache at pos 0, the held-out row
    only): one CTA with no cache rows."""
    n = 1 if length <= ONE_CTA_ROWS else min(MAX_CLUSTER, -(-length // CHUNK_ROWS))
    while n > 1 and bh_kv * n > CTAS_PER_SM * sms:
        n //= 2
    chunk = -(-length // n)
    chunk = -(-chunk // ROWS_PER_PASS) * ROWS_PER_PASS
    return (max(1, -(-length // chunk)) if chunk else 1), chunk


def flash_plan(length: int, bh_kv: int, sms: int = 132) -> tuple[int, int]:
    """K1's launch plan: ``(n, chunk)``, clusters of ``n`` CTAs (1 to 16), one
    per (batch row, kv head), rank ``r`` attending cache rows ``[r * chunk,
    min((r + 1) * chunk, length))`` in stages.  ``n`` doubles while the grid
    stays within one CTA per SM, so that few pairs still fill the card, and
    is cut to one CTA per ``ONE_CTA_ROWS`` rows; ``chunk`` is rounded up to a
    multiple of 16 rows and ``n`` cut to the ranks that hold rows.  Once the
    pairs alone fill the card, one CTA a pair streams all its rows: the
    cluster's barriers cost more than they save there (``chip_smoke.py
    --sweep``).  Batch 1 with CFG (8 pairs) at 2000 rows: 16 CTAs of 128;
    at 512 rows 8 CTAs of 64; batch 64 with CFG (512 pairs): one CTA.
    ``length`` 0 (a quantized cache at pos 0, the held-out row only): one
    CTA with no cache rows."""
    n = 1
    while n < MAX_FLASH_CLUSTER and 2 * n * bh_kv <= sms:
        n *= 2
    n = max(1, min(n, length // ONE_CTA_ROWS))
    chunk = -(-(-(-length // n)) // ROWS_PER_PASS) * ROWS_PER_PASS
    return (max(1, -(-length // chunk)) if chunk else 1), chunk


@functools.lru_cache(maxsize=None)
def attention_scale(head_dim: int) -> float:
    """1/sqrt(D) rounded as an fp32 computation, like the JAX reference."""
    return float(1.0 / torch.sqrt(torch.tensor(float(head_dim), dtype=torch.float32)))


def decode_attention_plain(q: torch.Tensor, k_cache: torch.Tensor, v_cache: torch.Tensor,
                           length: int) -> torch.Tensor:
    """q [B, 1, H, D] vs cache [B, H_kv, S, D], first ``length`` rows valid ->
    [B, 1, H, D].  fp32 scores and softmax; the weights are cast to v's dtype
    before the value product (zonos_tpu/ops/attention.py:173-210)."""
    B, _, H, D = q.shape
    H_kv, S = k_cache.shape[1], k_cache.shape[2]
    G = H // H_kv
    qh = q.transpose(1, 2).reshape(B, H_kv, G, 1, D)
    scores = torch.einsum("bhgqd,bhkd->bhgqk", qh.float(), k_cache.to(q.dtype).float())
    scores = scores * attention_scale(D)
    valid = torch.arange(S, device=q.device) < length
    scores = scores.masked_fill(~valid, float("-inf"))
    weights = torch.softmax(scores, dim=-1)
    out = torch.einsum("bhgqk,bhkd->bhgqd", weights.to(v_cache.dtype), v_cache)
    return out.reshape(B, H, 1, D).transpose(1, 2).to(q.dtype)


def _refusal(q, k, v, k_new=None, v_new=None, k_scale=None, v_scale=None):
    """Why the kernels do not take these operands (by dtype and shape), as
    ``(exception class, message)``, or None if they do.  With ``k_new`` the
    held-out variants: an f8 or int8 cache; without, a bf16 cache."""
    held_out = k_new is not None
    if held_out and (k.dtype not in STORAGE or v.dtype != k.dtype):
        return TypeError, ("quantized decode attention takes an f8 or int8 cache, got "
                           f"{k.dtype}/{v.dtype}")
    if not held_out and not k.dtype == v.dtype == torch.bfloat16:
        return TypeError, f"decode attention kernel takes a bf16 cache, got {k.dtype}/{v.dtype}"
    if q.dtype != torch.bfloat16 or held_out and not k_new.dtype == v_new.dtype == torch.bfloat16:
        return TypeError, f"q and a held-out row must be bf16, got {q.dtype}"
    if q.dim() != 4 or q.shape[1] != 1 or k.dim() != 4 or k.shape != v.shape:
        return ValueError, f"bad shapes q {tuple(q.shape)} k {tuple(k.shape)} v {tuple(v.shape)}"
    B, _, H, D = q.shape
    Bk, H_kv, S, Dk = k.shape
    if Bk != B or Dk != D or D != HEAD_DIM or H % H_kv or H // H_kv not in GROUPS:
        return ValueError, (f"unsupported shapes q {tuple(q.shape)} k {tuple(k.shape)}: the "
                            f"kernels take head_dim {HEAD_DIM} and {GROUPS} query heads per kv "
                            "head")
    if held_out:
        if k_new.shape != (B, 1, H_kv, D) or v_new.shape != k_new.shape:
            return ValueError, f"held-out rows {tuple(k_new.shape)}, expected {(B, 1, H_kv, D)}"
        scaled = k.dtype == torch.int8
        if scaled != (k_scale is not None) or scaled != (v_scale is not None):
            return ValueError, "an int8 cache comes with k_scale and v_scale, an f8 cache without"
        if scaled and any(t.dtype != torch.float32 or t.shape != (B, H_kv, S)
                          for t in (k_scale, v_scale)):
            return ValueError, f"row scales must be fp32 {(B, H_kv, S)}"
    return None


def kernel_takes(q, k_cache, v_cache, k_new=None, v_new=None, k_scale=None,
                 v_scale=None) -> bool:
    """Whether K1/K2 take these operands, by their dtypes and shapes alone:
    bf16 q (and held-out row), a bf16 cache (or, with ``k_new``, an f8 or
    int8 one with its row scales), head_dim 128 and 1, 2, 4 or 8 query heads
    per kv head.  ``ops/attention.py`` runs the plain version where they do
    not."""
    return _refusal(q, k_cache, v_cache, k_new, v_new, k_scale, v_scale) is None


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, length: int) -> tuple:
    if not (k.is_cuda and v.is_cuda) or not (q.device == k.device == v.device):
        raise ValueError("q, k_cache and v_cache must lie on the same CUDA device")
    refusal = _refusal(q, k, v)
    if refusal is not None:
        raise refusal[0](refusal[1])
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise ValueError("decode attention kernel takes contiguous tensors")
    B, _, H, _ = q.shape
    H_kv, S = k.shape[1], k.shape[2]
    if not 1 <= length <= S:
        raise ValueError(f"length {length} outside [1, {S}]")
    return B, H_kv, H // H_kv, S


def flash_decode_attention(q: torch.Tensor, k_cache: torch.Tensor, v_cache: torch.Tensor,
                           length: int) -> torch.Tensor:
    """K1: one thread-block cluster of up to 16 CTAs per (row, kv head)
    (:func:`flash_plan`), each CTA streaming its chunk of the valid rows
    through a ring of stages, the partial softmaxes combined through
    distributed shared memory; one launch, no scratch.  CPU tensors take the
    plain version."""
    length = int(length)
    if not q.is_cuda:
        return decode_attention_plain(q, k_cache, v_cache, length)
    B, H_kv, G, S = _check(q, k_cache, v_cache, length)
    n, chunk = flash_plan(length, B * H_kv, sm_count(q.device.index))
    out = torch.empty_like(q)
    lib = library("decode_attention", _SIGNATURES)
    rc = lib.zt_flash_decode_attention(
        q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(), out.data_ptr(),
        B, H_kv, G, S, length, n, chunk, attention_scale(HEAD_DIM),
        torch.cuda.current_stream(q.device).cuda_stream,
    )
    check(rc, "flash_decode_attention")
    launch_counts["flash_decode_attention"] += 1
    return out


def max_active_clusters(storage: torch.dtype, G: int, n: int, chunk: int) -> int:
    """How many of K1's clusters of ``n`` CTAs of ``chunk`` rows, over a cache
    of ``storage`` (bf16, f8 or int8) with ``G`` query heads a kv head, the
    current card holds at once (``cudaOccupancyMaxActiveClusters``; 0: it
    cannot launch them)."""
    code = 0 if storage == torch.bfloat16 else STORAGE[storage][0]
    clusters = ctypes.c_int(0)
    check(library("decode_attention", _SIGNATURES).zt_flash_max_active_clusters(
        code, G, n, chunk, ctypes.addressof(clusters)), "flash_max_active_clusters")
    return clusters.value


def decode_attention_single(q: torch.Tensor, k_cache: torch.Tensor, v_cache: torch.Tensor,
                            length: int) -> torch.Tensor:
    """K2: one thread-block cluster per (row, kv head) splits the valid rows
    over its CTAs (:func:`cluster_plan`) and combines their partial softmaxes
    through distributed shared memory; one launch, no scratch.  CPU tensors
    take the plain version."""
    length = int(length)
    if not q.is_cuda:
        return decode_attention_plain(q, k_cache, v_cache, length)
    B, H_kv, G, S = _check(q, k_cache, v_cache, length)
    n, chunk = cluster_plan(length, B * H_kv, sm_count(q.device.index))
    out = torch.empty_like(q)
    lib = library("decode_attention", _SIGNATURES)
    rc = lib.zt_decode_attention_single(
        q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(), out.data_ptr(),
        B, H_kv, G, S, length, n, chunk, attention_scale(HEAD_DIM),
        torch.cuda.current_stream(q.device).cuda_stream,
    )
    check(rc, "decode_attention_single")
    launch_counts["decode_attention_single"] += 1
    return out


def decode_attention_split_plain(q: torch.Tensor, k_cache: torch.Tensor, v_cache: torch.Tensor,
                                 k_new: torch.Tensor, v_new: torch.Tensor, pos: int,
                                 k_scale: torch.Tensor | None = None,
                                 v_scale: torch.Tensor | None = None) -> torch.Tensor:
    """q [B, 1, H, D] against cache rows [0, pos) of ``k_cache``/``v_cache``
    [B, H_kv, S, D] plus the held-out current row ``k_new``/``v_new``
    [B, 1, H_kv, D]; ``k_scale``/``v_scale`` [B, H_kv, S] are an int8 cache's
    row scales.  The arithmetic and dtype points of decode_attention_split
    (zonos_tpu/ops/attention.py:141-170): fp32 scores, the int8 scales folded
    into the scores and into the softmax weights before the cast to q's dtype,
    an f8 cache's values and weights read in bf16."""
    B, _, H, D = q.shape
    H_kv, S = k_cache.shape[1], k_cache.shape[2]
    G = H // H_kv
    scale = attention_scale(D)
    qh = q.transpose(1, 2).reshape(B, H_kv, G, 1, D).float()
    k_read = k_cache if k_cache.dtype == q.dtype else k_cache.to(q.dtype)
    scores = torch.einsum("bhgqd,bhkd->bhgqk", qh, k_read.float()) * scale
    if k_scale is not None:
        scores = scores * k_scale[:, :, None, None, :]
    valid = torch.arange(S, device=q.device) < pos
    scores = scores.masked_fill(~valid, float("-inf"))
    s_new = torch.einsum("bhgqd,bhkd->bhgqk", qh, k_new.transpose(1, 2).float()) * scale
    weights = torch.softmax(torch.cat([scores, s_new], dim=-1), dim=-1)
    w_cache, w_new = weights[..., :S], weights[..., S:]
    if v_scale is not None:
        w_cache = w_cache * v_scale[:, :, None, None, :]
        out = gqa_output(w_cache.to(q.dtype), v_cache.to(q.dtype), q.dtype)
    else:
        out = gqa_output(w_cache, v_cache, q.dtype)
    return out + gqa_output(w_new, v_new.transpose(1, 2), q.dtype)


def gqa_output(weights: torch.Tensor, v: torch.Tensor, out_dtype) -> torch.Tensor:
    """weights [B, H_kv, G, Sq, Sk] x v [B, H_kv, Sk, D] -> [B, Sq, H, D]: the
    weights are cast to v's dtype before the product, and an f8 ``v`` is read
    in bf16 (zonos_tpu/ops/attention.py:71-78)."""
    B, H_kv, G, Sq, _ = weights.shape
    if v.element_size() < 2:
        v = v.to(torch.bfloat16)
    out = torch.einsum("bhgqk,bhkd->bhgqd", weights.to(v.dtype), v)
    return out.reshape(B, H_kv * G, Sq, v.shape[-1]).transpose(1, 2).to(out_dtype)


def _check_held_out(q, k_cache, v_cache, k_new, v_new, pos, k_scale, v_scale) -> tuple:
    tensors = (k_cache, v_cache, k_new, v_new) + tuple(
        t for t in (k_scale, v_scale) if t is not None)
    if not all(t.is_cuda and t.device == q.device for t in tensors):
        raise ValueError("q, the cache, its scales and the held-out row must lie on the same "
                         "CUDA device")
    refusal = _refusal(q, k_cache, v_cache, k_new, v_new, k_scale, v_scale)
    if refusal is not None:
        raise refusal[0](refusal[1])
    if not (q.is_contiguous() and k_cache.is_contiguous() and v_cache.is_contiguous()
            and all(t.is_contiguous() for t in (k_scale, v_scale) if t is not None)):
        raise ValueError("decode attention kernel takes a contiguous q, cache and scales")
    B, _, H, _ = q.shape
    H_kv, S = k_cache.shape[1], k_cache.shape[2]
    if not 0 <= pos < S:
        raise ValueError(f"pos {pos} outside [0, {S})")
    return B, H_kv, H // H_kv, S


def _scale_ptrs(k_scale, v_scale) -> tuple[int, int]:
    return (0, 0) if k_scale is None else (k_scale.data_ptr(), v_scale.data_ptr())


def flash_decode_attention_held_out(q, k_cache, v_cache, k_new, v_new, pos: int,
                                    k_scale=None, v_scale=None) -> torch.Tensor:
    """K1 over an f8 or int8 cache with the current row held out: one cluster
    per (row, kv head) streams [0, pos) over its CTAs (:func:`flash_plan`),
    rank 0 starting its online softmax from the held-out row.  CPU tensors
    take the plain version."""
    pos = int(pos)
    if not q.is_cuda:
        return decode_attention_split_plain(q, k_cache, v_cache, k_new, v_new, pos,
                                            k_scale, v_scale)
    k_new, v_new = k_new.contiguous(), v_new.contiguous()
    B, H_kv, G, S = _check_held_out(q, k_cache, v_cache, k_new, v_new, pos, k_scale, v_scale)
    code, suffix = STORAGE[k_cache.dtype]
    n, chunk = flash_plan(pos, B * H_kv, sm_count(q.device.index))
    out = torch.empty_like(q)
    lib = library("decode_attention", _SIGNATURES)
    rc = lib.zt_flash_decode_attention_q(
        code, q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(), *_scale_ptrs(k_scale, v_scale),
        k_new.data_ptr(), v_new.data_ptr(), out.data_ptr(), B, H_kv, G, S, pos, n, chunk,
        attention_scale(HEAD_DIM), torch.cuda.current_stream(q.device).cuda_stream,
    )
    check(rc, f"flash_decode_attention_{suffix}")
    launch_counts[f"flash_decode_attention_{suffix}"] += 1
    return out


def decode_attention_single_held_out(q, k_cache, v_cache, k_new, v_new, pos: int,
                                     k_scale=None, v_scale=None) -> torch.Tensor:
    """K2 over an f8 or int8 cache with the current row held out: one cluster
    per (row, kv head) splits [0, pos) over its CTAs, rank 0 starting its
    online softmax from the held-out row.  CPU tensors take the plain
    version."""
    pos = int(pos)
    if not q.is_cuda:
        return decode_attention_split_plain(q, k_cache, v_cache, k_new, v_new, pos,
                                            k_scale, v_scale)
    k_new, v_new = k_new.contiguous(), v_new.contiguous()
    B, H_kv, G, S = _check_held_out(q, k_cache, v_cache, k_new, v_new, pos, k_scale, v_scale)
    code, suffix = STORAGE[k_cache.dtype]
    n, chunk = cluster_plan(pos, B * H_kv, sm_count(q.device.index))
    out = torch.empty_like(q)
    lib = library("decode_attention", _SIGNATURES)
    rc = lib.zt_decode_attention_single_q(
        code, q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(), *_scale_ptrs(k_scale, v_scale),
        k_new.data_ptr(), v_new.data_ptr(), out.data_ptr(), B, H_kv, G, S, pos, n, chunk,
        attention_scale(HEAD_DIM), torch.cuda.current_stream(q.device).cuda_stream,
    )
    check(rc, f"decode_attention_single_{suffix}")
    launch_counts[f"decode_attention_single_{suffix}"] += 1
    return out
