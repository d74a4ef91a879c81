"""K1/K2 decode attention (csrc/decode_attention.cu) and its plain versions.

Replaces ``flash_decode_attention_pallas`` and ``decode_attention_pallas``
(zonos_tpu/ops/pallas_kernels.py:147, :58): one query token per row against
a KV cache masked to its first ``length`` rows.  As in the Pallas kernels,
which take ``length`` as a scalar-prefetch operand over a grid fixed by the
cache size, the kernels read ``length`` from the card (an int32 tensor), so
a decode step is one program with no host read and can be replayed as a
CUDA graph.  The host fixes each launch's grid per :class:`Band` of lengths
(:func:`band_plan`); each CTA computes its rows from the length on the card
(:func:`rank_rows`).

Over a quantized cache (f8 e4m3, or int8 with one fp32 scale per row and kv
head) the current token's k/v are held out in the compute dtype, as in
``decode_attention_split`` (zonos_tpu/ops/attention.py:119): the kernels
attend over cache rows ``[0, pos)`` plus that row, and the caller writes the
row into the cache afterwards.
"""

from __future__ import annotations

import ctypes
import functools
from dataclasses import dataclass

import torch

from zonos_tpu_torch.kernels import launch_counts
from zonos_tpu_torch.kernels._build import check, library, sm_count

BLOCK_S = 256  # the longest length K2's band takes; longer ones go to K1
HEAD_DIM = 128  # compiled into the kernel
GROUPS = (1, 2, 4, 8)  # query heads per kv head the kernel is instantiated for

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_SIGNATURES = {
    "zt_flash_decode_attention": [_P, _P, _P, _P] + [_I] * 4 + [_P] + [_I] * 6 + [_F, _P],
    "zt_decode_attention_single": [_P, _P, _P, _P] + [_I] * 4 + [_P] + [_I] * 6 + [_F, _P],
    "zt_flash_decode_attention_q": [_I] + [_P] * 8 + [_I] * 4 + [_P] + [_I] * 6 + [_F, _P],
    "zt_decode_attention_single_q": [_I] + [_P] * 8 + [_I] * 4 + [_P] + [_I] * 6 + [_F, _P],
    "zt_flash_max_active_clusters": [_I, _I, _I, _I, _P],
    "zt_decode_attention_prepare": [],
}
# quantized cache storage: the kernels' storage code and the launch-count suffix
STORAGE = {torch.float8_e4m3fn: (1, "f8"), torch.int8: (2, "int8")}
MAX_CLUSTER = 8  # K2's CTAs in a thread-block cluster, the portable limit
CHUNK_ROWS = 32  # K2: the fewest cache rows worth a CTA of its own in a cluster
ONE_CTA_ROWS = 64  # K1: the same; and up to 2 x K2's CHUNK_ROWS one CTA a pair (--sweep)
ROWS_PER_PASS = 16  # cache rows a CTA covers at once (16 lanes a row); chunks are multiples
CTAS_PER_SM = 2  # the grid K2's plan stops adding CTAs at
FLASH_WAVES = 4  # K1: one CTA a rank while the grid fills at most this many waves
MAX_FLASH_CLUSTER = 16  # K1's CTAs per cluster, the largest (non-portable) size
# The bands of attended lengths (cache rows, plus the held-out row over a quantized cache)
# whose launches share one grid: K2's up to 256 rows, K1's beyond in two (one cluster size
# for each); None: to the end of the cache.
BANDS = ((1, BLOCK_S), (BLOCK_S + 1, 2 * BLOCK_S), (2 * BLOCK_S + 1, None))


@dataclass(frozen=True)
class Band:
    """A range ``[lo, hi]`` of attended lengths (``hi`` None: to the end of the
    cache) over which one launch plan holds, so that one captured decode step
    serves every length in it.  K2 takes the band up to 256 (``kernel``), K1
    the rest."""

    lo: int
    hi: int | None

    @property
    def kernel(self) -> str:
        return "K2" if self.hi is not None and self.hi <= BLOCK_S else "K1"

    def check(self, length: int) -> None:
        """Raise where the host's ``length`` lies outside the band."""
        if length < self.lo or (self.hi is not None and length > self.hi):
            raise ValueError(f"length {length} outside the band [{self.lo}, {self.hi}]")


def band_of(length: int) -> Band:
    """The band of :data:`BANDS` that holds ``length`` (at least 1)."""
    for lo, hi in BANDS:
        if lo <= length and (hi is None or length <= hi):
            return Band(lo, hi)
    raise ValueError(f"attended length {length} is below 1")


@dataclass(frozen=True)
class BandPlan:
    """One launch over a band: a split of up to ``n`` ranks of at least
    ``min_rows`` rows (:func:`rank_rows`), the cache rows ``[lo, hi]`` the
    kernel clamps the length to and the longest chunk of the band,
    ``chunk_max`` (it sizes the shared memory): what fixes a row's sums; and
    ``grid``, the CTAs of a pair's cluster (a divisor of n, each running n /
    grid ranks in turn), chosen by the number of pairs."""

    n: int
    min_rows: int
    lo: int
    hi: int
    chunk_max: int
    grid: int

    @property
    def split(self) -> tuple[int, int, int, int, int]:
        """The fields that fix a row's result (all but ``grid``)."""
        return self.n, self.min_rows, self.lo, self.hi, self.chunk_max


def _round16(rows: int) -> int:
    return -(-rows // ROWS_PER_PASS) * ROWS_PER_PASS


def rank_rows(rows: int, n: int, min_rows: int) -> tuple[int, int]:
    """The split each CTA computes on the card: ``(used, chunk)``, the first
    ``used`` ranks of a cluster of ``n`` taking ``chunk`` rows each (rank r
    ``[r * chunk, min((r + 1) * chunk, rows))``, possibly empty at the end),
    the others none.  One CTA up to ``2 * min_rows`` rows (a cluster's
    barriers and exchange cost more than they save there), else one per
    ``min_rows`` rows, at most ``n``; ``chunk`` a multiple of 16."""
    used = 1 if rows <= 2 * min_rows else min(n, -(-rows // min_rows))
    return used, _round16(-(-rows // used))


def split_cap(kernel: str, sms: int = 132) -> int:
    """The most ranks a pair's rows split into for ``kernel`` ("K1" or "K2")
    on a card of ``sms`` SMs.  K2: 8, the portable cluster limit.  K1: 16 (a
    non-portable cluster size), halved while the 8 (batch row, kv head) pairs
    of batch 1 with CFG would not find one SM a CTA.  The batch never
    enters: the split fixes a row's sums and the order they combine in."""
    if kernel == "K2":
        return MAX_CLUSTER
    n = MAX_FLASH_CLUSTER
    while n > 1 and 8 * n > sms:
        n //= 2
    return n


def grid_cap(kernel: str, bh_kv: int, n: int, sms: int = 132) -> int:
    """The most CTAs a pair's split of ``n`` ranks gets at ``bh_kv`` (batch
    row, kv head) pairs, the fastest of every grid measured (PERF.md section
    6).  K2: one CTA a rank while the grid stays within two CTAs per SM
    (batch 4 with CFG and fewer), else two CTAs a pair while that does
    (batch 8: 10.7 us against 12.4-22.5 for the other grids), else one
    (batch 64: 50.2 us against 71.6-124.5).  K1: one CTA a rank while the
    grid stays within four waves of one CTA an SM (batch 4: 27.6 us against
    40.2-79.1); past that doubled up to 16 while it stays within one, so
    that one CTA a pair runs its ranks once the pairs alone fill the card.
    It sets the grid only, never a row's split."""
    if kernel == "K2":
        if bh_kv * n <= CTAS_PER_SM * sms:
            return n
        return 2 if 2 * bh_kv <= CTAS_PER_SM * sms else 1
    if bh_kv * n <= FLASH_WAVES * sms:
        return n
    g = 1
    while g < MAX_FLASH_CLUSTER and 2 * g * bh_kv <= sms:
        g *= 2
    return g


def band_plan(kernel: str, band: Band, bh_kv: int, S: int, held_out: bool,
              sms: int = 132) -> BandPlan:
    """``kernel``'s launch over ``band`` for a cache of ``S`` rows: the cache
    rows it attends are the band's lengths (one fewer with the current row
    held out), cut at the cache's end; the split is what the longest of them
    splits into (:func:`rank_rows`) under :func:`split_cap`, the same at
    every batch (K2 8 ranks of 32 rows at 256, K1 8 up to 512 rows and 16
    beyond); ``bh_kv`` sets the grid: the largest divisor of the split's
    ranks within :func:`grid_cap` (batch 1 with CFG, 8 pairs: one CTA a
    rank; batch 64, 512 pairs: one CTA a pair).  Raises where the band does
    not fit the cache."""
    cut = 1 if held_out else 0
    lo = band.lo - cut
    hi = (S if band.hi is None else min(band.hi, S)) - cut
    if lo < 0 or lo > hi or bh_kv < 1:
        raise ValueError(f"the band [{band.lo}, {band.hi}] does not fit a cache of {S} rows")
    min_rows = CHUNK_ROWS if kernel == "K2" else ONE_CTA_ROWS
    n = max(1, min(split_cap(kernel, sms), -(-hi // min_rows)))
    # the longest chunk: one CTA's rows up to 2 * min_rows, a cluster's at most min_rows
    # rows while it grows and ceil(hi / n) once it is full
    chunk_max = max(_round16(min(hi, 2 * min_rows)), _round16(min_rows), _round16(-(-hi // n)))
    grid = min(n, grid_cap(kernel, bh_kv, n, sms))
    while n % grid:
        grid -= 1
    return BandPlan(n, min_rows, lo, hi, chunk_max, grid)


@functools.lru_cache(maxsize=None)
def attention_scale(head_dim: int) -> float:
    """1/sqrt(D) rounded as an fp32 computation, like the JAX reference."""
    return float(1.0 / torch.sqrt(torch.tensor(float(head_dim), dtype=torch.float32)))


def decode_attention_plain(q: torch.Tensor, k_cache: torch.Tensor, v_cache: torch.Tensor,
                           length: int | torch.Tensor) -> torch.Tensor:
    """q [B, 1, H, D] vs cache [B, H_kv, S, D], first ``length`` rows valid (a
    host int or a 0-d tensor on q's device) -> [B, 1, H, D].  fp32 scores and
    softmax; the weights are cast to v's dtype before the value product
    (zonos_tpu/ops/attention.py:173-210)."""
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


def resolve_band(length, band: Band | None, held_out: bool) -> Band:
    """The band of what ``length`` attends (one row more with the current row
    held out): ``band``, which must hold a host int ``length``, or the band
    of its value.  A tensor comes with its band: the host cannot read it."""
    if isinstance(length, torch.Tensor):
        if band is None:
            raise ValueError("a length on the card comes with the band it lies in")
        return band
    attended = int(length) + held_out
    if band is None:
        return band_of(attended)
    band.check(attended)
    return band


def _length_operand(length, band: Band | None, held_out: bool, device: torch.device):
    """The length as the kernels read it, an int32 on ``device``, and its band;
    a host int (a one-off call) is placed on the card by a fill."""
    band = resolve_band(length, band, held_out)
    if isinstance(length, torch.Tensor):
        if length.dtype != torch.int32 or length.numel() != 1 or length.device != device:
            raise ValueError(f"the length must be one int32 on {device}, got {length.dtype} "
                             f"{tuple(length.shape)} on {length.device}")
        return length, band
    return torch.full((), int(length), dtype=torch.int32, device=device), band


def _clamped(length, plan: BandPlan):
    """A CPU length clamped to the band's rows, as the kernels clamp it."""
    if isinstance(length, torch.Tensor):
        return length.clamp(plan.lo, plan.hi)
    return min(max(int(length), plan.lo), plan.hi)


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> tuple:
    if not (k.is_cuda and v.is_cuda) or not (q.device == k.device == v.device):
        raise ValueError("q, k_cache and v_cache must lie on the same CUDA device")
    refusal = _refusal(q, k, v)
    if refusal is not None:
        raise refusal[0](refusal[1])
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise ValueError("decode attention kernel takes contiguous tensors")
    B, _, H, _ = q.shape
    H_kv, S = k.shape[1], k.shape[2]
    return B, H_kv, H // H_kv, S


@functools.lru_cache(maxsize=None)
def _library(device_index: int) -> ctypes.CDLL:
    """The library, with every kernel's attributes set on the device: once,
    at the first launch, so never while a CUDA graph is being captured."""
    lib = library("decode_attention", _SIGNATURES)
    with torch.cuda.device(device_index):
        check(lib.zt_decode_attention_prepare(), "decode_attention_prepare")
    return lib


def _attend(kernel: str, q, k_cache, v_cache, length, band: Band | None) -> torch.Tensor:
    """K1 (``kernel`` "K1") or K2 over a bf16 cache: CUDA tensors launch the
    kernel with ``band``'s plan, CPU tensors take the plain version."""
    if not q.is_cuda:
        if band is not None:
            band = resolve_band(length, band, False)
            plan = band_plan(kernel, band, q.shape[0] * k_cache.shape[1], k_cache.shape[2],
                             False)
            length = _clamped(length, plan)
        return decode_attention_plain(q, k_cache, v_cache, length)
    B, H_kv, G, S = _check(q, k_cache, v_cache)
    length, band = _length_operand(length, band, False, q.device)
    plan = band_plan(kernel, band, B * H_kv, S, False, sm_count(q.device.index))
    out = torch.empty_like(q)
    lib = _library(q.device.index)
    entry = lib.zt_flash_decode_attention if kernel == "K1" else lib.zt_decode_attention_single
    name = "flash_decode_attention" if kernel == "K1" else "decode_attention_single"
    rc = entry(q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(), out.data_ptr(),
               B, H_kv, G, S, length.data_ptr(), plan.lo, plan.hi, plan.n, plan.grid,
               plan.chunk_max, plan.min_rows, attention_scale(HEAD_DIM),
               torch.cuda.current_stream(q.device).cuda_stream)
    check(rc, name)
    launch_counts[name] += 1
    return out


def flash_decode_attention(q: torch.Tensor, k_cache: torch.Tensor, v_cache: torch.Tensor,
                           length, band: Band | None = None) -> torch.Tensor:
    """K1: one thread-block cluster of up to 16 CTAs per (row, kv head)
    (:func:`band_plan`), each CTA streaming its chunk of the valid rows
    through a ring of stages, the partial softmaxes combined through
    distributed shared memory; one launch, no scratch.  ``length``: an int32
    on the card with its ``band`` (or a host int).  CPU tensors take the
    plain version."""
    return _attend("K1", q, k_cache, v_cache, length, band)


def max_active_clusters(storage: torch.dtype, G: int, n: int, chunk: int) -> int:
    """How many of K1's clusters of ``n`` CTAs of ``chunk`` rows, over a cache
    of ``storage`` (bf16, f8 or int8) with ``G`` query heads a kv head, the
    current card holds at once (``cudaOccupancyMaxActiveClusters``; 0: it
    cannot launch them)."""
    code = 0 if storage == torch.bfloat16 else STORAGE[storage][0]
    clusters = ctypes.c_int(0)
    check(_library(torch.cuda.current_device()).zt_flash_max_active_clusters(
        code, G, n, chunk, ctypes.addressof(clusters)), "flash_max_active_clusters")
    return clusters.value


def decode_attention_single(q: torch.Tensor, k_cache: torch.Tensor, v_cache: torch.Tensor,
                            length, band: Band | None = None) -> torch.Tensor:
    """K2: one thread-block cluster per (row, kv head) splits the valid rows
    over its CTAs (:func:`band_plan`) and combines their partial softmaxes
    through distributed shared memory; one launch, no scratch.  ``length``:
    an int32 on the card with its ``band`` (or a host int).  CPU tensors take
    the plain version."""
    return _attend("K2", q, k_cache, v_cache, length, band)


def decode_attention_split_plain(q: torch.Tensor, k_cache: torch.Tensor, v_cache: torch.Tensor,
                                 k_new: torch.Tensor, v_new: torch.Tensor,
                                 pos: int | torch.Tensor, k_scale: torch.Tensor | None = None,
                                 v_scale: torch.Tensor | None = None) -> torch.Tensor:
    """q [B, 1, H, D] against cache rows [0, pos) of ``k_cache``/``v_cache``
    [B, H_kv, S, D] plus the held-out current row ``k_new``/``v_new``
    [B, 1, H_kv, D] (``pos`` a host int or a 0-d tensor on q's device);
    ``k_scale``/``v_scale`` [B, H_kv, S] are an int8 cache's row scales.  The
    arithmetic and dtype points of decode_attention_split
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


def _check_held_out(q, k_cache, v_cache, k_new, v_new, k_scale, v_scale) -> tuple:
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
    return B, H_kv, H // H_kv, S


def _scale_ptrs(k_scale, v_scale) -> tuple[int, int]:
    return (0, 0) if k_scale is None else (k_scale.data_ptr(), v_scale.data_ptr())


def _attend_held_out(kernel: str, q, k_cache, v_cache, k_new, v_new, pos, k_scale, v_scale,
                     band: Band | None) -> torch.Tensor:
    """K1 or K2 over an f8 or int8 cache with the current row held out: CUDA
    tensors launch the kernel with ``band``'s plan, CPU tensors take the
    plain version."""
    if not q.is_cuda:
        if band is not None:
            band = resolve_band(pos, band, True)
            plan = band_plan(kernel, band, q.shape[0] * k_cache.shape[1], k_cache.shape[2], True)
            pos = _clamped(pos, plan)
        return decode_attention_split_plain(q, k_cache, v_cache, k_new, v_new, pos,
                                            k_scale, v_scale)
    k_new, v_new = k_new.contiguous(), v_new.contiguous()
    B, H_kv, G, S = _check_held_out(q, k_cache, v_cache, k_new, v_new, k_scale, v_scale)
    pos, band = _length_operand(pos, band, True, q.device)
    plan = band_plan(kernel, band, B * H_kv, S, True, sm_count(q.device.index))
    code, suffix = STORAGE[k_cache.dtype]
    out = torch.empty_like(q)
    lib = _library(q.device.index)
    entry = lib.zt_flash_decode_attention_q if kernel == "K1" else lib.zt_decode_attention_single_q
    name = f"{'flash_decode_attention' if kernel == 'K1' else 'decode_attention_single'}_{suffix}"
    rc = entry(code, q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(),
               *_scale_ptrs(k_scale, v_scale), k_new.data_ptr(), v_new.data_ptr(),
               out.data_ptr(), B, H_kv, G, S, pos.data_ptr(), plan.lo, plan.hi, plan.n,
               plan.grid, plan.chunk_max, plan.min_rows, attention_scale(HEAD_DIM),
               torch.cuda.current_stream(q.device).cuda_stream)
    check(rc, name)
    launch_counts[name] += 1
    return out


def flash_decode_attention_held_out(q, k_cache, v_cache, k_new, v_new, pos, k_scale=None,
                                    v_scale=None, band: Band | None = None) -> torch.Tensor:
    """K1 over an f8 or int8 cache with the current row held out: one cluster
    per (row, kv head) streams [0, pos) over its CTAs (:func:`band_plan`),
    rank 0 starting its online softmax from the held-out row.  ``pos``: an
    int32 on the card with the ``band`` of ``pos + 1`` (or a host int).  CPU
    tensors take the plain version."""
    return _attend_held_out("K1", q, k_cache, v_cache, k_new, v_new, pos, k_scale, v_scale,
                            band)


def decode_attention_single_held_out(q, k_cache, v_cache, k_new, v_new, pos, k_scale=None,
                                     v_scale=None, band: Band | None = None) -> torch.Tensor:
    """K2 over an f8 or int8 cache with the current row held out: one cluster
    per (row, kv head) splits [0, pos) over its CTAs, rank 0 starting its
    online softmax from the held-out row.  ``pos`` as in
    :func:`flash_decode_attention_held_out`.  CPU tensors take the plain
    version."""
    return _attend_held_out("K2", q, k_cache, v_cache, k_new, v_new, pos, k_scale, v_scale,
                            band)
