"""K5 snake-conv (csrc/snake_conv.cu) and its plain version.

Replaces ``snake_conv1d_pallas`` / ``snake_residual_unit_pallas``
(zonos_tpu/ops/pallas_dac.py:47, :90): ``conv1d(snake(x, alpha), w, b)``
with 'same' padding, NWC activations, fp32.  The residual add of the DAC
residual unit is fused into the second launch.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from zonos_tpu_torch.kernels import launch_counts
from zonos_tpu_torch.kernels._build import check, library, sm_count

_P, _I = ctypes.c_void_p, ctypes.c_int
_SIGNATURES = {"zt_snake_conv1d": [_P, _P, _P, _P, _P, _P] + [_I] * 7 + [_P]}
SMEM_LIMIT = 232448  # dynamic shared memory a block may take on sm_90 (227 KB)
# the tiles compiled into the kernel, by index: (time steps, output channels) a CTA; 96
# divides every DAC width (768, 384, 192, 96)
TILES = ((128, 96), (64, 96), (32, 96))
# each tile's device time per output element relative to the first's, from one tile per SM
# at (C, T) = (768, 688), k = 7 (chip_smoke.py --sweep, k5_sweep): a smaller tile stages each
# weight for fewer time steps and, at 4 time steps a thread, loads more per FMA
TILE_COST = (1.0, 1.36, 1.54)


def ci_chunk(k: int) -> int:
    """Input channels a staged chunk (compiled into the kernel): 8, or 32 at
    k = 1, where a chunk's products are few."""
    return 32 if k == 1 else 8


def conv_plan(T: int, C_in: int, C_out: int, k: int, dilation: int, sms: int = 132,
              batch: int = 1) -> int:
    """K5's tile (an index into ``TILES``) for this shape: the one whose SMs
    each take the least work, masked edges included: the most CTAs an SM
    runs, ``ceil(CTAs / sms)``, times the tile's area and its
    ``TILE_COST``; the larger tile on a tie.  At 86 frames, batch 1: 64 x 96
    for (C, T) = (768, 688) (88 CTAs: a wave of 32 x 96 tiles, 176 CTAs, is
    slower there), 128 x 96 for (384, 5504), (192, 22016) and (96, 44032).
    ``C_in``, ``k`` and ``dilation`` do not move it: every tile's K = C_in x
    k is the same."""
    def cost(tile):
        tt, tc = TILES[tile]
        ctas = batch * -(-T // tt) * -(-C_out // tc)
        return -(-ctas // sms) * tt * tc * TILE_COST[tile], -tt * tc

    return min(range(len(TILES)), key=cost)


def smem_bytes(tile: int, k: int, dilation: int) -> int:
    """Dynamic shared memory of one CTA (csrc/snake_conv.cu ``Layout``): two
    buffers of the snake'd window in 4 copies shifted by 0-3 time steps (one
    when every tap's shift is a multiple of 4), the raw window and two
    buffers of k weight slices, fp32."""
    tt, tc = TILES[tile]
    rows, ci = tt + (k - 1) * dilation, ci_chunk(k)
    copies = 1 if k == 1 or dilation % 4 == 0 else 4
    return 4 * (2 * copies * ci * -(-rows // 4) * 4 + ci * rows + 2 * k * ci * tc)


def snake_conv1d_plain(x: torch.Tensor, alpha: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                       dilation: int = 1, residual: torch.Tensor | None = None) -> torch.Tensor:
    """x [B, T, C_in], w [C_out, C_in, k] (k odd) -> [B, T, C_out]."""
    k = w.shape[-1]
    s = torch.sin(alpha * x)
    xs = (x + s * s / (alpha + 1e-9)).transpose(1, 2)
    y = F.conv1d(xs, w, b, padding=(k - 1) * dilation // 2, dilation=dilation).transpose(1, 2)
    return y.contiguous() if residual is None else residual + y


def _refusal(x, alpha, w, b, dilation, residual):
    """Why the kernel does not take these operands (by dtype and shape), as
    ``(exception class, message)``, or None if it does."""
    tensors = [x, alpha, w, b] + ([residual] if residual is not None else [])
    if any(t.dtype != torch.float32 for t in tensors):
        return TypeError, "snake_conv1d takes fp32 (the DAC runs in fp32)"
    if x.dim() != 3 or w.dim() != 3:
        return ValueError, f"bad shapes x {tuple(x.shape)} w {tuple(w.shape)}"
    B, T, C_in = x.shape
    C_out, w_in, k = w.shape
    if w_in != C_in or k % 2 == 0 or alpha.shape != (C_in,) or b.shape != (C_out,):
        return ValueError, (f"bad shapes x {tuple(x.shape)} w {tuple(w.shape)} "
                            f"alpha {tuple(alpha.shape)} b {tuple(b.shape)}")
    if residual is not None and residual.shape != (B, T, C_out):
        return ValueError, f"residual {tuple(residual.shape)} != {(B, T, C_out)}"
    if C_in % 4 or C_out % 4:
        return ValueError, f"C_in {C_in} and C_out {C_out} must be multiples of 4 (16-byte rows)"
    smem = max(smem_bytes(tile, k, dilation) for tile in range(len(TILES)))
    if smem > SMEM_LIMIT:
        return ValueError, f"k={k}, dilation={dilation} needs {smem} B of shared memory"
    return None


def kernel_takes(x, alpha, w, b, dilation: int = 1, residual=None) -> bool:
    """Whether K5 takes these operands, by dtype and shape: fp32, an odd
    kernel width, channel counts that are multiples of 4, and a halo that fits
    227 KB of shared memory in every tile (at k = 7, a dilation of at most
    87, or a multiple of 4 up to 304; the DAC's are 1, 3 and 9)."""
    return _refusal(x, alpha, w, b, dilation, residual) is None


def snake_conv1d(x: torch.Tensor, alpha: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                 dilation: int = 1, residual: torch.Tensor | None = None) -> torch.Tensor:
    """Fused snake + 'same'-padded dilated conv (+ residual); CPU tensors take
    the plain version."""
    if not x.is_cuda:
        return snake_conv1d_plain(x, alpha, w, b, dilation, residual)
    tensors = [x, alpha, w, b] + ([residual] if residual is not None else [])
    if any(t.device != x.device for t in tensors):
        raise ValueError("snake_conv1d operands must lie on one CUDA device")
    refusal = _refusal(x, alpha, w, b, dilation, residual)
    if refusal is not None:
        raise refusal[0](refusal[1])
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("snake_conv1d takes contiguous tensors")
    # the kernel reads x, the bias and the residual in 16-byte pieces
    x, b, residual = (t if t is None or t.data_ptr() % 16 == 0 else t.clone()
                      for t in (x, b, residual))
    B, T, C_in = x.shape
    C_out, _, k = w.shape
    # the kernel reads weights as [k, C_in, C_out] so a warp's loads are contiguous
    w_kio = w.permute(2, 1, 0).contiguous()
    y = torch.empty((B, T, C_out), dtype=x.dtype, device=x.device)
    tile = conv_plan(T, C_in, C_out, k, dilation, sm_count(x.device.index), B)
    lib = library("snake_conv", _SIGNATURES)
    rc = lib.zt_snake_conv1d(
        x.data_ptr(), alpha.data_ptr(), w_kio.data_ptr(), b.data_ptr(),
        residual.data_ptr() if residual is not None else None, y.data_ptr(),
        B, T, C_in, C_out, k, dilation, tile, torch.cuda.current_stream(x.device).cuda_stream,
    )
    check(rc, "snake_conv1d")
    launch_counts["snake_conv1d"] += 1
    return y


def _snake_conv(x, alpha, w, b, dilation: int = 1, residual=None) -> torch.Tensor:
    """K5 where it takes the operands; the plain version otherwise (any
    dilation, as JAX's convolution takes)."""
    fn = snake_conv1d if kernel_takes(x, alpha, w, b, dilation, residual) else snake_conv1d_plain
    return fn(x, alpha, w, b, dilation, residual)


def snake_residual_unit(p: dict, x: torch.Tensor, dilation: int) -> torch.Tensor:
    """DAC residual unit ``x + conv1x1(snake2(conv_k7_dil(snake1(x))))``: two
    K5 launches on the card, the residual add fused into the second, each
    where the kernel takes its operands."""
    y = _snake_conv(x, p["alpha1"], p["conv1"]["w"], p["conv1"]["b"], dilation=dilation)
    return _snake_conv(y, p["alpha2"], p["conv2"]["w"], p["conv2"]["b"], dilation=1, residual=x)
