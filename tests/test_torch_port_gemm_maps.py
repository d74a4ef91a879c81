"""A numpy model of G1's index maps (``csrc/gemm.cu``): where TMA puts each
operand element in shared memory, where ``wgmma`` reads it back through its
descriptors, where an accumulator register lands in the output, and which
CTA writes which output.

The model transcribes the kernel's constants and formulas: 128-byte
swizzle (the 16-byte chunk c of a 128-byte row r sits at c ^ (r % 8)), x
as K-major A (descriptor SBO 1024 bytes, a 16-k step 32 bytes further), the
weight as N-major B in two boxes of 64 columns (SBO 1024, LBO 8192, a 16-k
step 2048 bytes), the int8 tile widened by the consumers into that layout,
the accumulator fragment of ``wgmma.m64n128k16``, the staged TMA stores,
the persistent walk's grouped tile order, the cluster's shares of the
reduction and the splits' stages.  It shows, at ragged M, ragged N (the
hybrid's in_proj: 8512 columns), ragged K and ragged splits, that every
operand element the wgmmas read is the one the product needs (zero past the
edges) and that every output is written exactly once, with its own value.
Edit it with the kernel.
"""

from __future__ import annotations

import numpy as np
import pytest

from zonos_tpu_torch.kernels import gemm as g1

SMS = 132
BOX_COLS = 64  # a bf16 weight box: 128-byte rows
BOX_BYTES = 8192  # a swizzled box of 64 rows of 128 bytes
A_SBO = B_SBO = 1024  # 8 rows (A) or 8 k rows (B) of a swizzle atom
B_LBO = BOX_BYTES  # the next 64 columns of B
A_STEP, B_STEP = 32, 2048  # bytes a 16-k step moves the descriptors
GROUP_ROWS = 16  # row tiles a group of the persistent walk
WEIGHTS = {"wqkv": (2048, 3072), "w2": (8192, 2048), "in_proj": (2048, 8512),
           "heads": (2048, 10368), "ragged": (272, 144)}


def swizzle(byte):
    """The 128-byte swizzle of a byte offset from a 1024-byte boundary."""
    return byte ^ (((byte >> 7) & 7) << 4)


def tma_bf16_box(src, r0, c0, rows, cols):
    """A TMA box of bf16 ``src[r0:, c0:]`` (zero past the edges) with 128-byte
    swizzle: shared memory as an array of 2-byte slots."""
    smem = np.full(rows * cols, np.nan)
    r, c = np.meshgrid(np.arange(rows), np.arange(cols), indexing="ij")
    gr, gc = r0 + r, c0 + c
    inside = (gr < src.shape[0]) & (gc < src.shape[1])
    vals = np.where(inside, src[np.minimum(gr, src.shape[0] - 1), np.minimum(gc, src.shape[1] - 1)],
                    0.0)
    smem[swizzle(r * cols * 2 + c * 2) // 2] = vals
    return smem


def wgmma_a(smem, start, kk):
    """A [64 rows][16 k] as wgmma reads it: K-major, 128-byte swizzle."""
    m, j = np.meshgrid(np.arange(64), np.arange(16), indexing="ij")
    logical = start + kk * A_STEP + m // 8 * A_SBO + m % 8 * 128 + j * 2
    return smem[swizzle(logical) // 2]


def wgmma_b(smem, start, kk):
    """B [16 k][128 columns] as wgmma reads it: N-major (transposed), 128-byte
    swizzle, two atoms of 64 columns LBO apart."""
    j, n = np.meshgrid(np.arange(16), np.arange(128), indexing="ij")
    logical = start + kk * B_STEP + n // 64 * B_LBO + n % 64 * 2 + j // 8 * B_SBO + j % 8 * 128
    return smem[swizzle(logical) // 2]


def byte_perm(x, y, s):
    b = [(x >> (8 * i)) & 0xFF for i in range(4)] + [(y >> (8 * i)) & 0xFF for i in range(4)]
    return sum(b[(s >> (4 * n)) & 0xF] << (8 * n) for n in range(4))


def widen4(word):
    """The kernel's four int8 (a 32-bit word) -> two bf16 pairs, as 16-bit words."""
    u = word ^ 0x80808080
    f = [np.float32(np.uint32(byte_perm(u, 0x4B000000, 0x7650 | i)).view(np.float32))
         - np.float32(8388736.0) for i in range(4)]
    bits = [int(np.float32(v).view(np.uint32)) for v in f]
    return [b >> 16 for b in bits]


def test_widen4_is_exact_for_every_byte():
    for q in range(-128, 128):
        word = (q & 0xFF) | ((-q & 0xFF) << 8) | (((q + 1) & 0xFF) << 16) | ((q & 0x7F) << 24)
        got = widen4(word)
        want = [q, -q if q > -128 else -128, q + 1 if q < 127 else -128, q & 0x7F]
        for g, v in zip(got, want):
            assert g == int(np.float32(v).view(np.uint32)) >> 16


def test_widen_map_lays_the_int8_tile_out_as_tma_would():
    """The consumers' pieces (16 columns each, threads of NC warpgroups) cover
    the [64 k][128] int8 tile once and land in the two swizzled bf16 boxes
    exactly where TMA would have put a bf16 tile."""
    rng = np.random.default_rng(0)
    tile = rng.integers(-127, 128, size=(64, 128))
    want = tma_bf16_box(tile.astype(float), 0, 0, 64, 64)
    want = np.concatenate([want, tma_bf16_box(tile.astype(float), 0, 64, 64, 64)])
    for nc in (1, 2):
        smem = np.full(2 * 64 * 64, np.nan)
        seen = np.zeros(512, int)
        each = 512 // (nc * 128)
        for t in range(nc * 128):
            for e in range(each):
                i = e * nc * 128 + t
                seen[i] += 1
                k, c16 = i // 8, i % 8
                vals = tile[k, c16 * 16:c16 * 16 + 16]
                row = c16 // 4 * BOX_BYTES + k * 128
                chunk = c16 % 4 * 2
                for half in range(2):
                    at = row + (((chunk + half) ^ (k & 7)) << 4)
                    smem[at // 2:at // 2 + 8] = vals[8 * half:8 * half + 8]
        assert (seen == 1).all()
        np.testing.assert_array_equal(smem, want)


@pytest.mark.parametrize("name", list(WEIGHTS))
@pytest.mark.parametrize("M", [2, 65, 142, 300])
def test_operands_are_the_product_s(name, M):
    """Every wgmma of a tile's first and last stage reads x's and the
    weight's elements of its 16 k (zero past M, K and N), for each consumer
    warpgroup, in the last column tile (ragged N) and the last row tile; the
    rows past x's box (M rounded up to 8) read stale shared memory and are
    never stored."""
    K, N = WEIGHTS[name]
    plan = g1.gemm_plan(M, K, N, SMS)
    nc = plan.bm // 64
    rng = np.random.default_rng(K + N + M)
    x = rng.integers(-8, 9, size=(M, K)).astype(float)
    w = rng.integers(-8, 9, size=(K, N)).astype(float)
    m0 = (-(-M // plan.bm) - 1) * plan.bm
    n0 = (-(-N // 128) - 1) * 128
    x_rows = min(plan.bm, -(-M // 8) * 8)  # x's box: M rounded up to 8 rows, at most the tile
    assert m0 + x_rows >= M  # the rows past the box (stale shared memory) are never stored
    for k in (0, (K - 1) // 64 * 64):
        xs = np.full(plan.bm * 64, np.nan)
        xs[:x_rows * 64] = tma_bf16_box(x, m0, k, x_rows, 64)
        ws = np.concatenate([tma_bf16_box(w, k, n0 + b * BOX_COLS, 64, 64) for b in range(2)])
        for wg in range(nc):
            for kk in range(min(4, -(-(K - k) // 16))):
                a = wgmma_a(xs, wg * BOX_BYTES, kk)
                rows = m0 + wg * 64 + np.arange(64)
                ks = k + kk * 16 + np.arange(16)
                want_a = np.where((rows[:, None] < M) & (ks[None, :] < K),
                                  x[np.minimum(rows, M - 1)][:, np.minimum(ks, K - 1)], 0)
                boxed = rows < m0 + x_rows
                np.testing.assert_array_equal(a[boxed], want_a[boxed])
                assert np.isnan(a[~boxed]).all()
                b = wgmma_b(ws, 0, kk)
                cols = n0 + np.arange(128)
                want_b = np.where((ks[:, None] < K) & (cols[None, :] < N),
                                  w[np.minimum(ks, K - 1)][:, np.minimum(cols, N - 1)], 0)
                np.testing.assert_array_equal(b, want_b)


def fragment(nc):
    """(thread, register) -> (row, column) of the tile, for NC consumer
    warpgroups of wgmma.m64n128k16's accumulators."""
    t = np.arange(nc * 128)[:, None]
    i = np.arange(64)[None, :]
    j, h, e = i // 4, i % 4 // 2, i % 2
    wg, warp, lane = t // 128, t // 32 % 4, t % 32
    return wg * 64 + warp * 16 + lane // 4 + 8 * h, 8 * j + 2 * (lane % 4) + e


@pytest.mark.parametrize("nc", [1, 2])
def test_accumulators_cover_the_tile_once(nc):
    rows, cols = fragment(nc)
    seen = np.zeros((nc * 64, 128), int)
    np.add.at(seen, (rows, cols), 1)
    assert (seen == 1).all()


def tile_origins(M, N, bm, sms):
    """The persistent walk: every CTA's tiles (first row, first column)."""
    row_tiles, col_tiles = -(-M // bm), -(-N // 128)
    tiles = row_tiles * col_tiles
    grid = min(sms * (2 if bm == 64 else 1), tiles)
    out = []
    for cta in range(grid):
        for t in range(cta, tiles, grid):
            per_group = GROUP_ROWS * col_tiles
            first = t // per_group * GROUP_ROWS
            in_group = min(GROUP_ROWS, row_tiles - first)
            out.append(((first + t % per_group % in_group) * bm, t % per_group // in_group * 128))
    return out


@pytest.mark.parametrize("name,M", [("in_proj", 300), ("wqkv", 2), ("ragged", 9088),
                                    ("heads", 142), ("w2", 1000)])
def test_every_output_is_written_once(name, M):
    """The plan's launch at M rows: in-CTA splits walk the tiles (every tile
    once) and store each tile from its accumulators (one consumer warpgroup)
    or through the swizzled staging boxes and two TMA stores clipped at M
    and N (two); a cluster's ranks each add a share of the tile's outputs.
    Every output below (M, N) gets exactly one write, of its own total."""
    K, N = WEIGHTS[name]
    for parallel in (False, True):
        plan = g1.gemm_plan(M, K, N, SMS)
        plan = g1.GemmPlan(plan.n_split, plan.rows_per_split, plan.bm,
                           parallel and plan.n_split > 1)
        bm, nc = plan.bm, plan.bm // 64
        writes = np.zeros((M, N), int)
        value = np.full((M, N), -1.0)
        rows, cols = fragment(nc)
        if plan.parallel:
            origins = [(rt * bm, ct * 128) for rt in range(-(-M // bm)) for ct in range(-(-N // 128))]
        else:
            origins = tile_origins(M, N, bm, SMS)
            assert len(set(origins)) == len(origins) == -(-M // bm) * -(-N // 128)
        for m0, n0 in origins:
            total = (m0 + rows) * 100000.0 + n0 + cols  # each accumulator's own value
            if plan.parallel:
                _cluster_store(plan, M, N, m0, n0, rows, cols, total, writes, value)
            elif nc == 1:
                ok = (m0 + rows < M) & (n0 + cols < N)
                np.add.at(writes, (m0 + rows[ok], n0 + cols[ok]), 1)
                value[m0 + rows[ok], n0 + cols[ok]] = total[ok]
            else:
                _staged_store(bm, M, N, m0, n0, rows, cols, total, writes, value)
        assert (writes == 1).all()
        r, c = np.meshgrid(np.arange(M), np.arange(N), indexing="ij")
        np.testing.assert_array_equal(value, r * 100000.0 + c)


def _staged_store(bm, M, N, m0, n0, rows, cols, total, writes, value):
    stg = np.full(2 * bm * 64, np.nan)
    j, c = cols // 8, cols % 8
    logical_chunk = (j % 8 ^ (rows & 7)) << 4
    at = j // 8 * bm * 128 + rows * 128 + logical_chunk + c * 2
    assert len(np.unique(at)) == at.size
    stg[at // 2] = total
    for b in range(2):
        r, cc = np.meshgrid(np.arange(bm), np.arange(64), indexing="ij")
        v = stg[(b * bm * 128 + swizzle(r * 128 + cc * 2)) // 2]
        gm, gn = m0 + r, n0 + b * 64 + cc
        ok = (gm < M) & (gn < N)
        np.add.at(writes, (gm[ok], gn[ok]), 1)
        value[gm[ok], gn[ok]] = v[ok]


def _cluster_store(plan, M, N, m0, n0, rows, cols, total, writes, value):
    n, nc = plan.n_split, plan.bm // 64
    valid = min(plan.bm, M - m0)
    part = np.full((plan.bm, 136), np.nan)
    keep = rows < valid  # only the rows below M are written to the partial
    part[rows[keep], cols[keep]] = total[keep]
    quads = valid * 32  # 4 columns a thread step
    share = -(-quads // n)
    for rank in range(n):
        lo, hi = rank * share, min(quads, (rank + 1) * share)
        p = np.arange(lo, lo + max(hi - lo, 0))
        threads = (p - lo) % (nc * 128)  # thread t adds quads lo + t, lo + t + NC 128, ...
        assert np.bincount(threads, minlength=nc * 128).max(initial=0) <= -(-len(p) // (nc * 128))
        pr, pc = p // 32, 4 * (p % 32)
        ok = n0 + pc < N
        for e in range(4):
            v = part[pr[ok], pc[ok] + e]
            assert not np.isnan(v).any()
            np.add.at(writes, (m0 + pr[ok], n0 + pc[ok] + e), 1)
            value[m0 + pr[ok], n0 + pc[ok] + e] = v


@pytest.mark.parametrize("K", [272, 2048, 2064, 8192])
def test_splits_run_the_same_steps_either_way(K):
    """A cluster's CTA s and one CTA running the splits in turn issue the
    same 16-k steps per split (each k below K once, none past it); a stage
    never straddles two splits, and exactly each split's first step starts
    its sums from 0."""
    for N in (2048, 144):
        plan = g1.gemm_plan(2, K, N, SMS)
        rps = plan.rows_per_split
        clustered = []
        for s in range(plan.n_split):
            k0, k1 = s * rps, min(K, (s + 1) * rps)
            clustered.append([(k + kk * 16, kk == 0 and k % rps == 0)
                              for k in range(k0, k1, 64) for kk in range(min(4, -(-(k1 - k) // 16)))])
        serial, split = [[]], 0
        for k in range(0, K, 64):
            serial[-1] += [(k + kk * 16, kk == 0 and k % rps == 0)
                           for kk in range(min(4, -(-(K - k) // 16)))]
            if k + 64 >= K or (k + 64) % rps == 0:
                serial.append([])
        assert serial[:-1] == clustered
        steps = [k for s in clustered for k, _ in s]
        assert steps == list(range(0, K, 16))
        assert all(first == (i == 0) for s in clustered for i, (_, first) in enumerate(s))


X_TILE_ROW = 128  # bytes of a row of the stage's x tile (64 k of bf16)
F32_RAW_OFF = 16 * X_TILE_ROW  # fp32 x's raw box: the x tile's rows 16-47 (Layout::kRawOff)
F32_MAX_ROWS = 16


def _prologue_items(nc, valid, k, K):
    """The consumers' items of one stage under a folded norm: thread t, item
    e -> (row m, chunk c) of x's tile, for the rows below M (``valid``) and
    the chunks below K."""
    each = nc * 64 * 8 // (nc * 128)
    for t in range(nc * 128):
        for e in range(each):
            i = t + e * nc * 128
            m, c = i // 8, i % 8
            assert c == t % 8  # a thread's chunk, so its scale and bias, is the same for every e
            if m < valid and k + 8 * c < K:
                yield m, c


@pytest.mark.parametrize("nc,x_rows,f32", [(1, 8, False), (1, 16, False), (1, 64, False),
                                           (2, 8, False), (2, 64, False), (2, 128, False),
                                           (1, 8, True), (1, 16, True), (2, 16, True)])
def test_folded_norm_writes_x_where_tma_would(nc, x_rows, f32):
    """The folded norm's staging (``csrc/gemm.cu``, XN 1 and 2): bf16 x
    arrives swizzled by TMA and each chunk is normalised in place; fp32 x
    arrives unswizzled in the x tile's rows 16-47 and each chunk is written
    as bf16 at chunk c ^ (m % 8) of its row.  Either way every chunk of a
    row below M is read with the 8 elements it needs (x[m][k + 8 c ..], the
    norm's parameters at the same k), written once, and the tile ends up
    equal to TMA's swizzled box of the normalised rows, which the wgmma
    descriptors were shown to read right.  fp32 x: at most 16 rows, whose
    chunks lie below the raw box."""
    assert x_rows <= 64 * nc and (not f32 or x_rows <= F32_MAX_ROWS)
    K, M, k = 272, x_rows - 3, 256  # the contraction's ragged last stage: 16 k of 64
    valid = min(x_rows, M)
    rng = np.random.default_rng(x_rows + nc)
    x = rng.integers(-50, 50, size=(M, K)).astype(float)
    scale = rng.integers(1, 5, size=K).astype(float)

    def norm(v, m, cols):  # a stand-in for the normalisation: row- and column-dependent
        return v * scale[cols] + m

    tile = np.full(nc * 64 * 64, np.nan)  # the stage's x tile, 2-byte slots
    raw = None
    if f32:  # TMA: box {64, x_rows} fp32, unswizzled, into the tile's rows 16-47
        raw = np.full((x_rows, 64), np.nan)
        r, c = np.meshgrid(np.arange(x_rows), np.arange(64), indexing="ij")
        inside = (r < M) & (k + c < K)
        raw[inside] = x[np.minimum(r, M - 1), np.minimum(k + c, K - 1)][inside]
        assert F32_RAW_OFF + x_rows * 256 <= 64 * X_TILE_ROW  # inside warpgroup 0's tile
    else:
        tile[:x_rows * 64] = tma_bf16_box(x, 0, k, x_rows, 64)
    writes = np.zeros((nc * 64, 8), int)
    for m, c in _prologue_items(nc, valid, k, K):
        at = m * X_TILE_ROW + ((c ^ (m & 7)) << 4)  # the chunk's bytes in the swizzled tile
        assert at + 16 <= (F32_RAW_OFF if f32 else nc * 64 * X_TILE_ROW)
        v = raw[m, 8 * c:8 * c + 8] if f32 else tile[at // 2:at // 2 + 8]
        cols = k + 8 * c + np.arange(8)
        np.testing.assert_array_equal(v, x[m, cols])
        tile[at // 2:at // 2 + 8] = norm(v, m, cols)
        writes[m, c] += 1
    want = np.array([[1 if m < valid and k + 8 * c < K else 0 for c in range(8)]
                     for m in range(nc * 64)])
    np.testing.assert_array_equal(writes, want)
    normed = np.zeros((M, K))
    for m in range(M):
        normed[m] = norm(x[m], m, np.arange(K))
    box = tma_bf16_box(normed, 0, k, x_rows, 64)
    r, c = np.meshgrid(np.arange(x_rows), np.arange(64), indexing="ij")
    slots = swizzle(r * X_TILE_ROW + c * 2)[(r < valid) & (k + c < K)] // 2
    np.testing.assert_array_equal(tile[slots], box[slots])
