"""XXH3-64 (seed 0, the default secret) in numpy: the content hash that keys
the voice cache (``speaker_db.py``), equal to ``xxhash.xxh3_64().hexdigest()``
so a ``.voices/`` directory written by either package is read by the other.

Inputs up to 240 bytes take the algorithm's short paths on Python ints.
Longer ones accumulate 64-byte stripes into eight 64-bit lanes: within a
1024-byte block the lanes only add, so every block's sum is formed at once
in numpy (uint64 arithmetic wraps modulo 2^64, as the algorithm's does), and
only the scramble between blocks runs block by block.
"""

from __future__ import annotations

import numpy as np

_M64 = (1 << 64) - 1
P32_1, P32_2, P32_3 = 0x9E3779B1, 0x85EBCA77, 0xC2B2AE3D
P64_1, P64_2, P64_3 = 0x9E3779B185EBCA87, 0xC2B2AE3D27D4EB4F, 0x165667B19E3779F9
P64_4, P64_5 = 0x85EBCA77C2B2AE63, 0x27D4EB2F165667C5
PRIME_MX1, PRIME_MX2 = 0x165667919E3779F9, 0x9FB21C651E98DF25

SECRET = bytes.fromhex(
    "b8fe6c3923a44bbe7c01812cf721ad1cded46de9839097db7240a4a4b7b3671f"
    "cb79e64eccc0e578825ad07dccff7221b8084674f743248ee03590e6813a264c"
    "3c2852bb91c300cb88d0658b1b532ea371644897a20df94e3819ef46a9deacd8"
    "a8fa763fe39c343ff9dcbbc7c70b4f1d8a51e04bcdb45931c89f7ec9d9787364"
    "eac5ac8334d3ebc3c581a0fffa1363eb170ddd51b7f0da49d316552629d4689e"
    "2b16be587d47a1fc8ff8b8d17ad031ce45cb3a8f95160428afd7fbcabb4b407e")
_STRIPE, _BLOCK = 64, 1024  # 16 stripes a block: (192 - 64) / 8
_SECRET64 = np.frombuffer(SECRET, "<u8")
_STRIPE_KEYS = np.stack([_SECRET64[n:n + 8] for n in range(16)])  # stripe n reads secret + 8n
_SWAP = np.array([1, 0, 3, 2, 5, 4, 7, 6])  # lane i's input goes to lane i ^ 1
_ACC0 = (P32_3, P64_1, P64_2, P64_3, P64_4, P32_2, P64_5, P32_1)


def _r64(b: bytes, i: int) -> int:
    return int.from_bytes(b[i:i + 8], "little")


def _r32(b: bytes, i: int) -> int:
    return int.from_bytes(b[i:i + 4], "little")


def _mul_fold(a: int, b: int) -> int:
    p = a * b
    return (p ^ (p >> 64)) & _M64


def _avalanche(h: int) -> int:
    h ^= h >> 37
    h = (h * PRIME_MX1) & _M64
    return h ^ (h >> 32)


def _xxh64_avalanche(h: int) -> int:
    h ^= h >> 33
    h = (h * P64_2) & _M64
    h ^= h >> 29
    h = (h * P64_3) & _M64
    return h ^ (h >> 32)


def _rotl(x: int, r: int) -> int:
    return ((x << r) | (x >> (64 - r))) & _M64


def _mix16(b: bytes, i: int, s: int) -> int:
    return _mul_fold(_r64(b, i) ^ _r64(SECRET, s), _r64(b, i + 8) ^ _r64(SECRET, s + 8))


def _short(b: bytes) -> int:
    n = len(b)
    if n == 0:
        return _xxh64_avalanche(_r64(SECRET, 56) ^ _r64(SECRET, 64))
    if n <= 3:
        combined = (b[0] << 16) | (b[n >> 1] << 24) | b[n - 1] | (n << 8)
        return _xxh64_avalanche(combined ^ (_r32(SECRET, 0) ^ _r32(SECRET, 4)))
    if n <= 8:
        keyed = (_r32(b, n - 4) + (_r32(b, 0) << 32)) ^ (_r64(SECRET, 8) ^ _r64(SECRET, 16))
        h = keyed ^ _rotl(keyed, 49) ^ _rotl(keyed, 24)
        h = (h * PRIME_MX2) & _M64
        h ^= ((h >> 35) + n) & _M64
        h = (h * PRIME_MX2) & _M64
        return h ^ (h >> 28)
    if n <= 16:
        lo = _r64(b, 0) ^ (_r64(SECRET, 24) ^ _r64(SECRET, 32))
        hi = _r64(b, n - 8) ^ (_r64(SECRET, 40) ^ _r64(SECRET, 48))
        swapped = int.from_bytes(lo.to_bytes(8, "little"), "big")
        return _avalanche((n + swapped + hi + _mul_fold(lo, hi)) & _M64)
    acc = n * P64_1
    if n <= 128:
        for k in range((n - 1) // 32 + 1):  # pairs from both ends, 16 bytes each
            acc += _mix16(b, 16 * k, 32 * k) + _mix16(b, n - 16 * (k + 1), 32 * k + 16)
        return _avalanche(acc & _M64)
    for i in range(8):
        acc += _mix16(b, 16 * i, 16 * i)
    acc = _avalanche(acc & _M64)
    for i in range(8, n // 16):
        acc += _mix16(b, 16 * i, 16 * (i - 8) + 3)
    return _avalanche((acc + _mix16(b, n - 16, 136 - 17)) & _M64)


def _stripe_sums(stripes: np.ndarray, keys: np.ndarray) -> np.ndarray:
    """stripes [..., S, 8] uint64, keys [S, 8] -> each lane's sum over the S
    stripes of the accumulate step's two terms, [..., 8]."""
    dk = stripes ^ keys
    terms = stripes[..., _SWAP] + (dk & np.uint64(0xFFFFFFFF)) * (dk >> np.uint64(32))
    return terms.sum(axis=-2, dtype=np.uint64)


def _long(b: bytes) -> int:
    n = len(b)
    acc = np.array(_ACC0, np.uint64)
    n_blocks = (n - 1) // _BLOCK
    data = np.frombuffer(b, "<u8", count=n_blocks * _BLOCK // 8).reshape(n_blocks, 16, 8)
    scramble_key = _SECRET64[16:24]
    for start in range(0, n_blocks, 4096):  # bounded temporaries on long files
        for block_sum in _stripe_sums(data[start:start + 4096], _STRIPE_KEYS):
            acc += block_sum
            acc ^= acc >> np.uint64(47)
            acc ^= scramble_key
            acc *= np.uint64(P32_1)
    tail = n_blocks * _BLOCK
    n_stripes = (n - 1 - tail) // _STRIPE
    if n_stripes:
        part = np.frombuffer(b, "<u8", count=n_stripes * 8, offset=tail).reshape(n_stripes, 8)
        acc += _stripe_sums(part, _STRIPE_KEYS[:n_stripes])
    last = np.frombuffer(b, "<u8", count=8, offset=n - _STRIPE)[None]
    acc += _stripe_sums(last, np.frombuffer(SECRET, "<u8", count=8, offset=192 - 64 - 7)[None])
    lanes = [int(v) for v in acc]
    h = n * P64_1
    for i in range(4):
        h += _mul_fold(lanes[2 * i] ^ _r64(SECRET, 11 + 16 * i),
                       lanes[2 * i + 1] ^ _r64(SECRET, 19 + 16 * i))
    return _avalanche(h & _M64)


def xxh3_64(data: bytes) -> int:
    data = bytes(data)
    return _short(data) if len(data) <= 240 else _long(data)


def xxh3_64_hexdigest(data: bytes) -> str:
    return f"{xxh3_64(data):016x}"
