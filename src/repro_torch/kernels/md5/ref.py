"""Plain PyTorch version of the MD5 benchmark (SHOC; paper §4.2).

SHOC's MD5Hash generates *n* candidate keys, hashes each with MD5, and
searches for a target digest (``reduce(min)`` over matching indices).  The
messages are 8 bytes, two little-endian uint32 words (the key index and the
index xor 0x9E3779B9), which fill exactly one padded 512-bit MD5 block, so
the full 64-round compression function runs per message.  Pure compute,
zero data: the paper's purest compute-scaling benchmark.

PyTorch has little uint32 arithmetic, so words are held in int64 and
masked to 32 bits wherever a bit above 31 could change the result (before
a rotate, after an add that is carried on, at the end).
"""

from __future__ import annotations

import torch

from ...device import resolve_device

MASK = 0xFFFFFFFF
#: the second message word is the key xor this constant
KEY_XOR = 0x9E3779B9

# Per-round shift amounts and sine constants (RFC 1321).
_S = (
    [7, 12, 17, 22] * 4
    + [5, 9, 14, 20] * 4
    + [4, 11, 16, 23] * 4
    + [6, 10, 15, 21] * 4
)
_K = [
    0xD76AA478, 0xE8C7B756, 0x242070DB, 0xC1BDCEEE,
    0xF57C0FAF, 0x4787C62A, 0xA8304613, 0xFD469501,
    0x698098D8, 0x8B44F7AF, 0xFFFF5BB1, 0x895CD7BE,
    0x6B901122, 0xFD987193, 0xA679438E, 0x49B40821,
    0xF61E2562, 0xC040B340, 0x265E5A51, 0xE9B6C7AA,
    0xD62F105D, 0x02441453, 0xD8A1E681, 0xE7D3FBC8,
    0x21E1CDE6, 0xC33707D6, 0xF4D50D87, 0x455A14ED,
    0xA9E3E905, 0xFCEFA3F8, 0x676F02D9, 0x8D2A4C8A,
    0xFFFA3942, 0x8771F681, 0x6D9D6122, 0xFDE5380C,
    0xA4BEEA44, 0x4BDECFA9, 0xF6BB4B60, 0xBEBFBC70,
    0x289B7EC6, 0xEAA127FA, 0xD4EF3085, 0x04881D05,
    0xD9D4D039, 0xE6DB99E5, 0x1FA27CF8, 0xC4AC5665,
    0xF4292244, 0x432AFF97, 0xAB9423A7, 0xFC93A039,
    0x655B59C3, 0x8F0CCC92, 0xFFEFF47D, 0x85845DD1,
    0x6FA87E4F, 0xFE2CE6E0, 0xA3014314, 0x4E0811A1,
    0xF7537E82, 0xBD3AF235, 0x2AD7D2BB, 0xEB86D391,
]
_INIT = (0x67452301, 0xEFCDAB89, 0x98BADCFE, 0x10325476)

#: keys hashed at a time by ``md5_search_ref``: its int64 temporaries stay
#: at 128 MiB each whatever n is
SLAB_KEYS = 1 << 24


def word_index(i: int) -> int:
    """The message word that round ``i`` adds (RFC 1321)."""
    if i < 16:
        return i
    if i < 32:
        return (5 * i + 1) % 16
    if i < 48:
        return (3 * i + 5) % 16
    return (7 * i) % 16


def _rotl(x: torch.Tensor, s: int) -> torch.Tensor:
    x = x & MASK
    return ((x << s) | (x >> (32 - s))) & MASK


def md5_u32x2(w0: torch.Tensor, w1: torch.Tensor) -> tuple[torch.Tensor, ...]:
    """MD5 digest (a, b, c, d, int64 tensors holding uint32 values) of the
    8-byte message [w0, w1].

    Message block: w0, w1, 0x80 padding word, zeros, bit length (64) in
    words 14-15.
    """
    w0 = w0.to(torch.int64) & MASK
    w1 = w1.to(torch.int64) & MASK
    m = [w0, w1, 0x80] + [0] * 11 + [64, 0]
    a, b, c, d = (torch.full_like(w0, v) for v in _INIT)

    for i in range(64):
        if i < 16:
            f = (b & c) | (~b & d)
        elif i < 32:
            f = (d & b) | (~d & c)
        elif i < 48:
            f = b ^ c ^ d
        else:
            f = c ^ (b | ~d)
        tmp = d
        d = c
        c = b
        add = a + f + _K[i] + m[word_index(i)]
        b = (b + _rotl(add, _S[i])) & MASK
        a = tmp
    return tuple((v + init) & MASK for v, init in zip((a, b, c, d), _INIT))


def md5_search_ref(
    n: int,
    target: tuple[int, int, int, int],
    key_offset: int = 0,
    *,
    device: torch.device | str | None = None,
) -> torch.Tensor:
    """Hash keys [offset, offset+n) and return the smallest matching index
    (or n if none matches) as a 0-d int32 tensor: SHOC's FindKeyWithDigest
    semantics.  Keys are hashed ``SLAB_KEYS`` at a time.  ``device=None``
    means the GPU, and fails where there is none."""
    device = resolve_device(device)
    tgt = [int(t) & MASK for t in target]
    best = n
    for lo in range(0, n, SLAB_KEYS):
        hi = min(n, lo + SLAB_KEYS)
        idx = torch.arange(lo, hi, dtype=torch.int64, device=device)
        w0 = (idx + key_offset) & MASK
        a, b, c, d = md5_u32x2(w0, w0 ^ KEY_XOR)
        hit = (a == tgt[0]) & (b == tgt[1]) & (c == tgt[2]) & (d == tgt[3])
        found = torch.where(hit, idx, n).min()
        if int(found) < n:  # the first slab with a hit holds the smallest
            best = int(found)
            break
    return torch.tensor(best, dtype=torch.int32, device=device)
