"""The checkpoint's DEFLATE encoder and its plain version
(:func:`deflate_fixed`, ``csrc/deflate.cu``), a port-only kernel for the
production hooks: the raw DEFLATE stream of one fixed-code block and the
CRC-32 of a member of the checkpoint's ``.npz``, so that the host writes
only the zip container around it (``io/checkpoint.py``).
"""

from __future__ import annotations

import ctypes
import functools
from typing import Tuple

import torch

from fastslam_tpu_torch.core.cuda_kernels._launch import launch, ptr, require_cuda

# the farthest back a DEFLATE match reaches (RFC 1951; csrc/deflate.cu MAX_DISTANCE)
DEFLATE_WINDOW = 32768
# a segment holds whole rows, at least this many bytes
DEFLATE_MIN_SEGMENT = 256
# a segment's bytes where no row distance applies
DEFLATE_PLAIN_SEGMENT = 1024
_CRC_POLY = 0xEDB88320
_U32 = 0xFFFFFFFF
# a word's token kinds (csrc/deflate.cu LIT, ROW, RUN)
_LIT, _ROW, _RUN = 0, 1, 2


def deflate_layout(row_bytes: int) -> Tuple[int, int]:
    """``(segment_bytes, distance)`` of a member made of rows of
    ``row_bytes``: segments of whole rows, at least
    :data:`DEFLATE_MIN_SEGMENT` bytes, matched at the row distance; segments
    of :data:`DEFLATE_PLAIN_SEGMENT` bytes and no row distance where the rows
    are no multiple of 4 bytes or lie past the window, or for ``row_bytes``
    0 (no rows: the planes layout's ``[L, P]`` planes)."""
    if row_bytes <= 0 or row_bytes % 4 or row_bytes > DEFLATE_WINDOW:
        return DEFLATE_PLAIN_SEGMENT, 0
    return row_bytes * -(-DEFLATE_MIN_SEGMENT // row_bytes), row_bytes


def deflate_stream_words(nbytes: int) -> int:
    """32-bit words of a stream buffer for ``nbytes`` bytes: 9 bits a byte
    at worst, with the block header and the end-of-block code."""
    return (9 * nbytes + 41) // 32 + 1


def _reversed(code: int, n: int) -> int:
    return int(format(code, f"0{n}b")[::-1], 2)


def _length_code(n: int) -> Tuple[int, int]:
    """``(bits, count)`` of a match length of 3 to 258 bytes: its fixed
    Huffman code, reversed, then its extra bits."""
    if n == 258:
        sym, ext, extra = 285, 0, 0
    elif n <= 10:
        sym, ext, extra = 254 + n, 0, 0
    else:
        x = n - 3
        ext = x.bit_length() - 3
        sym, extra = 257 + 4 * (ext + 1) + (x >> ext) - 4, x & ((1 << ext) - 1)
    code, clen = (sym - 256, 7) if sym < 280 else (0xC0 + sym - 280, 8)
    return _reversed(code, clen) | extra << clen, clen + ext


def _distance_code(d: int) -> Tuple[int, int]:
    """``(bits, count)`` of a match distance of 1 to 32768: its 5-bit code,
    reversed, then its extra bits."""
    x = d - 1
    if x < 4:
        sym, ext, extra = x, 0, 0
    else:
        lg = x.bit_length() - 1
        ext = lg - 1
        sym, extra = 2 * lg + ((x >> ext) & 1), x & ((1 << ext) - 1)
    return _reversed(sym, 5) | extra << 5, 5 + ext


def _multmodp(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a * b`` modulo the CRC-32 polynomial, elementwise, in zlib's
    reflected representation (bit 31 is x^0), as ``csrc/deflate.cu``."""
    p = torch.zeros_like(b)
    m = 1 << 31
    for _ in range(32):
        p = torch.where((a & m) != 0, p ^ b, p)
        b = torch.where((b & 1) != 0, (b >> 1) ^ _CRC_POLY, b >> 1)
        m >>= 1
    return p


@functools.lru_cache(maxsize=None)
def _x2n_table() -> Tuple[int, ...]:
    """``x^(2^k)`` modulo the polynomial, k = 0 .. 31."""
    p = torch.tensor([1 << 30], dtype=torch.int64)   # x^1
    table = [int(p)]
    for _ in range(31):
        p = _multmodp(p, p)
        table.append(int(p))
    return tuple(table)


def _x2nmodp(n: torch.Tensor, k: int) -> torch.Tensor:
    """``x^(n * 2^k)`` modulo the polynomial, elementwise: with k = 3 the
    shift over ``n`` bytes."""
    x2n = _x2n_table()
    p = torch.full_like(n, 1 << 31)                   # x^0
    bit = 0
    while bool(((n >> bit) != 0).any()):
        take = ((n >> bit) & 1) != 0
        p = torch.where(take, _multmodp(torch.full_like(n, x2n[(k + bit) & 31]), p), p)
        bit += 1
    return p


def _crc_tables() -> torch.Tensor:
    """int64 ``[4, 256]``: the slicing-by-4 tables of the reflected CRC-32."""
    t = torch.arange(256, dtype=torch.int64)
    for _ in range(8):
        t = torch.where((t & 1) != 0, (t >> 1) ^ _CRC_POLY, t >> 1)
    tables = [t]
    for _ in range(3):
        tables.append((tables[-1] >> 8) ^ t[tables[-1] & 0xFF])
    return torch.stack(tables)


def _deflate_bytes(data: torch.Tensor) -> int:
    if data.nbytes % 4:
        raise ValueError(f"the encoder takes whole 4-byte words, got {data.nbytes} bytes")
    return data.nbytes


def deflate_fixed_ref(data: torch.Tensor, row_bytes: int,
                      seed_crc: int = 0) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of :func:`deflate_fixed`: the same segments, tokens,
    bits and CRC fold, looping over a segment's word positions, vectorised
    over the segments (a segment's bits go to its place after the scan of
    every segment's count)."""
    nbytes = _deflate_bytes(data)
    seg_bytes, distance = deflate_layout(row_bytes)
    words = data.reshape(-1).view(torch.uint8).view(torch.int32).to(torch.int64) & _U32
    nw, sw, dw = words.numel(), seg_bytes // 4, distance // 4
    nseg = -(-nw // sw)
    # each word's kind: the first of a match one row back, a run of the byte
    # before it, literals
    row = torch.zeros(nw, dtype=torch.bool)
    if dw:
        row[dw:] = words[dw:] == words[:-dw]
    run = torch.zeros(nw, dtype=torch.bool)
    run[1:] = words[1:] == (words[:-1] >> 24) * 0x01010101
    kind = torch.where(row, _ROW, torch.where(run, _RUN, _LIT))
    pad = nseg * sw - nw
    kinds = torch.cat([kind, torch.full((pad,), -1, dtype=torch.int64)]).view(nseg, sw)
    wmat = torch.cat([words, torch.zeros(pad, dtype=torch.int64)]).view(nseg, sw)
    seg_len = torch.clamp(nw - torch.arange(nseg) * sw, max=sw)

    lit_bits, lit_n = (torch.tensor(v, dtype=torch.int64) for v in zip(*(
        (_reversed(0x30 + b, 8), 8) if b < 144 else (_reversed(0x190 + b - 144, 9), 9)
        for b in range(256))))
    # indexed by the length, 3 to 258
    len_bits, len_n = (torch.tensor(v, dtype=torch.int64) for v in zip(
        (0, 0), (0, 0), (0, 0), *(_length_code(n) for n in range(3, 259))))
    dist_code = {_ROW: _distance_code(distance) if distance else (0, 0),
                 _RUN: _distance_code(1)}
    pending = torch.zeros(nseg, dtype=torch.int64)    # the open match's kind
    length = torch.zeros(nseg, dtype=torch.int64)     # and its bytes
    pos = torch.zeros(nseg, dtype=torch.int64)        # bits so far, by segment
    row_bytes_matched = 0
    emitted = []                                      # (segment, first bit, bits)

    def emit(seg, bits, count):
        emitted.append((seg, pos[seg], bits))
        pos[seg] += count

    def close(mask):
        nonlocal row_bytes_matched
        seg = mask.nonzero().flatten()
        if not seg.numel():
            return
        rows, rem = pending[seg] == _ROW, length[seg].clone()
        row_bytes_matched += int(rem[rows].sum())
        dbits = torch.where(rows, dist_code[_ROW][0], dist_code[_RUN][0])
        dn = torch.where(rows, dist_code[_ROW][1], dist_code[_RUN][1])
        while bool((rem > 0).any()):
            on = rem > 0
            piece = torch.where(rem > 258, torch.clamp(rem - 3, max=258), rem)[on]
            emit(seg[on], len_bits[piece] | (dbits[on] << len_n[piece]), len_n[piece] + dn[on])
            rem[on] -= piece
        pending[seg] = _LIT

    for k in range(sw):
        now, v = kinds[:, k], wmat[:, k]
        lit = now == _LIT
        match = now > _LIT
        close((lit | (match & (now != pending))) & (pending != _LIT))
        seg = lit.nonzero().flatten()
        if seg.numel():
            b = [(v[seg] >> s) & 0xFF for s in (0, 8, 16, 24)]
            n = [lit_n[x] for x in b]
            emit(seg, lit_bits[b[0]] | lit_bits[b[1]] << n[0] | lit_bits[b[2]] << (n[0] + n[1])
                 | lit_bits[b[3]] << (n[0] + n[1] + n[2]), n[0] + n[1] + n[2] + n[3])
        length = torch.where(match & (now == pending), length + 4,
                             torch.where(match, 4, length))
        pending = torch.where(match, now, pending)
        close((seg_len == k + 1) & (pending != _LIT))

    # each segment's first bit, after the 3 bits of the block header
    offsets = 3 + torch.cumsum(pos, 0) - pos
    total = 3 + int(pos.sum()) + 7                    # and the end-of-block code
    out = torch.zeros(deflate_stream_words(nbytes) + 1, dtype=torch.int64)
    if emitted:
        seg, rel, bits = (torch.cat(x) for x in zip(*emitted))
        at = offsets[seg] + rel

        def place(value, at):   # value < 2^32: its bits disjoint from all others'
            shifted = value << (at & 31)
            out.index_add_(0, at >> 5, shifted & _U32)
            out.index_add_(0, (at >> 5) + 1, shifted >> 32)
        place(bits & _U32, at)
        place(bits >> 32, at + 32)
    out[0] += 3                                       # BFINAL 1, BTYPE 01
    stream = torch.stack([(out[:-1] >> s) & 0xFF for s in (0, 8, 16, 24)], 1)

    # each segment's CRC-32 (slicing by 4), shifted over the bytes after it
    tables = _crc_tables()
    crc = torch.full((nseg,), _U32, dtype=torch.int64)
    for k in range(sw):
        x = crc ^ wmat[:, k]
        step = (tables[3][x & 0xFF] ^ tables[2][(x >> 8) & 0xFF] ^ tables[1][(x >> 16) & 0xFF]
                ^ tables[0][x >> 24])
        crc = torch.where(k < seg_len, step, crc)
    end = torch.clamp((torch.arange(nseg) + 1) * sw, max=nw)
    folded = _multmodp(_x2nmodp(4 * (nw - end), 3), crc ^ _U32)
    fold = int((((folded[:, None] >> torch.arange(32)) & 1).sum(0) % 2 << torch.arange(32)).sum())
    seed = torch.tensor([seed_crc & _U32], dtype=torch.int64)
    member_crc = int(_multmodp(_x2nmodp(torch.tensor([nbytes]), 3), seed)) ^ fold
    return (stream.to(torch.uint8).reshape(-1),
            torch.tensor([total, member_crc, row_bytes_matched], dtype=torch.int64))


def deflate_fixed(data: torch.Tensor, row_bytes: int,
                  seed_crc: int = 0) -> Tuple[torch.Tensor, torch.Tensor]:
    """The raw DEFLATE stream (RFC 1951) of ``data``'s bytes and their
    CRC-32, for a member of the checkpoint's ``.npz``.

    Args:
      data: a contiguous tensor of any dtype, a whole number of 4-byte
        words, 4-byte aligned.
      row_bytes: the bytes of one row (one particle's slice; 0 for none),
        whose previous row the encoder matches (:func:`deflate_layout`).
      seed_crc: the CRC-32 of what precedes the bytes in the member (its
        ``.npy`` header).

    Returns ``(stream, info)``: ``stream`` uint8, of
    ``4 * deflate_stream_words(nbytes)`` bytes on ``data``'s device, whose
    first ``ceil(info[0] / 8)`` bytes are one final block of fixed Huffman
    codes and the rest zeros; ``info`` int64 ``[3]`` on the same device:
    the stream's length in bits, the CRC-32 of the member (seeded with
    ``seed_crc``) and the bytes that matches at the row distance cover.  On
    CUDA one call of ``deflate_fixed_launch`` (count, scan, write) and no
    host sync; the stream and scratch come from ``torch.empty``, so the
    caching allocator hands the same blocks to the next checkpoint.
    """
    if data.device.type == "cpu":
        return deflate_fixed_ref(data, row_bytes, seed_crc)
    device = require_cuda(data)
    nbytes = _deflate_bytes(data)
    if data.data_ptr() % 4:
        raise ValueError("the encoder reads 4-byte aligned words")
    seg_bytes, distance = deflate_layout(row_bytes)
    segments = -(-(nbytes // 4) // (seg_bytes // 4))
    stream = torch.empty(deflate_stream_words(nbytes), dtype=torch.int32, device=device)
    scratch = torch.empty(max(segments, 1), dtype=torch.int64, device=device)
    info = torch.empty(4, dtype=torch.int64, device=device)
    # the seed's 32 bits as a C int (ctypes does not range-check)
    launch("deflate_fixed", device, ptr(data), ctypes.c_longlong(nbytes),
           ctypes.c_int(seg_bytes), ctypes.c_int(distance), ctypes.c_int(seed_crc),
           ptr(scratch), ptr(stream), ctypes.c_longlong(stream.numel()), ptr(info))
    return stream.view(torch.uint8), info[:3]
