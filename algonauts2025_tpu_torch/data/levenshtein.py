"""Levenshtein edit scripts in the standard library and NumPy.

``opcodes(a, b)`` returns the same 5-tuples as ``Levenshtein.opcodes`` (the
python-Levenshtein package over rapidfuzz's C++), so ``match_list`` aligns
transcripts exactly as the JAX package does, without either package.

The C++ picks one of the many optimal edit scripts by how it searches, and
this module searches the same way:

- the common prefix and suffix are stripped first, at every level;
- a small problem is solved whole: Hyyrö's bit-parallel distance matrix (one
  Python integer per row of ``b``, a bit per symbol of ``a``) and a backtrace
  from the end that prefers a deletion, then an insertion, then the diagonal;
- a large one (more than 2**20 bytes of matrix for the band it would need) is
  split Hirschberg-style: ``b`` at its middle, ``a`` at the first position
  where the forward row of the first half plus the backward row of the
  second half is least; the halves are solved in turn with their own scores
  as bounds.  This is what makes long inputs differ from a plain backtrace.
"""

from __future__ import annotations

import typing as tp

import numpy as np

__all__ = ["editops", "opcodes"]

Editop = tuple[str, int, int]
Opcode = tuple[str, int, int, int, int]

#: the C++ solves a problem whole below this many bytes of (VP, VN) matrix
_MATRIX_BYTES = 1024 * 1024


def _pattern(s: str) -> dict[str, int]:
    """Bit masks of the positions of each symbol of ``s``."""
    pm: dict[str, int] = {}
    bit = 1
    for ch in s:
        pm[ch] = pm.get(ch, 0) | bit
        bit <<= 1
    return pm


def _hyyro(s1: str, s2: str, record: bool) -> tuple[int, int, list[int], list[int]]:
    """Run Hyyrö's algorithm with ``s1`` as the pattern over every symbol of
    ``s2``.  Returns the last row's (VP, VN) and, with ``record``, every
    row's: bit ``i`` of VP (VN) is set where D[i+1][j] - D[i][j] is +1 (-1),
    D[i][j] being the distance of s1[:i] to s2[:j]."""
    full = (1 << len(s1)) - 1
    vp, vn = full, 0
    pm_get = _pattern(s1).get
    vps: list[int] = []
    vns: list[int] = []
    for ch in s2:
        x = pm_get(ch, 0)
        d0 = (((x & vp) + vp) ^ vp) | x | vn
        hp = vn | ~(d0 | vp)
        hn = d0 & vp
        hp = (hp << 1) | 1
        hn <<= 1
        vp = (hn | ~(d0 | hp)) & full
        vn = hp & d0 & full
        if record:
            vps.append(vp)
            vns.append(vn)
    return vp, vn, vps, vns


def _bits(v: int, n: int) -> np.ndarray:
    """The low ``n`` bits of ``v`` as an int64 array, bit 0 first."""
    raw = np.frombuffer(v.to_bytes((n + 7) // 8 or 1, "little"), dtype=np.uint8)
    return np.unpackbits(raw, bitorder="little")[:n].astype(np.int64)


def _last_row(s1: str, s2: str) -> np.ndarray:
    """D[i][len(s2)] for i = 0 .. len(s1)."""
    vp, vn, _, _ = _hyyro(s1, s2, record=False)
    out = np.empty(len(s1) + 1, dtype=np.int64)
    out[0] = len(s2)
    np.cumsum(_bits(vp, len(s1)) - _bits(vn, len(s1)), out=out[1:])
    out[1:] += len(s2)
    return out


def _affix(s1: str, s2: str) -> tuple[int, int]:
    n = min(len(s1), len(s2))
    pre = 0
    while pre < n and s1[pre] == s2[pre]:
        pre += 1
    suf = 0
    while suf < n - pre and s1[-1 - suf] == s2[-1 - suf]:
        suf += 1
    return pre, suf


def _align(s1: str, s2: str, src: int, dest: int, out: list[Editop]) -> None:
    """The whole-matrix backtrace of a problem with no common affix."""
    if not s1 or not s2:
        out.extend(("delete", src + i, dest) for i in range(len(s1)))
        out.extend(("insert", src, dest + j) for j in range(len(s2)))
        return
    _, _, vps, vns = _hyyro(s1, s2, record=True)
    ops: list[Editop] = []
    col, row = len(s1), len(s2)
    while row and col:
        if (vps[row - 1] >> (col - 1)) & 1:
            col -= 1
            ops.append(("delete", src + col, dest + row))
            continue
        row -= 1
        if row and (vns[row - 1] >> (col - 1)) & 1:
            ops.append(("insert", src + col, dest + row))
            continue
        col -= 1
        if s1[col] != s2[row]:
            ops.append(("replace", src + col, dest + row))
    while col:
        col -= 1
        ops.append(("delete", src + col, dest + row))
    while row:
        row -= 1
        ops.append(("insert", src + col, dest + row))
    out.extend(reversed(ops))


def _split(s1: str, s2: str) -> tuple[int, int, int, int]:
    """(s1_mid, s2_mid, left score, right score) of the Hirschberg split."""
    s2_mid = len(s2) // 2
    left = _last_row(s1, s2[:s2_mid])
    right = _last_row(s1[::-1], s2[s2_mid:][::-1])
    # candidates s1_mid = 1 .. len(s1); the first least total wins
    total = left[1:] + right[::-1][1:]
    k = int(np.argmin(total))
    s1_mid = k + 1
    return s1_mid, s2_mid, int(left[s1_mid]), int(right[len(s1) - s1_mid])


def _solve(s1: str, s2: str, src: int, dest: int, bound: int, out: list[Editop]) -> None:
    pre, suf = _affix(s1, s2)
    s1 = s1[pre : len(s1) - suf]
    s2 = s2[pre : len(s2) - suf]
    src += pre
    dest += pre
    bound = min(bound, max(len(s1), len(s2)))
    band = min(len(s1), 2 * bound + 1)
    if 2 * band * len(s2) // 8 < _MATRIX_BYTES or len(s1) < 65 or len(s2) < 10:
        _align(s1, s2, src, dest, out)
        return
    s1_mid, s2_mid, left, right = _split(s1, s2)
    _solve(s1[:s1_mid], s2[:s2_mid], src, dest, left, out)
    _solve(s1[s1_mid:], s2[s2_mid:], src + s1_mid, dest + s2_mid, right, out)


def editops(s1: str, s2: str) -> list[Editop]:
    """(tag, src_pos, dest_pos) edit operations turning ``s1`` into ``s2``."""
    out: list[Editop] = []
    _solve(s1, s2, 0, 0, max(len(s1), len(s2)), out)
    return out


def opcodes(s1: str, s2: str) -> list[Opcode]:
    """(tag, i1, i2, j1, j2) blocks turning ``s1`` into ``s2``: the equal
    stretches between edit operations, and runs of one kind of operation
    merged, as ``Levenshtein.opcodes`` gives them."""
    ops = editops(s1, s2)
    blocks: list[Opcode] = []
    src = dest = i = 0
    while i < len(ops):
        tag, op_src, op_dest = ops[i]
        if src < op_src or dest < op_dest:
            blocks.append(("equal", src, op_src, dest, op_dest))
            src, dest = op_src, op_dest
        src0, dest0 = src, dest
        while i < len(ops) and ops[i] == (tag, src, dest):
            src += tag != "insert"
            dest += tag != "delete"
            i += 1
        blocks.append((tag, src0, src, dest0, dest))
    if src < len(s1) or dest < len(s2):
        blocks.append(("equal", src, len(s1), dest, len(s2)))
    return blocks
