"""HDF5 files in NumPy and the standard library: a reader and a writer.

The reader covers what h5py 3.x writes for a flat file of datasets (the
Algonauts release holds one 2-D dataset per run in each subject's file):

- ``libver="earliest"``: superblock v0/v1, version-1 object headers, a
  symbol-table root group (a version-1 B-tree of symbol nodes over a local
  heap, any depth);
- ``libver="latest"``: superblock v2/v3, version-2 object headers, links
  held compactly in the header or densely in a fractal heap indexed by a
  version-2 B-tree;
- compact, contiguous and chunked layouts; chunks indexed by a version-1
  B-tree, a single chunk or a fixed array, with no filter, ``gzip`` or
  ``shuffle`` + ``gzip``;
- little-endian integers and floats.

Anything else raises ``NotImplementedError`` naming what it met; nothing is
ever returned in part.  The writer writes the earliest format: superblock
v0, one symbol-table root group, contiguous datasets.
"""

from __future__ import annotations

import bisect
import contextlib
import mmap
import os
import struct
import typing as tp
import zlib
from pathlib import Path

import numpy as np

__all__ = ["keys", "read", "read_all", "write"]

_SIGNATURE = b"\x89HDF\r\n\x1a\n"
_UNDEF = 0xFFFFFFFFFFFFFFFF

# object header message types
_DATASPACE, _LINK_INFO, _DATATYPE, _LINK, _EXTERNAL = 0x01, 0x02, 0x03, 0x06, 0x07
_LAYOUT, _FILTERS, _CONTINUATION, _SYMBOL_TABLE = 0x08, 0x0B, 0x10, 0x11
_FILTER_NAMES = {1: "deflate", 2: "shuffle", 3: "fletcher32", 4: "szip", 5: "nbit",
                 6: "scaleoffset", 32000: "lzf"}


def _uint(buf: bytes | bytes, pos: int, size: int) -> int:
    return int.from_bytes(buf[pos : pos + size], "little")


def _enc_size(n: int) -> int:
    """Bytes HDF5 gives a field that counts up to ``n`` (H5VM_limit_enc_size)."""
    return (max(n, 1).bit_length() - 1) // 8 + 1


class _Reader:
    """One open file: the parsed superblock and the root group's links."""

    def __init__(self, path: str | os.PathLike):
        with open(path, "rb") as f:
            size = os.fstat(f.fileno()).st_size
            self.buf = mmap.mmap(f.fileno(), 0, access=mmap.ACCESS_READ) if size else b""
        self.path = str(path)
        start = next((p for p in [0] + [512 << k for k in range(20)]
                      if self.buf[p : p + 8] == _SIGNATURE), None)
        if start is None:
            raise ValueError(f"{path} is not an HDF5 file")
        version = self.buf[start + 8]
        if version in (0, 1):
            sizes = self.buf[start + 13], self.buf[start + 14]
            pos = start + 24 + (4 if version == 1 else 0)
            self.base = self._u8(pos)
            root = self._u8(pos + 32 + 8)  # the root entry's object header address
        elif version in (2, 3):
            sizes = self.buf[start + 9], self.buf[start + 10]
            self.base = self._u8(start + 12)
            root = self._u8(start + 36)
        else:
            raise NotImplementedError(f"HDF5 superblock version {version}")
        if sizes != (8, 8):
            raise NotImplementedError(f"HDF5 offsets / lengths of {sizes} bytes (only 8, 8)")
        self.root = root

    def close(self) -> None:
        if isinstance(self.buf, mmap.mmap):
            self.buf.close()

    def _u8(self, pos: int) -> int:
        return struct.unpack_from("<Q", self.buf, pos)[0]

    def _addr(self, pos: int) -> int:
        a = self._u8(pos)
        return a if a == _UNDEF else a + self.base

    def _expect(self, pos: int, sig: bytes) -> None:
        if self.buf[pos : pos + 4] != sig:
            raise ValueError(f"{self.path}: expected {sig!r} at {pos}, found "
                             f"{bytes(self.buf[pos:pos + 4])!r}")

    # -- object headers ---------------------------------------------------
    def messages(self, addr: int) -> list[tuple[int, bytes]]:
        """Every (type, body) message of the object header at ``addr``."""
        buf = self.buf
        out: list[tuple[int, bytes]] = []
        if buf[addr : addr + 4] == b"OHDR":
            version = buf[addr + 4]
            if version != 2:
                raise NotImplementedError(f"object header version {version}")
            flags = buf[addr + 5]
            pos = addr + 6 + (16 if flags & 0x20 else 0) + (4 if flags & 0x10 else 0)
            width = 1 << (flags & 3)
            size = _uint(buf, pos, width)
            blocks = [(pos + width, pos + width + size)]
            head = 6 if flags & 0x04 else 4
            while blocks:
                pos, end = blocks.pop(0)
                while pos + head <= end:
                    mtype, msize = buf[pos], _uint(buf, pos + 1, 2)
                    body = buf[pos + head : pos + head + msize]
                    pos += head + msize
                    if mtype == _CONTINUATION:
                        start, length = self._addr_of(body, 0), _uint(body, 8, 8)
                        self._expect(start, b"OCHK")
                        blocks.append((start + 4, start + length - 4))
                    elif mtype:
                        out.append((mtype, body))
            return out
        version = buf[addr]
        if version != 1:
            raise NotImplementedError(f"object header version {version}")
        n_messages = _uint(buf, addr + 2, 2)
        blocks = [(addr + 16, addr + 16 + _uint(buf, addr + 8, 4))]
        while blocks and len(out) < n_messages:
            pos, end = blocks.pop(0)
            while pos + 8 <= end:
                mtype, msize = _uint(buf, pos, 2), _uint(buf, pos + 2, 2)
                body = buf[pos + 8 : pos + 8 + msize]
                pos += 8 + msize
                if mtype == _CONTINUATION:
                    blocks.append((self._addr_of(body, 0),
                                   self._addr_of(body, 0) + _uint(body, 8, 8)))
                elif mtype:
                    out.append((mtype, body))
        return out

    def _addr_of(self, body: bytes, pos: int) -> int:
        a = _uint(body, pos, 8)
        return a if a == _UNDEF else a + self.base

    # -- groups -----------------------------------------------------------
    def links(self, addr: int) -> dict[str, int]:
        """{name: object header address} of the group at ``addr``."""
        msgs = self.messages(addr)
        out: dict[str, int] = {}
        for mtype, body in msgs:
            if mtype == _SYMBOL_TABLE:
                heap = self._local_heap(self._addr_of(body, 8))
                self._symbol_btree(self._addr_of(body, 0), heap, out)
            elif mtype == _LINK:
                name, target = self._link(body)
                out[name] = target
            elif mtype == _LINK_INFO:
                flags = body[1]
                pos = 2 + (8 if flags & 1 else 0)
                fheap, btree = self._addr_of(body, pos), self._addr_of(body, pos + 8)
                if fheap != _UNDEF:
                    heap = _FractalHeap(self, fheap)
                    for record in self._btree2_records(btree):
                        name, target = self._link(heap.get(record[4:]))
                        out[name] = target
        return out

    def _link(self, body: bytes | bytes) -> tuple[str, int]:
        if body[0] != 1:
            raise NotImplementedError(f"link message version {body[0]}")
        flags = body[1]
        pos = 2
        link_type = 0
        if flags & 0x08:
            link_type = body[pos]
            pos += 1
        if flags & 0x04:
            pos += 8
        if flags & 0x10:
            pos += 1
        width = 1 << (flags & 3)
        length = _uint(body, pos, width)
        pos += width
        name = bytes(body[pos : pos + length]).decode("utf-8")
        if link_type != 0:
            raise NotImplementedError(f"link {name!r}: soft or external link (type {link_type})")
        return name, self._addr_of(body, pos + length)

    def _local_heap(self, addr: int) -> int:
        self._expect(addr, b"HEAP")
        return self._addr(addr + 24)

    def _symbol_btree(self, addr: int, heap: int, out: dict[str, int]) -> None:
        self._expect(addr, b"TREE")
        node_type, level, used = self.buf[addr + 4], self.buf[addr + 5], _uint(self.buf, addr + 6, 2)
        if node_type != 0:
            raise ValueError(f"{self.path}: group B-tree node of type {node_type}")
        for k in range(used):
            child = self._addr(addr + 24 + 8 + 16 * k)
            if level:
                self._symbol_btree(child, heap, out)
                continue
            self._expect(child, b"SNOD")
            for e in range(_uint(self.buf, child + 6, 2)):
                entry = child + 8 + 40 * e
                name_at = heap + self._u8(entry)
                name = bytes(self.buf[name_at : self.buf.find(b"\0", name_at)]).decode("utf-8")
                out[name] = self._addr(entry + 8)

    def _btree2_records(self, addr: int) -> list[bytes]:
        """Every record of the version-2 B-tree at ``addr``, in order."""
        buf = self.buf
        self._expect(addr, b"BTHD")
        node_size, rec_size = _uint(buf, addr + 6, 4), _uint(buf, addr + 10, 2)
        depth, root = _uint(buf, addr + 12, 2), self._addr(addr + 16)
        root_n = _uint(buf, addr + 24, 2)
        # per-level record capacity and field widths (H5B2__hdr_init)
        max_n = [(node_size - 10) // rec_size]
        cum_n = [max_n[0]]
        n_size = _enc_size(max_n[0])
        cum_size = [0]
        for d in range(1, depth + 1):
            pointer = 8 + n_size + (cum_size[d - 1] if d > 1 else 0)
            max_n.append((node_size - (10 + pointer)) // (rec_size + pointer))
            cum_n.append((max_n[d] + 1) * cum_n[d - 1] + max_n[d])
            cum_size.append(_enc_size(cum_n[d]))
        out: list[bytes] = []

        def walk(node: int, n: int, d: int) -> None:
            if root == _UNDEF or n == 0:
                return
            records = node + 6
            if d == 0:
                self._expect(node, b"BTLF")
                out.extend(buf[records + i * rec_size : records + (i + 1) * rec_size]
                           for i in range(n))
                return
            self._expect(node, b"BTIN")
            pos = records + n * rec_size
            width = 8 + n_size + (cum_size[d - 1] if d > 1 else 0)
            for i in range(n + 1):
                child = self._addr(pos + i * width)
                walk(child, _uint(buf, pos + i * width + 8, n_size), d - 1)
                if i < n:
                    out.append(buf[records + i * rec_size : records + (i + 1) * rec_size])

        walk(root, root_n, depth)
        return out

    # -- datasets ---------------------------------------------------------
    def dataset(self, addr: int, name: str) -> np.ndarray:
        msgs = dict(self.messages(addr))
        if _EXTERNAL in msgs:
            raise NotImplementedError(f"dataset {name!r}: external data files")
        if _LAYOUT not in msgs:
            raise NotImplementedError(f"{name!r} is not a dataset")
        shape = _dataspace(msgs[_DATASPACE], name)
        dtype = _datatype(msgs[_DATATYPE], name)
        filters = _filters(msgs[_FILTERS], name) if _FILTERS in msgs else []
        layout = msgs[_LAYOUT]
        version, cls = layout[0], layout[1]
        if version not in (3, 4):
            raise NotImplementedError(f"dataset {name!r}: layout message version {version}")
        count = int(np.prod(shape, dtype=np.int64))
        if cls == 0:  # compact
            size = _uint(layout, 2, 2)
            return np.frombuffer(bytes(layout[4 : 4 + size]), dtype, count).reshape(shape).copy()
        if cls == 1:  # contiguous
            data_at = self._addr_of(layout, 2)
            if data_at == _UNDEF:
                raise NotImplementedError(f"dataset {name!r}: storage never allocated")
            return np.frombuffer(self.buf, dtype, count, data_at).reshape(shape).copy()
        if cls != 2:
            raise NotImplementedError(f"dataset {name!r}: layout class {cls} (virtual)")
        return self._chunked(layout, shape, dtype, filters, name)

    def _chunked(self, layout, shape, dtype, filters, name) -> np.ndarray:
        rank = len(shape)
        if layout[0] == 3:
            ndim = layout[2]
            index_at = self._addr_of(layout, 3)
            chunk = tuple(_uint(layout, 11 + 4 * i, 4) for i in range(ndim - 1))
            chunks = self._chunk_btree(index_at, ndim, name) if index_at != _UNDEF else []
            edge_unfiltered = False
        else:
            flags, ndim, width = layout[2], layout[3], layout[4]
            chunk = tuple(_uint(layout, 5 + width * i, width) for i in range(ndim - 1))
            pos = 5 + width * ndim
            index_type = layout[pos]
            pos += 1
            edge_unfiltered = bool(flags & 1)
            if index_type == 1:  # single chunk
                size = int(np.prod(chunk)) * dtype.itemsize
                mask = 0
                if flags & 2:
                    size, mask = _uint(layout, pos, 8), _uint(layout, pos + 8, 4)
                    pos += 12
                chunks = [((0,) * rank, self._addr_of(layout, pos), size, mask)]
            elif index_type == 3:  # fixed array
                chunks = self._fixed_array(self._addr_of(layout, pos + 1), shape, chunk, dtype)
            else:
                kinds = {2: "implicit", 4: "extensible array", 5: "version-2 B-tree"}
                raise NotImplementedError(
                    f"dataset {name!r}: {kinds.get(index_type, index_type)} chunk index")
        if len(chunk) != rank:
            raise ValueError(f"dataset {name!r}: chunk rank {len(chunk)} for shape {shape}")
        n_chunks = int(np.prod([-(-s // c) for s, c in zip(shape, chunk)]))
        if len(chunks) != n_chunks or any(a == _UNDEF for _, a, _, _ in chunks):
            raise NotImplementedError(
                f"dataset {name!r}: {n_chunks - len(chunks)} of {n_chunks} chunks never written")
        out = np.empty(shape, dtype)
        chunk_bytes = int(np.prod(chunk)) * dtype.itemsize
        for offset, at, size, mask in chunks:
            raw = bytes(self.buf[at : at + size])
            edge = any(o + c > s for o, c, s in zip(offset, chunk, shape))
            if not (edge and edge_unfiltered):
                for k in reversed(range(len(filters))):
                    if not mask >> k & 1:
                        raw = _unfilter(filters[k], raw, dtype.itemsize)
            if len(raw) != chunk_bytes:
                raise ValueError(f"dataset {name!r}: chunk at {offset} holds {len(raw)} bytes")
            block = np.frombuffer(raw, dtype).reshape(chunk)
            dst = tuple(slice(o, min(o + c, s)) for o, c, s in zip(offset, chunk, shape))
            out[dst] = block[tuple(slice(0, d.stop - d.start) for d in dst)]
        return out

    def _chunk_btree(self, addr: int, ndim: int, name: str) -> list[tuple]:
        self._expect(addr, b"TREE")
        node_type, level, used = self.buf[addr + 4], self.buf[addr + 5], _uint(self.buf, addr + 6, 2)
        if node_type != 1:
            raise ValueError(f"dataset {name!r}: chunk B-tree node of type {node_type}")
        key = 8 + 8 * ndim
        out: list[tuple] = []
        for k in range(used):
            pos = addr + 24 + k * (key + 8)
            child = self._addr(pos + key)
            if level:
                out.extend(self._chunk_btree(child, ndim, name))
                continue
            size, mask = _uint(self.buf, pos, 4), _uint(self.buf, pos + 4, 4)
            offset = tuple(self._u8(pos + 8 + 8 * i) for i in range(ndim - 1))
            out.append((offset, child, size, mask))
        return out

    def _fixed_array(self, addr: int, shape, chunk, dtype) -> list[tuple]:
        self._expect(addr, b"FAHD")
        client, entry_size, page_bits = self.buf[addr + 5], self.buf[addr + 6], self.buf[addr + 7]
        n = self._u8(addr + 8)
        block = self._addr(addr + 16)
        if n > 1 << page_bits:
            raise NotImplementedError("fixed-array chunk index split into pages")
        self._expect(block, b"FADB")
        grid = [-(-s // c) for s, c in zip(shape, chunk)]
        pos = block + 6 + 8
        out = []
        size = int(np.prod(chunk)) * dtype.itemsize
        for i in range(n):
            at = self._addr(pos + i * entry_size)
            mask = 0
            if client == 1:  # filtered chunks: address, size, filter mask
                width = entry_size - 12
                size = _uint(self.buf, pos + i * entry_size + 8, width)
                mask = _uint(self.buf, pos + i * entry_size + 8 + width, 4)
            index = np.unravel_index(i, grid)
            out.append((tuple(int(j) * c for j, c in zip(index, chunk)), at, size, mask))
        return out


class _FractalHeap:
    """The managed and tiny objects of a fractal heap (dense link storage)."""

    def __init__(self, f: _Reader, addr: int):
        f._expect(addr, b"FRHP")
        buf = f.buf
        self.f = f
        self.id_len = _uint(buf, addr + 5, 2)
        if _uint(buf, addr + 7, 2):
            raise NotImplementedError("fractal heap with I/O filters")
        self.checksummed = bool(buf[addr + 9] & 2)
        max_managed = _uint(buf, addr + 10, 4)
        pos = addr + 14 + 12 * 8  # past the twelve 8-byte counters and addresses
        self.width = _uint(buf, pos, 2)
        self.start_size = f._u8(pos + 2)
        max_direct = f._u8(pos + 10)
        max_heap_bits = _uint(buf, pos + 18, 2)
        root = f._addr(pos + 22)
        rows = _uint(buf, pos + 30, 2)
        self.off_size = (max_heap_bits + 7) // 8
        self.len_size = min((max_direct.bit_length() - 1 + 7) // 8, _enc_size(max_managed))
        self.max_direct_rows = (max_direct.bit_length() - 1) - (self.start_size.bit_length() - 1) + 2
        self.blocks: list[tuple[int, int, int]] = []  # (heap offset, size, address)
        if root == _UNDEF:
            pass
        elif rows == 0:
            self.blocks.append((0, self.start_size, root))
        else:
            self._indirect(root, rows)
        self.blocks.sort()
        self.starts = [b[0] for b in self.blocks]

    def _indirect(self, addr: int, rows: int) -> None:
        f = self.f
        f._expect(addr, b"FHIB")
        offset = _uint(f.buf, addr + 13, self.off_size)
        pos = addr + 13 + self.off_size
        for r in range(rows):
            size = self.start_size << max(r - 1, 0)
            for _ in range(self.width):
                child = f._addr(pos)
                pos += 8
                if r >= self.max_direct_rows:
                    if child != _UNDEF:
                        raise NotImplementedError("fractal heap with nested indirect blocks")
                elif child != _UNDEF:
                    self.blocks.append((offset, size, child))
                offset += size

    def get(self, heap_id: bytes) -> bytes:
        kind = heap_id[0] >> 4 & 3
        if kind == 2:  # tiny: the object is in the id itself
            return bytes(heap_id[1 : 1 + (heap_id[0] & 0x0F) + 1])
        if kind != 0:
            raise NotImplementedError("fractal heap 'huge' object")
        offset = _uint(heap_id, 1, self.off_size)
        length = _uint(heap_id, 1 + self.off_size, self.len_size)
        k = bisect.bisect_right(self.starts, offset) - 1
        start, size, at = self.blocks[k]
        if not start <= offset < start + size:
            raise ValueError(f"fractal heap object at {offset} in no direct block")
        self.f._expect(at, b"FHDB")
        return bytes(self.f.buf[at + offset - start : at + offset - start + length])


def _dataspace(body: bytes, name: str) -> tuple[int, ...]:
    version, rank = body[0], body[1]
    if version == 1:
        pos = 8
    elif version == 2:
        if body[3] == 2:
            raise NotImplementedError(f"dataset {name!r}: null dataspace")
        pos = 4
    else:
        raise NotImplementedError(f"dataset {name!r}: dataspace version {version}")
    return tuple(_uint(body, pos + 8 * i, 8) for i in range(rank))


def _datatype(body: bytes, name: str) -> np.dtype:
    cls, bits, size = body[0] & 0x0F, body[1], _uint(body, 4, 4)
    if cls not in (0, 1):
        raise NotImplementedError(f"dataset {name!r}: datatype class {cls} (only integer, float)")
    if bits & 1 or (cls == 1 and bits & 0x40):
        raise NotImplementedError(f"dataset {name!r}: big-endian or VAX datatype")
    if cls == 1:
        if size not in (2, 4, 8):
            raise NotImplementedError(f"dataset {name!r}: {size}-byte float")
        return np.dtype(f"<f{size}")
    if size not in (1, 2, 4, 8):
        raise NotImplementedError(f"dataset {name!r}: {size}-byte integer")
    return np.dtype(f"<{'i' if bits & 0x08 else 'u'}{size}")


def _filters(body: bytes, name: str) -> list[int]:
    version, n = body[0], body[1]
    if version not in (1, 2):
        raise NotImplementedError(f"dataset {name!r}: filter pipeline version {version}")
    pos = 8 if version == 1 else 2
    out = []
    for _ in range(n):
        fid = _uint(body, pos, 2)
        if version == 1 or fid >= 256:
            name_len = _uint(body, pos + 2, 2)
            pos += 4
        else:
            name_len = 0
            pos += 2
        n_values = _uint(body, pos + 2, 2)
        pos += 4
        pos += (-(-name_len // 8) * 8) if version == 1 else name_len
        pos += 4 * n_values + (4 if version == 1 and n_values % 2 else 0)
        if fid not in (1, 2):
            raise NotImplementedError(
                f"dataset {name!r}: filter {_FILTER_NAMES.get(fid, fid)} (only deflate, shuffle)")
        out.append(fid)
    return out


def _unfilter(fid: int, raw: bytes, itemsize: int) -> bytes:
    if fid == 1:
        return zlib.decompress(raw)
    n = len(raw) // itemsize
    planes = np.frombuffer(raw, np.uint8, n * itemsize).reshape(itemsize, n)
    return planes.T.tobytes() + raw[n * itemsize :]


@contextlib.contextmanager
def _open(path: str | os.PathLike) -> tp.Iterator[tuple[_Reader, dict[str, int]]]:
    """The file and its root group's {name: object header address}."""
    f = _Reader(path)
    try:
        yield f, f.links(f.root)
    finally:
        f.close()


def keys(path: str | os.PathLike) -> list[str]:
    """The names in the root group, sorted."""
    with _open(path) as (_, links):
        return sorted(links)


def read(path: str | os.PathLike, key: str) -> np.ndarray:
    """The dataset ``key`` of the root group, as stored."""
    with _open(path) as (f, links):
        if key not in links:
            raise KeyError(f"{key!r} not in {path}")
        return f.dataset(links[key], key)


def read_all(path: str | os.PathLike) -> dict[str, np.ndarray]:
    """Every dataset of the root group, by sorted name."""
    with _open(path) as (f, links):
        return {k: f.dataset(links[k], k) for k in sorted(links)}


# -- writer ---------------------------------------------------------------
def _datatype_message(dtype: np.dtype) -> bytes:
    if dtype.kind == "f" and dtype.itemsize in (4, 8):
        bits = dtype.itemsize * 8
        sign, exp_loc, exp_size, mant_size, bias = (
            (31, 23, 8, 23, 127) if bits == 32 else (63, 52, 11, 52, 1023))
        return (bytes([0x11, 0x20, sign, 0]) + struct.pack("<I", dtype.itemsize)
                + struct.pack("<HHBBBBI", 0, bits, exp_loc, exp_size, 0, mant_size, bias))
    if dtype.kind in "iu" and dtype.itemsize in (1, 2, 4, 8):
        return (bytes([0x10, 0x08 if dtype.kind == "i" else 0, 0, 0])
                + struct.pack("<I", dtype.itemsize) + struct.pack("<HH", 0, dtype.itemsize * 8))
    raise NotImplementedError(f"writing dtype {dtype} (only integers, float32, float64)")


def _v1_header(messages: list[tuple[int, bytes]]) -> bytes:
    body = b""
    for mtype, data in messages:
        data += b"\0" * (-len(data) % 8)
        body += struct.pack("<HHB3x", mtype, len(data), 0) + data
    return struct.pack("<BBHII4x", 1, 0, len(messages), 1, len(body)) + body


def write(path: str | os.PathLike, arrays: tp.Mapping[str, np.ndarray], mode: str = "w") -> None:
    """Write ``arrays`` as datasets of the root group of an HDF5 file.

    ``mode="w"`` replaces the file; ``"a"`` keeps the datasets already in it
    (rewriting them) and adds or replaces those given.  The file is written
    whole to a temporary name and then moved over ``path``."""
    if mode not in ("w", "a"):
        raise ValueError(f"mode {mode!r} (only 'w' or 'a')")
    path = Path(path)
    data = read_all(path) if mode == "a" and path.exists() else {}
    data.update({k: np.ascontiguousarray(v) for k, v in arrays.items()})
    for k in data:
        if not k or "/" in k or "\0" in k:
            raise ValueError(f"dataset name {k!r}")
    names = sorted(data, key=lambda k: k.encode("utf-8"))
    # local heap: "" at 0, then each name NUL-terminated and 8-byte aligned
    heap = bytearray(8)
    name_at = {}
    for k in names:
        name_at[k] = len(heap)
        raw = k.encode("utf-8") + b"\0"
        heap += raw + b"\0" * (-len(raw) % 8)
    leaf_k = max(4, -(-len(names) // 2))  # one symbol node holds every entry
    internal_k = 16

    def dataset_header(arr: np.ndarray, at: int) -> bytes:
        space = struct.pack("<BBB5x", 1, arr.ndim, 0) + b"".join(
            struct.pack("<Q", d) for d in arr.shape)
        fill = bytes([2, 2, 2, 0])  # version 2, allocated late, written if set, undefined
        layout = struct.pack("<BBQQ", 3, 1, at, arr.nbytes)
        return _v1_header([(_DATASPACE, space), (_DATATYPE, _datatype_message(arr.dtype)),
                           (0x05, fill), (_LAYOUT, layout)])

    root_at = 96  # after the 56-byte superblock and the root symbol-table entry
    btree_at = root_at + len(_v1_header([(_SYMBOL_TABLE, bytes(16))]))
    heap_hdr_at = btree_at + 24 + 2 * internal_k * 8 + (2 * internal_k + 1) * 8
    heap_at = heap_hdr_at + 32
    snod_at = heap_at + len(heap)
    header_at = {}
    pos = snod_at + 8 + 2 * leaf_k * 40
    for k in names:
        header_at[k] = pos
        pos += len(dataset_header(data[k], 0))
    data_at = {}
    for k in names:
        data_at[k] = pos
        pos += data[k].nbytes

    out = bytearray(_SIGNATURE + bytes([0, 0, 0, 0, 0, 8, 8, 0]))
    out += struct.pack("<HHI", leaf_k, internal_k, 0)
    out += struct.pack("<QQQQ", 0, _UNDEF, pos, _UNDEF)
    out += struct.pack("<QQIIQQ", 0, root_at, 1, 0, btree_at, heap_hdr_at)
    out += _v1_header([(_SYMBOL_TABLE, struct.pack("<QQ", btree_at, heap_hdr_at))])
    btree = bytearray(heap_hdr_at - btree_at)
    struct.pack_into("<4sBBHQQ", btree, 0, b"TREE", 0, 0, 1 if names else 0, _UNDEF, _UNDEF)
    if names:  # keys: "" and the last name; the one child: the symbol node
        struct.pack_into("<QQQ", btree, 24, 0, snod_at, name_at[names[-1]])
    out += btree
    out += struct.pack("<4sB3xQQQ", b"HEAP", 0, len(heap), 1, heap_at) + heap  # 1: no free block
    snod = bytearray(8 + 2 * leaf_k * 40)
    struct.pack_into("<4sBBH", snod, 0, b"SNOD", 1, 0, len(names))
    for i, k in enumerate(names):
        struct.pack_into("<QQII", snod, 8 + 40 * i, name_at[k], header_at[k], 0, 0)
    out += snod
    for k in names:
        out += dataset_header(data[k], data_at[k])
    tmp = path.with_name(f"{path.name}.tmp{os.getpid()}")
    with open(tmp, "wb") as f:
        f.write(out)
        for k in names:
            f.write(data[k].astype(data[k].dtype.newbyteorder("<"), copy=False).tobytes())
    tmp.replace(path)
