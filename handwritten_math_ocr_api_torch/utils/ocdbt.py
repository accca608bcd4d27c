"""A read-only OCDBT key-value store, and the zarr v2 arrays stored in it.

Orbax writes a PyTree checkpoint into tensorstore's OCDBT format (an
"optionally-cooperative distributed B+tree"): ``manifest.ocdbt`` names the
root B-tree node of the latest version; nodes and out-of-line values live in
data files under ``d/`` (a database that merged per-process databases points
into their ``ocdbt.process_N/d/`` files). Each array is a zarr v2 array: a
``<name>/.zarray`` JSON value beside one value per chunk.

Encoding, as tensorstore writes it (every integer a LEB128 varint unless
named otherwise):

- manifest and node files: a magic number (uint32 big-endian:
  ``0x0cdb3a2a`` manifest, ``0x0cdb20de`` node), the file's length (uint64
  little-endian), the format version (0), the compression (0 none, 1 zstd),
  the body, and a CRC-32C (uint32 little-endian) of everything before it;
- a data file table: the count, for each file after the first the length of
  the path prefix it shares with the one before, each path's suffix length,
  each path's base-path length, then the suffixes; a path is relative to the
  database's directory;
- manifest body: the config (uuid[16], manifest kind, max inline value
  bytes, max decoded node bytes, version tree arity log2 (one byte),
  compression method, and for zstd its level as int32), a data file table,
  then the newest versions as arrays: generation numbers, root heights (one
  byte each), root node file ids, offsets and lengths, the statistics
  (keys, tree bytes, indirect value bytes) and commit times (uint64 each);
  references to older version tree nodes follow, which reading the newest
  version does not need;
- B-tree node body: the height (one byte), a data file table, the entry
  count, each entry's key prefix length shared with the entry before
  (entries after the first), each key suffix's length, in an interior node
  each entry's subtree common prefix length, the key suffixes; then in a
  leaf each value's length, kind (0 inline, 1 in a data file), the file ids
  and offsets of the out-of-line values, and the inline values back to
  back; in an interior node each child's file id, offset and length, and
  its statistics. The keys of a child are stored without the first
  ``subtree common prefix length`` bytes of its entry's key.

Every framing field and check value is verified, and anything the reader
does not implement raises ``ValueError`` naming it.
"""

from __future__ import annotations

import json
import math
import os
import struct
from typing import Dict, List, Tuple, Union

import numpy as np

from . import zstd

MANIFEST_MAGIC = 0x0CDB3A2A
NODE_MAGIC = 0x0CDB20DE
_HEADER = 12  # magic + length; the version and compression varints follow


def _crc32c_table() -> List[int]:
    table = []
    for n in range(256):
        c = n
        for _ in range(8):
            c = (c >> 1) ^ 0x82F63B78 if c & 1 else c >> 1
        table.append(c)
    return table


_CRC_TABLE = _crc32c_table()


def crc32c(data: bytes) -> int:
    """CRC-32C (Castagnoli), the check value of OCDBT files."""
    crc = 0xFFFFFFFF
    table = _CRC_TABLE
    for byte in data:
        crc = table[(crc ^ byte) & 0xFF] ^ (crc >> 8)
    return crc ^ 0xFFFFFFFF


class _Reader:
    """Sequential reader of a decoded body; running past its end raises."""

    def __init__(self, data: bytes, what: str):
        self.data = data
        self.pos = 0
        self.what = what

    def _need(self, n: int) -> None:
        if self.pos + n > len(self.data):
            raise ValueError(f"{self.what}: truncated body")

    def varint(self) -> int:
        value, shift = 0, 0
        while True:
            self._need(1)
            byte = self.data[self.pos]
            self.pos += 1
            value |= (byte & 0x7F) << shift
            shift += 7
            if byte < 0x80:
                return value
            if shift > 63:
                raise ValueError(f"{self.what}: varint longer than 64 bits")

    def varints(self, n: int) -> List[int]:
        return [self.varint() for _ in range(n)]

    def byte(self) -> int:
        self._need(1)
        self.pos += 1
        return self.data[self.pos - 1]

    def raw(self, n: int) -> bytes:
        self._need(n)
        self.pos += n
        return self.data[self.pos - n:self.pos]


def _unframe(data: bytes, magic: int, what: str,
             limit: int = 1 << 20) -> bytes:
    """Check a manifest or node file's header and CRC-32C; return its
    decoded body (at most ``limit`` bytes)."""
    if len(data) < _HEADER + 6:
        raise ValueError(f"{what}: {len(data)} bytes, too short")
    got_magic, length = struct.unpack_from(">I", data)[0], struct.unpack_from(
        "<Q", data, 4)[0]
    if got_magic != magic:
        raise ValueError(f"{what}: magic {got_magic:#010x}, expected "
                         f"{magic:#010x}")
    if length != len(data):
        raise ValueError(f"{what}: header length {length}, file has "
                         f"{len(data)} bytes")
    want = struct.unpack_from("<I", data, len(data) - 4)[0]
    if crc32c(data[:-4]) != want:
        raise ValueError(f"{what}: CRC-32C check failed")
    head = _Reader(data[:-4], what)
    head.pos = _HEADER
    version = head.varint()
    if version != 0:
        raise ValueError(f"{what}: format version {version} not implemented")
    compression = head.varint()
    body = data[head.pos:-4]
    if compression == 0:
        return body
    if compression == 1:
        return zstd.decompress(body, limit=limit)
    raise ValueError(f"{what}: compression format {compression} not "
                     "implemented")


def _data_file_table(r: _Reader) -> List[str]:
    n = r.varint()
    prefix = [0] + r.varints(max(n - 1, 0))
    suffix = r.varints(n)
    r.varints(n)  # base path lengths: the paths are used whole
    paths: List[str] = []
    prev = b""
    for i in range(n):
        if prefix[i] > len(prev):
            raise ValueError(f"{r.what}: data file path prefix too long")
        prev = prev[:prefix[i]] + r.raw(suffix[i])
        paths.append(prev.decode())
    return paths


def _keys(r: _Reader, n: int, interior: bool):
    prefix = [0] + r.varints(max(n - 1, 0))
    suffix = r.varints(n)
    common = r.varints(n) if interior else [0] * n
    keys: List[bytes] = []
    prev = b""
    for i in range(n):
        if prefix[i] > len(prev):
            raise ValueError(f"{r.what}: key prefix too long")
        prev = prev[:prefix[i]] + r.raw(suffix[i])
        keys.append(prev)
    return keys, common


# a value: inline bytes, or (data file, offset, length)
Value = Union[bytes, Tuple[str, int, int]]


class OcdbtStore:
    """The newest version of an OCDBT database in ``directory``, read whole
    at construction: ``keys(prefix)`` and ``get(key)``."""

    def __init__(self, directory: str):
        self.directory = os.path.abspath(directory)
        path = os.path.join(self.directory, "manifest.ocdbt")
        with open(path, "rb") as f:
            r = _Reader(_unframe(f.read(), MANIFEST_MAGIC, path), path)
        r.raw(16)  # uuid
        kind = r.varint()
        if kind != 0:
            raise ValueError(f"{path}: manifest kind {kind} (numbered "
                             "manifests) not implemented")
        r.varint()  # max inline value bytes
        self._node_limit = r.varint()  # max decoded node bytes
        r.byte()    # version tree arity log2
        if r.varint() == 1:  # zstd compression of new nodes: its level
            r.raw(4)
        files = _data_file_table(r)
        n = r.varint()
        if n == 0:
            raise ValueError(f"{path}: the manifest holds no version")
        generation = r.varints(n)
        height = [r.byte() for _ in range(n)]
        file_id, offset, length = r.varints(n), r.varints(n), r.varints(n)
        num_keys = r.varints(n)
        newest = max(range(n), key=generation.__getitem__)
        self.generation = generation[newest]
        self._values: Dict[bytes, Value] = {}
        if num_keys[newest]:
            self._walk(self._file(files, file_id[newest], path),
                       offset[newest], length[newest], height[newest], b"")
        if len(self._values) != num_keys[newest]:
            raise ValueError(f"{path}: {len(self._values)} keys read, the "
                             f"manifest counts {num_keys[newest]}")

    def _file(self, files: List[str], i: int, what: str) -> str:
        if i >= len(files):
            raise ValueError(f"{what}: data file id {i} out of range")
        rel = files[i]
        if os.path.isabs(rel) or ".." in rel.split("/"):
            raise ValueError(f"{what}: data file path {rel!r} leaves the "
                             "database")
        return os.path.join(self.directory, rel)

    def _read(self, path: str, offset: int, length: int) -> bytes:
        with open(path, "rb") as f:
            f.seek(offset)
            data = f.read(length)
        if len(data) != length:
            raise ValueError(
                f"{path}: truncated data file ({len(data)} of {length} bytes "
                f"at offset {offset})")
        return data

    def _walk(self, path: str, offset: int, length: int, height: int,
              prefix: bytes) -> None:
        what = f"{path}@{offset}"
        r = _Reader(_unframe(self._read(path, offset, length), NODE_MAGIC,
                             what, self._node_limit), what)
        got = r.byte()
        if got != height:
            raise ValueError(f"{what}: node height {got}, expected {height}")
        files = _data_file_table(r)
        n = r.varint()
        keys, common = _keys(r, n, height > 0)
        if height > 0:
            file_id, off, ln = r.varints(n), r.varints(n), r.varints(n)
            r.varints(3 * n)  # statistics
            self._end(r)
            for i in range(n):
                self._walk(self._file(files, file_id[i], what), off[i],
                           ln[i], height - 1, prefix + keys[i][:common[i]])
            return
        value_len = r.varints(n)
        kinds = r.varints(n)
        if any(k > 1 for k in kinds):
            raise ValueError(f"{what}: value kind {max(kinds)} not "
                             "implemented")
        out_of_line = [i for i in range(n) if kinds[i] == 1]
        file_id = r.varints(len(out_of_line))
        off = r.varints(len(out_of_line))
        for j, i in enumerate(out_of_line):
            self._values[prefix + keys[i]] = (
                self._file(files, file_id[j], what), off[j], value_len[i])
        for i in range(n):
            if kinds[i] == 0:
                self._values[prefix + keys[i]] = r.raw(value_len[i])
        self._end(r)

    @staticmethod
    def _end(r: _Reader) -> None:
        if r.pos != len(r.data):
            raise ValueError(f"{r.what}: {len(r.data) - r.pos} bytes past "
                             "the node's entries")

    def keys(self, prefix: str = "") -> List[str]:
        p = prefix.encode()
        return sorted(k.decode() for k in self._values if k.startswith(p))

    def __contains__(self, key: str) -> bool:
        return key.encode() in self._values

    def get(self, key: str) -> bytes:
        """The value of ``key``; ``KeyError`` where the store lacks it."""
        value = self._values[key.encode()]
        if isinstance(value, bytes):
            return value
        return self._read(*value)


# -- zarr v2 arrays -----------------------------------------------------------

_FILL_WORDS = {"NaN": math.nan, "Infinity": math.inf, "-Infinity": -math.inf}


def _dtype(spec):
    """numpy dtype of a zarr v2 ``dtype``; ``"bfloat16"`` (tensorstore's
    name) reads as uint16 bits."""
    if spec == "bfloat16":
        return np.dtype("<u2")
    if not isinstance(spec, str):
        raise ValueError(f"zarr dtype {spec!r} (structured) not implemented")
    try:
        dt = np.dtype(spec)
    except TypeError as e:
        raise ValueError(f"zarr dtype {spec!r} not implemented") from e
    if dt.kind not in "biuf" or len(spec) < 3 or spec[0] not in "<>|":
        raise ValueError(f"zarr dtype {spec!r} not implemented")
    return dt


def read_array(store: OcdbtStore, name: str):
    """The zarr v2 array ``name``: a numpy array in its stored dtype (native
    byte order), or a CPU ``torch.bfloat16`` tensor for a ``bfloat16``
    array. Chunks are zstd-compressed or raw; a chunk that the store lacks
    is ``fill_value`` (zeros where it is null), as zarr reads it."""
    meta = json.loads(store.get(f"{name}/.zarray"))
    if meta.get("zarr_format") != 2:
        raise ValueError(f"{name}: zarr_format {meta.get('zarr_format')} "
                         "not implemented")
    compressor = meta.get("compressor")
    if compressor is not None and compressor.get("id") != "zstd":
        raise ValueError(f"{name}: zarr compressor {compressor.get('id')!r} "
                         "not implemented")
    if meta.get("filters"):
        raise ValueError(f"{name}: zarr filters {meta['filters']!r} not "
                         "implemented")
    order = meta.get("order", "C")
    if order not in ("C", "F"):
        raise ValueError(f"{name}: zarr order {order!r} not implemented")
    sep = meta.get("dimension_separator", ".")
    if sep not in (".", "/"):
        raise ValueError(f"{name}: zarr dimension_separator {sep!r} not "
                         "implemented")
    dt = _dtype(meta["dtype"])
    shape = tuple(meta["shape"])
    chunks = tuple(meta["chunks"])
    if len(chunks) != len(shape) or any(c <= 0 for c in chunks):
        raise ValueError(f"{name}: chunks {chunks} do not fit shape {shape}")
    fill = meta.get("fill_value")
    fill = 0 if fill is None else _FILL_WORDS.get(fill, fill)
    out = np.full(shape, fill, dt)
    chunk_bytes = int(np.prod(chunks, dtype=np.int64)) * dt.itemsize
    grid = [range(math.ceil(s / c)) for s, c in zip(shape, chunks)]
    for idx in np.ndindex(*[len(g) for g in grid]):
        key = f"{name}/{sep.join(map(str, idx)) if idx else '0'}"
        if key not in store:
            continue
        raw = store.get(key)
        if compressor is not None:
            raw = zstd.decompress(raw, chunk_bytes)
        elif len(raw) != chunk_bytes:
            raise ValueError(f"{key}: {len(raw)} bytes, expected "
                             f"{chunk_bytes}")
        chunk = np.frombuffer(raw, dt).reshape(chunks, order=order)
        region = tuple(slice(i * c, min((i + 1) * c, s))
                       for i, c, s in zip(idx, chunks, shape))
        out[region] = chunk[tuple(slice(0, r.stop - r.start)
                                  for r in region)]
    out = out.astype(dt.newbyteorder("="), copy=False)
    if meta["dtype"] == "bfloat16":
        import torch

        return torch.from_numpy(out.view(np.int16)).view(torch.bfloat16)
    return out
