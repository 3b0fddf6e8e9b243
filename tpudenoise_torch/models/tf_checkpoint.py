"""TensorFlow checkpoints read with numpy alone (the calls that
`tpudenoise/models/convert.py` makes on TensorFlow's
`py_checkpoint_reader.NewCheckpointReader`), and a minimal V2 writer.

`CheckpointReader(prefix)` takes the prefix that `--src` names and
offers `get_tensor(name)`, `has_tensor(name)` and
`get_variable_to_shape_map()`.  It reads a V2 bundle where
`prefix.index` exists, else the V1 file at `prefix` itself, as
TensorFlow chooses.  Arrays come back in the checkpoint's own dtype:
float32, float64, float16, int32, int64 and bfloat16 (`ml_dtypes.bfloat16`,
the dtype TensorFlow's reader returns, where `ml_dtypes` is installed;
else float32 holding the same values exactly).  Any other dtype, a
big-endian bundle, a V2 partitioned variable (an entry with `slices`), a
snappy-compressed block, a checksum that does not match and an unknown
name raise an error that names the tensor, the file or the block.

Both formats are tables in LevelDB's layout.  A 48-byte footer holds the
metaindex and index block handles (varint64 offset and size), padding
and the magic 0xdb4775248b80fb57.  The index block maps each data block's
last key to its handle.  A block is a run of entries (varints `shared`,
`non_shared`, `value_len`, the key's new bytes, the value), the restart
array and its count, then a 5-byte trailer: the compression type (0
none, 1 snappy) and the masked crc32c of the block and that byte.  Every
block read is checked.

* V2: `prefix.index` is the table; the key "" holds a
  `BundleHeaderProto` (num_shards 1, endianness 2, version 3), every other
  key a `BundleEntryProto` (dtype 1, shape 2, shard_id 3, offset 4, size
  5, crc32c 6, slices 7) locating the tensor's raw little-endian bytes in
  `prefix.data-NNNNN-of-MMMMM`.  Those bytes are checked against the
  entry's size (shape x dtype) and its crc32c.  Keys that begin with a
  zero byte are the slices of a partitioned variable, and are not
  listed.
* V1: the file at `prefix` is a table of `SavedTensorSlices`: the key ""
  holds the meta (field 1: per tensor its name, shape, dtype and slices),
  every other key one `SavedSlice` (field 2: name 1, `TensorSliceProto`
  extent 2, `TensorProto` 3).  A `TensorProto`'s values come from
  `tensor_content` or from its packed `*_val` field; the slices are put
  together into the full tensor the meta describes.

The crc32c (Castagnoli, as TensorFlow's) is computed with numpy: the
bytes split into lanes that run the slicing-by-4 table step side by
side, and the lane values combined by the GF(2) operator that advances
a register over a lane's length of zero bytes.

`write_checkpoint(prefix, {name: array})` writes a V2 bundle of float32
and int64 arrays (one shard), which TensorFlow's reader reads back.  It
makes checkpoints where no TensorFlow is installed: the tests and
`chip_smoke.py` use it.
"""

from __future__ import annotations

import functools
import os.path as osp
import struct

import numpy as np

# ------------------------------------------------------------ crc32c --

_POLY = 0x82F63B78          # Castagnoli, reflected
_MASK_DELTA = 0xA282EAD8


def _byte_table() -> np.ndarray:
    t = np.arange(256, dtype=np.uint32)
    for _ in range(8):
        t = np.where(t & 1, (t >> 1) ^ np.uint32(_POLY), t >> 1)
    return t.astype(np.uint32)


_T0 = _byte_table()
# slicing-by-4: _SLICE[k][i] is byte i followed by k zero bytes
_SLICE = [_T0]
for _ in range(3):
    _SLICE.append((_SLICE[-1] >> 8) ^ _T0[_SLICE[-1] & 0xFF])
_T0_LIST = _T0.tolist()
_UNIT = np.left_shift(np.uint32(1), np.arange(32, dtype=np.uint32))
_BITS = ((np.arange(256)[:, None] >> np.arange(8)) & 1).astype(bool)


def _op_tables(cols: np.ndarray) -> np.ndarray:
    """(4, 256) byte tables of the GF(2)-linear map on 32-bit registers
    whose column j is cols[j] (the image of bit j)."""
    return np.stack([np.bitwise_xor.reduce(
        np.where(_BITS, cols[8 * p:8 * p + 8], np.uint32(0)), axis=1)
        for p in range(4)]).astype(np.uint32)


def _op_apply(tables: np.ndarray, x: np.ndarray) -> np.ndarray:
    return (tables[0][x & 0xFF] ^ tables[1][(x >> 8) & 0xFF]
            ^ tables[2][(x >> 16) & 0xFF] ^ tables[3][x >> 24])


@functools.lru_cache(maxsize=None)
def _pow_tables(k: int) -> np.ndarray:
    """Tables of the map that advances a register over 2**k zero
    bytes."""
    if k == 0:
        return _op_tables(_T0[_UNIT & 0xFF] ^ (_UNIT >> 8))
    half = _pow_tables(k - 1)
    return _op_tables(_op_apply(half, _op_apply(half, _UNIT)))


def _advance(x: np.ndarray, n: int) -> np.ndarray:
    """Registers x advanced over n zero bytes."""
    k = 0
    while n:
        if n & 1:
            x = _op_apply(_pow_tables(k), x)
        n >>= 1
        k += 1
    return x


@functools.lru_cache(maxsize=None)
def _word_tables():
    """Two 2**16-entry tables: a register's low and high halves after
    one word step (slicing-by-4 merged in pairs of bytes)."""
    v = np.arange(1 << 16, dtype=np.uint32)
    t0, t1, t2, t3 = _SLICE
    return (t3[v & 0xFF] ^ t2[v >> 8]), (t1[v & 0xFF] ^ t0[v >> 8])


def _register_small(buf, reg: int) -> int:
    t = _T0_LIST
    for b in bytes(buf):
        reg = t[(reg ^ b) & 0xFF] ^ (reg >> 8)
    return reg


def _register_lanes(buf) -> int:
    """The register after buf from register 0.  Zero bytes in front leave
    a zero register unchanged, so buf is padded in front to lanes of
    whole words; each lane runs from register 0, then neighbours combine
    as advance(left, len(right)) ^ right."""
    n = len(buf)
    lanes = 1 << max(0, min(16, (n // 256).bit_length() - 1))
    words = -(-n // (4 * lanes))
    data = np.zeros(words * 4 * lanes, np.uint8)
    data[data.size - n:] = np.frombuffer(buf, np.uint8)
    rows = np.ascontiguousarray(data.view('<u4').reshape(lanes, words).T)
    lo, hi = _word_tables()
    reg = np.zeros(lanes, np.uint32)
    for row in rows:
        reg ^= row
        reg = lo[reg & 0xFFFF] ^ hi[reg >> 16]
    span = 4 * words
    while reg.size > 1:
        reg = _advance(reg[0::2], span) ^ reg[1::2]
        span *= 2
    return int(reg[0])


def crc32c(buf, crc: int = 0) -> int:
    """crc32c of buf (any bytes-like object) extending crc, as
    `crc32c::Extend(crc, buf)`."""
    reg = crc ^ 0xFFFFFFFF
    if len(buf) <= 2048:
        reg = _register_small(buf, reg)
    else:
        reg = int(_advance(np.asarray([reg], np.uint32), len(buf))[0]) \
            ^ _register_lanes(buf)
    return reg ^ 0xFFFFFFFF


def _mask(crc: int) -> int:
    return (((crc >> 15) | (crc << 17)) + _MASK_DELTA) & 0xFFFFFFFF


# ---------------------------------------------------------- protobuf --

def _varint(buf, pos: int):
    result = shift = 0
    while True:
        b = buf[pos]
        pos += 1
        result |= (b & 0x7F) << shift
        if b < 0x80:
            return result, pos
        shift += 7


def _signed(v: int) -> int:
    """A varint holding a two's-complement int64."""
    return v - (1 << 64) if v >= 1 << 63 else v


def _message(buf) -> dict:
    """field number -> list of values (ints for varints, memoryviews for
    length-delimited and fixed-width fields) of one protobuf message."""
    out, pos, end = {}, 0, len(buf)
    while pos < end:
        tag, pos = _varint(buf, pos)
        wire = tag & 7
        if wire == 0:
            v, pos = _varint(buf, pos)
        elif wire in (1, 5):
            n = 8 if wire == 1 else 4
            v, pos = buf[pos:pos + n], pos + n
        elif wire == 2:
            n, pos = _varint(buf, pos)
            v, pos = buf[pos:pos + n], pos + n
        else:
            raise ValueError(f'protobuf wire type {wire} is not read here')
        out.setdefault(tag >> 3, []).append(v)
    return out


def _one(msg: dict, field: int, default=0):
    return msg[field][-1] if field in msg else default


def _shape(buf) -> list:
    """TensorShapeProto -> list of dim sizes."""
    return [_signed(_one(_message(d), 1)) for d in _message(buf).get(2, [])]


def _extents(buf) -> list:
    """TensorSliceProto -> [(start, length or None: the whole dim)]."""
    out = []
    for e in _message(buf).get(1, []):
        m = _message(e)
        out.append((_one(m, 1), m[2][-1] if 2 in m else None))
    return out


def _joined(chunks, dtype) -> np.ndarray:
    """The values of length-delimited or fixed-width chunks, read as
    dtype (no copy for one chunk)."""
    if len(chunks) == 1:
        return np.frombuffer(chunks[0], dtype)
    return np.frombuffer(b''.join(bytes(c) for c in chunks), dtype)


def _packed_varints(chunks) -> np.ndarray:
    """The values of varint fields, packed (memoryviews) or not (ints),
    as int64 (two's complement)."""
    loose = np.asarray([c for c in chunks if isinstance(c, int)], np.uint64)
    b = _joined([c for c in chunks if not isinstance(c, int)] or [b''],
                np.uint8)
    if b.size == 0:
        return loose.view(np.int64)
    ends = np.flatnonzero(b < 0x80)
    starts = np.concatenate([[0], ends[:-1] + 1])
    group = np.repeat(np.arange(ends.size), ends - starts + 1)
    shift = (7 * (np.arange(b.size) - starts[group])).astype(np.uint64)
    bits = (b & 0x7F).astype(np.uint64) << shift
    return np.concatenate([np.add.reduceat(bits, starts),
                           loose]).view(np.int64)


def _enc_varint(v: int) -> bytes:
    out = bytearray()
    v &= (1 << 64) - 1
    while True:
        b = v & 0x7F
        v >>= 7
        if v:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def _enc_field(field: int, value) -> bytes:
    """A varint (int) or length-delimited (bytes) field."""
    if isinstance(value, int):
        return _enc_varint(field << 3) + _enc_varint(value)
    return _enc_varint(field << 3 | 2) + _enc_varint(len(value)) + value


# ------------------------------------------------------------ dtypes --

_DTYPE_NAMES = {0: 'invalid', 1: 'float32', 2: 'float64', 3: 'int32',
                4: 'uint8', 5: 'int16', 6: 'int8', 7: 'string',
                8: 'complex64', 9: 'int64', 10: 'bool', 11: 'qint8',
                12: 'quint8', 13: 'qint32', 14: 'bfloat16', 15: 'qint16',
                16: 'quint16', 17: 'uint16', 18: 'complex128',
                19: 'float16', 20: 'resource', 21: 'variant',
                22: 'uint32', 23: 'uint64'}
_READ = {1: np.dtype('<f4'), 2: np.dtype('<f8'), 3: np.dtype('<i4'),
         9: np.dtype('<i8'), 14: np.dtype('<u2'), 19: np.dtype('<f2')}
_WRITE = {np.dtype(np.float32): 1, np.dtype(np.int64): 9}
_BFLOAT16 = 14


def _storage_dtype(dt: int, name: str, where: str) -> np.dtype:
    if dt not in _READ:
        raise ValueError(
            f'{where}: tensor {name!r} has dtype '
            f'{_DTYPE_NAMES.get(dt, dt)}, which this reader does not read '
            f'(float32, float64, float16, bfloat16, int32, int64)')
    return _READ[dt]


def _finish(a: np.ndarray, dt: int) -> np.ndarray:
    """bfloat16 bits (uint16) -> the bfloat16 dtype, or float32."""
    if dt != _BFLOAT16:
        return a
    try:
        import ml_dtypes
    except ImportError:
        return (a.astype(np.uint32) << 16).view(np.float32)
    return a.view(ml_dtypes.bfloat16)


# ------------------------------------------------------------- table --

_MAGIC = 0xDB4775248B80FB57
_FOOTER = 48
_TRAILER = 5


def _read_at(path: str, offset: int, size: int) -> bytearray:
    buf = bytearray(size)
    with open(path, 'rb') as f:
        f.seek(offset)
        got = f.readinto(buf)
    if got != size:
        raise ValueError(f'{path}: truncated: {size} bytes wanted at '
                         f'offset {offset}, {got} read')
    return buf


def _block(path: str, handle) -> memoryview:
    """The checked contents of the block at handle (offset, size)."""
    offset, size = handle
    raw = memoryview(_read_at(path, offset, size + _TRAILER))
    kind = raw[size]
    stored = struct.unpack_from('<I', raw, size + 1)[0]
    if _mask(crc32c(raw[size:size + 1], crc32c(raw[:size]))) != stored:
        raise ValueError(f'{path}: block at offset {offset} ({size} bytes): '
                         f'crc32c mismatch (the file is corrupt)')
    if kind == 1:
        raise ValueError(f'{path}: block at offset {offset} is '
                         f'snappy-compressed, which this reader does not '
                         f'decode')
    if kind != 0:
        raise ValueError(f'{path}: block at offset {offset} has compression '
                         f'type {kind}')
    return raw[:size]


def _block_entries(block: memoryview):
    """(key bytes, value memoryview) of each entry of a block."""
    n = len(block)
    restarts = struct.unpack_from('<I', block, n - 4)[0]
    end = n - 4 - 4 * restarts
    pos, key = 0, b''
    while pos < end:
        shared, pos = _varint(block, pos)
        fresh, pos = _varint(block, pos)
        vlen, pos = _varint(block, pos)
        key = key[:shared] + bytes(block[pos:pos + fresh])
        pos += fresh
        yield key, block[pos:pos + vlen]
        pos += vlen


def _handle(value) -> tuple:
    offset, pos = _varint(value, 0)
    size, _ = _varint(value, pos)
    return offset, size


def _table_entries(path: str) -> list:
    """Every (key, value) of the table file at path, in key order."""
    if not osp.isfile(path):
        raise FileNotFoundError(f'no checkpoint file {path!r}')
    size = osp.getsize(path)
    if size < _FOOTER:
        raise ValueError(f'{path}: {size} bytes, shorter than a table footer')
    footer = memoryview(_read_at(path, size - _FOOTER, _FOOTER))
    if struct.unpack_from('<Q', footer, _FOOTER - 8)[0] != _MAGIC:
        raise ValueError(f'{path}: not a TensorFlow table (bad magic)')
    _, pos = _varint(footer, _varint(footer, 0)[1])     # metaindex handle
    offset, pos = _varint(footer, pos)
    index_size, _ = _varint(footer, pos)
    out = []
    for _, value in _block_entries(_block(path, (offset, index_size))):
        out.extend(_block_entries(_block(path, _handle(value))))
    return out


# ---------------------------------------------------------------- V2 --

class _BundleV2:
    def __init__(self, prefix: str):
        self.prefix = prefix
        self.index = prefix + '.index'
        entries = _table_entries(self.index)
        if not entries or entries[0][0] != b'':
            raise ValueError(f'{self.index}: no bundle header')
        header = _message(entries[0][1])
        self.num_shards = _one(header, 1, 1)
        if _one(header, 2) == 1:
            raise ValueError(f'{self.index}: a big-endian bundle, which this '
                             f'reader does not read')
        self.entries = {k.decode(): _message(v) for k, v in entries[1:]
                        if not k.startswith(b'\x00')}

    def shape(self, name: str) -> list:
        return _shape(_one(self.entries[name], 2, b''))

    def tensor(self, name: str) -> np.ndarray:
        e = self.entries[name]
        if 7 in e:
            raise ValueError(f'{self.index}: tensor {name!r} is a '
                             f'partitioned variable ({len(e[7])} slices), '
                             f'which this reader does not put together')
        dt = _one(e, 1)
        dtype = _storage_dtype(dt, name, self.index)
        shape = self.shape(name)
        size = _one(e, 5)
        if size != int(np.prod(shape)) * dtype.itemsize:
            raise ValueError(f'{self.index}: tensor {name!r} holds {size} '
                             f'bytes, not those of {shape} x {dtype}')
        path = (f'{self.prefix}.data-{_one(e, 3):05d}-of-'
                f'{self.num_shards:05d}')
        buf = _read_at(path, _one(e, 4), size)
        stored = struct.unpack('<I', _one(e, 6, b'\0\0\0\0'))[0]
        if _mask(crc32c(buf)) != stored:
            raise ValueError(f'{path}: tensor {name!r}: crc32c mismatch '
                             f'(the file is corrupt)')
        return _finish(np.frombuffer(buf, dtype).reshape(shape), dt)


# ---------------------------------------------------------------- V1 --

# TensorProto's value fields, by storage dtype: (field, packed varints)
_VAL_FIELDS = {1: (5, False), 2: (6, False), 3: (7, True), 9: (10, True),
               19: (13, True)}


def _tensor_values(proto, dt: int, dtype: np.dtype) -> np.ndarray:
    """The flat values of a TensorProto, from tensor_content (4) or from
    the packed *_val field of its dtype."""
    msg = _message(proto)
    if 4 in msg:
        return _joined(msg[4], dtype)
    field, varints = _VAL_FIELDS[dt]
    chunks = msg.get(field, [])
    if varints:
        ints = _packed_varints(chunks)
        if dt == 19:           # half_val: the float16 bits in an int32
            return ints.astype(np.uint16).view(np.float16)
        return ints.astype(dtype)
    return _joined(chunks or [b''], dtype)


class _SlicesV1:
    def __init__(self, path: str):
        self.path = path
        entries = _table_entries(path)
        if not entries or entries[0][0] != b'':
            raise ValueError(f'{path}: no V1 checkpoint meta')
        self.meta = {}
        for t in _message(_one(_message(entries[0][1]), 1, b'')).get(1, []):
            m = _message(t)
            self.meta[bytes(_one(m, 1, b'')).decode()] = (
                _shape(_one(m, 2, b'')), _one(m, 3))
        self.slices = {}
        for _, value in entries[1:]:
            s = _message(_one(_message(value), 2, b''))
            self.slices.setdefault(bytes(_one(s, 1, b'')).decode(), []).append(
                (_extents(_one(s, 2, b'')), _one(s, 3, b'')))

    def shape(self, name: str) -> list:
        return self.meta[name][0]

    def tensor(self, name: str) -> np.ndarray:
        shape, dt = self.meta[name]
        dtype = _storage_dtype(dt, name, self.path)
        out = np.zeros(shape, dtype)
        filled = 0
        for extents, proto in self.slices.get(name, []):
            index = tuple(slice(None) if n is None else slice(s, s + n)
                          for s, n in extents)
            part = out[index]
            values = _tensor_values(proto, dt, dtype)
            if values.size != part.size:
                raise ValueError(f'{self.path}: a slice of tensor {name!r} '
                                 f'holds {values.size} values for '
                                 f'{part.shape}')
            out[index] = values.reshape(part.shape)
            filled += values.size
        if filled != out.size:
            raise ValueError(f'{self.path}: the slices of tensor {name!r} '
                             f'fill {filled} of its {out.size} values')
        return _finish(out, dt)


# ------------------------------------------------------------ reader --

class CheckpointReader:
    """A TensorFlow checkpoint, V2 where `prefix.index` exists, else the
    V1 file at prefix."""

    def __init__(self, prefix: str):
        prefix = str(prefix)
        self.prefix = prefix
        if osp.exists(prefix + '.index'):
            self.version, self._ckpt = 'V2', _BundleV2(prefix)
        elif osp.isfile(prefix):
            self.version, self._ckpt = 'V1', _SlicesV1(prefix)
        else:
            raise FileNotFoundError(
                f'no TensorFlow checkpoint at {prefix!r}: neither '
                f'{prefix}.index (V2) nor the file itself (V1) exists')

    def _names(self):
        c = self._ckpt
        return c.entries if self.version == 'V2' else c.meta

    def has_tensor(self, name: str) -> bool:
        return name in self._names()

    def get_variable_to_shape_map(self) -> dict:
        return {name: self._ckpt.shape(name) for name in self._names()}

    def get_tensor(self, name: str) -> np.ndarray:
        if name not in self._names():
            raise KeyError(f'tensor {name!r} is not in the checkpoint '
                           f'{self.prefix!r}')
        return self._ckpt.tensor(name)


# ------------------------------------------------------------ writer --

_BLOCK_SIZE = 4096
_RESTART_INTERVAL = 16


def _block_bytes(entries) -> bytes:
    out, restarts, last = bytearray(), [], b''
    for i, (key, value) in enumerate(entries):
        if i % _RESTART_INTERVAL == 0:
            restarts.append(len(out))
            shared = 0
        else:
            shared = 0
            while (shared < min(len(key), len(last))
                   and key[shared] == last[shared]):
                shared += 1
        out += (_enc_varint(shared) + _enc_varint(len(key) - shared)
                + _enc_varint(len(value)) + key[shared:] + value)
        last = key
    restarts = restarts or [0]
    out += struct.pack(f'<{len(restarts)}I', *restarts)
    out += struct.pack('<I', len(restarts))
    return bytes(out)


def _write_table(path: str, entries):
    """A table of the sorted (key, value) byte pairs, uncompressed."""
    with open(path, 'wb') as f:
        def put(contents: bytes) -> bytes:
            offset = f.tell()
            crc = crc32c(b'\0', crc32c(contents))
            f.write(contents + b'\0' + struct.pack('<I', _mask(crc)))
            return _enc_varint(offset) + _enc_varint(len(contents))

        index, pending, size = [], [], 0
        for key, value in entries:
            pending.append((key, value))
            size += len(key) + len(value) + 8
            if size >= _BLOCK_SIZE:
                index.append((key, put(_block_bytes(pending))))
                pending, size = [], 0
        if pending:
            index.append((pending[-1][0], put(_block_bytes(pending))))
        meta_handle = put(_block_bytes([]))
        index_handle = put(_block_bytes(index))
        footer = meta_handle + index_handle
        f.write(footer + b'\0' * (_FOOTER - 8 - len(footer))
                + struct.pack('<Q', _MAGIC))


def write_checkpoint(prefix: str, tensors: dict):
    """Write {name: float32 or int64 array} as a one-shard V2 bundle:
    `prefix.index` and `prefix.data-00000-of-00001`."""
    prefix = str(prefix)
    names = sorted(tensors, key=lambda n: n.encode())
    entries = [(b'', _enc_field(1, 1) + _enc_field(3, _enc_field(1, 1)))]
    offset = 0
    with open(prefix + '.data-00000-of-00001', 'wb') as f:
        for name in names:
            a = np.asarray(tensors[name])
            if a.dtype not in _WRITE:
                raise ValueError(f'tensor {name!r}: dtype {a.dtype}; the '
                                 f'writer takes float32 and int64')
            data = np.ascontiguousarray(
                a, a.dtype.newbyteorder('<')).reshape(-1).view(np.uint8)
            f.write(data)
            dims = b''.join(_enc_field(2, _enc_field(1, d) if d else b'')
                            for d in a.shape)
            entry = (_enc_field(1, _WRITE[a.dtype]) + _enc_field(2, dims)
                     + (_enc_field(4, offset) if offset else b'')
                     + (_enc_field(5, len(data)) if len(data) else b'')
                     + _enc_varint(6 << 3 | 5)
                     + struct.pack('<I', _mask(crc32c(data))))
            entries.append((name.encode(), entry))
            offset += len(data)
    _write_table(prefix + '.index', entries)
