"""`tpudenoise_torch/models/tf_checkpoint.py` (a numpy-only reader of
TensorFlow checkpoints, and its V2 writer) against TensorFlow's own
`NewCheckpointReader`, on the CPU.

TensorFlow writes the checkpoints here (`Saver(write_version=...)`):
* V2: every dtype the reader reads (float32, float64, float16, bfloat16,
  int32, int64), scalars, 1-d and 4-d tensors, 40 keys under shared
  prefixes (restart points every 16 entries), 150 keys of 2000-byte
  names (TensorFlow's 256 KB index blocks: an index of several data
  blocks), an int64 `global_step` and a partitioned variable;
* V1: float32, float64, int32 and int64, the same shapes, a 320 KB
  tensor (several data blocks), a partitioned variable (its slices put
  together) and a float16 (TensorFlow's V1 writer takes no bfloat16, and
  its V1 reader reads neither float16 nor, here, the partitioned
  variable: those two are held to the values the session saved).
Each tensor and the shape map must equal TensorFlow's bit for bit; the
port's writer must read back through TensorFlow's reader bit for bit;
each refusal raises naming itself."""

import tests.torch_threads  # noqa: F401  (torch threads per xdist worker)
import os
import struct

import numpy as np
import pytest

from tpudenoise_torch.models import tf_checkpoint as T

tf = pytest.importorskip('tensorflow')
tf1 = tf.compat.v1


def tf_reader(prefix):
    from tensorflow.python.training import py_checkpoint_reader
    return py_checkpoint_reader.NewCheckpointReader(prefix)


def tf_save(prefix, arrays: dict, version: str = 'V2',
            partitioned: dict = None) -> dict:
    """Save {name: numpy array} (bfloat16 given as float64 values) and
    {name: shape} partitioned in two along axis 0 with TensorFlow;
    returns the values the session saved."""
    g = tf.Graph()
    with g.as_default():
        saved, vs = {}, []
        for name, a in arrays.items():
            if name.endswith('bf16'):
                init = tf.constant(a, tf.bfloat16)
            else:
                init = tf.constant(a)
            vs.append(tf1.get_variable(name, initializer=init))
        for name, shape in (partitioned or {}).items():
            parts = tf1.get_variable(
                name, shape=shape, dtype=tf.float32,
                initializer=tf1.random_normal_initializer(seed=1),
                partitioner=tf1.fixed_size_partitioner(2))
            vs.extend(parts)
        saver = tf1.train.Saver(vs, write_version=getattr(
            tf1.train.SaverDef, version))
        with tf1.Session(graph=g) as sess:
            sess.run(tf1.global_variables_initializer())
            for name in partitioned or {}:
                saved[name] = np.concatenate(sess.run(
                    [v for v in vs if v.name.startswith(name + '/part_')]))
            saver.save(sess, str(prefix), write_meta_graph=False)
    return saved


def _arrays(version: str) -> dict:
    rng = np.random.RandomState(0)
    out = {'global_step': np.int64(4321), 'scalar_f32': np.float32(2.5),
           'dt/f32': rng.randn(2, 3, 4, 5).astype(np.float32),
           'dt/f64': rng.randn(7),
           'dt/i32': rng.randint(-2**31, 2**31 - 1, (3, 4), np.int64)
           .astype(np.int32),
           'dt/i64': np.array([-1, 0, 2**40, -2**62], np.int64)}
    if version == 'V2':
        out['dt/f16'] = rng.randn(3, 1, 1, 2).astype(np.float16)
        out['dt/bf16'] = rng.randn(5)
        out.update({f'long/{i:03d}/' + 'w' * 2000: np.float32([i])
                    for i in range(150)})
    else:
        out['big'] = rng.randn(80000).astype(np.float32)
    out.update({f'net/block{b}/unit_{u}/conv/weights':
                rng.randn(1, 1, 2, u + 1).astype(np.float32)
                for b in range(1, 5) for u in range(10)})
    return out


@pytest.fixture(scope='module')
def ckpts(tmp_path_factory):
    out = {}
    for version in ('V2', 'V1'):
        d = tmp_path_factory.mktemp(version)
        saved = tf_save(d / 'model.ckpt', _arrays(version), version,
                        partitioned={'part': (6, 2)})
        out[version] = (str(d / 'model.ckpt'), saved)
    return out


def _data_blocks(path: str) -> int:
    """Entries of the index block of a table file (one per data block)."""
    size = os.path.getsize(path)
    footer = memoryview(T._read_at(path, size - 48, 48))
    _, pos = T._varint(footer, T._varint(footer, 0)[1])
    offset, pos = T._varint(footer, pos)
    n, _ = T._varint(footer, pos)
    return len(list(T._block_entries(T._block(path, (offset, n)))))


def _same(got, want, name):
    assert got.dtype == want.dtype, (name, got.dtype, want.dtype)
    assert got.shape == want.shape, name
    assert np.ascontiguousarray(got).tobytes() == \
        np.ascontiguousarray(want).tobytes(), name


@pytest.mark.parametrize('version', ['V2', 'V1'])
def test_reader_matches_tensorflow(ckpts, version):
    prefix, saved = ckpts[version]
    mine, theirs = T.CheckpointReader(prefix), tf_reader(prefix)
    assert mine.version == version
    shapes = theirs.get_variable_to_shape_map()
    assert mine.get_variable_to_shape_map() == shapes
    assert len(shapes) == len(_arrays(version)) + 1
    held = 0
    for name in shapes:
        assert mine.has_tensor(name)
        if name == 'part' and version == 'V2':
            continue                        # refused: see the refusals
        got = mine.get_tensor(name)
        if name in saved:                   # V1's partitioned variable
            want = saved[name]
        else:
            want = theirs.get_tensor(name)
            held += 1
        _same(got, want, name)
    assert held == len(shapes) - 1
    assert not mine.has_tensor('dt/missing')
    if version == 'V2':
        assert mine.get_tensor('dt/bf16').dtype.name == 'bfloat16'
        assert _data_blocks(prefix + '.index') >= 2
    else:
        assert _data_blocks(prefix) >= 2


def test_v1_float16_and_slices(ckpts, tmp_path):
    """V1 tensors TensorFlow's own reader does not read here: float16
    (`half_val`) and a variable saved as two slices."""
    prefix, saved = ckpts['V1']
    mine = T.CheckpointReader(prefix)
    _same(mine.get_tensor('part'), saved['part'], 'part')
    f16 = np.random.RandomState(1).randn(4, 3).astype(np.float16)
    tf_save(tmp_path / 'half.ckpt', {'h': f16}, 'V1')
    _same(T.CheckpointReader(str(tmp_path / 'half.ckpt')).get_tensor('h'),
          f16, 'h')


def test_writer_reads_back_through_tensorflow(tmp_path):
    rng = np.random.RandomState(2)
    arrays = {f'scope/block{i % 7}/unit_{i}/weights':
              np.float32(rng.randn(*(3,) * (i % 5)))
              for i in range(300)}
    arrays.update({'global_step': np.int64(77),
                   'steps': np.array([-3, 2**50], np.int64),
                   'big': rng.randn(300, 1000).astype(np.float32),
                   'empty': np.zeros((0, 4), np.float32)})
    prefix = str(tmp_path / 'port.ckpt')
    T.write_checkpoint(prefix, arrays)
    assert _data_blocks(prefix + '.index') >= 2
    theirs, mine = tf_reader(prefix), T.CheckpointReader(prefix)
    want_shapes = {k: list(np.shape(v)) for k, v in arrays.items()}
    assert theirs.get_variable_to_shape_map() == want_shapes
    assert mine.get_variable_to_shape_map() == want_shapes
    for name, a in arrays.items():
        _same(theirs.get_tensor(name), np.asarray(a), name)
        _same(mine.get_tensor(name), np.asarray(a), name)
    with pytest.raises(ValueError, match=r"'b'.*float64.*float32 and int64"):
        T.write_checkpoint(str(tmp_path / 'bad'), {'b': np.zeros(2)})


def test_crc32c_known_values():
    """RFC 3720's vectors and the byte loop against the lane form."""
    assert T.crc32c(b'123456789') == 0xE3069283
    assert T.crc32c(bytes(32)) == 0x8A9136AA
    assert T.crc32c(b'\xff' * 32) == 0x62A8AB43
    data = np.random.RandomState(3).bytes(300001)
    want = T._register_small(data, 0xFFFFFFFF) ^ 0xFFFFFFFF
    assert T.crc32c(data) == want
    assert T.crc32c(data[123457:], T.crc32c(data[:123457])) == want


def _flip(path, offset):
    with open(path, 'r+b') as f:
        f.seek(offset)
        b = f.read(1)
        f.seek(offset)
        f.write(bytes([b[0] ^ 0x20]))


def _forge_snappy(path):
    """Mark the index file's first block snappy, with its crc32c made to
    match, so that the compression type is what is refused."""
    with open(path, 'rb') as f:
        raw = bytearray(f.read())
    footer = memoryview(raw)[-48:]
    _, pos = T._varint(footer, T._varint(footer, 0)[1])
    offset, pos = T._varint(footer, pos)
    n, _ = T._varint(footer, pos)
    first = T._handle(next(T._block_entries(
        memoryview(raw)[offset:offset + n]))[1])
    start, size = first
    raw[start + size] = 1
    crc = T.crc32c(b'\x01', T.crc32c(bytes(raw[start:start + size])))
    raw[start + size + 1:start + size + 5] = struct.pack('<I', T._mask(crc))
    with open(path, 'wb') as f:
        f.write(raw)


def _big_endian(prefix):
    """A bundle whose header says big-endian."""
    entries = T._table_entries(prefix + '.index')
    header = T._enc_field(1, 1) + T._enc_field(2, 1)
    T._write_table(prefix + '.index', [(b'', header)] + [
        (k, bytes(v)) for k, v in entries[1:]])


@pytest.mark.parametrize('case,err,match', [
    ('flipped index byte', ValueError,
     r'model\.ckpt\.index: block at offset \d+ .*crc32c mismatch'),
    ('flipped data byte', ValueError,
     r"data-00000-of-00001: tensor 'x': crc32c mismatch"),
    ('partitioned variable', ValueError,
     r"tensor 'part' is a partitioned variable"),
    ('snappy block', ValueError, r'block at offset 0 is snappy-compressed'),
    ('unknown name', KeyError, r"tensor 'nope' is not in the checkpoint"),
    ('unsupported dtype', ValueError, r"tensor 'flag' has dtype bool"),
    ('big-endian bundle', ValueError, r'a big-endian bundle'),
    ('no checkpoint', FileNotFoundError, r'neither .*\.index \(V2\) nor'),
])
def test_refusals_name_themselves(case, err, match, tmp_path):
    prefix = str(tmp_path / 'model.ckpt')
    x = np.arange(3000, dtype=np.float32)
    tf_save(prefix, {'x': x, 'flag': np.array([True, False])},
            partitioned={'part': (4, 2)})
    if case == 'flipped index byte':
        _flip(prefix + '.index', 5)
    elif case == 'flipped data byte':
        reader = T.CheckpointReader(prefix)
        entry = reader._ckpt.entries['x']
        _flip(prefix + '.data-00000-of-00001', T._one(entry, 4) + 100)
    elif case == 'snappy block':
        _forge_snappy(prefix + '.index')
    elif case == 'big-endian bundle':
        _big_endian(prefix)
    elif case == 'no checkpoint':
        prefix += '.missing'
    name = {'unknown name': 'nope', 'unsupported dtype': 'flag',
            'partitioned variable': 'part'}.get(case, 'x')
    with pytest.raises(err, match=match):
        T.CheckpointReader(prefix).get_tensor(name)
