"""The codec registry and the host codecs of the port against the JAX
package, on the CPU, exactly (stored bytes and results):

- the port reads a JAX map written at the JAX default config
  (``codec="auto"``: SLZ frames) and a JAX ``codec="tpu"`` map written with
  its host fallback on (SLZ frames in a TLZ-configured stream);
- for every codec name (``none``, ``zlib``, ``zstd``, ``native``, ``lz4``,
  ``tpu``) a TeraSort-shaped ``sort_by_key`` through both packages'
  ``ShuffleContext`` writes byte-equal object trees, and each package reads
  the other's objects;
- a frame of an unknown codec id raises;
- a map writer whose sink fails to build leaves no object behind once
  aborted, in both packages;
- ``flush_streams`` over several streams (their held full blocks in shared
  launches) gives each stream the sink bytes, frame counts and checksum of
  its own ``flush_block``, in launches of at most ``batch_blocks`` rows.

The JAX side runs ``codec="tpu"`` as ``tests/test_torch_record_slice.py``
runs it (``tpu_host_fallback=False``, ``encode_inflight_batches=1``, its
numpy TLZ host encoder); the port runs with ``device="cpu"``.
"""

import io
import os

import numpy as np
import pytest

from s3shuffle_tpu.batch import RecordBatch as JaxRecordBatch
from s3shuffle_tpu.config import ShuffleConfig as JaxConfig
from s3shuffle_tpu.dependency import RangePartitioner as JaxRangePartitioner
from s3shuffle_tpu.dependency import ShuffleDependency as JaxDependency
from s3shuffle_tpu.dependency import natural_key as jax_natural_key
from s3shuffle_tpu.manager import ShuffleManager as JaxManager
from s3shuffle_tpu.metadata.helper import ShuffleHelper as JaxHelper
from s3shuffle_tpu.metadata.map_output import MapStatus as JaxMapStatus
from s3shuffle_tpu.ops import tlz as jax_tlz
from s3shuffle_tpu.serializer import ColumnarKVSerializer as JaxColumnarKV
from s3shuffle_tpu.shuffle import ShuffleContext as JaxContext
from s3shuffle_tpu.storage.dispatcher import Dispatcher as JaxDispatcher
from s3shuffle_tpu.write import map_output_writer as jax_map_output_writer
from s3shuffle_tpu.write import pipelined_upload as jax_pipelined_upload
from s3shuffle_tpu.write.map_output_writer import MapOutputWriter as JaxMapOutputWriter
from s3shuffle_tpu_torch import ShuffleConfig, ShuffleContext, ShuffleManager
from s3shuffle_tpu_torch.batch import RecordBatch
from s3shuffle_tpu_torch.codec import CODEC_IDS, HEADER, CodecInputStream, get_codec
from s3shuffle_tpu_torch.codec.framing import codec_for_frame_id
from s3shuffle_tpu_torch.dependency import RangePartitioner, ShuffleDependency, natural_key
from s3shuffle_tpu_torch.dependency import range_bounds
from s3shuffle_tpu_torch.metadata.helper import ShuffleHelper
from s3shuffle_tpu_torch.metadata.map_output import STORE_LOCATION, MapStatus
from s3shuffle_tpu_torch.serializer import ColumnarKVSerializer
from s3shuffle_tpu_torch.storage.dispatcher import Dispatcher
from s3shuffle_tpu_torch.write import map_output_writer
from torch_jax_native import jax_native_library  # noqa: F401  (loads the JAX oracle's native library)
from torch_port_dispatcher import port_dispatcher_reset  # noqa: F401  (resets the port's process dispatcher)

BS = 2048
BATCH = 4
MAPS = 3
PARTS = 3
CODEC_NAMES = ["none", "zlib", "zstd", "native", "lz4", "tpu"]
ALGORITHMS = ["CRC32C", "ADLER32"]


@pytest.fixture(autouse=True)
def no_c_encoder(monkeypatch):
    """The JAX side encodes TLZ host blocks with numpy, as the record slice
    tests do (its C encoder picks other valid matches)."""
    monkeypatch.setattr(jax_tlz, "_encode_block_native", lambda _data: None)


def _arrays(seed: int, n: int = 1500):
    """TeraSort-shaped maps: 10-byte random keys, 90-byte values from a
    small pool (so every codec shrinks them)."""
    rng = np.random.default_rng(seed)
    pool = rng.integers(0, 256, (16, 90), dtype=np.uint8)
    return [(rng.integers(0, 256, (n, 10), dtype=np.uint8).reshape(-1),
             pool[rng.integers(0, 16, n)].reshape(-1)) for _ in range(MAPS)]


def _batches(arrays, cls):
    return [cls(np.full(len(k) // 10, 10, np.int32), np.full(len(v) // 90, 90, np.int32),
                k.copy(), v.copy()) for k, v in arrays]


def _expected_rows(arrays):
    return sorted(bytes(k[i * 10:(i + 1) * 10]) + bytes(v[i * 90:(i + 1) * 90])
                  for k, v in arrays for i in range(len(k) // 10))


def _bounds(arrays):
    sample = []
    for k, _v in arrays:
        n = len(k) // 10
        sample.extend(bytes(k[i * 10:(i + 1) * 10]) for i in range(0, n, max(1, n // 64)))
    return range_bounds(sample, PARTS)


def _objects(root) -> dict:
    out = {}
    for dirpath, _dirs, files in os.walk(root):
        for fn in files:
            full = os.path.join(dirpath, fn)
            with open(full, "rb") as f:
                out[os.path.relpath(full, root)] = f.read()
    return out


def _frame_ids(objects) -> set:
    """Codec ids of every frame of every data object."""
    ids = set()
    for name, data in objects.items():
        if not name.endswith(".data"):
            continue
        pos = 0
        while pos < len(data):
            cid, _ulen, clen = HEADER.unpack_from(data, pos)
            ids.add(cid)
            pos += HEADER.size + clen
    return ids


def _rows(out, cls):
    return [k + v for part in out for k, v in cls.concat(list(part)).iter_records()]


def _port_config(root, **knobs):
    return ShuffleConfig(root_dir=f"file://{root}", cleanup=False, **knobs)


def _jax_manager(root, **knobs):
    JaxDispatcher.reset()
    return JaxManager(JaxConfig(root_dir=f"file://{root}", cleanup=False, **knobs))


def _jax_tpu_knobs(name: str) -> dict:
    if name != "tpu":
        return {}
    return {"tpu_host_fallback": False, "encode_inflight_batches": 1}


def _read_sorted(mgr, dep, jax: bool):
    """Register every committed map found in the store with ``mgr`` and read
    each reduce partition back as ordered rows."""
    handle = mgr.register_shuffle(dep.shuffle_id, dep)
    status = JaxMapStatus if jax else MapStatus
    for m in range(MAPS):
        offsets = mgr.helper.get_partition_lengths(dep.shuffle_id, m)
        mgr.tracker.register_map_output(
            dep.shuffle_id,
            status(map_id=m, location=STORE_LOCATION, sizes=np.diff(np.asarray(offsets))),
        )
    out = [mgr.get_reader(handle, p, p + 1).read_result_batches() for p in range(PARTS)]
    return _rows(out, JaxRecordBatch if jax else RecordBatch)


def _port_reads(root, arrays, **knobs):
    mgr = ShuffleManager(_port_config(root, **knobs), device="cpu")
    dep = ShuffleDependency(shuffle_id=0, partitioner=RangePartitioner(_bounds(arrays)),
                            serializer=ColumnarKVSerializer(), key_ordering=natural_key)
    return _read_sorted(mgr, dep, jax=False)


def _jax_reads(root, arrays, **knobs):
    mgr = _jax_manager(root, **knobs)
    dep = JaxDependency(shuffle_id=0, partitioner=JaxRangePartitioner(_bounds(arrays)),
                        serializer=JaxColumnarKV(), key_ordering=jax_natural_key)
    return _read_sorted(mgr, dep, jax=True)


def _jax_sort(root, arrays, **knobs):
    ctx = JaxContext(manager=_jax_manager(root, **knobs), num_workers=2)
    out = ctx.sort_by_key(_batches(arrays, JaxRecordBatch), PARTS, serializer=JaxColumnarKV(),
                          materialize="batches", cleanup=False)
    return _rows(out, JaxRecordBatch)


@pytest.mark.parametrize(
    "jax_knobs, frame_id",
    [({}, CODEC_IDS["native-lz"]), ({"codec": "tpu", "tpu_host_fallback": True},
                                    CODEC_IDS["native-lz"])],
    ids=["jax-defaults", "jax-tpu-host-fallback"],
)
def test_port_reads_jax_maps_of_host_frames(tmp_path, jax_knobs, frame_id):
    """The JAX defaults (``codec="auto"``, ADLER32) and a JAX ``codec="tpu"``
    without a chip (host fallback on) both write SLZ frames; the port, at
    its own default ``codec="tpu"``, decodes them frame by frame."""
    arrays = _arrays(3)
    want = _expected_rows(arrays)
    assert _jax_sort(tmp_path, arrays, **jax_knobs) == want
    assert frame_id in _frame_ids(_objects(tmp_path))
    assert _port_reads(tmp_path, arrays) == want
    # the checksum sidecars were validated, not skipped: flip a stored byte
    name = next(n for n in _objects(tmp_path) if n.endswith(".data"))
    with open(os.path.join(tmp_path, name), "r+b") as f:
        f.seek(os.fstat(f.fileno()).st_size // 2)
        byte = f.read(1)[0]
        f.seek(-1, os.SEEK_CUR)
        f.write(bytes([byte ^ 0xFF]))
    with pytest.raises(IOError):
        _port_reads(tmp_path, arrays)


@pytest.mark.parametrize("algorithm", ALGORITHMS)
@pytest.mark.parametrize("name", CODEC_NAMES)
def test_objects_are_byte_equal_per_codec_and_each_package_reads_the_other(
        tmp_path, name, algorithm):
    arrays = _arrays(7)
    want = _expected_rows(arrays)
    knobs = dict(codec=name, checksum_algorithm=algorithm, codec_block_size=BS,
                 codec_batch_blocks=BATCH)
    port_root, jax_root = tmp_path / "port", tmp_path / "jax"
    ctx = ShuffleContext(_port_config(port_root, **knobs), num_workers=2, device="cpu")
    out = ctx.sort_by_key(_batches(arrays, RecordBatch), PARTS,
                          serializer=ColumnarKVSerializer(), materialize="batches",
                          cleanup=False)
    assert _rows(out, RecordBatch) == want
    assert _jax_sort(jax_root, arrays, **knobs, **_jax_tpu_knobs(name)) == want
    port_objs, jax_objs = _objects(port_root), _objects(jax_root)
    assert sorted(port_objs) == sorted(jax_objs)
    assert any(n.endswith(".data") for n in port_objs)
    for obj in port_objs:
        assert port_objs[obj] == jax_objs[obj], obj
    ids = _frame_ids(port_objs)
    if name == "none":
        assert ctx.manager.codec is None
    else:
        codec_id = ctx.manager.codec.codec_id
        assert ids <= {0, codec_id} and codec_id in ids
    assert _port_reads(jax_root, arrays, **knobs) == want
    assert _jax_reads(port_root, arrays, **knobs, **_jax_tpu_knobs(name)) == want


@pytest.mark.parametrize("name", ["zlib", "native", "lz4"])
def test_streams_of_mixed_frame_ids_decode_frame_by_frame(name):
    """One stream holding frames of another codec, of TLZ and raw frames,
    read through each stream codec; the registry builds each codec once."""
    rng = np.random.default_rng(5)
    pieces = [bytes(rng.integers(0, 3, 5000, dtype=np.uint8)), rng.bytes(3000),
              bytes(rng.integers(0, 5, 4096, dtype=np.uint8))]
    tlz = get_codec("tpu", block_size=BS, device="cpu")
    host = get_codec(name, block_size=BS)
    stream = host.compress_bytes(pieces[0]) + tlz.compress_bytes(pieces[1] + pieces[2]) \
        + host.compress_bytes(pieces[2])
    want = pieces[0] + pieces[1] + pieces[2] + pieces[2]
    for reader_codec in (host, tlz, get_codec("zlib", block_size=BS)):
        with CodecInputStream(reader_codec, io.BytesIO(stream), device="cpu") as s:
            assert s.read() == want
    assert codec_for_frame_id(host.codec_id) is codec_for_frame_id(host.codec_id)


@pytest.mark.parametrize("codec_id", [6, 9, 255])
def test_unknown_frame_id_raises(codec_id):
    payload = b"x" * 16
    frame = HEADER.pack(codec_id, len(payload), len(payload)) + payload
    codec = get_codec("tpu", block_size=BS, device="cpu")
    with pytest.raises(IOError, match=f"Unknown codec id in frame: {codec_id}"):
        CodecInputStream(codec, io.BytesIO(frame)).read()


def test_get_codec_names():
    assert get_codec("none") is None and get_codec("RAW") is None and get_codec("off") is None
    assert type(get_codec("auto")).__name__ == "NativeLZCodec"
    assert get_codec("zlib").block_size == 64 * 1024
    assert get_codec("tpu", device="cpu").block_size == 256 * 1024
    codec = get_codec("lz4", decode_batch_frames=0, decode_inflight_batches=3)
    assert codec.decode_batch_frames == 1 and codec.decode_inflight_batches == 3
    assert ShuffleConfig().codec == "tpu"
    with pytest.raises(ValueError, match="Unknown codec"):
        get_codec("snappy")


def test_zstd_names_the_codec_when_the_package_is_missing(monkeypatch):
    import builtins

    real_import = builtins.__import__

    def no_zstandard(name, *args, **kwargs):
        if name == "zstandard":
            raise ImportError("no module named zstandard")
        return real_import(name, *args, **kwargs)

    monkeypatch.setattr(builtins, "__import__", no_zstandard)
    with pytest.raises(ImportError, match='codec="zstd"'):
        get_codec("zstd")


def _failing_sink(stream, *_args, **_kwargs):
    """A sink constructor that fails after closing the stream it was handed
    (so no file handle outlives the test)."""
    stream.close()
    raise OSError("sink failed to build")


@pytest.mark.parametrize("queue_bytes", [32 * 1024 * 1024, 0], ids=["pipelined", "serial"])
def test_abort_after_a_failed_sink_leaves_no_object(tmp_path, monkeypatch, queue_bytes):
    """``create_block`` runs, then the sink around it fails to build: both
    packages' ``abort`` must delete the data object."""
    if queue_bytes:
        monkeypatch.setattr(map_output_writer, "PipelinedUploadStream", _failing_sink)
        monkeypatch.setattr(jax_pipelined_upload, "PipelinedUploadStream", _failing_sink)
    else:
        monkeypatch.setattr(map_output_writer, "MeasuredOutputStream", _failing_sink)
        monkeypatch.setattr(jax_map_output_writer, "MeasuredOutputStream", _failing_sink)
    port_root, jax_root = tmp_path / "port", tmp_path / "jax"
    disp = Dispatcher(ShuffleConfig(root_dir=f"file://{port_root}",
                                    upload_queue_bytes=queue_bytes))
    writer = map_output_writer.MapOutputWriter(disp, ShuffleHelper(disp), 0, 0, 2, device="cpu")
    jdisp = JaxDispatcher(JaxConfig(root_dir=f"file://{jax_root}", upload_queue_bytes=queue_bytes))
    jwriter = JaxMapOutputWriter(jdisp, JaxHelper(jdisp), 0, 0, 2)
    for w in (writer, jwriter):
        with pytest.raises(OSError, match="sink failed"):
            w.get_partition_writer(0).write(b"0123456789")
    assert _objects(port_root) and _objects(jax_root)  # the objects were created
    writer.abort()
    jwriter.abort()
    assert _objects(port_root) == {}
    assert _objects(jax_root) == {}


# --- the shared launches of several streams' held blocks ---

#: (full blocks, tail bytes) of each stream, by case, at BATCH = 4 rows a
#: launch
SHARED_CASES = {
    "tails-only": [(0, 700), (0, 1), (0, 2047)],
    "one-full-batch": [(BATCH, 0), (BATCH, 300), (1, 5)],
    "spans-two-launches": [(3, 10), (3, 0), (2, 99), (5, 1)],
    "empty-streams": [(0, 0), (2, 40), (0, 0), (3, 0), (0, 0)],
}


def _shared_codec(kind: str, window: int):
    if kind == "torch-cpu":
        from s3shuffle_tpu_torch.codec.cuda import CudaCodec

        return CudaCodec(BS, BATCH, device="cpu", encode_inflight_batches=window)
    codec = get_codec("native", block_size=BS)
    codec.batch_blocks = BATCH
    return codec


def _held_streams(codec, sizes, fused: bool, seed: int):
    """One output stream per size, each holding its full blocks and tail
    (written held, as the map writer serializes) without a launch."""
    from s3shuffle_tpu_torch.codec.cuda import FusedChecksumAccumulator
    from s3shuffle_tpu_torch.codec.framing import CodecOutputStream
    from s3shuffle_tpu_torch.ops.checksum import POLY_CRC32C

    rng = np.random.default_rng(seed)
    pool = rng.integers(0, 256, (8, 64), dtype=np.uint8)
    streams, raws = [], []
    for i, (full, tail) in enumerate(sizes):
        n = full * BS + tail
        rows = pool[rng.integers(0, 8, -(-n // 64))].reshape(-1)
        if i % 3 == 1:  # incompressible: the raw escape
            rows = rng.integers(0, 256, rows.size, dtype=np.uint8)
        raw = rows[:n].tobytes()
        acc = FusedChecksumAccumulator(POLY_CRC32C) if fused else None
        s = CodecOutputStream(codec, io.BytesIO(), close_sink=False, checksum=acc)
        s._holding = True
        s.write(raw)
        s._holding = False
        streams.append(s)
        raws.append(raw)
    return streams, raws


def _launch_model(sizes):
    """Launches and shared streams of packing the full blocks in stream
    order, BATCH rows a launch."""
    owners, block = {}, 0
    for i, (full, _tail) in enumerate(sizes):
        for _ in range(full):
            owners.setdefault(block // BATCH, set()).add(i)
            block += 1
    shared = set().union(*(o for o in owners.values() if len(o) > 1), set())
    return len(owners), len(shared)


@pytest.mark.parametrize("fused", [True, False], ids=["fused-crc", "no-checksum"])
@pytest.mark.parametrize("window", [1, 2], ids=["sync", "window2"])
@pytest.mark.parametrize("kind", ["torch-cpu", "native"])
@pytest.mark.parametrize("case", list(SHARED_CASES))
def test_shared_launches_give_each_stream_its_own_flush(case, kind, window, fused):
    from s3shuffle_tpu_torch.codec.framing import flush_streams

    sizes = SHARED_CASES[case]
    codecs = [_shared_codec(kind, window) for _ in range(2)]
    for c in codecs:
        c.timings = {}
    alone, raws = _held_streams(codecs[0], sizes, fused, seed=31)
    shared, _ = _held_streams(codecs[1], sizes, fused, seed=31)
    for s in alone:
        s.flush_block()
    flush_streams(shared)
    for a, s, raw in zip(alone, shared, raws):
        assert s._sink.getvalue() == a._sink.getvalue()
        assert (s.frames, s.fused_frames) == (a.frames, a.fused_frames)
        assert s.pending_bytes == 0 and not s._inflight
        if fused:
            assert s._checksum.value == a._checksum.value
        assert CodecInputStream(codecs[0], io.BytesIO(s._sink.getvalue())).read() == raw
    launches, shared_streams = _launch_model(sizes)
    held = sum(full for full, _tail in sizes)
    assert launches == -(-held // BATCH)
    assert codecs[1].timings.get("encode_launches", 0) == launches
    assert codecs[1].timings.get("encode_shared_streams", 0) == shared_streams
    assert codecs[0].timings.get("encode_launches", 0) == sum(
        -(-full // BATCH) for full, _tail in sizes)
    if fused and kind == "torch-cpu":
        assert sum(s.fused_frames for s in shared) == held
