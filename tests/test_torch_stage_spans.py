"""The port's stage spans (``utils/trace.py``: ``span`` on the profiler's
clock, ``stage``, ``Tally``) on the CPU.

- Profiler path: with the recorder off and ``torch.profiler`` running, one
  small ``ShuffleContext.sort_by_key`` over columnar batches puts the job
  stage, task, record and codec span names on the profiler's timeline,
  records no event of the port's recorder and stacks no instrumented
  store.
- Off path: with the recorder and the profiler off, ``span`` and ``stage``
  are the shared no-op and never reach ``record_function``.
- Sink: with ``codec.timings = {}`` one job fills every stage key, with
  validation inside parse, the two stages inside the job's wall, one task
  counted per map and per reducer; with ``timings = None`` nothing is
  written anywhere.
"""

import time

import numpy as np
import pytest
import torch
from torch._C._profiler import _ExperimentalConfig, _RecordFunctionFast
from torch.profiler import ProfilerActivity, profile

from s3shuffle_tpu_torch import ShuffleConfig, ShuffleContext
from s3shuffle_tpu_torch.batch import RecordBatch
from s3shuffle_tpu_torch.serializer import ColumnarKVSerializer
from s3shuffle_tpu_torch.storage.instrumented import InstrumentedBackend
from s3shuffle_tpu_torch.trace import KNOWN_SPANS
from s3shuffle_tpu_torch.utils import trace
from torch_port_dispatcher import port_dispatcher_reset  # noqa: F401  (resets the port's process dispatcher)

MAPS, REDUCERS, ROWS = 4, 3, 1500
STAGE_SPANS = ("driver.sample", "driver.map_stage", "driver.reduce_stage", "driver.cleanup",
               "worker.task")
RECORD_SPANS = ("record.partition", "record.serialize", "record.deserialize", "record.sort")
CODEC_SPANS = ("codec.encode_stage", "codec.device_wait", "codec.encode_assembly",
               "codec.decode_parse", "codec.decode_validate", "codec.decode_emit",
               "codec.crc_host")
KEYS = ("sample_s", "map_stage_s", "reduce_stage_s", "cleanup_s", "map_task_s", "map_tasks",
        "reduce_task_s", "reduce_tasks", "record_host_s", "encode_stage_s",
        "encode_device_wait_s", "encode_assembly_s", "decode_parse_s", "decode_validate_s",
        "decode_device_wait_s", "decode_emit_s", "crc_host_s")


@pytest.fixture(autouse=True)
def recorder_off():
    trace.disable()
    trace.reset()
    yield
    trace.disable()
    trace.reset()


def _parts(seed=3):
    rng = np.random.default_rng(seed)
    pool = rng.integers(0, 256, (16, 90), dtype=np.uint8)
    out = []
    for _ in range(MAPS):
        keys = rng.integers(0, 256, (ROWS, 10), dtype=np.uint8).reshape(-1)
        vals = pool[rng.integers(0, 16, ROWS)].reshape(-1)
        out.append(RecordBatch(np.full(ROWS, 10, np.int32), np.full(ROWS, 90, np.int32),
                               keys, vals))
    return out


def _context(tmp_path):
    cfg = ShuffleConfig(root_dir=f"file://{tmp_path / 'store'}", codec="tpu",
                        checksum_algorithm="CRC32C", autotune=False, codec_block_size=2048,
                        codec_batch_blocks=4)
    return ShuffleContext(cfg, num_workers=2, device="cpu")


def _sort(ctx, parts):
    out = ctx.sort_by_key(parts, REDUCERS, serializer=ColumnarKVSerializer(),
                          materialize="batches")
    rows = np.concatenate([np.hstack([b.keys.reshape(-1, 10), b.values.reshape(-1, 90)])
                           for p in out for b in p if b.n])
    return rows


def _expected(parts):
    rows = np.concatenate([np.hstack([p.keys.reshape(-1, 10), p.values.reshape(-1, 90)])
                           for p in parts])
    order = np.lexsort(rows[:, :10].T[::-1])
    return rows[order]


def _profiled():
    return profile(activities=[ProfilerActivity.CPU],
                   experimental_config=_ExperimentalConfig(profile_all_threads=True))


# --- the profiler path ---

def test_a_profiled_sort_puts_every_stage_span_on_the_profiler_timeline(tmp_path):
    parts = _parts()
    with _profiled() as prof:
        ctx = _context(tmp_path)
        try:
            rows = _sort(ctx, parts)
            backend = ctx.manager.dispatcher.backend
        finally:
            ctx.stop()
    # keys sort as the reference's: equal 10-byte keys are vanishingly rare
    assert np.array_equal(rows[:, :10], _expected(parts)[:, :10])
    names = {e.name for e in prof.events()}
    missing = [n for n in STAGE_SPANS + RECORD_SPANS + CODEC_SPANS if n not in names]
    assert not missing
    assert all(n in KNOWN_SPANS for n in STAGE_SPANS + RECORD_SPANS + CODEC_SPANS)
    # the recorder stays off: no event, no counter, no instrumented store
    assert trace.events_snapshot() == [] and trace.counters() == {}
    assert not isinstance(backend, InstrumentedBackend)


def test_a_profiled_span_is_a_function_scope_range_and_records_nothing():
    with _profiled() as prof:
        span = trace.span("record.sort", rows=3)
        assert isinstance(span, _RecordFunctionFast)
        with span:
            pass
        with trace.stage("codec.crc_host", None, "crc_host_s"):
            pass
        with torch.profiler.record_function("user.range"):
            pass
    events = {e.name(): e for e in prof.profiler.kineto_results.events()}
    assert events["record.sort"].duration_ns() >= 0 and "codec.crc_host" in events
    # not of record_function's user scope, which the device timeline mirrors
    assert events["record.sort"].scope() != events["user.range"].scope()
    assert events["codec.crc_host"].scope() == events["record.sort"].scope()
    assert trace.events_snapshot() == []


def test_with_the_recorder_on_a_span_is_as_before(tmp_path):
    trace.enable(str(tmp_path / "trace.json"), torch_annotations=False)
    with _profiled() as prof:
        with trace.span("driver.job", app="t"):
            pass
    (event,) = trace.events_snapshot()
    assert event["name"] == "driver.job" and event["args"]["app"] == "t"
    assert "driver.job" not in {e.name for e in prof.events()}


# --- the off path ---

def _no_profiler_range(monkeypatch):
    def boom(*args, **kwargs):
        raise AssertionError("a profiler range opened with the profiler off")

    monkeypatch.setattr(torch.autograd.profiler, "record_function", boom)
    monkeypatch.setattr(trace, "_RecordFunctionFast", boom)


def test_off_span_and_stage_are_the_shared_noop(monkeypatch):
    _no_profiler_range(monkeypatch)

    class Codec:
        timings = None

    assert trace.span("record.sort") is trace._NOOP
    assert trace.stage("codec.crc_host", Codec(), "crc_host_s") is trace._NOOP
    assert trace.stage("codec.crc_host", None, "crc_host_s") is trace._NOOP
    assert trace.stage("record.sort", trace.Tally(Codec()), "record_host_s") is trace._NOOP
    with trace.span("record.sort"), trace.stage("codec.crc_host", None, "crc_host_s") as st:
        st.discard()


def test_an_unprofiled_sort_never_opens_a_profiler_range(tmp_path, monkeypatch):
    _no_profiler_range(monkeypatch)
    parts = _parts(5)
    ctx = _context(tmp_path)
    try:
        rows = _sort(ctx, parts)
    finally:
        ctx.stop()
    assert np.array_equal(rows[:, :10], _expected(parts)[:, :10])


# --- the sink ---

def test_one_job_fills_every_stage_key(tmp_path):
    parts = _parts(7)
    ctx = _context(tmp_path)
    try:
        _sort(ctx, parts)  # warm: the first job builds the staging buffers
        ctx.manager.codec.timings = t = {}
        t0 = time.perf_counter()
        rows = _sort(ctx, parts)
        wall = time.perf_counter() - t0
    finally:
        ctx.stop()
    assert np.array_equal(rows[:, :10], _expected(parts)[:, :10])
    missing = [k for k in KEYS if k not in t]
    assert not missing
    assert all(t[k] > 0 for k in KEYS)
    assert "encode_device_s" not in t and "decode_device_s" not in t
    assert t["decode_validate_s"] <= t["decode_parse_s"]
    assert t["crc_host_s"] > 0
    assert t["map_stage_s"] + t["reduce_stage_s"] <= wall
    assert t["sample_s"] + t["map_stage_s"] + t["reduce_stage_s"] + t["cleanup_s"] <= wall
    assert (t["map_tasks"], t["reduce_tasks"]) == (MAPS, REDUCERS)
    # tasks run inside their stage; threads add up, the stage is wall time
    assert t["map_task_s"] <= 2 * t["map_stage_s"] + 1e-3
    assert t["reduce_task_s"] <= 2 * t["reduce_stage_s"] + 1e-3


def test_a_sink_set_to_none_receives_nothing(tmp_path):
    parts = _parts(11)
    ctx = _context(tmp_path)
    kept = {}
    try:
        ctx.manager.codec.timings = None
        _sort(ctx, parts)
        assert ctx.manager.codec.timings is None
        ctx.manager.codec.timings = kept
        ctx.manager.codec.timings = None  # replaced before the job, as between windows
        _sort(ctx, parts)
    finally:
        ctx.stop()
    assert kept == {} and ctx.manager.codec.timings is None


def test_the_sink_is_read_as_each_stage_ends():
    class Codec:
        timings = None

    codec = Codec()
    with trace.stage("codec.crc_host", codec, "crc_host_s"):
        codec.timings = {}  # a stage that began with no sink adds nothing
    assert codec.timings == {}
    first = codec.timings
    with trace.stage("codec.crc_host", codec, "crc_host_s", count="batches"):
        codec.timings = second = {}  # replaced mid-stage: the new dict gets it
    assert first == {} and set(second) == {"crc_host_s", "batches"}
    assert second["batches"] == 1


def test_a_tally_adds_its_stages_at_once_and_a_discarded_stage_adds_nothing():
    class Codec:
        timings = {}

    codec = Codec()
    tally = trace.Tally(codec)
    for _ in range(5):
        with trace.stage("record.deserialize", tally, "record_host_s"):
            pass
    with trace.stage("codec.decode_parse", tally, "decode_parse_s") as st:
        st.discard()
    assert codec.timings == {}
    tally.flush()
    assert set(codec.timings) == {"record_host_s"}
    tally.flush()  # nothing twice
    seconds = codec.timings["record_host_s"]
    tally.flush()
    assert codec.timings["record_host_s"] == seconds
    assert trace.Tally(type("NoSink", (), {"timings": None})()).timings is None
    assert trace.Tally(None, keep=True).timings == {}


def test_a_dict_is_a_sink_as_the_jax_batch_functions_take_it():
    from s3shuffle_tpu_torch.ops import tlz
    from s3shuffle_tpu_torch.ops.checksum import POLY_CRC32C

    bs = 2048
    rng = np.random.default_rng(13)
    blocks = np.tile(rng.integers(0, 256, (4, 256), dtype=np.uint8), (1, bs // 256))
    enc, dec = {}, {}
    payloads, _ = tlz.encode_batch_device(blocks.tobytes(), 4, bs, batch_blocks=2,
                                          device="cpu", timings=enc)
    out, crcs = tlz.decode_batch_device(payloads, [bs] * 4, bs, batch_rows=2,
                                        poly=POLY_CRC32C, device="cpu", timings=dec)
    assert b"".join(out) == blocks.tobytes() and all(c is not None for c in crcs)
    assert set(enc) == {"encode_stage_s", "encode_device_wait_s", "encode_assembly_s"}
    # the stage keys, and the rows the validation and the stitch counted
    assert set(dec) == {"decode_parse_s", "decode_validate_s", "decode_device_wait_s",
                        "decode_emit_s", "crc_host_s", "validate_native_rows",
                        "crc_native_rows"}
    assert dec["validate_native_rows"] == dec["crc_native_rows"] == 4
    assert dec["decode_validate_s"] <= dec["decode_parse_s"]
    assert dec["crc_host_s"] <= dec["decode_emit_s"]


def test_armed_the_batch_stages_never_nest_and_fit_in_the_call(monkeypatch):
    """With the dispatcher armed over emulated lanes, acquiring a lane may
    drain an earlier batch (its device wait, assembly or emit): that drain
    must run between stages, so the disjoint keys (``tlz.STAGE_KEYS``)
    count no second alone and add up to no more than the call's wall."""
    from s3shuffle_tpu_torch.ops import tlz
    from s3shuffle_tpu_torch.ops.checksum import POLY_CRC32C
    from s3shuffle_tpu_torch.parallel import dispatch

    monkeypatch.setattr(dispatch, "local_devices",
                        lambda device_type="cuda": [torch.device("cpu")] * 2)
    dispatch.reset_for_testing()
    dispatch.configure(2)
    opened, nested = [], []
    real_stage = trace.stage

    class Watched:
        def __init__(self, key, inner):
            self.key, self.inner = key, inner

        def __enter__(self):
            if self.key in tlz.STAGE_KEYS:
                if opened:
                    nested.append((opened[-1], self.key))
                opened.append(self.key)
            return self.inner.__enter__()

        def __exit__(self, *exc):
            if self.key in tlz.STAGE_KEYS:
                opened.pop()
            return self.inner.__exit__(*exc)

    monkeypatch.setattr(trace, "stage",
                        lambda name, sink, key, *a, **k: Watched(key, real_stage(name, sink, key,
                                                                                 *a, **k)))
    bs, n = 2048, 6
    rng = np.random.default_rng(17)
    blocks = np.tile(rng.integers(0, 256, (n, 256), dtype=np.uint8), (1, bs // 256))
    try:
        assert tlz._mesh_dispatcher(torch.device("cpu")) is not None
        walls = {}
        for side in ("encode", "decode"):
            t = {}
            t0 = time.perf_counter()
            if side == "encode":
                payloads, _ = tlz.encode_batch_device(blocks.tobytes(), n, bs, batch_blocks=1,
                                                      device="cpu", timings=t)
            else:
                out, crcs = tlz.decode_batch_device(payloads, [bs] * n, bs, batch_rows=1,
                                                    poly=POLY_CRC32C, device="cpu", timings=t)
            walls[side] = (time.perf_counter() - t0, t)
        disp = dispatch.get_dispatcher("cpu")
        assert disp.outstanding_snapshot() == [0, 0]
    finally:
        dispatch.reset_for_testing()
    assert b"".join(out) == blocks.tobytes() and all(c is not None for c in crcs)
    assert nested == [] and opened == []
    for side, (wall, t) in walls.items():
        keys = [k for k in tlz.STAGE_KEYS if k.startswith(side)]
        assert all(t.get(k, 0) > 0 for k in keys), (side, t)
        assert sum(t[k] for k in keys) <= wall, (side, wall, t)


# --- the rows of the codec batch layer's host checks, by route ---

COUNT_KEYS = ("crc_native_rows", "crc_host_rows", "validate_native_rows", "validate_host_rows")


@pytest.mark.parametrize("route", ["native", "host"])
def test_every_device_shaped_row_counts_in_its_route(route, monkeypatch):
    """With the library loaded every device-shaped row of an encode and a
    decode counts in ``crc_native_rows`` and ``validate_native_rows``;
    forced off, in the ``*_host_rows`` keys. Counts, not seconds: outside
    ``tlz.STAGE_KEYS``, and the CRC and validation stages still nest in
    the decode's emit and parse."""
    from s3shuffle_tpu_torch.codec import native
    from s3shuffle_tpu_torch.codec.cuda import CudaCodec
    from s3shuffle_tpu_torch.ops import tlz
    from s3shuffle_tpu_torch.ops.checksum import POLY_CRC32C

    assert native.native_available(), "the port's native library must build here"
    if route == "host":
        monkeypatch.setattr(native, "native_available", lambda: False)
    bs, n = 2048, 5  # two launches of 4 rows, the second padded
    rng = np.random.default_rng(19)
    blocks = np.tile(rng.integers(0, 256, (n, 256), dtype=np.uint8), (1, bs // 256))
    codec = CudaCodec(block_size=bs, batch_blocks=4, device="cpu")
    codec.timings = enc = {}
    framed, crcs = codec.compress_framed_fused(blocks.tobytes(), n, bs)
    codec.timings = dec = {}
    frames, off = [], 0
    for _crc, length in crcs:
        frames.append((framed[off + 9 : off + length], bs))
        off += length
    tail = (tlz._assemble_payload_numpy(blocks[0, :1000].tobytes()), 1000)  # a host row
    out, payload_crcs = codec.decompress_blocks_fused(frames + [tail], POLY_CRC32C)
    assert out == blocks.tobytes() + blocks[0, :1000].tobytes()
    assert payload_crcs[-1] is None and None not in payload_crcs[:-1]
    assert not set(COUNT_KEYS) & set(tlz.STAGE_KEYS)
    ours, other = ("native", "host") if route == "native" else ("host", "native")
    assert enc[f"crc_{ours}_rows"] == n and f"validate_{ours}_rows" not in enc
    assert dec[f"crc_{ours}_rows"] == dec[f"validate_{ours}_rows"] == n
    assert not any(f"_{other}_rows" in k for k in (*enc, *dec))
    assert dec["decode_validate_s"] <= dec["decode_parse_s"]
    assert dec["crc_host_s"] <= dec["decode_emit_s"]


@pytest.mark.parametrize("route", ["native", "host"])
def test_a_job_counts_its_rows_in_one_route(tmp_path, route, monkeypatch):
    """A whole job (encode, the frame reader's header stitch, the decode):
    rows in the route's count keys only, the stage keys as before."""
    from s3shuffle_tpu_torch.codec import native

    if route == "host":
        monkeypatch.setattr(native, "native_available", lambda: False)
    parts = _parts(23)
    ctx = _context(tmp_path)
    try:
        ctx.manager.codec.timings = t = {}
        rows = _sort(ctx, parts)
    finally:
        ctx.stop()
    assert np.array_equal(rows[:, :10], _expected(parts)[:, :10])
    other = "host" if route == "native" else "native"
    assert t[f"crc_{route}_rows"] > t[f"validate_{route}_rows"] > 0
    assert not any(f"_{other}_rows" in k for k in t)
    assert all(t[k] > 0 for k in KEYS)
    assert t["decode_validate_s"] <= t["decode_parse_s"]
