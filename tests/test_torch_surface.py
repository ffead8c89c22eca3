"""The port's public surface against the JAX package's, name for name, and
the behaviour of the names that made it whole.

- Every module of the JAX package has a counterpart at the same path in the
  port (``codec/tpu.py``'s work is ``codec/cuda.py``'s, ``TpuCodec`` is
  ``CudaCodec``), or stays out by rule (:data:`NO_COUNTERPART`).
- In each counterpart, every public top-level name of the JAX module (for a
  package ``__init__``, its imports too), every public attribute of its
  public classes and every ``__all__`` entry exists in the port; only
  :data:`BY_RULE` names stay out, each with its reason.
- Every public function and method of the JAX module takes the same
  parameters in the same order in the port; the port may add ``device``
  anywhere and its own parameters after the JAX ones
  (:data:`PARAMETER_RULES` lists the by-rule departures).
- ``parse_column_frame`` returns a ``ColumnFrame`` equal to the JAX one's
  for JAX- and port-written frames; ``ops.crc32_batch`` and
  ``ops.adler32_batch`` equal the JAX ones and zlib / CRC32C on ragged
  right-aligned batches; ``codec.cuda.fused_compress_and_checksum`` gives
  the JAX function's frames and CRCs; ``FrameCodec.compress_stream`` /
  ``decompress_stream`` / ``frame_block`` and ``decompress_frame_payload``
  give the JAX codec's bytes; the small names behave as the JAX ones.

The port runs with ``device="cpu"`` (its kernels' plain versions); the JAX
TLZ side runs its Pallas kernels in interpret mode.
"""

import ast
import importlib
import inspect
import io
import logging
import zlib
from pathlib import Path

import numpy as np
import pytest
import torch

import s3shuffle_tpu
import s3shuffle_tpu_torch
from s3shuffle_tpu.ops import tlz as jax_tlz
from torch_jax_native import jax_native_library  # noqa: F401  (loads the JAX oracle's native library)
from torch_port_dispatcher import port_dispatcher_reset  # noqa: F401  (resets the port's process dispatcher)

JAX_ROOT = Path(s3shuffle_tpu.__file__).resolve().parent
PORT_ROOT = Path(s3shuffle_tpu_torch.__file__).resolve().parent

#: JAX modules with no counterpart in the port, each by rule
NO_COUNTERPART = {
    "ops/rates.py": "the measured-rate gate; nothing hides the device, so the port has no gate",
    "ops/crc_pallas.py": "a Pallas kernel; K1 is csrc/crc_fold.cu behind ops/crc_cuda.py",
    "ops/tlz_pallas.py": "Pallas kernels; K2 and K3 are csrc/tlz_planes.cu and "
                         "csrc/tlz_decode_fused.cu behind ops/tlz_cuda.py",
    "coding/gf_pallas.py": "a Pallas kernel; K4 is csrc/gf_encode.cu behind coding/gf_cuda.py",
}
#: JAX module → (port module, class names mapped)
MAPPED = {"codec/tpu.py": ("codec/cuda.py", {"TpuCodec": "CudaCodec"})}
#: (JAX module, name) → why the port does not have it
BY_RULE = {
    ("config.py", "CODEC_LABEL_MODES"):
        "its labels select the JAX codec's host fallback, which the port does not have",
    ("config.py", "ShuffleConfig.tpu_host_fallback"):
        "the host fallback's knob: nothing hides the device",
    ("config.py", "ShuffleConfig.codec_repin_probe_s"):
        "the host pin's re-probe knob: the port pins nothing to the host",
    ("parallel/mesh.py", "get_shard_map"):
        "the import shim of jax's shard_map: the port's exchange is peer copies",
}
#: (JAX module, function) → (JAX parameters the port leaves out, renames,
#: reason)
PARAMETER_RULES = {
    ("codec/__init__.py", "get_codec"): (
        {"tpu_host_fallback", "repin_probe_s"}, {},
        "the host fallback and its re-probe: nothing hides the device"),
    ("parallel/dispatch.py", "DeviceDispatcher.acquire"): (
        {"op"}, {}, "the class gate: with no rate gate every lane is eligible for every op"),
    ("utils/trace.py", "enable"): (
        set(), {"jax_annotations": "torch_annotations"},
        "spans annotate torch.profiler's trace, not jax's"),
    ("codec/tpu.py", "TpuCodec.__init__"): (
        {"use_device", "host_encode_fallback", "repin_probe_s"}, {},
        "the device is chosen by device=; no host encode fallback or re-probe"),
}


def _module_name(pkg: str, rel: str) -> str:
    parts = list(Path(rel).with_suffix("").parts)
    if parts[-1] == "__init__":
        parts = parts[:-1]
    return ".".join([pkg, *parts])


def _jax_modules():
    return sorted(p.relative_to(JAX_ROOT).as_posix() for p in JAX_ROOT.rglob("*.py"))


def _pairs():
    out = []
    for rel in _jax_modules():
        port_rel = MAPPED.get(rel, (rel, {}))[0]
        if (PORT_ROOT / port_rel).exists():
            out.append(rel)
    return out


PAIRS = _pairs()


def _load(rel: str):
    port_rel, names = MAPPED.get(rel, (rel, {}))
    return (importlib.import_module(_module_name("s3shuffle_tpu", rel)),
            importlib.import_module(_module_name("s3shuffle_tpu_torch", port_rel)), names)


def _public_definitions(rel: str):
    """Public top-level names a JAX module defines (and, for a package
    ``__init__``, imports), and its public classes, by its source."""
    path = JAX_ROOT / rel
    tree = ast.parse(path.read_text())
    names, classes = set(), set()
    for node in tree.body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            names.add(node.name)
        elif isinstance(node, ast.ClassDef):
            names.add(node.name)
            classes.add(node.name)
        elif isinstance(node, ast.Assign):
            names.update(t.id for t in node.targets if isinstance(t, ast.Name))
        elif isinstance(node, ast.AnnAssign) and isinstance(node.target, ast.Name):
            names.add(node.target.id)
        elif path.name == "__init__.py" and isinstance(node, ast.ImportFrom):
            names.update(a.asname or a.name for a in node.names)
    public = lambda n: not n.startswith("_")  # noqa: E731
    return sorted(filter(public, names)), sorted(filter(public, classes))


def _functions(rel: str):
    """Public functions and public methods (their own, by the source) of
    the JAX module's public classes: ``name`` or ``Class.method``."""
    tree = ast.parse((JAX_ROOT / rel).read_text())
    out = []
    for node in tree.body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)) and not node.name.startswith("_"):
            out.append(node.name)
        elif isinstance(node, ast.ClassDef) and not node.name.startswith("_"):
            for item in node.body:
                if isinstance(item, (ast.FunctionDef, ast.AsyncFunctionDef)) and (
                        not item.name.startswith("_") or item.name == "__init__"):
                    out.append(f"{node.name}.{item.name}")
    return out


def _resolve(module, dotted: str, names: dict):
    obj = module
    for i, part in enumerate(dotted.split(".")):
        obj = getattr(obj, names.get(part, part) if i == 0 else part, None)
        if obj is None:
            return None
    return obj


def test_every_jax_module_has_a_counterpart_or_a_rule():
    for rel in _jax_modules():
        port_rel = MAPPED.get(rel, (rel, {}))[0]
        assert (PORT_ROOT / port_rel).exists() or rel in NO_COUNTERPART, rel
    for rel in NO_COUNTERPART:
        assert (JAX_ROOT / rel).exists() and not (PORT_ROOT / rel).exists(), rel


@pytest.mark.parametrize("rel", PAIRS)
def test_public_names_exist_in_the_port(rel):
    jax_mod, port_mod, names = _load(rel)
    top, classes = _public_definitions(rel)
    missing = []
    for name in top:
        obj = getattr(jax_mod, name, None)
        if inspect.ismodule(obj) or isinstance(obj, logging.Logger):
            continue  # an imported module or a module's logger is no API
        if not hasattr(port_mod, names.get(name, name)):
            missing.append(name)
    for cls in classes:
        port_cls = getattr(port_mod, names.get(cls, cls), None)
        if port_cls is None:
            continue  # reported above
        for attr in dir(getattr(jax_mod, cls)):
            if attr.startswith("_") or hasattr(object, attr):
                continue
            if not hasattr(port_cls, attr):
                missing.append(f"{cls}.{attr}")
    for entry in getattr(jax_mod, "__all__", None) or ():
        if entry not in (getattr(port_mod, "__all__", None) or ()):
            missing.append(f"__all__ {entry}")
    assert [m for m in missing if (rel, m) not in BY_RULE] == []


@pytest.mark.parametrize("rel", PAIRS)
def test_parameter_names_match(rel):
    jax_mod, port_mod, names = _load(rel)
    differ = []
    for dotted in _functions(rel):
        jax_fn = _resolve(jax_mod, dotted, {})
        port_fn = _resolve(port_mod, dotted, names)
        if port_fn is None or not callable(jax_fn):
            continue  # a missing name is the other test's finding
        try:
            jax_params = list(inspect.signature(jax_fn).parameters)
            port_params = list(inspect.signature(port_fn).parameters)
        except (TypeError, ValueError):
            continue  # a builtin without a signature
        dropped, renamed, _why = PARAMETER_RULES.get((rel, dotted), (set(), {}, ""))
        want = [renamed.get(p, p) for p in jax_params if p not in dropped]
        got = [p for p in port_params if p != "device"]
        if got[: len(want)] != want:
            differ.append(f"{dotted}: {want} vs {got}")
    assert differ == []


def test_every_rule_exception_is_still_needed():
    """A name the port now has must leave the by-rule lists."""
    for rel, dotted in BY_RULE:
        jax_mod, port_mod, names = _load(rel)
        if dotted.startswith("__all__"):
            continue
        assert _resolve(jax_mod, dotted, {}) is not None, (rel, dotted)
        assert _resolve(port_mod, dotted, names) is None, (rel, dotted)
    for (rel, dotted), (dropped, renamed, _why) in PARAMETER_RULES.items():
        jax_mod, port_mod, names = _load(rel)
        jax_params = set(inspect.signature(_resolve(jax_mod, dotted, {})).parameters)
        port_params = set(inspect.signature(_resolve(port_mod, dotted, names)).parameters)
        assert dropped <= jax_params and not dropped & port_params, (rel, dotted)
        assert all(a in jax_params and b in port_params for a, b in renamed.items())


# ---------------------------------------------------------------------------
# ColumnFrame
# ---------------------------------------------------------------------------


def _frame_batch(pkg, shape: str):
    rng = np.random.default_rng(3)
    batch_mod = importlib.import_module(f"{pkg}.batch")
    if shape == "fixed":
        records = [(rng.integers(0, 256, 10, dtype=np.uint8).tobytes(),
                    rng.integers(0, 256, 90, dtype=np.uint8).tobytes()) for _ in range(50)]
    else:
        records = [(rng.integers(0, 256, int(rng.integers(0, 20)), dtype=np.uint8).tobytes(),
                    rng.integers(0, 256, int(rng.integers(0, 40)), dtype=np.uint8).tobytes())
                   for _ in range(50)]
    return batch_mod.RecordBatch.from_records(records), records


@pytest.mark.parametrize("writer", ["jax", "port"])
@pytest.mark.parametrize("shape", ["fixed", "varlen"])
def test_column_frame_parses_equal_in_both_packages(writer, shape):
    pkg = {"jax": "s3shuffle_tpu", "port": "s3shuffle_tpu_torch"}[writer]
    batch, records = _frame_batch(pkg, shape)
    buf = io.BytesIO()
    assert importlib.import_module(f"{pkg}.colframe").write_column_frame(buf, batch, schema=7)
    payload = buf.getvalue()[4:]
    from s3shuffle_tpu.colframe import parse_column_frame as jax_parse
    from s3shuffle_tpu_torch.colframe import ColumnFrame, parse_column_frame

    port = parse_column_frame(payload)
    jax = jax_parse(payload)
    assert isinstance(port, ColumnFrame)
    assert (port.schema, port.columns, port.n) == (jax.schema, jax.columns, jax.n) == \
        (7, jax.columns, 50)
    assert port.batch.to_records() == jax.batch.to_records() == records


# ---------------------------------------------------------------------------
# ops: the batch checksums
# ---------------------------------------------------------------------------


def _ragged(width: int, seed: int):
    from s3shuffle_tpu_torch.ops.checksum import stage_right_aligned

    rng = np.random.default_rng(seed)
    lengths = [0, width, *rng.integers(0, width + 1, 6).tolist()]
    chunks = [rng.integers(0, 256, n, dtype=np.uint8).tobytes() for n in lengths]
    rows, lens = stage_right_aligned(chunks, width)
    return chunks, rows, lens


@pytest.mark.parametrize("width", [1, 7, 64, 3000, 16389])
@pytest.mark.parametrize("poly", ["CRC32", "CRC32C"])
def test_crc32_batch_equals_jax_and_the_host(width, poly):
    from s3shuffle_tpu.ops import crc32_batch as jax_crc32_batch
    from s3shuffle_tpu_torch import ops
    from s3shuffle_tpu_torch.utils.checksums import crc32c

    chunks, rows, lens = _ragged(width, seed=width)
    value = getattr(ops, f"POLY_{poly}")
    got = ops.crc32_batch(rows, lens, value, device="cpu")
    assert got.dtype == np.uint32
    host = [zlib.crc32(c) if poly == "CRC32" else crc32c(c) for c in chunks]
    assert got.tolist() == host == jax_crc32_batch(rows, lens, poly=value).tolist()
    assert ops.crc32_batch(torch.from_numpy(rows), lens, value, block_len=width,
                           device="cpu").tolist() == host


@pytest.mark.parametrize("width", [1, 2048, 5000])
def test_adler32_batch_equals_jax_and_zlib(width):
    from s3shuffle_tpu.ops import adler32_batch as jax_adler32_batch
    from s3shuffle_tpu_torch.ops import adler32_batch

    chunks, rows, lens = _ragged(width, seed=width + 1)
    got = adler32_batch(rows, lens, device="cpu")
    assert got.tolist() == [zlib.adler32(c) for c in chunks] == \
        jax_adler32_batch(rows, lens).tolist()


def test_batch_checksums_refuse_bad_shapes_and_a_missing_card():
    from s3shuffle_tpu_torch.ops import adler32_batch, crc32_batch

    rows = np.zeros((2, 16), dtype=np.uint8)
    with pytest.raises(ValueError, match="block_len"):
        crc32_batch(rows, [1, 2], block_len=8, device="cpu")
    with pytest.raises(ValueError, match="lengths"):
        crc32_batch(rows, [1, 17], device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            crc32_batch(rows, [1, 2])
        with pytest.raises(RuntimeError, match="no CUDA device"):
            adler32_batch(rows, [1, 2])


# ---------------------------------------------------------------------------
# codec: the fused batch, the streams and the frame dispatch
# ---------------------------------------------------------------------------

BS = 2048
BATCH = 4


@pytest.fixture
def jax_tlz_oracle(monkeypatch):
    monkeypatch.setenv("S3SHUFFLE_TLZ_PALLAS", "1")
    monkeypatch.setattr(jax_tlz, "_encode_block_native", lambda _data: None)


def _terasort_blocks(n: int, tail: int = 0):
    rng = np.random.default_rng(11)
    pool = rng.integers(0, 256, (64, 90), dtype=np.uint8)
    rows = np.concatenate([rng.integers(0, 256, (n * BS // 100 + 1, 10), dtype=np.uint8),
                           pool[rng.integers(0, 64, n * BS // 100 + 1)]], axis=1)
    data = rows.reshape(-1)[: n * BS].tobytes()
    blocks = [data[i * BS:(i + 1) * BS] for i in range(n)]
    return blocks + ([data[:tail]] if tail else [])


@pytest.mark.parametrize("n_full,tail", [(4, 0), (3, 777)])
def test_fused_compress_and_checksum_equals_jax(jax_tlz_oracle, n_full, tail):
    from s3shuffle_tpu.codec.tpu import TpuCodec
    from s3shuffle_tpu.codec.tpu import fused_compress_and_checksum as jax_fused
    from s3shuffle_tpu_torch.codec.cuda import CudaCodec, fused_compress_and_checksum
    from s3shuffle_tpu_torch.ops.checksum import POLY_CRC32C, crc_combine
    from s3shuffle_tpu_torch.utils.checksums import crc32c

    blocks = _terasort_blocks(n_full, tail)
    frames, crcs = fused_compress_and_checksum(CudaCodec(BS, BATCH, device="cpu"), blocks)
    jax_frames, jax_crcs = jax_fused(TpuCodec(BS, BATCH, use_device=True), blocks)
    assert frames == jax_frames
    assert crcs == [int(c) for c in jax_crcs] == [crc32c(f) for f in frames]
    whole = 0
    for frame, crc in zip(frames, crcs):
        whole = crc_combine(whole, crc, len(frame), POLY_CRC32C)
    assert whole == crc32c(b"".join(frames))


class _KeptSink(io.BytesIO):
    """A sink that keeps its bytes when a stream closes it."""

    def close(self):
        self.kept = self.getvalue()
        super().close()


@pytest.mark.parametrize("name", ["zlib", "native"])
def test_codec_streams_and_frames_equal_jax(name):
    from s3shuffle_tpu.codec import get_codec as jax_get_codec
    from s3shuffle_tpu.codec.framing import decompress_frame_payload as jax_payload
    from s3shuffle_tpu_torch.codec import HEADER, get_codec
    from s3shuffle_tpu_torch.codec.framing import (
        _codec_for_frame_id,
        codec_for_frame_id,
        decompress_frame_payload,
    )

    data = b"".join(_terasort_blocks(5, 300))
    codec, jax_codec = get_codec(name), jax_get_codec(name)
    out, jax_out = _KeptSink(), _KeptSink()
    for c, sink in ((codec, out), (jax_codec, jax_out)):
        stream = c.compress_stream(sink)
        stream.write(data)
        stream.close()  # closes the sink too
    assert out.kept == jax_out.kept
    assert codec.decompress_stream(io.BytesIO(jax_out.kept)).read() == data
    frame = codec.frame_block(data[:BS])
    assert frame == jax_codec.frame_block(data[:BS])
    codec_id, ulen, clen = HEADER.unpack(frame[:HEADER.size])
    payload = frame[HEADER.size:]
    assert len(payload) == clen
    for hint in (codec, None):
        assert decompress_frame_payload(codec_id, payload, ulen, hint) == data[:BS] == \
            jax_payload(codec_id, payload, ulen, None)
    assert _codec_for_frame_id is codec_for_frame_id


# ---------------------------------------------------------------------------
# the small names
# ---------------------------------------------------------------------------


def test_package_build_info_and_version():
    from s3shuffle_tpu_torch.version import BUILD_INFO

    assert s3shuffle_tpu_torch.BUILD_INFO is BUILD_INFO
    assert s3shuffle_tpu_torch.__version__ == s3shuffle_tpu.__version__
    assert {"BUILD_INFO", "__version__"} <= set(s3shuffle_tpu_torch.__all__)


@pytest.mark.parametrize("root", ["file:///tmp/x", "s3://bucket/p", "memory://m", "/plain/path"])
def test_config_scheme_equals_jax(root):
    from s3shuffle_tpu.config import ShuffleConfig as JaxConfig
    from s3shuffle_tpu_torch.config import ShuffleConfig

    assert ShuffleConfig(root_dir=root).scheme == JaxConfig(root_dir=root).scheme


def test_manager_codec_is_its_shared_codec(tmp_path):
    from s3shuffle_tpu_torch import ShuffleConfig, ShuffleManager

    manager = ShuffleManager(ShuffleConfig(root_dir=f"file://{tmp_path}", codec="zlib"),
                             device="cpu")
    try:
        assert manager.codec is manager._codec and manager.codec.name == "zlib"
    finally:
        manager.stop()


def test_shuffle_id_of_and_the_long_packing_equal_jax():
    from s3shuffle_tpu.block_ids import ShuffleDataBlockId as JaxData
    from s3shuffle_tpu.block_ids import shuffle_id_of as jax_shuffle_id_of
    from s3shuffle_tpu.metadata.helper import pack_longs_be as jax_pack
    from s3shuffle_tpu_torch.block_ids import ShuffleDataBlockId, shuffle_id_of
    from s3shuffle_tpu_torch.metadata.helper import pack_longs_be, unpack_longs_be

    assert shuffle_id_of(ShuffleDataBlockId(7, 3)) == jax_shuffle_id_of(JaxData(7, 3)) == 7
    values = [0, 1, -1, 2**62, -(2**63)]
    assert pack_longs_be(values) == jax_pack(values)
    assert unpack_longs_be(pack_longs_be(values)) == values
    with pytest.raises(ValueError, match="multiple of 8"):
        unpack_longs_be(b"\0" * 9)


def test_concurrent_object_map_equals_jax():
    from s3shuffle_tpu.utils.concurrent_map import ConcurrentObjectMap as JaxMap
    from s3shuffle_tpu_torch.utils.concurrent_map import ConcurrentObjectMap

    seen = {}
    for cls in (ConcurrentObjectMap, JaxMap):
        m, closed = cls(), []
        m.put("a", 1)
        m.get_or_else_put("b", lambda _k: 2)
        m.put("c", 3)
        state = [m.get("a"), m.get("z"), sorted(m.keys()), "b" in m, "z" in m, len(m)]
        state.append(m.remove(lambda k: k != "a", action=closed.append))
        m.clear(action=closed.append)
        seen[cls] = state + [sorted(closed), len(m)]
    assert seen[ConcurrentObjectMap] == seen[JaxMap] == \
        [1, None, ["a", "b", "c"], True, False, 3, 2, [1, 2, 3], 0]


def test_checksum_stream_pending_uncertified_equals_jax():
    from s3shuffle_tpu.block_ids import ShuffleDataBlockId as JaxData
    from s3shuffle_tpu.read.checksum_stream import ChecksumValidationStream as JaxStream
    from s3shuffle_tpu_torch.block_ids import ShuffleDataBlockId
    from s3shuffle_tpu_torch.read.checksum_stream import ChecksumValidationStream
    from s3shuffle_tpu_torch.utils.checksums import crc32c

    data = bytes(range(256)) * 8
    offsets = np.array([0, 1000, len(data)], dtype=np.int64)
    sums = np.array([crc32c(data[:1000]), crc32c(data[1000:])], dtype=np.int64)
    seen = []
    for cls, block in ((ChecksumValidationStream, ShuffleDataBlockId(0, 0)),
                       (JaxStream, JaxData(0, 0))):
        stream = cls(block, io.BytesIO(data), offsets, sums, 0, 2, "CRC32C")
        assert stream.defer_validation()
        trail = [stream.pending_uncertified]
        got = stream.read(600)
        trail.append(stream.pending_uncertified)
        stream.certify(len(got))
        trail.append(stream.pending_uncertified)
        seen.append(trail)
    assert seen[0] == seen[1] == [0, 600, 0]


def test_partition_writer_bytes_written_and_spill_budget(tmp_path):
    from s3shuffle_tpu_torch import ShuffleConfig
    from s3shuffle_tpu_torch.dependency import HashPartitioner, ShuffleDependency
    from s3shuffle_tpu_torch.manager import BypassMergeShuffleHandle
    from s3shuffle_tpu_torch.metadata.helper import ShuffleHelper
    from s3shuffle_tpu_torch.storage.dispatcher import Dispatcher
    from s3shuffle_tpu_torch.write.map_output_writer import MapOutputWriter
    from s3shuffle_tpu_torch.write.spill_writer import ShuffleMapWriter

    disp = Dispatcher(ShuffleConfig(root_dir=f"file://{tmp_path}", codec="zlib"))
    writer = MapOutputWriter(disp, ShuffleHelper(disp), 0, 0, 2, codec=None, device="cpu")
    pw = writer.get_partition_writer(0)
    pw.write(b"abc")
    pw.write(memoryview(b"defg"))
    assert pw.bytes_written == 7
    with pytest.raises(AttributeError):
        pw.bytes_written = 0
    pw.close()
    writer.abort()
    handle = BypassMergeShuffleHandle(1, ShuffleDependency(1, HashPartitioner(2)))
    out = MapOutputWriter(disp, ShuffleHelper(disp), 1, 0, 2, codec=None, device="cpu")
    for budget, want in ((12345, 12345), (None, disp.config.max_buffer_size_task)):
        map_writer = ShuffleMapWriter(handle=handle, map_id=0, output_writer=out, codec=None,
                                      on_commit=lambda *a: None, spill_memory_budget=budget)
        assert map_writer.spill_memory_budget == want
        map_writer.stop(False)


def test_resolve_block_range_takes_must_raise(tmp_path):
    from s3shuffle_tpu_torch import ShuffleConfig
    from s3shuffle_tpu_torch.block_ids import ShuffleBlockId
    from s3shuffle_tpu_torch.metadata.helper import ShuffleHelper
    from s3shuffle_tpu_torch.read.block_iterator import resolve_block_range
    from s3shuffle_tpu_torch.storage.dispatcher import Dispatcher

    helper = ShuffleHelper(Dispatcher(ShuffleConfig(root_dir=f"file://{tmp_path}")))
    assert resolve_block_range(helper, ShuffleBlockId(0, 0, 0), must_raise=False) is None
    with pytest.raises(FileNotFoundError):
        resolve_block_range(helper, ShuffleBlockId(0, 0, 0), must_raise=True)


@pytest.mark.parametrize("use_native", [None, False, True])
def test_decode_payload_numpy_use_native_equals_jax(use_native):
    from s3shuffle_tpu_torch.ops import tlz

    block = _terasort_blocks(1)[0]
    payload = tlz._assemble_payload_numpy(block)
    assert payload == jax_tlz._assemble_payload_numpy(block)
    got = tlz.decode_payload_numpy(payload, len(block), use_native=use_native)
    assert got == block == jax_tlz.decode_payload_numpy(payload, len(block), use_native=use_native)
    bad = payload[:-1]
    with pytest.raises((IOError, RuntimeError)):
        tlz.decode_payload_numpy(bad, len(block), use_native=use_native)


def test_raw_crc_graph_fn_is_k1_over_its_shape():
    from s3shuffle_tpu_torch.ops.checksum import POLY_CRC32C, raw_crc_graph_fn, zero_run_crcs
    from s3shuffle_tpu_torch.utils.checksums import crc32c

    chunks, rows, lens = _ragged(300, seed=5)
    fn = raw_crc_graph_fn(POLY_CRC32C, 300, len(chunks))
    raw = fn(torch.from_numpy(rows)).numpy().astype(np.uint32)
    assert (raw ^ zero_run_crcs(POLY_CRC32C, 300)[lens]).tolist() == [crc32c(c) for c in chunks]
    with pytest.raises(ValueError, match="expected"):
        fn(torch.from_numpy(rows[:2]))
