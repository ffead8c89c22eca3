"""The port's wire-schema registry (``s3shuffle_tpu_torch/wire/schema.py``)
and its bindings, held against the JAX package.

- every golden blob under ``tests/fixtures/wire/`` decodes through the
  port's readers to what the JAX readers decode, and the port's writers
  reproduce the current-version blobs byte for byte;
- shuffle-lint's WIRE01 (``tools/shuffle_lint/rules/wire01.py``) over the
  port's implementing modules, with a model filled from the port's
  registry and ``version.py``, reports nothing; a registry edit without a
  format bump, or a dropped ``_WIRE_STRUCTS`` binding, trips it;
- the port's registry is the JAX one with the module paths mapped, and its
  rendered appendix is the JAX one with the package name mapped.
"""

import copy
import importlib
import io
import os
import struct

import numpy as np
import pytest

from s3shuffle_tpu.wire import schema as jax_schema
from s3shuffle_tpu_torch.version import SHUFFLE_FORMAT_VERSION
from s3shuffle_tpu_torch.wire import WIRE_STRUCTS, render_wire_doc
from s3shuffle_tpu_torch.wire.schema import max_current_format
from tools.shuffle_lint.core import ProjectModel, lint_source
from tools.shuffle_lint.rules import wire01

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURES = os.path.join(REPO_ROOT, "tests", "fixtures", "wire")
BLOBS = sorted(f for f in os.listdir(FIXTURES) if f.endswith(".bin"))
PORT_MODULES = sorted({spec["module"] for spec in WIRE_STRUCTS.values()})


def blob(name: str) -> bytes:
    with open(os.path.join(FIXTURES, name), "rb") as f:
        return f.read()


def words_of(data: bytes) -> np.ndarray:
    return np.frombuffer(data, dtype=">i8").astype(np.int64)


def _mod(pkg: str, name: str):
    return importlib.import_module(f"{pkg}.{name}")


def _batch_records(pkg: str, payload: bytes):
    parsed = _mod(pkg, "colframe").parse_column_frame(payload)
    batch = getattr(parsed, "batch", parsed)  # the JAX parse wraps its batch
    return batch.to_records()


def _decode(pkg: str, name: str):
    """One golden blob decoded through ``pkg``'s readers, as plain values."""
    data = blob(name)
    parity = _mod(pkg, "coding.parity")

    def geom(g):
        return None if g is None else (g.segments, g.stripe_k, g.chunk_bytes, g.payload_len)

    if name.startswith("snapshot_"):
        snap = _mod(pkg, "metadata.snapshot").MapOutputSnapshot.from_bytes(data)
        return (snap.shuffle_id, snap.epoch, snap.num_partitions(), snap.registered_map_ids(),
                sorted((s.map_id, s.map_index, s.composite_group, s.base_offset,
                        s.parity_segments, [int(x) for x in s.sizes]) for _i, s in snap.entries))
    if name.startswith("fat_index_"):
        fat = _mod(pkg, "metadata.fat_index").FatIndex.from_bytes(data)
        return (fat.shuffle_id, fat.group_id, fat.num_partitions, fat.has_checksums,
                geom(fat.parity), fat.split_bytes,
                sorted((m.map_id, m.map_index, m.base_offset, m.total_bytes, m.combined,
                        [int(x) for x in m.offsets], [int(x) for x in m.checksums])
                       for m in fat.members.values()))
    if name.startswith("index_"):
        offsets, g, skew = _mod(pkg, "skew").split_index_trailers(words_of(data))
        offsets2, g2 = parity.split_index_geometry(words_of(data))
        assert [int(x) for x in offsets2] == [int(x) for x in offsets] and g2 == g
        return ([int(x) for x in offsets], geom(g),
                None if skew is None else (skew.combined, skew.split_bytes))
    if name.startswith("checksum_"):
        return [int(x) for x in words_of(data)]
    if name.startswith("parity_header_"):
        return geom(parity.parse_parity_header(data)), data[64:]
    if name.startswith("colframe_"):
        (payload_len,) = struct.unpack_from("<I", data, 0)
        return payload_len, _batch_records(pkg, data[4:4 + payload_len])
    raise AssertionError(f"no decoder for {name}")


# ---------------------------------------------------------------------------
# Golden blobs: every version decodes through the port as through JAX
# ---------------------------------------------------------------------------


def test_the_corpus_is_the_expected_one():
    assert len(BLOBS) == 13, BLOBS


@pytest.mark.parametrize("name", BLOBS)
def test_golden_blob_decodes_through_the_port_as_through_jax(name):
    assert _decode("s3shuffle_tpu_torch", name) == _decode("s3shuffle_tpu", name)


@pytest.mark.parametrize("version", [1, 2, 3])
def test_snapshot_golden_decodes(version):
    from s3shuffle_tpu_torch.metadata.snapshot import MapOutputSnapshot

    snap = MapOutputSnapshot.from_bytes(blob(f"snapshot_v{version}.bin"))
    assert (snap.shuffle_id, snap.epoch, snap.num_partitions()) == (3, 2, 4)
    assert snap.registered_map_ids() == [7, 9]
    by_map = {s.map_id: s for _i, s in snap.entries}
    assert list(by_map[7].sizes) == [10, 20, 30, 40]
    assert list(by_map[9].sizes) == [11, 21, 31, 41]
    if version == 1:  # rows before composites take the one-object-per-map layout
        assert (by_map[9].composite_group, by_map[9].base_offset) == (-1, 0)
    else:
        assert (by_map[9].composite_group, by_map[9].base_offset) == (5, 100)
    assert by_map[9].parity_segments == (2 if version == 3 else 0)


@pytest.mark.parametrize("version", [1, 2, 3])
def test_fat_index_golden_decodes(version):
    from s3shuffle_tpu_torch.coding.parity import ParityGeometry
    from s3shuffle_tpu_torch.metadata.fat_index import FatIndex

    fat = FatIndex.from_bytes(blob(f"fat_index_v{version}.bin"))
    assert (fat.shuffle_id, fat.group_id, fat.num_partitions) == (3, 11, 4)
    assert sorted(fat.members) == [20, 21] and fat.has_checksums
    m = fat.member(21)
    assert (m.map_index, m.base_offset, m.total_bytes) == (1, 100, 64)
    assert list(m.checksums) == [201, 202, 203, 204]
    assert fat.parity == (None if version == 1 else ParityGeometry(2, 4, 32, 164))
    assert fat.split_bytes == (48 if version == 3 else 0)
    assert fat.member(20).combined is (version == 3)


def test_index_trailers_golden_decode():
    """The two trailers never reach an offset consumer, and the geometry's
    payload length is the true final offset."""
    from s3shuffle_tpu_torch.coding.parity import ParityGeometry, split_index_geometry
    from s3shuffle_tpu_torch.skew import split_index_trailers

    offsets, geometry = split_index_geometry(words_of(blob("index_plain_v1.bin")))
    assert list(offsets) == [0, 10, 30, 60, 100] and geometry is None
    offsets, geometry = split_index_geometry(words_of(blob("index_geom_v4.bin")))
    assert list(offsets) == [0, 10, 30, 60, 100]
    assert geometry == ParityGeometry(2, 4, 32, 100)
    offsets, geometry, skew = split_index_trailers(words_of(blob("index_skew_v6.bin")))
    assert list(offsets) == [0, 10, 30, 60, 100]
    assert geometry == ParityGeometry(2, 4, 32, 100)
    assert skew is not None and skew.combined and skew.split_bytes == 40


def test_parity_header_golden_decodes_and_truncated_raises():
    from s3shuffle_tpu_torch.coding.parity import ParityGeometry, parse_parity_header

    data = blob("parity_header_v1.bin")
    assert parse_parity_header(data) == ParityGeometry(2, 4, 32, 100)
    assert [int(w) for w in words_of(data[:64])[2:4]] == [3, 1]  # shuffle_id, seg
    assert data[64:] == b"\xaa" * 32
    with pytest.raises(ValueError, match="too short"):
        parse_parity_header(data[:40])


def test_colframe_truncated_and_corrupt_raise():
    from s3shuffle_tpu_torch.colframe import parse_column_frame

    payload = blob("colframe_fixed_v1.bin")[4:]
    with pytest.raises(IOError, match="truncated"):
        parse_column_frame(payload[:32])
    with pytest.raises(IOError, match="length mismatch"):
        parse_column_frame(payload[:-2])
    bad = bytearray(payload)
    bad[15] ^= 0x40  # the wire-version word
    with pytest.raises(IOError, match="wire version"):
        parse_column_frame(bytes(bad))


# ---------------------------------------------------------------------------
# Writer stability: the port reproduces the current-version blobs
# ---------------------------------------------------------------------------


def _rewrite(name: str) -> bytes:
    data = blob(name)
    if name.startswith("snapshot_"):
        from s3shuffle_tpu_torch.metadata.snapshot import MapOutputSnapshot

        return MapOutputSnapshot.from_bytes(data).to_bytes()
    if name.startswith("fat_index_"):
        from s3shuffle_tpu_torch.metadata.fat_index import FatIndex

        return FatIndex.from_bytes(data).to_bytes()
    from s3shuffle_tpu_torch.colframe import parse_column_frame, write_column_frame

    buf = io.BytesIO()
    write_column_frame(buf, parse_column_frame(data[4:]))
    return buf.getvalue()


@pytest.mark.parametrize("name", ["snapshot_v3.bin", "fat_index_v2.bin", "fat_index_v3.bin",
                                  "colframe_fixed_v1.bin", "colframe_varlen_v1.bin"])
def test_port_writer_reproduces_current_golden(name):
    assert _rewrite(name) == blob(name)


def test_fat_index_zero_skew_still_writes_v2():
    from s3shuffle_tpu_torch.metadata.fat_index import FatIndex

    assert words_of(FatIndex.from_bytes(blob("fat_index_v2.bin")).to_bytes())[1] == 2
    assert words_of(FatIndex.from_bytes(blob("fat_index_v3.bin")).to_bytes())[1] == 3


# ---------------------------------------------------------------------------
# WIRE01 over the port
# ---------------------------------------------------------------------------


def _port_model() -> ProjectModel:
    """``ProjectModel.load`` reads the JAX package's paths; the port's model
    is filled from its own registry and format version."""
    return ProjectModel(wire_structs=copy.deepcopy(WIRE_STRUCTS),
                        shuffle_format_version=SHUFFLE_FORMAT_VERSION)


def _wire01(rel_path: str, model: ProjectModel, source: str = None):
    path = os.path.join(REPO_ROOT, rel_path)
    if source is None:
        with open(path, encoding="utf-8") as f:
            source = f.read()
    return [v for v in lint_source(source, path, model=model, rules=[wire01])
            if v.rule == "WIRE01" and not v.suppressed]


def test_the_registry_names_eight_port_modules():
    assert len(PORT_MODULES) == 8
    assert all(m.startswith("s3shuffle_tpu_torch/") for m in PORT_MODULES)


@pytest.mark.parametrize("module", PORT_MODULES)
def test_wire01_reports_nothing_over_the_port(module):
    assert _wire01(module, _port_model()) == []


def test_wire01_project_check_over_every_port_module_reports_nothing():
    import ast

    from tools.shuffle_lint.core import ProjectGraph

    files = []
    for rel in PORT_MODULES:
        path = os.path.join(REPO_ROOT, rel)
        with open(path, encoding="utf-8") as f:
            source = f.read()
        files.append((path, source, ast.parse(source)))
    project = ProjectGraph(files, model=_port_model())
    assert wire01.check_project(project) == []


def test_registry_edit_without_version_bump_trips_wire01():
    model = _port_model()
    edited = copy.deepcopy(model)
    entry = edited.wire_structs["fat_index"]
    entry["constants"]["_VERSION"] = 4
    entry["read_versions"] = [1, 2, 3, 4]
    entry["current_version"] = 4
    entry["current_format"] = model.shuffle_format_version + 1
    messages = "\n".join(v.message for v in
                         _wire01("s3shuffle_tpu_torch/metadata/fat_index.py", edited))
    assert "_VERSION is 3" in messages
    assert "SHUFFLE_FORMAT_VERSION" in messages


def test_dropped_reader_guard_trips_wire01():
    """A reader that loses its back-compat branch for snapshot v1 fails the
    rule, though the v3 writer still round-trips."""
    path = os.path.join(REPO_ROOT, "s3shuffle_tpu_torch/metadata/snapshot.py")
    with open(path, encoding="utf-8") as f:
        source = f.read()
    model = _port_model()
    model.wire_structs["snapshot"]["read_versions"] = [0, 1, 2, 3]
    found = _wire01("s3shuffle_tpu_torch/metadata/snapshot.py", model, source)
    assert any("historical wire v0" in v.message for v in found)


@pytest.mark.parametrize("module", PORT_MODULES)
def test_dropped_wire_structs_binding_trips_wire01(module):
    path = os.path.join(REPO_ROOT, module)
    with open(path, encoding="utf-8") as f:
        source = f.read()
    stripped = "\n".join(line for line in source.splitlines()
                         if not line.startswith("_WIRE_STRUCTS"))
    assert stripped != source
    fired = _wire01(module, _port_model(), stripped)
    assert fired and "does not claim" in fired[0].message


# ---------------------------------------------------------------------------
# The registry against the JAX one
# ---------------------------------------------------------------------------


def test_registry_equals_the_jax_one_with_paths_mapped():
    mapped = copy.deepcopy(jax_schema.WIRE_STRUCTS)
    for spec in mapped.values():
        spec["module"] = spec["module"].replace("s3shuffle_tpu/", "s3shuffle_tpu_torch/", 1)
    assert WIRE_STRUCTS == mapped


def test_registry_is_a_pure_literal():
    import ast

    path = os.path.join(REPO_ROOT, "s3shuffle_tpu_torch", "wire", "schema.py")
    with open(path, encoding="utf-8") as f:
        tree = ast.parse(f.read())
    node = next(n for n in tree.body if isinstance(n, ast.Assign)
                and getattr(n.targets[0], "id", None) == "WIRE_STRUCTS")
    assert ast.literal_eval(node.value) == WIRE_STRUCTS


def test_rendered_doc_equals_the_jax_one_modulo_the_package():
    theirs = jax_schema.render_wire_doc().replace("s3shuffle_tpu/", "s3shuffle_tpu_torch/")
    assert render_wire_doc() == theirs


def test_registry_current_format_within_version_py():
    assert max_current_format() <= SHUFFLE_FORMAT_VERSION
    assert max_current_format() == jax_schema.max_current_format()


def test_every_registered_struct_has_layout_doc():
    for name, spec in WIRE_STRUCTS.items():
        assert spec["doc"] and spec["layout"], name
        assert spec["since_format"] <= spec["current_format"], name


@pytest.mark.parametrize("module", PORT_MODULES)
def test_each_binding_matches_its_jax_twin(module):
    """The port module claims what its JAX twin claims."""
    jax_module = module.replace("s3shuffle_tpu_torch/", "s3shuffle_tpu/", 1)
    claims = []
    for rel in (module, jax_module):
        mod = importlib.import_module(rel[:-3].replace("/", "."))
        claims.append(mod._WIRE_STRUCTS)
    assert claims[0] == claims[1]
    for sname in claims[0]:
        assert WIRE_STRUCTS[sname]["module"] == module
