"""The single-spill writer and the DataIO components of the port against the
JAX package, on the CPU, exactly: the same merged spill file, moved into
place by rename or by copy, uncoded and coded, gives byte-equal object
trees, which the port reads back; the executor component re-initializes
the application id and vends writers; the driver component removes a
shuffle and the root only with ``cleanup`` on."""

import io
import os

import numpy as np
import pytest

from s3shuffle_tpu.config import ShuffleConfig as JaxConfig
from s3shuffle_tpu.dataio import ShuffleDataIO as JaxDataIO
from s3shuffle_tpu.storage.dispatcher import Dispatcher as JaxDispatcher
from s3shuffle_tpu_torch import ShuffleConfig
from s3shuffle_tpu_torch.codec import get_codec
from s3shuffle_tpu_torch.dataio import ShuffleDataIO
from s3shuffle_tpu_torch.metadata.helper import ShuffleHelper
from s3shuffle_tpu_torch.read.reader import ShuffleReader
from s3shuffle_tpu_torch.storage.dispatcher import Dispatcher
from s3shuffle_tpu_torch.utils.checksums import create_checksum

BS = 2048
PARTS = 4
CODED = {"parity_segments": 2, "parity_stripe_k": 2, "parity_chunk_bytes": 1024}


def _objects(root) -> dict:
    out = {}
    for dirpath, _dirs, files in os.walk(root):
        for fn in files:
            full = os.path.join(dirpath, fn)
            with open(full, "rb") as f:
                out[os.path.relpath(full, root)] = f.read()
    return out


def _spill(tmp_path, name, raw_parts, algorithm):
    """A merged spill file of TLZ frames, its partition lengths and
    checksums."""
    codec = get_codec("tpu", block_size=BS, device="cpu")
    stored = [codec.compress_bytes(p) if p else b"" for p in raw_parts]
    path = tmp_path / name
    path.write_bytes(b"".join(stored))
    checksums = []
    for s in stored:
        c = create_checksum(algorithm)
        c.update(s)
        checksums.append(c.value)
    return str(path), np.array([len(s) for s in stored], np.int64), np.array(checksums, np.int64)


@pytest.mark.parametrize("coded", [False, True], ids=["uncoded", "coded"])
@pytest.mark.parametrize("rename", [None, False], ids=["rename", "copy"])
def test_single_spill_transfer_equals_jax(tmp_path, rename, coded):
    rng = np.random.default_rng(2)
    raw = [bytes(rng.integers(0, 4, 5000 + 700 * p, dtype=np.uint8)) for p in range(PARTS)]
    raw[2] = b""  # an empty partition
    knobs = dict(checksum_algorithm="CRC32C", supports_rename=rename, **(CODED if coded else {}))
    port_root, jax_root = tmp_path / "port", tmp_path / "jax"
    disp = Dispatcher(ShuffleConfig(root_dir=f"file://{port_root}", codec_block_size=BS, **knobs))
    JaxDispatcher.reset()
    jdisp = JaxDispatcher(JaxConfig(root_dir=f"file://{jax_root}", **knobs))
    for d, dataio, label in ((disp, ShuffleDataIO(disp, device="cpu"), "port"),
                             (jdisp, JaxDataIO(jdisp), "jax")):
        path, lengths, sums = _spill(tmp_path, f"{label}.spill", raw, "CRC32C")
        writer = dataio.executor().create_single_file_map_output_writer(0, 3)
        writer.transfer_map_spill_file(path, lengths, sums)
        assert not os.path.exists(path)  # moved or copied, then removed
    port, jax = _objects(port_root), _objects(jax_root)
    assert sorted(port) == sorted(jax)
    assert sum(n.endswith(".parity") for n in port) == (2 if coded else 0)
    for name in port:
        assert port[name] == jax[name], name
    reader = ShuffleReader(disp, ShuffleHelper(disp), device="cpu")
    for p in range(PARTS):
        if raw[p]:
            assert reader.read_partition(0, p, [3]) == raw[p]


def test_executor_and_driver_components(tmp_path):
    cfg = ShuffleConfig(root_dir=f"file://{tmp_path}", app_id="placeholder")
    disp = Dispatcher(cfg)
    dataio = ShuffleDataIO(disp, device="cpu")
    executor = dataio.executor()
    executor.initialize_executor("app-42", executor_id="7")
    assert disp.app_id == "app-42"
    for shuffle_id in (0, 1):
        writer = executor.create_map_output_writer(shuffle_id, 5, 2)
        pw = writer.get_encoding_partition_writer(1)
        pw.write(b"record bytes " * 100)
        pw.close()
        writer.commit_all_partitions()
    names = list(_objects(tmp_path))
    assert names and all("/app-42/" in "/" + n for n in names)
    driver = dataio.driver()
    driver.initialize_application()
    driver.remove_shuffle(0)
    assert _objects(tmp_path) and all("/app-42/1/" in "/" + n for n in _objects(tmp_path))
    driver.cleanup_application()
    assert _objects(tmp_path) == {}
    kept = Dispatcher(ShuffleConfig(root_dir=f"file://{tmp_path}", cleanup=False))
    writer = ShuffleDataIO(kept, device="cpu").executor().create_map_output_writer(0, 1, 1)
    pw = writer.get_encoding_partition_writer(0)
    pw.write(io.BytesIO(b"x" * 10).read())
    pw.close()
    writer.commit_all_partitions()
    ShuffleDataIO(kept).driver().cleanup_application()
    assert _objects(tmp_path)
