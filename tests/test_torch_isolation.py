"""Package rules of the port: it imports neither jax nor anything of the JAX
package (checked in a fresh interpreter, since this test process has both
loaded), its native host library is its own (built only under ``build/``,
never the JAX package's ``.so``), and its entry points never fall back to
the CPU on their own."""

import ast
import os
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import s3shuffle_tpu_torch
from s3shuffle_tpu_torch import ShuffleConfig, ShuffleContext, ShuffleManager
from s3shuffle_tpu_torch.codec.cuda import CudaCodec
from s3shuffle_tpu_torch.coding import gf, gf_cuda
from s3shuffle_tpu_torch.device import resolve_device
from s3shuffle_tpu_torch.metadata.helper import ShuffleHelper
from s3shuffle_tpu_torch.ops import _build, crc_cuda, tlz, tlz_cuda
from s3shuffle_tpu_torch.read.reader import ShuffleReader
from s3shuffle_tpu_torch.storage.dispatcher import Dispatcher
from s3shuffle_tpu_torch.write.map_output_writer import MapOutputWriter
from torch_port_dispatcher import port_dispatcher_reset  # noqa: F401  (resets the port's process dispatcher)

REPO = Path(__file__).resolve().parent.parent
PKG = Path(s3shuffle_tpu_torch.__file__).resolve().parent
#: modules the typed record paths, the host codecs, the read plane, the
#: composite commit plane, the skew plane with its metrics registry, the
#: online autotuner with its instrumented store, the trace plane with the
#: stats reports, the control plane, the worker fleet, the multi-GPU plane,
#: the codec bridge, the wire registry and the concurrency witnesses added;
#: the subprocess import and the AST scan must both reach them
SLICE_MODULES = [
    "s3shuffle_tpu_torch.codec.cpu",
    "s3shuffle_tpu_torch.codec.native",
    "s3shuffle_tpu_torch.structured",
    "s3shuffle_tpu_torch.colagg",
    "s3shuffle_tpu_torch.dataio",
    "s3shuffle_tpu_torch.write.single_spill",
    "s3shuffle_tpu_torch.read.block_iterator",
    "s3shuffle_tpu_torch.read.chunked_fetch",
    "s3shuffle_tpu_torch.read.prefetch",
    "s3shuffle_tpu_torch.read.scan_plan",
    "s3shuffle_tpu_torch.tuning.controller",
    "s3shuffle_tpu_torch.utils.concurrent_map",
    "s3shuffle_tpu_torch.utils.growpool",
    "s3shuffle_tpu_torch.metadata.fat_index",
    "s3shuffle_tpu_torch.write.composite_commit",
    "s3shuffle_tpu_torch.write.compactor",
    "s3shuffle_tpu_torch.metrics.registry",
    "s3shuffle_tpu_torch.metrics.names",
    "s3shuffle_tpu_torch.skew",
    "s3shuffle_tpu_torch.costs",
    "s3shuffle_tpu_torch.tuning.tuners",
    "s3shuffle_tpu_torch.tuning.profile",
    "s3shuffle_tpu_torch.storage.instrumented",
    "s3shuffle_tpu_torch.utils.trace",
    "s3shuffle_tpu_torch.trace.names",
    "s3shuffle_tpu_torch.metrics.stats",
    "s3shuffle_tpu_torch.version",
    "s3shuffle_tpu_torch.metadata.shard",
    "s3shuffle_tpu_torch.metadata.service",
    "s3shuffle_tpu_torch.metadata.snapshot",
    "s3shuffle_tpu_torch.metadata.async_client",
    "s3shuffle_tpu_torch.recovery",
    "s3shuffle_tpu_torch.worker",
    "s3shuffle_tpu_torch.cluster",
    "s3shuffle_tpu_torch.parallel.mesh",
    "s3shuffle_tpu_torch.parallel.repartition",
    "s3shuffle_tpu_torch.parallel.dispatch",
    "s3shuffle_tpu_torch.parallel.ici_shuffle",
    "s3shuffle_tpu_torch.bridge",
    "s3shuffle_tpu_torch.wire.schema",
    "s3shuffle_tpu_torch.utils.lockwitness",
    "s3shuffle_tpu_torch.utils.racewitness",
    "s3shuffle_tpu_torch.utils.protowitness",
    "s3shuffle_tpu_torch.utils.sched",
]


def _port_sources():
    return sorted(PKG.rglob("*.py")) + [REPO / "chip_smoke.py"]


def test_import_loads_neither_jax_nor_the_jax_package():
    code = (
        "import pkgutil, sys\n"
        "import s3shuffle_tpu_torch as pkg\n"
        "for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + '.'):\n"
        "    __import__(m.name)\n"
        "bad = sorted(n for n in sys.modules if n == 'jax' or n.startswith('jax.')\n"
        "             or n == 's3shuffle_tpu' or n.startswith('s3shuffle_tpu.'))\n"
        f"bad += [n for n in {SLICE_MODULES!r} if n not in sys.modules]\n"
        "print(len([n for n in sys.modules if n.startswith('s3shuffle_tpu_torch')]))\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    res = subprocess.run(
        [sys.executable, "-c", code], cwd=REPO, env=env,
        capture_output=True, text=True, timeout=120,
    )
    assert res.returncode == 0, res.stdout + res.stderr
    assert int(res.stdout.split()[0]) >= 20  # every submodule was imported


def test_the_worker_entry_point_loads_neither_jax_nor_the_jax_package():
    """``python -m s3shuffle_tpu_torch.worker --help`` in a fresh interpreter:
    it answers, and of every module it imports (``-X importtime``) none is
    jax or of the JAX package."""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    res = subprocess.run(
        [sys.executable, "-X", "importtime", "-m", "s3shuffle_tpu_torch.worker", "--help"],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=120,
    )
    assert res.returncode == 0, res.stdout + res.stderr
    assert "--coordinator" in res.stdout and "--device" in res.stdout
    imported = [line.rsplit("|", 1)[-1].strip() for line in res.stderr.splitlines()
                if line.startswith("import time:") and "|" in line]
    assert "s3shuffle_tpu_torch.metadata.service" in imported
    bad = [n for n in imported if n.split(".")[0] in ("jax", "s3shuffle_tpu")]
    assert bad == []


def test_the_bridge_cli_serves_without_jax_or_the_jax_package(tmp_path):
    """``python -m s3shuffle_tpu_torch.bridge --device cpu --port 0`` in a
    fresh interpreter: it prints its address, answers a round trip through
    the tpu codec's plain path, and of every module it imported
    (``-X importtime``) none is jax or of the JAX package."""
    from s3shuffle_tpu_torch.bridge import CodecBridgeClient

    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    # the import log goes to a file: a full stderr pipe would stall the child
    err_path = tmp_path / "importtime.log"
    with open(err_path, "w") as err_file:
        proc = subprocess.Popen(
            [sys.executable, "-X", "importtime", "-m", "s3shuffle_tpu_torch.bridge",
             "--codec", "tpu", "--device", "cpu", "--port", "0"],
            cwd=REPO, env=env, stdout=subprocess.PIPE, stderr=err_file, text=True,
        )
    try:
        line = proc.stdout.readline()
        assert line.startswith("codec bridge on 127.0.0.1:") and "(codec=tpu)" in line, line
        port = int(line.split(":", 1)[1].split()[0])
        client = CodecBridgeClient(port=port)
        try:
            data = [b"bridge" * 300, b"tail"]
            assert client.decompress(client.compress_framed(data)) == b"".join(data)
        finally:
            client.close()
    finally:
        proc.kill()
        proc.communicate(timeout=60)
    err = err_path.read_text()
    imported = [line.rsplit("|", 1)[-1].strip() for line in err.splitlines()
                if line.startswith("import time:") and "|" in line]
    assert "s3shuffle_tpu_torch.codec.cuda" in imported
    bad = [n for n in imported if n.split(".")[0] in ("jax", "s3shuffle_tpu")]
    assert bad == []


def test_the_scan_covers_the_slice_modules():
    scanned = {p.resolve() for p in _port_sources()}
    for name in SLICE_MODULES:
        path = REPO.joinpath(*name.split(".")).with_suffix(".py")
        assert path.resolve() in scanned, name


def test_native_library_is_the_ports_own_and_builds_only_under_build(tmp_path):
    """In a fresh interpreter: the host codecs load the port's library from
    ``build/native/`` and no library of the JAX package; a build into an
    empty checkout's ``build/native/`` leaves one file there and nothing
    else."""
    from s3shuffle_tpu_torch.codec import native

    assert native.BUILD_DIR == REPO / "build" / "native"
    assert native.LIBRARY.parent == native.BUILD_DIR
    assert native.SOURCE == PKG / "native" / "s3shuffle_native.cpp"
    code = (
        "import sys\n"
        "from pathlib import Path\n"
        "from s3shuffle_tpu_torch.codec import get_codec, native\n"
        "for name in ('native', 'lz4', 'auto'):\n"
        "    codec = get_codec(name)\n"
        "    assert codec.decompress_bytes(codec.compress_bytes(b'ab' * 70000)) == b'ab' * 70000\n"
        "maps = open('/proc/self/maps').read()\n"
        "assert str(native.LIBRARY) in maps, maps\n"
        "assert 's3shuffle_tpu/native' not in maps, 'the JAX package library is loaded'\n"
        f"native.BUILD_DIR = Path({str(tmp_path / 'build' / 'native')!r})\n"
        "native.LIBRARY = native.BUILD_DIR / 'libs3shuffle_native.so'\n"
        "native._build()\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    res = subprocess.run(
        [sys.executable, "-c", code], cwd=REPO, env=env,
        capture_output=True, text=True, timeout=300,
    )
    assert res.returncode == 0, res.stdout + res.stderr
    written = sorted(p.relative_to(tmp_path) for p in tmp_path.rglob("*") if p.is_file())
    assert written == [Path("build/native/libs3shuffle_native.so")]


@pytest.mark.parametrize("path", _port_sources(), ids=lambda p: p.name)
def test_source_imports_no_jax_and_no_jax_package(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        names = []
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.module:
            names = [node.module]
        for name in names:
            root = name.split(".")[0]
            assert root != "jax", f"{path}: imports {name}"
            assert root != "s3shuffle_tpu", f"{path}: imports {name}"
        # the trace plane annotates through torch.profiler, never JAX's
        if isinstance(node, ast.Attribute) and node.attr == "profiler":
            assert not (isinstance(node.value, ast.Name) and node.value.id == "jax"), path
    text = path.read_text()
    assert "jax.profiler" not in text
    assert "import jax" not in text
    assert "from s3shuffle_tpu " not in text and "from s3shuffle_tpu." not in text


#: a dotted module name of the JAX package (``s3shuffle_tpu.x``), never the
#: port's (``s3shuffle_tpu_torch.x``)
_JAX_MODULE_NAME = re.compile(r"\bs3shuffle_tpu\.[A-Za-z_]")


@pytest.mark.parametrize("path", _port_sources(), ids=lambda p: p.name)
def test_source_strings_name_no_jax_package_module(path):
    """The witnesses find each other through ``sys.modules`` names and lazy
    imports held in strings, which the import scan above cannot see: a copy
    that kept a JAX name would bind the port's race witness to the JAX lock
    witness. No string literal of a port source names a JAX module."""
    tree = ast.parse(path.read_text())
    bad = [(node.lineno, node.value) for node in ast.walk(tree)
           if isinstance(node, ast.Constant) and isinstance(node.value, str)
           and _JAX_MODULE_NAME.search(node.value)]
    assert bad == [], f"{path}: {bad}"


def test_the_witnesses_find_the_ports_own_modules():
    """The names the witnesses look each other up by are the port's."""
    from s3shuffle_tpu_torch.utils import lockwitness, racewitness, sched

    assert racewitness._lockwitness() is lockwitness
    text = (PKG / "utils" / "sched.py").read_text()
    assert 'sys.modules.get("s3shuffle_tpu_torch.utils.racewitness")' in text
    assert sched._race_witness() is None  # the port's witness is not installed


@pytest.fixture
def no_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def test_entry_points_raise_without_cuda_unless_cpu_is_asked(no_cuda, tmp_path):
    with pytest.raises(RuntimeError, match="device='cpu'"):
        CudaCodec()
    with pytest.raises(RuntimeError):
        CudaCodec(device="cuda")
    assert CudaCodec(device="cpu").device.type == "cpu"
    with pytest.raises(RuntimeError):
        resolve_device(None)
    with pytest.raises(ValueError):
        resolve_device("meta")
    disp = Dispatcher(ShuffleConfig(root_dir=f"file://{tmp_path}"))
    helper = ShuffleHelper(disp)
    with pytest.raises(RuntimeError):
        MapOutputWriter(disp, helper, 0, 0, 2)
    with pytest.raises(RuntimeError):
        ShuffleReader(disp, helper)
    cfg = ShuffleConfig(root_dir=f"file://{tmp_path}")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ShuffleManager(cfg)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ShuffleContext(cfg)
    with pytest.raises(RuntimeError):
        ShuffleContext(cfg, device="cuda")
    assert ShuffleManager(cfg, device="cpu").codec.device.type == "cpu"
    ctx = ShuffleContext(cfg, device="cpu")
    assert ctx.manager.codec.device.type == "cpu"
    # the prefetcher completes blocks LIFO, so a group's value order is not
    # defined (as in the JAX package): compare each group's values sorted
    groups = ctx.group_by_key([[(1, b"a"), (2, b"b")], [(1, b"c")]], 2)
    assert sorted((k, sorted(vs)) for k, vs in groups) == [(1, [b"a", b"c"]), (2, [b"b"])]
    assert len(groups) == 2
    with pytest.raises(RuntimeError):
        tlz.encode_batch_device(bytes(512), 1, 512)
    with pytest.raises(RuntimeError):
        tlz.decode_batch_device([b"\x00\x80"], [0], 512)
    with pytest.raises(RuntimeError):
        gf.encode_groups(np.zeros((1, 2, 16), np.uint8), gf.parity_coefficients(2, 2))


@pytest.mark.parametrize("codec", ["none", "zlib", "native"])
def test_host_codec_entry_points_still_default_to_the_card(no_cuda, tmp_path, codec):
    """A host codec does not move an entry point off the card: without
    ``device="cpu"`` they raise as on the TLZ codec."""
    from s3shuffle_tpu_torch.dataio import ShuffleDataIO
    from s3shuffle_tpu_torch.write.single_spill import SingleSpillMapOutputWriter

    cfg = ShuffleConfig(root_dir=f"file://{tmp_path}", codec=codec)
    disp = Dispatcher(cfg)
    helper = ShuffleHelper(disp)
    for build in (lambda: ShuffleManager(cfg), lambda: ShuffleContext(cfg),
                  lambda: MapOutputWriter(disp, helper, 0, 0, 2),
                  lambda: ShuffleReader(disp, helper),
                  lambda: SingleSpillMapOutputWriter(disp, helper, 0, 0),
                  lambda: ShuffleDataIO(disp).executor().create_map_output_writer(0, 0, 2)):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            build()
    manager = ShuffleManager(cfg, device="cpu")
    assert manager.device.type == "cpu"
    assert (manager.codec is None) == (codec == "none")
    writer = ShuffleDataIO(disp, device="cpu").executor().create_map_output_writer(0, 0, 2)
    assert writer.device.type == "cpu"


def test_cpu_tensors_take_the_plain_versions_and_count_no_launch():
    before = dict(_build.LAUNCHES)
    rng = np.random.default_rng(0)
    blocks = torch.from_numpy(rng.integers(0, 4, (2, 512), dtype=np.uint8))
    n_groups = 64
    cand = tlz.candidate_math(blocks, n_groups)
    got = tlz_cuda.plane_decisions(blocks, cand, n_groups)
    want = tlz.plane_decisions_plain(blocks, cand, n_groups)
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    crc = crc_cuda.crc_raw(blocks, 0x82F63B78)
    assert crc.dtype == torch.int64 and crc.shape == (2,)
    parity = gf_cuda.encode(blocks.reshape(1, 2, 512), torch.ones((3, 2, 8), dtype=torch.uint8))
    assert parity.shape == (1, 3, 512)
    assert _build.LAUNCHES == before


def test_kernel_build_is_sm90a_from_repo_sources():
    names = sorted(p.name for p in _build.CSRC.glob("*.cu"))
    assert names == ["crc_fold.cu", "gf_encode.cu", "tlz_decode_fused.cu", "tlz_planes.cu"]
    assert "arch=compute_90a,code=sm_90a" in _build.NVCC_FLAGS
    assert _build.BUILD_DIR == REPO / "build" / "torch_kernels"
    replaces = {
        "crc_fold.cu": "s3shuffle_tpu/ops/crc_pallas.py:68",
        "tlz_planes.cu": "s3shuffle_tpu/ops/tlz_pallas.py:77",
        "tlz_decode_fused.cu": "s3shuffle_tpu/ops/tlz_pallas.py:230",
        "gf_encode.cu": "s3shuffle_tpu/coding/gf_pallas.py:76",
    }
    for src in _build.CSRC.glob("*.cu"):
        text = src.read_text()
        assert "cudaGetLastError()" in text
        assert replaces[src.name] in text  # names the TPU kernel it replaces
        entry = src.stem + "_launch"
        assert f'extern "C" int {entry}(' in text and entry in _build._SIGNATURES
        assert src.stem in _build.LAUNCHES
    assert len(_build._digest()) == 16
