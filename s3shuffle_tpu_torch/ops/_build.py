"""Build and load the port's CUDA kernels.

Every ``csrc/*.cu`` compiles on first use with ``nvcc`` for ``sm_90a``
(one ``nvcc`` per source, all started together), and the objects link into
one shared library with a plain C interface under ``build/torch_kernels/``
at the repository root, named by a hash of the sources so a changed source
never loads a stale build. The library loads with ``ctypes``; every pointer
and the stream pass as ``ctypes.c_void_p``, and every C entry returns
``cudaGetLastError()`` after its launch, which :func:`check` turns into an
exception.

Launch counts: each kernel wrapper adds one to :data:`LAUNCHES` through
:func:`count_launch` where it launches its kernel, and nowhere else; map and
reduce tasks launch from several threads, so the count takes a lock.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
import time
from pathlib import Path

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG.parent / "build" / "torch_kernels"
ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]
NVCC_FLAGS = ARCH_FLAGS + ["-std=c++17", "-O3", "-Xcompiler", "-fPIC"]

#: kernel name → launches by its wrapper
LAUNCHES = {"crc_fold": 0, "tlz_planes": 0, "tlz_decode_fused": 0, "gf_encode": 0}
_launches_lock = threading.Lock()


def count_launch(name: str) -> None:
    with _launches_lock:
        LAUNCHES[name] += 1


def reset_launches() -> None:
    with _launches_lock:
        for name in LAUNCHES:
            LAUNCHES[name] = 0

_P = ctypes.c_void_p
_I64 = ctypes.c_longlong
_I32 = ctypes.c_int
#: C entry → argtypes (every entry returns the launch's cudaError_t)
_SIGNATURES = {
    # rows_a, lengths_a|NULL, n_a, rows_b|NULL, lengths_b|NULL, n_b, width,
    # n_seg, tab8, nib, seg_cols, counters, partials, out, stream
    "crc_fold_launch": [_P, _P, _I64, _P, _P, _I64, _I64, _I32, _P, _P, _P, _P, _P, _P, _P],
    # buf, cand, n_rows, n_groups, match, cont, split, dists, ks, stream
    "tlz_planes_launch": [_P, _P, _I64, _I64, _P, _P, _P, _P, _P, _P],
    # match, cont, split, offs, ks, lits, n_rows, n_groups, tab8, nib,
    # seg_cols, state, state_words, gen_scratch, gen_slots, gen_counter, dec,
    # crc, stream
    "tlz_decode_fused_launch": [
        _P, _P, _P, _P, _P, _P, _I64, _I64, _P, _P, _P, _P, _I64, _P, _I32,
        _P, _P, _P, _P,
    ],
    # chunks, consts, groups, k, m, length, out, stream
    "gf_encode_launch": [_P, _P, _I64, _I32, _I32, _I64, _P, _P],
}

_lock = threading.Lock()
_lib = None
#: compiler output of the build (``-Xptxas -v``: registers, shared memory,
#: spills per kernel) and its wall seconds
build_log = ""
build_seconds = 0.0


def _sources():
    return sorted(CSRC.glob("*.cu")), sorted(CSRC.glob("*.cuh"))


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    toolkit = os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc")
    if os.path.exists(toolkit):
        return toolkit
    raise RuntimeError("nvcc not found (PATH, $CUDA_HOME/bin): the CUDA kernels cannot be built")


def _digest() -> str:
    h = hashlib.sha256()
    for path in sum(_sources(), []):
        h.update(path.name.encode())
        h.update(path.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return h.hexdigest()[:16]


def _compile(out_path: Path) -> str:
    """One nvcc per source in parallel, then one link. Returns the compiler
    output."""
    nvcc = _nvcc()
    cu_files, _headers = _sources()
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        procs = []
        for src in cu_files:
            obj = Path(tmp) / (src.stem + ".o")
            cmd = [nvcc, *NVCC_FLAGS, "-Xptxas", "-v", "-c", str(src), "-o", str(obj)]
            procs.append((src, obj, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
            )))
        logs, failed = [], []
        for src, _obj, proc in procs:
            out, _ = proc.communicate()
            logs.append(f"== {src.name}\n{out}")
            if proc.returncode != 0:
                failed.append(src.name)
        if failed:
            raise RuntimeError(
                f"nvcc failed for {', '.join(failed)}:\n" + "\n".join(logs)
            )
        tmp_lib = Path(tmp) / out_path.name
        link = [nvcc, *ARCH_FLAGS, "-shared", "-Xcompiler", "-fPIC", "-o",
                str(tmp_lib), *[str(o) for _s, o, _p in procs]]
        res = subprocess.run(link, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                             text=True, check=False)
        if res.returncode != 0:
            raise RuntimeError(f"nvcc link failed:\n{res.stdout}")
        os.replace(tmp_lib, out_path)  # atomic: concurrent builds agree
    return "\n".join(logs)


def library() -> ctypes.CDLL:
    """The kernel library, built on first use."""
    global _lib, build_log, build_seconds
    with _lock:
        if _lib is not None:
            return _lib
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        path = BUILD_DIR / f"libs3shuffle_torch_kernels_{_digest()}.so"
        if not path.exists():
            t0 = time.perf_counter()
            build_log = _compile(path)
            build_seconds = time.perf_counter() - t0
        lib = ctypes.CDLL(str(path))
        for name, argtypes in _SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        _lib = lib
        return lib


def check(rc: int, what: str) -> None:
    """Raise on a non-zero ``cudaError_t`` returned by a C entry."""
    if rc != 0:
        import torch

        raise RuntimeError(
            f"{what}: CUDA error {rc} at launch "
            f"({torch.cuda.get_device_name() if torch.cuda.is_available() else 'no device'})"
        )


def stream_ptr(device) -> int:
    """PyTorch's current CUDA stream on ``device`` as a raw pointer."""
    import torch

    return torch.cuda.current_stream(device).cuda_stream


def require_cuda(name: str, t, dtype=None, shape=None) -> None:
    """Validate one kernel argument: on CUDA, contiguous, 16-byte aligned,
    of the given dtype and shape."""
    if t.device.type != "cuda":
        raise ValueError(f"{name} must be a CUDA tensor, got {t.device}")
    if dtype is not None and t.dtype != dtype:
        raise ValueError(f"{name} must be {dtype}, got {t.dtype}")
    if shape is not None and tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} must have shape {tuple(shape)}, got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
    if t.data_ptr() % 16:
        raise ValueError(f"{name} must be 16-byte aligned")
