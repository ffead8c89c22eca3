#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (``s3shuffle_tpu_torch``) on one GPU.

    python3 chip_smoke.py [--seed 0] [--total-mib 1024] [--reps 20]

Phases (any failure exits non-zero; no phase catches its own failure):

1. Card and build: the card's name and power limit as ``nvidia-smi`` gives
   them, the torch/CUDA versions, and the build of every kernel from
   ``s3shuffle_tpu_torch/csrc`` (nvcc, sm_90a) with its compiler summary.
2. Kernel vs plain: kernels K1 (CRC fold), K2 (TLZ plane decisions), K3
   (fused TLZ decode + CRC) and K4 (GF(2^8) parity encode) at the main
   paths' shapes (K1 on 64 raw blocks of 256 KiB and their 64 literal
   planes, two row sets in one launch as the write path runs it, K2 on 64
   rows x 32768 groups of TeraSort bytes, K3 on a decode run's 32 rows x
   32768 groups of them (also timed at 64 rows, the runs before the codec
   windows) and on 32 all-zero blocks, whose distance-1 chains cross every
   segment, K4 on 16 stripe
   groups x 2 chunks x 1 MiB at m = 2), each held byte-for-byte against its
   plain PyTorch version, timed with CUDA events (median of >= 20 warm
   launches), beside the plain version's time and the bound at this card's
   rates; K1's stage is also timed as the first design ran it (torch.cat of
   the two sets, then one launch), and K1's and K2's device time per call
   comes from a ``torch.profiler`` trace. The kernel phase times the first
   16 MiB of the data; below --total-mib 1024 that batch is part zeros.
   Edge shapes are checked too: CRC lengths around K1's 16 KiB segments
   (0, 1, 7, 8, S - 1, S, S + 1, 2S + 5, the width) and unaligned ones, K1's
   two-set launch against its one-set launch; K2 on crafted blocks (sources
   at a row's first bytes, forward sources clamped at its last byte, split
   groups, distances 65535 and 65536) at 32768, 8256, 300 and 64 groups;
   decode planes that were never
   validated, at 64 and 32768 groups — non-negative distances up to 2**31 - 1
   (clamped, K3's segmented route) and negative or extreme ones (forward
   pointers, pointer cycles longer than one, int32 wraps: K3's general
   route, whose row count must match); K4 at ragged lengths and at (m, k)
   up to (8, 64) and beyond. K3's general-route row count must stay 0 on
   both main-shape batches and on the 1 GiB paths, and its device time per
   call is split by launch (count, segment, general) from a
   ``torch.profiler`` trace.
3. Main path: ``--total-mib`` of TeraSort-shaped partition bytes (10-byte
   random keys, 90-byte values from a 64-entry pool; one map in eight gets
   a quarter of random bytes, so the raw escape runs) written by 8 maps x 8
   reduce partitions through ``MapOutputWriter`` to a ``file://`` root with
   CRC32C on, then every reduce partition read back through the validating
   ``ShuffleReader`` and compared byte for byte. Launch counts are zeroed
   just before and read just after; K1, K2 and K3 must have run, and no
   row may have taken K3's general route.
4. Coded path: the same bytes written with ``parity_segments=2,
   parity_stripe_k=2, parity_chunk_bytes=1 MiB`` (two parity sidecars per
   data object), then the data objects of maps 1, 3, 5 and 7 deleted and
   every reduce partition read back byte for byte, the lost half rebuilt
   from parity. Launch counts are zeroed just before and read just after:
   K1-K4 must have run (K4 on the write), and every block of the four lost
   maps must have been reconstructed.

5. Record path, through the entry points a user calls, with CRC32C, 256 KiB
   blocks, 64-block batches and a ``file://`` root:
   a. TeraSort as ``examples/terasort.py`` runs it:
      ``ShuffleContext(cfg, num_workers=4, device=...).sort_by_key(parts, 8,
      serializer=ColumnarKVSerializer(), materialize="batches")`` over
      ``--total-mib`` of records from ``--seed`` (10,737,416 at 1 GiB, 8
      maps, 8 reducers; the bypass-merge handle, ``ShuffleMapWriter``, the
      batch sorter). TeraValidated (count, key order within and across
      partitions) and its rows, ordered by the whole row, equal to the
      input's. Launch counts are zeroed just before and read just after:
      K1, K2 and K3 must have run, no row may have taken K3's general route,
      and frames must have been certified by fused CRCs on both sides.
      Prints the wall time, records/s, raw MiB/s, the stored ratio, the
      codec's stage timings (summed over the worker threads) and the
      launches; ``stop()`` must leave the root without objects.
   b. The same on the serialized handle (``ShuffleManager(cfg,
      bypass_merge_threshold=0)``: ``SerializedSortMapWriter``), same checks.
   c. Pickled records: 8 maps x 500,000 records (int key in [0, 65536),
      16-byte value); ``group_by_key`` and ``fold_by_key`` (a sum, map-side
      combine) each against a dict computed in plain Python;
      ``group_by_key`` must launch K1-K3.

6. Typed record paths and host codecs:
   a. q5 and q67 of ``examples/sql_queries.py`` at SF 100 (21,600,792
      rows in, tables from its ``gen_tables`` with seed 17, copied here
      with the queries), as the example runs them: 4 maps,
      6 reducers, TOP_K 10, ``ShuffleContext(cfg, num_workers=4)`` with
      ``codec="tpu"`` and CRC32C; q5 one aggregate stage with the columnar
      map-side combine, q67 an aggregate without it, the rank pushdown
      (``window_group_limit``) and a range-partitioned sort. Each result
      equals a plain numpy recomputation over the same tables (np.lexsort +
      np.add.reduceat, not through the shuffle). Launch counts are zeroed
      just before each query and read just after: q67 must launch K1-K3;
      q5's combine leaves every partition under one block, so it may
      launch none (its combined row count is printed). Prints per query
      the wall, the shuffle-stage wall, rows in/s, stored bytes, the
      launches and the codec's stage timings; ``stop()`` must leave no
      object.
   b. The phase-3 data plane at 64 MiB with ``codec="native"``, ``"lz4"``
      and ``"zlib"``: each read back validated and byte-exact with no
      kernel launched. The port's native library is built here from
      ``s3shuffle_tpu_torch/native/`` (a library left by an earlier run is
      removed first), ``codec="auto"`` must choose it, and the JAX
      package's library must not be loaded.

7. The read-plane split: phase 5a's TeraSort at 256 MiB (``--total-mib``
   when smaller) in six runs, each TeraValidated and launching K1-K3:
   1, 2 and 4 workers at the defaults; 4 workers with
   ``torch.set_num_threads(1)``; 4 workers with ``coalesce_gap_bytes=0``
   (the per-block path); and 4 workers with ``coalesce_gap_bytes=0,
   max_concurrency_task=1, fetch_parallelism=1`` (one GET at a time per
   task, the read pattern before the read plane). Each run prints its wall,
   records/s, the codec's stage seconds, the reduce tasks' summed
   ``wait_ns`` and ``prefetch_ns``, the blocks and bytes fetched, the GETs
   by object kind (counted by a wrapper around the backend defined here)
   and the most prefetch threads a reduce task ran.

8. The codec windows (every run exact; any failure exits non-zero):
   a. Identity: phase 3's data plane at 64 MiB written with the encode
      window at 2 and at 1 (the data, index and checksum objects must be
      byte-equal), each read with the decode window at 2 and at 1 (the bytes
      must equal the input), fused CRCs on both sides; K1 and K2 must have
      launched from the encode thread and K3 from the decode pool at
      window 2, and from the task threads at 1 (launches counted by
      thread with a wrapper defined here). Then K2 and K1 run on the
      encode thread at the encode batch's shape and K3 on a decode-pool
      thread at the decode run's shape (32 rows), each held against its
      plain version.
   b. Windows on and off: 5a's TeraSort at 256 MiB, 4 workers, at the
      defaults (encode window 2, 32-frame decode runs, decode window 2) and
      at 1/32/1, each TeraValidated; per run the wall, process CPU, the
      codec's stage seconds, K1-K3 launches by thread, GETs by object kind
      and the most decode-pool threads decoding at once.
   c. Listing mode: 8b's windows-on shuffle read again through a second
      manager at ``use_block_manager=False`` (its tracker knows no map),
      TeraValidated, with GETs and LIST calls by kind.
   d. The fallback-fetch layout: 8a's data plane under
      ``use_fallback_fetch=True``, its maps enumerated by listing; every
      object must sit at ``{root}{appId}/{shuffleId}/{hash(name)}/{name}``
      with Java's ``String.hashCode`` (computed here apart from the port).

Every record read of phases 3-8 goes through the port's read plane: the
coalescing scan planner and the prefetcher at the read knobs' defaults
unless a run says otherwise (phases 3, 4, 8a and 8d read each partition
with ``ShuffleReader.read_partition``, one scan per partition), and every
phase runs at the codec windows' defaults unless it says otherwise.

Output: the JSON of phase 8, then of phase 7's runs, then the JSON kernel
table on the line before the last (launch counts of
K1-K3 from 6a, this slice's main path; K4's from phase 4; every path's
counts under ``launches_by_path``), and as the last line
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.
Exits non-zero without a CUDA device, and when run outside a checkout of
the repository.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import statistics
import subprocess
import sys
import tempfile
import time

MiB = 1 << 20
BLOCK = 256 * 1024
BATCH = 64
MAPS = 8
PARTS = 8
#: the coded path: k data chunks and m parity sidecars of PARITY_CHUNK bytes
#: per stripe group, and the maps whose data objects it deletes
PARITY_K = 2
PARITY_M = 2
PARITY_CHUNK = MiB
LOST_MAPS = (1, 3, 5, 7)
#: K4's batch on the coded path: ENCODE_BATCH_GROUPS stripe groups
K4_GROUPS = 16
UNCODED_KERNELS = ("crc_fold", "tlz_planes", "tlz_decode_fused")
#: the record path (phase 5): TeraSort's record shape, the worker threads of
#: examples/terasort.py, and the pickled phase's records per map
KEY_BYTES, VALUE_BYTES = 10, 90
WORKERS = 4
PICKLED_PER_MAP = 500_000
#: phase 6a: examples/sql_queries.py's scale factor for the run, table seed,
#: N_MAPS, N_REDUCERS and TOP_K
SQL_SF = 100
SQL_SEED = 17
SQL_MAPS, SQL_REDUCERS, SQL_TOP_K = 4, 6, 10
#: phase 6b: the host codecs and the size of their data plane run
HOST_CODECS = ("native", "lz4", "zlib")
HOST_CODEC_MIB = 64
#: phase 7: the TeraSort size of the read-plane split and its six runs as
#: (workers, torch intra-op threads (None: the default), read knobs)
SPLIT_MIB = 256
SPLIT_RUNS = (
    (1, None, {}),
    (2, None, {}),
    (4, None, {}),
    (4, 1, {}),
    (4, None, {"coalesce_gap_bytes": 0}),
    (4, None, {"coalesce_gap_bytes": 0, "max_concurrency_task": 1, "fetch_parallelism": 1}),
)
#: phase 8: the data plane's size in 8a and 8d, the TeraSort size of 8b and
#: 8c, its two runs as (label, codec window knobs), and the rows of one
#: decode run (the config's decode_batch_frames)
WINDOW_MIB = 64
WINDOW_SORT_MIB = 256
WINDOW_RUNS = (
    ("on", {}),
    ("off", {"encode_inflight_batches": 1, "decode_inflight_batches": 1}),
)
DECODE_ROWS = 32
#: device memory bandwidth (bytes/s) by card name (NVIDIA data sheets)
BANDWIDTH = (
    ("H200", 4.8e12),
    ("H100 NVL", 3.9e12),
    ("H100 PCIe", 2.0e12),
    ("H100", 3.35e12),  # SXM (HBM3)
)
#: 32-bit integer operations per second: 64 INT32 lanes per SM (Hopper
#: architecture white paper) x 132 SMs x 1.98 GHz boost (H100 SXM)
INT32_OPS = 64 * 132 * 1.98e9


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def bandwidth_for(name: str) -> float:
    for key, bw in BANDWIDTH:
        if key in name:
            return bw
    return 3.35e12


def terasort_bytes(rng, size: int, pool) -> bytes:
    """TeraSort rows (examples/terasort.py): random 10-byte keys, 90-byte
    values drawn from a 64-entry pool, truncated to ``size`` bytes."""
    import numpy as np

    n = size // 100 + 1
    keys = rng.integers(0, 256, (n, 10), dtype=np.uint8)
    rows = np.concatenate([keys, pool[rng.integers(0, 64, n)]], axis=1)
    return rows.reshape(-1)[:size].tobytes()


def make_partitions(seed: int, part_bytes: int):
    import numpy as np

    rng = np.random.default_rng(seed)
    pool = rng.integers(0, 256, (64, 90), dtype=np.uint8)
    data = []
    for m in range(MAPS):
        parts = []
        for _p in range(PARTS):
            buf = bytearray(terasort_bytes(rng, part_bytes, pool))
            if m == MAPS - 1:  # one map in eight: a quarter of random bytes
                q = part_bytes // 4
                buf[:q] = rng.integers(0, 256, q, dtype=np.uint8).tobytes()
            parts.append(bytes(buf))
        data.append(parts)
    return data


def time_kernel(fn, reps: int) -> float:
    """Median ms per launch of ``fn`` over ``reps`` warm launches, each
    bracketed by CUDA events. The stream is first held by a sleep kernel so
    the host enqueues every launch ahead of the device: the events time the
    kernel, not the host's launch overhead."""
    import torch

    fn()
    torch.cuda.synchronize()
    starts = [torch.cuda.Event(enable_timing=True) for _ in range(reps)]
    ends = [torch.cuda.Event(enable_timing=True) for _ in range(reps)]
    torch.cuda._sleep(50_000_000)
    for s, e in zip(starts, ends):
        s.record()
        fn()
        e.record()
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) for s, e in zip(starts, ends))


def time_plain(fn, reps: int = 5) -> float:
    import torch

    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        s.record()
        fn()
        e.record()
        torch.cuda.synchronize()
        times.append(s.elapsed_time(e))
    return statistics.median(times)


def launch_breakdown(fn, calls: int = 10) -> dict:
    """Device µs per call of each CUDA kernel that ``fn`` launches, from a
    ``torch.profiler`` trace of ``calls`` warm calls."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    return {e.key.split("(")[0]: round(e.device_time_total / calls, 2)
            for e in prof.key_averages() if e.device_time_total > 0}


def stage_planes(payloads, n_groups: int, dev):
    """The decode staging of device-shaped payloads, as decode_batch_device
    builds it, on ``dev``."""
    import torch

    from s3shuffle_tpu_torch.ops import tlz

    rows, fallback = tlz._parse_batch_v2(payloads, [BLOCK] * len(payloads), n_groups)
    assert not fallback
    st = tlz._new_decode_staging(len(payloads), n_groups)
    for j, row in enumerate(rows):
        m, c, sp, dist_vals, kv, lit, nl, _ = row
        st[0][j], st[1][j], st[2][j] = m, c, sp
        st[3][j, : len(dist_vals)] = dist_vals
        st[4][j, : len(kv)] = kv
        st[5][j, : nl * tlz.GROUP] = lit
        st[6][j] = nl
    return [torch.from_numpy(a).to(dev) for a in st]


def wrapping_planes(n_groups: int, seed: int):
    """Decode planes with negative or extreme stored distances: forward
    pointers (-5), pointer cycles longer than one (-8 / +8 pairs, random
    negatives) and int32 wraps (-2**31 + 3, -2**31), on match and split
    groups; every row holds a negative distance."""
    import numpy as np

    from s3shuffle_tpu_torch.ops import tlz

    rng = np.random.default_rng(seed)
    b = 6
    idx = np.arange(n_groups)
    m = rng.random((b, n_groups)) < 0.5
    c = m & (rng.random((b, n_groups)) < 0.3)
    s = ~m & (rng.random((b, n_groups)) < 0.3)
    offs = rng.integers(-700, 700, (b, n_groups)).astype(np.int64)
    m[0], c[0], s[0], offs[0] = idx % 2 == 1, False, False, -(2**31) + 3
    offs[1] = -5
    m[2], c[2], s[2] = True, False, False
    offs[2, 0::2], offs[2, 1::2] = -8, 8
    extremes = np.array([-5, -(2**31) + 3, 2**31 - 4, -(2**31), 2**31 - 1, 0, 8])
    offs[3] = rng.choice(extremes, n_groups)
    s[4] = ~m[4] & (idx % 3 == 1)
    offs[4] = rng.integers(-(2**31), 0, n_groups)
    offs[5] = rng.integers(-40, 0, n_groups)
    ks = rng.integers(0, 9, (b, n_groups)).astype(np.int32)
    lits = rng.integers(0, 256, (b, n_groups * tlz.GROUP), dtype=np.uint8)
    nl = (n_groups - m.sum(1) - s.sum(1)).astype(np.int32)
    return m, c, s, offs.astype(np.int32), ks, lits, nl


def k2_edge_blocks(n_groups: int, seed: int):
    """Blocks and candidates (each in [-1, G*8 - 8]) that reach kernel K2's
    special cases, over a 4-symbol alphabet so neighbours share prefixes and
    suffixes (split groups): row 0 copies from the row's first bytes (source
    windows at 0-7, suffix sources before the row's start); row 1 points its
    last groups forward (negative distances: source bytes clamped at the
    row's last byte); row 2 copies at distances 65535 (a match) and 65536
    (too far) where the row is that long; row 3 copies runs of groups at one
    distance with candidates pointing anywhere. Every row holds such runs,
    which the promotion passes extend."""
    import numpy as np

    rng = np.random.default_rng(seed)
    n = n_groups * 8
    blocks = rng.integers(0, 4, (4, n), dtype=np.uint8)
    cand = np.full((4, n_groups), -1, dtype=np.int64)

    def copy(r, g, src, point=True):
        blocks[r, 8 * g : 8 * g + 8] = blocks[r, src : src + 8].copy()
        if point:
            cand[r, g] = src

    for r in range(4):  # runs at one distance: the first group points, the rest are promoted
        g = 2
        while g < n_groups - 8:
            d = 8 * int(rng.integers(1, min(g, 64) + 1)) + int(rng.integers(0, 8))
            run = int(rng.integers(2, 6))
            for k in range(run):
                if 8 * (g + k) - d >= 0:
                    copy(r, g + k, 8 * (g + k) - d, point=k == 0)
            g += run + int(rng.integers(1, 4))
    for g in range(1, min(n_groups, 48)):  # row 0: sources at the row's first bytes
        if g % 3:
            copy(0, g, int(rng.integers(0, 8)))
    for g in range(n_groups - 1, max(n_groups - 48, 0), -1):  # row 1: forward sources
        src = int(rng.integers(8 * g + 1, n - 7)) if 8 * g + 1 < n - 7 else n - 8
        if g % 3:
            copy(1, g, src)
        else:
            cand[1, g] = src
    far = [g for g in range(n_groups) if 8 * g >= 65536]
    for i, g in enumerate(far[:64]):  # row 2: distances 65535 and 65536
        copy(2, g, 8 * g - (65535 if i % 2 == 0 else 65536))
    for i, g in enumerate(far[64:128]):  # a distance-65535 run, promoted after its first group
        copy(2, g, 8 * g - 65535, point=i == 0)
    pick = rng.random(n_groups) < 0.3  # row 3: candidates anywhere in range
    cand[3, pick] = rng.integers(0, n - 7, int(pick.sum()))
    for r in range(4):  # split groups: a prefix at the left match's distance, the rest at the right's
        for g in range(5, n_groups - 1, 11):
            if r == 0 and g < 48:  # both neighbours copy from the row's first 8 bytes
                pd = 8 * (g - 1) - int(rng.integers(0, 8))
                nd = 8 * (g + 1) - int(rng.integers(0, 8))
            else:
                pd = 8 * int(rng.integers(1, g - 1)) + 3
                nd = pd + 8 * int(rng.integers(1, 4))
            if 8 * (g + 1) - nd < 0:
                continue
            copy(r, g - 1, 8 * (g - 1) - pd)
            copy(r, g + 1, 8 * (g + 1) - nd)
            k = int(rng.integers(1, 8))
            for j in range(8):
                src = 8 * g + j - (pd if j < k else nd)
                if src >= 0:
                    blocks[r, 8 * g + j] = blocks[r, src]
            cand[r, g] = -1
    return blocks, cand.astype(np.int32)


def kernel_phase(first_batch: bytes, k4_bytes: bytes, reps: int, bw: float, dev):
    """Phase 2: each kernel against its plain version at main-path shapes."""
    import numpy as np
    import torch

    from s3shuffle_tpu_torch.coding import gf, gf_cuda
    from s3shuffle_tpu_torch.ops import checksum, crc_cuda, tlz, tlz_cuda

    poly = checksum.POLY_CRC32C
    n_groups = BLOCK // tlz.GROUP
    blocks = torch.from_numpy(
        np.frombuffer(first_batch, dtype=np.uint8).reshape(BATCH, BLOCK).copy()
    ).to(dev)
    results = []

    # --- K2: plane decisions ---
    cand = tlz.candidate_math(blocks, n_groups)
    got = tlz_cuda.plane_decisions(blocks, cand, n_groups)
    torch.cuda.synchronize()
    want = tlz.plane_decisions_plain(blocks, cand, n_groups)
    for g, w, name in zip(got, want, ("is_match", "is_cont", "is_split", "dists", "ks")):
        assert torch.equal(g, w), f"K2 {name} differs from the plain version"
    k2_bytes = blocks.numel() + cand.numel() * 4 + 3 * BATCH * n_groups + 2 * BATCH * n_groups * 4
    results.append({
        "name": "tlz_planes", "route": "cuda",
        "source": "s3shuffle_tpu_torch/csrc/tlz_planes.cu",
        "replaces": "s3shuffle_tpu/ops/tlz_pallas.py:77",
        "max_abs_err": 0,
        "ms": time_kernel(lambda: tlz_cuda.plane_decisions(blocks, cand, n_groups), reps),
        "plain_ms": time_plain(lambda: tlz.plane_decisions_plain(blocks, cand, n_groups)),
        "bytes": k2_bytes,
        # ~60 int ops per group: 12 8-byte compares, the 16-lane split tier
        "ops": 60 * BATCH * n_groups,
    })

    # --- K1: CRC fold over the raw blocks + the literal planes, two row
    # sets in one launch as encode_fused runs it ---
    outs = tlz.compact_pack(blocks, *got, n_groups)
    lits = outs[5].reshape(BATCH, BLOCK)
    lit_len = ((n_groups - outs[8] - outs[7]) * tlz.GROUP).to(torch.int32)
    k1 = crc_cuda.crc_raw_pair(blocks, lits, poly, more_lengths=lit_len)
    torch.cuda.synchronize()
    rows = torch.cat([blocks, lits], dim=0)
    lengths = torch.cat([torch.full((BATCH,), BLOCK, dtype=torch.int32, device=dev), lit_len])
    k1_plain = checksum.crc_raw_plain(rows, poly, lengths)
    assert torch.equal(k1, k1_plain), "K1 differs from the plain version"
    assert torch.equal(crc_cuda.crc_raw(rows, poly, lengths), k1_plain), "K1 one-set launch"
    need = int(lengths.to(torch.int64).sum())
    results.append({
        "name": "crc_fold", "route": "cuda",
        "source": "s3shuffle_tpu_torch/csrc/crc_fold.cu",
        "replaces": "s3shuffle_tpu/ops/crc_pallas.py:68",
        "max_abs_err": int((k1 - k1_plain).abs().max()),
        "ms": time_kernel(lambda: crc_cuda.crc_raw_pair(blocks, lits, poly, more_lengths=lit_len),
                          reps),
        "plain_ms": time_plain(lambda: checksum.crc_raw_plain(rows, poly, lengths)),
        "bytes": need + lit_len.numel() * 4 + rows.shape[0] * 8,
        "ops": 2 * need,  # one xor + one table step per byte
    })

    def staged_k1():  # the first design's main-path stage: concatenate, then one set
        crc_cuda.crc_raw(torch.cat([blocks, lits], dim=0), poly, torch.cat([
            torch.full((BATCH,), BLOCK, dtype=torch.int32, device=dev), lit_len]))

    print(f"K1 main-path stage: two-set launch {results[-1]['ms']:.4f} ms; "
          f"torch.cat staging + one-set launch {time_kernel(staged_k1, reps):.4f} ms")
    for name, fn in (
        ("K2", lambda: tlz_cuda.plane_decisions(blocks, cand, n_groups)),
        ("K1", lambda: crc_cuda.crc_raw_pair(blocks, lits, poly, more_lengths=lit_len)),
    ):
        print(f"{name}: device µs per call by launch (torch.profiler): {launch_breakdown(fn)}")

    # --- K3: fused decode + literal-plane CRC at the decode run's shape
    # (DECODE_ROWS rows), on this batch's first payloads and on all-zero
    # blocks (distance-1 chains through every segment) ---
    rows = DECODE_ROWS
    for name, batch in (("tlz_decode_fused", first_batch[: rows * BLOCK]),
                        ("tlz_decode_fused[zeros]", bytes(rows * BLOCK))):
        want_rows = torch.from_numpy(
            np.frombuffer(batch, dtype=np.uint8).reshape(rows, BLOCK).copy()
        ).to(dev)
        payloads, _ = tlz.encode_batch_device(batch, rows, BLOCK, rows, device=dev)
        staged = stage_planes(payloads, n_groups, dev)
        tlz_cuda.reset_general_route_rows()
        dec, raw = tlz_cuda.decode_fused(*staged, n_groups, poly)
        torch.cuda.synchronize()
        dec_p, raw_p = tlz.decode_fused_plain(*staged, n_groups, poly)
        assert torch.equal(dec, dec_p) and torch.equal(raw, raw_p), f"{name} differs from plain"
        assert torch.equal(dec, want_rows), f"{name} did not decode the blocks"
        m, c, s, offs, ks, lits_s, nl = staged
        n_new = int((m & ~c).sum())
        n_spl = int(s.sum())
        lit_bytes = int(nl.to(torch.int64).sum()) * tlz.GROUP
        results.append({
            "name": name, "route": "cuda",
            "source": "s3shuffle_tpu_torch/csrc/tlz_decode_fused.cu",
            "replaces": "s3shuffle_tpu/ops/tlz_pallas.py:230",
            "max_abs_err": int((raw - raw_p).abs().max()),
            "ms": time_kernel(lambda: tlz_cuda.decode_fused(*staged, n_groups, poly), reps),
            "plain_ms": time_plain(lambda: tlz.decode_fused_plain(*staged, n_groups, poly)),
            "bytes": 3 * rows * n_groups + 4 * (n_new + n_spl) + lit_bytes
            + dec.numel() + rows * 8,
            # one gather per decoded byte, the literal CRC as in K1
            "ops": dec.numel() + 2 * lit_bytes,
        })
        general = tlz_cuda.general_route_rows(dev)
        print(f"K3 {name}: general-route rows {general}; device µs per call by launch "
              f"(torch.profiler): {launch_breakdown(lambda: tlz_cuda.decode_fused(*staged, n_groups, poly))}")
        assert general == 0, f"{name}: validated rows took the general route"
    # the shape of the decode runs before the codec windows (64 rows), for
    # comparison with the earlier measurements
    staged64 = stage_planes(tlz.encode_batch_device(first_batch, BATCH, BLOCK, BATCH,
                                                    device=dev)[0], n_groups, dev)
    print(f"K3 at {BATCH} rows (the decode runs before the codec windows): "
          f"{time_kernel(lambda: tlz_cuda.decode_fused(*staged64, n_groups, poly), reps):.4f} "
          f"ms/launch")

    # --- K4: parity encode of one batch of stripe groups on the coded path ---
    chunks = torch.from_numpy(
        np.frombuffer(k4_bytes, dtype=np.uint8).reshape(K4_GROUPS, PARITY_K, PARITY_CHUNK).copy()
    ).to(dev)
    coefs = gf.parity_coefficients(PARITY_M, PARITY_K)
    consts = torch.from_numpy(gf.bit_constants(coefs)).to(dev)
    par = gf_cuda.encode(chunks, consts)
    torch.cuda.synchronize()
    par_p = gf_cuda.encode_groups_plain(chunks, consts)
    assert torch.equal(par, par_p), "K4 differs from the plain version"
    # reference on the host: row 0 is the XOR of the chunks, row 1 the
    # RAID-6 Q parity D0 ^ 2*D1, from the log/exp tables
    host = chunks[:2].cpu().numpy()
    assert np.array_equal(par[:2, 0].cpu().numpy(), host[:, 0] ^ host[:, 1])
    assert np.array_equal(par[:2, 1].cpu().numpy(),
                          host[:, 0] ^ gf.gf_mul_bytes(2, host[:, 1]))
    n = chunks.numel()
    results.append({
        "name": "gf_encode", "route": "cuda",
        "source": "s3shuffle_tpu_torch/csrc/gf_encode.cu",
        "replaces": "s3shuffle_tpu/coding/gf_pallas.py:76",
        "max_abs_err": int((par.to(torch.int16) - par_p.to(torch.int16)).abs().max()),
        "ms": time_kernel(lambda: gf_cuda.encode(chunks, consts), reps),
        "plain_ms": time_plain(lambda: gf_cuda.encode_groups_plain(chunks, consts)),
        "bytes": n + par.numel(),
        # a table formulation's least work: one multiply and one XOR per
        # (parity row, data chunk, byte)
        "ops": 2 * PARITY_M * n,
    })

    for r in results:
        t_bytes = r.pop("bytes") / bw * 1e3
        t_ops = r.pop("ops") / INT32_OPS * 1e3
        r["bound_ms"] = max(t_bytes, t_ops)
        r["bound_by"] = "bytes" if t_bytes >= t_ops else "operations"
        r["library_ms"] = None  # no single PyTorch call computes these functions
        print(
            f"kernel {r['name']}: equal to plain; {r['ms']:.4f} ms/launch "
            f"(plain {r['plain_ms']:.3f} ms, bound {r['bound_ms']:.4f} ms by {r['bound_by']})"
        )
    edge_checks(dev)
    return results


def edge_checks(dev) -> None:
    """Inputs beyond the main path's: CRC lengths not a multiple of 8 and
    widths below one chunk per thread; decode planes that were never
    validated, at 64 and 32768 groups — non-negative distances (clamped
    offsets; K3's segmented route) and negative or extreme distances
    (forward pointers, pointer cycles longer than one, int32 wraps; K3's
    general route); full-size blocks of text, zeros, random and mixed
    bytes, whose device payloads must also equal the host numpy
    encoder's."""
    import numpy as np
    import torch

    from s3shuffle_tpu_torch.coding import gf, gf_cuda
    from s3shuffle_tpu_torch.ops import checksum, crc_cuda, tlz, tlz_cuda

    rng = np.random.default_rng(7)
    seg = crc_cuda.SEG_BYTES
    for poly in (checksum.POLY_CRC32, checksum.POLY_CRC32C):
        for width in (8, 512, 1280, 8192, 3 * seg + 128, BLOCK):
            rows = torch.from_numpy(rng.integers(0, 256, (9, width), dtype=np.uint8)).to(dev)
            lengths = torch.from_numpy(
                rng.integers(0, width + 1, 9).astype(np.int32)
            ).to(dev)
            assert torch.equal(crc_cuda.crc_raw(rows, poly), checksum.crc_raw_plain(rows, poly))
            assert torch.equal(
                crc_cuda.crc_raw(rows, poly, lengths),
                checksum.crc_raw_plain(rows, poly, lengths),
            ), f"K1 differs at width {width}"
        # the segment cut's edges: lengths around one and two segments, and
        # the two-set launch against the one-set launch and the plain version
        width = 3 * seg + 128
        edge = [0, 1, 7, 8, seg - 1, seg, seg + 1, 2 * seg + 5, width]
        rows = torch.from_numpy(rng.integers(0, 256, (len(edge), width), dtype=np.uint8)).to(dev)
        lengths = torch.tensor(edge, dtype=torch.int32, device=dev)
        want = checksum.crc_raw_plain(rows, poly, lengths)
        assert torch.equal(crc_cuda.crc_raw(rows, poly, lengths), want), "K1 at segment edges"
        first = torch.from_numpy(rng.integers(0, 256, (3, width), dtype=np.uint8)).to(dev)
        first_len = torch.tensor([width, 5, seg + 3], dtype=torch.int32, device=dev)
        for a_len in (None, first_len):
            pair = crc_cuda.crc_raw_pair(first, rows, poly, lengths=a_len, more_lengths=lengths)
            full = torch.full((3,), width, dtype=torch.int32, device=dev)
            both = torch.cat([a_len if a_len is not None else full, lengths])
            one = crc_cuda.crc_raw(torch.cat([first, rows]), poly, both)
            assert torch.equal(pair, one), "K1 two-set launch != one-set launch"
            assert torch.equal(pair, checksum.crc_raw_plain(torch.cat([first, rows]), poly, both))
    # K2 on crafted blocks: sources at the row's first bytes, forward sources
    # clamped at its last byte, split groups, distances 65535 and 65536; at
    # full width, 8256, 300 and 64 groups (none a multiple of its 124-group
    # warp tile; 64 is less than one)
    for n_groups in (BLOCK // tlz.GROUP, 8256, 300, 64):
        blocks_np, cand_np = k2_edge_blocks(n_groups, n_groups)
        eb = torch.from_numpy(blocks_np).to(dev)
        ec = torch.from_numpy(cand_np).to(dev)
        got = tlz_cuda.plane_decisions(eb, ec, n_groups)
        want = tlz.plane_decisions_plain(eb, ec, n_groups)
        for g, w, name in zip(got, want, ("is_match", "is_cont", "is_split", "dists", "ks")):
            assert torch.equal(g, w), f"K2 {name} differs on edge blocks of {n_groups} groups"
        assert int(want[2].sum()) > 0 and int((want[3] < 0).sum()) > 0
    tlz_cuda.reset_general_route_rows()
    expect_general = 0
    for n_groups, b in ((64, 16), (BLOCK // tlz.GROUP, 6)):
        for hi in (700, 2**31 - 1):  # non-negative distances: the segmented route
            m = rng.random((b, n_groups)) < 0.5
            planes = (
                m, m & (rng.random((b, n_groups)) < 0.5), ~m & (rng.random((b, n_groups)) < 0.3),
                rng.integers(0, hi, (b, n_groups)).astype(np.int32),
                rng.integers(0, 9, (b, n_groups)).astype(np.int32),
                rng.integers(0, 256, (b, n_groups * tlz.GROUP), dtype=np.uint8),
            )
            nl = (n_groups - planes[0].sum(1) - planes[2].sum(1)).astype(np.int32)
            staged = [torch.from_numpy(a).to(dev) for a in (*planes, nl)]
            for poly in (checksum.POLY_CRC32, checksum.POLY_CRC32C):
                got = tlz_cuda.decode_fused(*staged, n_groups, poly)
                want = tlz.decode_fused_plain(*staged, n_groups, poly)
                assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1]), (
                    f"K3 corrupt planes, {n_groups} groups, distances in [0, {hi})")
        # negative and extreme distances: the general route
        staged = [torch.from_numpy(a).to(dev) for a in wrapping_planes(n_groups, n_groups)]
        for poly in (checksum.POLY_CRC32, checksum.POLY_CRC32C):
            got = tlz_cuda.decode_fused(*staged, n_groups, poly)
            want = tlz.decode_fused_plain(*staged, n_groups, poly)
            assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1]), (
                f"K3 negative/extreme distances, {n_groups} groups")
            expect_general += int(tlz.general_route_plain(staged[3]).sum())
    general = tlz_cuda.general_route_rows(dev)
    print(f"K3 edge checks: general-route rows {general} (expected {expect_general})")
    assert general == expect_general > 0, "K3's general route did not take the corrupt rows"
    rng_blocks = torch.from_numpy(rng.integers(0, 3, (4, 512), dtype=np.uint8)).to(dev)
    cand = tlz.candidate_math(rng_blocks, 64)
    for g, w in zip(tlz_cuda.plane_decisions(rng_blocks, cand, 64),
                    tlz.plane_decisions_plain(rng_blocks, cand, 64)):
        assert torch.equal(g, w), "K2 differs on a 512-byte block"
    # full-size blocks of other kinds: text, zeros (distance-1 chains: every
    # pointer-jump round), random (raw escapes), mixed
    text = (b"the quick brown fox jumps over the lazy dog " * (BLOCK // 40))[:BLOCK]
    run = (b"columnar shuffle row payload " * (BLOCK // 20))[: BLOCK // 3]
    mixed = (run + rng.integers(0, 256, BLOCK - 2 * len(run), dtype=np.uint8).tobytes()
             + run)
    kinds = [text, bytes(BLOCK), rng.integers(0, 256, BLOCK, dtype=np.uint8).tobytes(), mixed]
    blob = b"".join(kinds)
    blocks = torch.from_numpy(np.frombuffer(blob, dtype=np.uint8).reshape(4, BLOCK).copy()).to(dev)
    n_groups = BLOCK // tlz.GROUP
    cand = tlz.candidate_math(blocks, n_groups)
    for g, w in zip(tlz_cuda.plane_decisions(blocks, cand, n_groups),
                    tlz.plane_decisions_plain(blocks, cand, n_groups)):
        assert torch.equal(g, w), "K2 differs on text/zeros/random/mixed blocks"
    payloads, crcs = tlz.encode_batch_device(blob, 4, BLOCK, 4, poly=checksum.POLY_CRC32C,
                                             device=dev)
    for data, payload, block_crc in zip(kinds, payloads, crcs[0]):
        assert payload == tlz._assemble_payload_numpy(data), "device payload != host encoder"
        assert int(block_crc) == checksum.host_crc(data, checksum.POLY_CRC32C)
    staged = stage_planes(payloads, n_groups, dev)
    got = tlz_cuda.decode_fused(*staged, n_groups, checksum.POLY_CRC32C)
    want = tlz.decode_fused_plain(*staged, n_groups, checksum.POLY_CRC32C)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1]), "K3 on block kinds"
    assert torch.equal(got[0], blocks), "K3 did not decode the block kinds"
    torch.cuda.synchronize()
    # K4: the tail group (G = 1, L not a multiple of 16), (m, k) from (1, 1)
    # to (8, 64), more than 8 parity rows (several CTA rows) and more than
    # 64 data chunks (several constant tiles), zero and random chunks
    for m, k, groups, length in ((2, 2, 1, PARITY_CHUNK - 7), (1, 1, 3, 4096),
                                 (4, 16, 5, 1000), (8, 64, 2, 4096 + 3), (8, 64, 1, 64),
                                 (11, 3, 2, 777), (2, 100, 2, 160)):
        consts = torch.from_numpy(gf.bit_constants(gf.parity_coefficients(m, k))).to(dev)
        for zero in (False, True):
            chunks = (torch.zeros((groups, k, length), dtype=torch.uint8, device=dev) if zero
                      else torch.from_numpy(rng.integers(0, 256, (groups, k, length),
                                                         dtype=np.uint8)).to(dev))
            got = gf_cuda.encode(chunks, consts)
            assert torch.equal(got, gf_cuda.encode_groups_plain(chunks, consts)), (
                f"K4 differs at m={m}, k={k}, G={groups}, L={length}, zero={zero}")
    # the read side: recover_group encodes the survivors' share on the card
    coefs = gf.parity_coefficients(2, 4)
    stripe = rng.integers(0, 256, (1, 4, 1000), dtype=np.uint8)
    par = gf.encode_groups(stripe, coefs, dev)[0]
    rec = gf.recover_group(4, coefs, {0: stripe[0, 0], 3: stripe[0, 3]},
                           {0: par[0], 1: par[1]}, [1, 2], dev)
    assert rec is not None and all(np.array_equal(rec[j], stripe[0, j]) for j in (1, 2))
    torch.cuda.synchronize()
    print("edge checks: K1 unaligned lengths, segment edges and two-set launches, "
          "K2 crafted edge blocks at 32768, 8256, 300 and 64 groups, K3 corrupt planes "
          "(segmented and general routes, 64 and 32768 groups), "
          "K2/K3 on text/zeros/random/mixed 256 KiB blocks, K4 at ragged lengths and "
          "(m, k) from (1, 1) to (11, 3) and (2, 100): equal to plain; a stripe group "
          "recovered on the card; device payloads equal to the host encoder")


def main_path(data, dev, root: str, listing: bool = False, **knobs):
    """Phase 3 (and 8d): write every map, read every reduce partition back.
    ``knobs`` are further ShuffleConfig fields; with ``listing`` the maps
    the reads name are enumerated by listing the store's index objects.
    Returns the launches and the write and read seconds."""
    import torch

    from s3shuffle_tpu_torch import ShuffleConfig, ShuffleDataBlockId
    from s3shuffle_tpu_torch.codec import codec_from_config
    from s3shuffle_tpu_torch.codec.cuda import CudaCodec
    from s3shuffle_tpu_torch.metadata.helper import ShuffleHelper
    from s3shuffle_tpu_torch.ops import _build, tlz_cuda
    from s3shuffle_tpu_torch.ops.checksum import POLY_CRC32C, host_crc
    from s3shuffle_tpu_torch.read.reader import ShuffleReader
    from s3shuffle_tpu_torch.storage.dispatcher import Dispatcher
    from s3shuffle_tpu_torch.write.map_output_writer import MapOutputWriter

    cfg = ShuffleConfig(root_dir=f"file://{root}", checksum_algorithm="CRC32C",
                        codec_block_size=BLOCK, codec_batch_blocks=BATCH, **knobs)
    disp = Dispatcher(cfg)
    helper = ShuffleHelper(disp)
    codec = codec_from_config(cfg, dev)
    codec.timings = {}
    total = sum(len(p) for parts in data for p in parts)
    _build.reset_launches()
    tlz_cuda.reset_general_route_rows()
    t0 = time.perf_counter()
    stored = 0
    for m in range(MAPS):
        writer = MapOutputWriter(disp, helper, 0, m, PARTS, codec=codec)
        for p in range(PARTS):
            pw = writer.get_encoding_partition_writer(p)
            pw.write(data[m][p])
            pw.close()
        msg = writer.commit_all_partitions()
        stored += int(msg.partition_lengths.sum())
    torch.cuda.synchronize()
    t_write = time.perf_counter() - t0
    write_stages = dict(codec.timings)
    codec.timings.clear()
    reader = ShuffleReader(disp, helper, codec=codec)
    t_read = 0.0
    map_ids = list(range(MAPS))
    if listing:
        map_ids = [index.map_id for index in disp.list_shuffle_indices(0)]
        assert map_ids == list(range(MAPS)), map_ids
    for r in range(PARTS):
        t0 = time.perf_counter()
        got = reader.read_partition(0, r, map_ids)
        t_read += time.perf_counter() - t0
        want = b"".join(data[m][r] for m in range(MAPS))
        assert got == want, f"reduce partition {r} read back wrong bytes"
    launches = dict(_build.LAUNCHES)
    general = tlz_cuda.general_route_rows(dev)
    read_stages = dict(codec.timings)
    counts = dict(codec.frame_counts)
    # reference checks on a small input: one partition's frames through the
    # host numpy decoder, and its sidecar CRC against the host CRC32C
    offsets = helper.get_partition_lengths(0, 0)
    sums = helper.get_checksums(0, 0)
    with disp.open_block(ShuffleDataBlockId(0, 0)) as f:
        stored0 = f.read_fully(int(offsets[0]), int(offsets[1] - offsets[0]))
    assert host_crc(stored0, POLY_CRC32C) == int(sums[0]) & 0xFFFFFFFF
    host = CudaCodec(BLOCK, BATCH, device="cpu")
    assert host.decompress_bytes(stored0) == data[0][0]
    print(
        f"main path: {total / MiB:.0f} MiB in {MAPS} maps x {PARTS} partitions, "
        f"stored {stored / MiB:.1f} MiB (ratio {total / stored:.3f})"
    )
    print(f"write: {total / MiB / t_write:.1f} MB/s ({t_write:.2f} s); "
          f"read+validate: {total / MiB / t_read:.1f} MB/s ({t_read:.2f} s)")
    for label, stages, wall in (("write", write_stages, t_write), ("read", read_stages, t_read)):
        parts = ", ".join(f"{k} {v:.2f}" for k, v in sorted(stages.items()))
        rest = wall - sum(stages.values())
        print(f"{label} stages (s): {parts}, rest of the path {rest:.2f}")
    print(f"write frames: {counts['written']}, CRC fused from the encode launch: "
          f"{counts['written_fused']}")
    print(f"read frames: {counts['read']}, certified by fused decode CRCs: {counts['read_fused']}")
    print(f"launches on the main path: {json.dumps(launches)}; "
          f"K3 general-route rows: {general}")
    print("reference checks: host numpy decode of map 0 partition 0 and host CRC32C "
          "of its stored bytes agree")
    for name in UNCODED_KERNELS:
        assert launches[name] > 0, f"kernel {name} was not launched on the main path"
    assert counts["written_fused"] > 0 and counts["read_fused"] > 0, counts
    assert general == 0, "validated rows took K3's general route on the main path"
    return launches, t_write, t_read


def coded_path(data, dev, root: str):
    """Phase 4: write every map with two parity sidecars, lose four data
    objects, read every reduce partition back."""
    import torch

    from s3shuffle_tpu_torch import ShuffleConfig, ShuffleDataBlockId
    from s3shuffle_tpu_torch.codec import codec_from_config
    from s3shuffle_tpu_torch.metadata.helper import ShuffleHelper
    from s3shuffle_tpu_torch.ops import _build, tlz_cuda
    from s3shuffle_tpu_torch.read.reader import ShuffleReader
    from s3shuffle_tpu_torch.storage.dispatcher import Dispatcher
    from s3shuffle_tpu_torch.write.map_output_writer import MapOutputWriter

    cfg = ShuffleConfig(root_dir=f"file://{root}", checksum_algorithm="CRC32C",
                        codec_block_size=BLOCK, codec_batch_blocks=BATCH,
                        parity_segments=PARITY_M, parity_stripe_k=PARITY_K,
                        parity_chunk_bytes=PARITY_CHUNK)
    disp = Dispatcher(cfg)
    helper = ShuffleHelper(disp)
    codec = codec_from_config(cfg, dev)
    total = sum(len(p) for parts in data for p in parts)
    _build.reset_launches()
    tlz_cuda.reset_general_route_rows()
    t0 = time.perf_counter()
    stored = 0
    for m in range(MAPS):
        writer = MapOutputWriter(disp, helper, 1, m, PARTS, codec=codec)
        for p in range(PARTS):
            pw = writer.get_encoding_partition_writer(p)
            pw.write(data[m][p])
            pw.close()
        msg = writer.commit_all_partitions()
        assert msg.parity_segments == PARITY_M
        stored += int(msg.partition_lengths.sum())
    torch.cuda.synchronize()
    t_write = time.perf_counter() - t0
    write_launches = dict(_build.LAUNCHES)
    parity_bytes = sum(
        os.path.getsize(os.path.join(d, f))
        for d, _dirs, files in os.walk(root) for f in files if f.endswith(".parity")
    )
    for m in LOST_MAPS:
        path = disp.get_path(ShuffleDataBlockId(1, m))
        assert os.path.exists(path[len("file://"):])
        disp.backend.delete(path)
    reader = ShuffleReader(disp, helper, codec=codec)
    t_read = 0.0
    for r in range(PARTS):
        t0 = time.perf_counter()
        got = reader.read_partition(1, r, range(MAPS))
        t_read += time.perf_counter() - t0
        want = b"".join(data[m][r] for m in range(MAPS))
        assert got == want, f"coded path: reduce partition {r} read back wrong bytes"
    launches = dict(_build.LAUNCHES)
    general = tlz_cuda.general_route_rows(dev)
    read_gf = launches["gf_encode"] - write_launches["gf_encode"]
    print(f"coded path: {total / MiB:.0f} MiB in {MAPS} maps x {PARTS} partitions, "
          f"k={PARITY_K} m={PARITY_M} chunk {PARITY_CHUNK // 1024} KiB; stored "
          f"{stored / MiB:.1f} MiB, parity {parity_bytes} bytes "
          f"({parity_bytes / stored:.3f} of stored)")
    print(f"coded write (with parity): {total / MiB / t_write:.1f} MB/s ({t_write:.2f} s); "
          f"read+validate with data objects of maps {list(LOST_MAPS)} lost: "
          f"{total / MiB / t_read:.1f} MB/s ({t_read:.2f} s)")
    print(f"reconstructions: {reader.reconstructions}; gf_encode launches: write "
          f"{write_launches['gf_encode']}, read {read_gf}")
    print(f"launches on the coded path: {json.dumps(launches)}; "
          f"K3 general-route rows: {general}")
    assert general == 0, "validated rows took K3's general route on the coded path"
    assert write_launches["gf_encode"] > 0, "K4 was not launched on the coded write"
    assert reader.reconstructions == len(LOST_MAPS) * PARTS, reader.reconstructions
    for name, n in launches.items():
        assert n > 0, f"kernel {name} was not launched on the coded path"
    return launches


def terasort_parts(seed: int, total_bytes: int):
    """TeraSort input as ``examples/terasort.py`` generates it: per map, a
    columnar batch of random 10-byte keys and 90-byte values drawn from a
    64-entry pool, ``total_bytes // 100 // MAPS`` records."""
    import numpy as np

    from s3shuffle_tpu_torch.batch import RecordBatch

    per_map = total_bytes // (KEY_BYTES + VALUE_BYTES) // MAPS
    rng = np.random.default_rng(seed)
    pool = rng.integers(0, 256, (64, VALUE_BYTES), dtype=np.uint8)
    parts = []
    for _ in range(MAPS):
        keys = rng.integers(0, 256, (per_map, KEY_BYTES), dtype=np.uint8)
        values = pool[rng.integers(0, 64, per_map)]
        parts.append(RecordBatch(
            np.full(per_map, KEY_BYTES, np.int32), np.full(per_map, VALUE_BYTES, np.int32),
            keys.reshape(-1), values.reshape(-1),
        ))
    return parts


def rows_of(batches):
    """(n, 100) uint8 rows of fixed-width TeraSort batches."""
    import numpy as np

    return np.concatenate([
        np.hstack([b.keys.reshape(-1, KEY_BYTES), b.values.reshape(-1, VALUE_BYTES)])
        for b in batches if b.n
    ])


def sort_rows(rows):
    """``rows`` ordered by their whole bytes (each row one fixed-width
    string, so numpy compares them in plain byte order)."""
    import numpy as np

    width = rows.shape[1]
    flat = np.ascontiguousarray(rows).view(f"S{width}").ravel()
    return np.sort(flat).view(np.uint8).reshape(-1, width)


def teravalidate(out, expected_records: int, input_rows) -> None:
    """examples/terasort.py's TeraValidate (record count, key order within
    and across partitions), then the output rows against the input rows,
    both ordered by the whole row (the order of equal keys is not defined)."""
    import numpy as np

    from s3shuffle_tpu_torch.batch import RecordBatch

    merged = [RecordBatch.concat(p) for p in out]
    n = sum(b.n for b in merged)
    assert n == expected_records, f"record count {n} != {expected_records}"
    prev_last = None
    for b in merged:
        if b.n == 0:
            continue
        sk = b.key_strings(width=KEY_BYTES)
        assert (sk[:-1] <= sk[1:]).all(), "order violated within partition"
        if prev_last is not None:
            assert prev_last <= sk[0], "order violated across partitions"
        prev_last = sk[-1]
    assert np.array_equal(sort_rows(rows_of(merged)), input_rows), \
        "the output rows are not the input rows"


def files_under(root: str):
    return [os.path.join(d, f) for d, _dirs, files in os.walk(root) for f in files]


class CountingBackend:
    """Counts the positioned reads (GETs) issued through a backend, by
    object kind; everything else passes through. An instrument of this
    script, not a feature of the port."""

    KINDS = (".data", ".index", ".checksum", ".parity")

    def __init__(self, inner):
        import collections
        import threading

        self._inner = inner
        self.gets = collections.Counter()
        self._lock = threading.Lock()

    def __getattr__(self, name):
        return getattr(self._inner, name)

    def open_ranged(self, path):
        name = path.rsplit("/", 1)[-1]
        kind = next((k[1:] for k in self.KINDS if k in name), "other")
        return _CountingReader(self, kind, self._inner.open_ranged(path))

    def read_all(self, path):
        with self.open_ranged(path) as r:
            return r.read_fully(0, r.size)

    def list_prefix(self, prefix):
        with self._lock:
            self.gets["list"] += 1
        return self._inner.list_prefix(prefix)


class LaunchThreads:
    """Counts kernel launches by the kind of thread that made them (the
    codec's encode thread, a decode-pool thread, or a task thread) by
    wrapping the port's launch counter while in use. An instrument of this
    script, not a feature of the port."""

    def __enter__(self):
        import collections
        import threading

        from s3shuffle_tpu_torch.ops import _build

        self.counts = collections.Counter()
        self._build = _build
        self._real = _build.count_launch

        def count_launch(name, _real=self._real):
            thread = threading.current_thread().name
            kind = next((k for k in ("encode", "decode")
                         if thread.startswith(f"s3shuffle-torch-{k}")), "task")
            self.counts[f"{name}@{kind}"] += 1
            _real(name)

        _build.count_launch = count_launch
        return self

    def __exit__(self, *exc):
        self._build.count_launch = self._real


class DecodePoolUse:
    """The most decode-pool threads decoding at once, and how many distinct
    pool threads decoded, by wrapping the port's run decode while in use.
    An instrument of this script, not a feature of the port."""

    def __enter__(self):
        import threading

        from s3shuffle_tpu_torch.codec.framing import CodecInputStream

        self.most = 0
        self.threads = set()
        self._active = 0
        self._lock = threading.Lock()
        self._cls = CodecInputStream
        self._real = CodecInputStream._decode_frames

        def decode_frames(stream, frames, _real=self._real):
            name = threading.current_thread().name
            if not name.startswith("s3shuffle-torch-decode"):
                return _real(stream, frames)
            with self._lock:
                self._active += 1
                self.most = max(self.most, self._active)
                self.threads.add(name)
            try:
                return _real(stream, frames)
            finally:
                with self._lock:
                    self._active -= 1

        CodecInputStream._decode_frames = decode_frames
        return self

    def __exit__(self, *exc):
        self._cls._decode_frames = self._real


class _CountingReader:
    def __init__(self, owner: CountingBackend, kind: str, inner):
        self._owner, self._kind, self._inner = owner, kind, inner

    @property
    def size(self):
        return self._inner.size

    def read_fully(self, position: int, length: int) -> bytes:
        with self._owner._lock:
            self._owner.gets[self._kind] += 1
        return self._inner.read_fully(position, length)

    def close(self):
        self._inner.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def record_path(label: str, parts, input_rows, dev, root: str, bypass: int,
                workers: int = WORKERS, after=None, **knobs):
    """Phase 5a/5b (and each run of phases 7 and 8b): TeraSort through
    ShuffleContext.sort_by_key, as examples/terasort.py runs it, on
    ``workers`` task threads, then TeraValidate; ``bypass`` is the manager's
    bypass-merge threshold (0 selects the serialized handle), ``knobs``
    further ShuffleConfig fields. The store's GETs are counted
    (:class:`CountingBackend`) and every reduce task's read metrics summed;
    ``after(manager)``, when given, runs on the written shuffle before the
    context stops. Returns the launches, the wall seconds and the read
    side's numbers."""
    import torch

    from s3shuffle_tpu_torch import ShuffleConfig, ShuffleContext, ShuffleManager
    from s3shuffle_tpu_torch.ops import _build, tlz_cuda
    from s3shuffle_tpu_torch.serializer import ColumnarKVSerializer

    cfg = ShuffleConfig(root_dir=f"file://{root}", checksum_algorithm="CRC32C",
                        codec_block_size=BLOCK, codec_batch_blocks=BATCH, **knobs)
    manager = ShuffleManager(cfg, bypass_merge_threshold=bypass, device=dev)
    manager.codec.timings = {}
    counting = CountingBackend(manager.dispatcher.backend)
    manager.dispatcher.backend = counting
    readers = []
    get_reader = manager.get_reader

    def tracked_reader(*args, **kwargs):
        reader = get_reader(*args, **kwargs)
        readers.append(reader)
        return reader

    manager.get_reader = tracked_reader
    ctx = ShuffleContext(manager=manager, num_workers=workers)
    n_records = sum(p.n for p in parts)
    raw = n_records * (KEY_BYTES + VALUE_BYTES)
    _build.reset_launches()
    tlz_cuda.reset_general_route_rows()
    cpu0 = time.process_time()
    t0 = time.perf_counter()
    out = ctx.sort_by_key(parts, PARTS, serializer=ColumnarKVSerializer(),
                          materialize="batches", cleanup=False)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    cpu = time.process_time() - cpu0
    launches = dict(_build.LAUNCHES)
    general = tlz_cuda.general_route_rows(dev)
    counts = dict(manager.codec.frame_counts)
    stages = dict(manager.codec.timings)
    kind = manager.handle(0).kind
    stored = sum(os.path.getsize(f) for f in files_under(root) if f.endswith(".data"))
    if after is not None:
        after(manager)
    ctx.stop()
    assert not files_under(root), "stop() with cleanup left objects behind"
    teravalidate(out, n_records, input_rows)
    read = {key: sum(getattr(r.metrics, key) for r in readers)
            for key in ("remote_blocks_fetched", "remote_bytes_read", "records_read",
                        "wait_ns", "prefetch_ns")}
    read["threads"] = max((r.prefetch_stats or {}).get("threads", 0) for r in readers)
    read["gets"] = dict(counting.gets)
    print(f"{label}: TeraSort {raw / MiB:.0f} MiB, {n_records} records, {MAPS} maps x "
          f"{PARTS} reducers, {workers} workers, {kind} handle; TeraValidate and rows: ok")
    print(f"{label}: wall {wall:.2f} s, {n_records / wall:.0f} records/s, "
          f"{raw / MiB / wall:.1f} raw MiB/s, process CPU {cpu:.2f} s; stored "
          f"{stored / MiB:.1f} MiB (ratio {raw / stored:.3f})")
    thread_s = sum(stages.values())
    parts_s = ", ".join(f"{k} {v:.2f}" for k, v in sorted(stages.items()))
    print(f"{label}: codec stages (s, summed over worker threads): {parts_s}; "
          f"sum {thread_s:.2f}; rest of the {workers} threads' wall "
          f"{workers * wall - thread_s:.2f}")
    print(f"{label}: reduce reads: {read['remote_blocks_fetched']} blocks, "
          f"{read['remote_bytes_read']} bytes, {read['records_read']} records; wait "
          f"{read['wait_ns'] / 1e9:.3f} s, prefetch {read['prefetch_ns'] / 1e9:.3f} s (summed "
          f"over reduce tasks); GETs {json.dumps(read['gets'])}; prefetch threads (most in "
          f"a reduce task) {read['threads']}")
    print(f"{label}: frames {json.dumps(counts)}; launches {json.dumps(launches)}; "
          f"K3 general-route rows: {general}")
    assert kind == ("serialized" if bypass == 0 else "bypass-merge"), kind
    for name in UNCODED_KERNELS:
        assert launches[name] > 0, f"{label}: kernel {name} was not launched"
    assert general == 0, f"{label}: validated rows took K3's general route"
    assert counts["written_fused"] > 0 and counts["read_fused"] > 0, counts
    assert read["records_read"] == n_records, read
    return launches, wall, dict(read, wall_s=wall, cpu_s=cpu, stages=stages)


def read_plane_split(seed: int, total_mib: int, dev, root: str) -> list:
    """Phase 7: phase 5a's TeraSort at ``total_mib`` in the six runs of
    :data:`SPLIT_RUNS`: 1, 2 and 4 workers; 4 workers with one torch
    intra-op thread; 4 workers on the per-block path
    (``coalesce_gap_bytes=0``); and 4 workers on the serial per-block read
    (one prefetch thread, no chunked fetch), the parent's read pattern.
    Each run is TeraValidated and must launch K1-K3. Returns each run's
    numbers."""
    import torch

    parts = terasort_parts(seed, total_mib * MiB)
    input_rows = sort_rows(rows_of(parts))
    default_threads = torch.get_num_threads()
    runs = []
    for i, (workers, threads, knobs) in enumerate(SPLIT_RUNS, 1):
        label = (f"7.{i} workers={workers} torch_threads={threads or default_threads} "
                 f"read={json.dumps(knobs, sort_keys=True)}")
        if threads is not None:
            torch.set_num_threads(threads)
        try:
            launches, wall, read = record_path(
                label, parts, input_rows, dev, os.path.join(root, f"run{i}"), bypass=200,
                workers=workers, **knobs)
        finally:
            torch.set_num_threads(default_threads)
        runs.append(dict(read, run=i, workers=workers, torch_threads=threads or default_threads,
                         knobs=knobs, launches={k: launches[k] for k in UNCODED_KERNELS},
                         records_per_s=read["records_read"] / wall))
    return runs


def executor_kernel_check(batch: bytes, dev) -> dict:
    """Phase 8a: K2 and K1 launched on the codec's encode thread at the
    encode batch's shape (64 blocks), K3 on a decode-pool thread at the
    decode run's shape (DECODE_ROWS blocks), each held byte for byte against
    its plain version on the same inputs. Returns each kernel's max abs
    error and the launches by thread."""
    import numpy as np
    import torch

    from s3shuffle_tpu_torch.codec import framing
    from s3shuffle_tpu_torch.device import on_device
    from s3shuffle_tpu_torch.ops import checksum, crc_cuda, tlz, tlz_cuda

    poly = checksum.POLY_CRC32C
    n_groups = BLOCK // tlz.GROUP

    def rows_of_batch(n):
        return torch.from_numpy(
            np.frombuffer(batch[: n * BLOCK], dtype=np.uint8).reshape(n, BLOCK).copy()
        ).to(dev)

    def encode_side():
        with on_device(dev):
            blocks = rows_of_batch(BATCH)
            cand = tlz.candidate_math(blocks, n_groups)
            got = tlz_cuda.plane_decisions(blocks, cand, n_groups)
            want = tlz.plane_decisions_plain(blocks, cand, n_groups)
            assert all(torch.equal(g, w) for g, w in zip(got, want)), \
                "K2 on the encode thread differs from the plain version"
            outs = tlz.compact_pack(blocks, *got, n_groups)
            lits = outs[5].reshape(BATCH, BLOCK)
            lit_len = ((n_groups - outs[8] - outs[7]) * tlz.GROUP).to(torch.int32)
            k1 = crc_cuda.crc_raw_pair(blocks, lits, poly, more_lengths=lit_len)
            lengths = torch.cat([torch.full((BATCH,), BLOCK, dtype=torch.int32, device=dev),
                                 lit_len])
            k1_plain = checksum.crc_raw_plain(torch.cat([blocks, lits]), poly, lengths)
            assert torch.equal(k1, k1_plain), "K1 on the encode thread differs from plain"
            return int((k1 - k1_plain).abs().max())

    def decode_side():
        with on_device(dev):
            want_rows = rows_of_batch(DECODE_ROWS)
            payloads, _ = tlz.encode_batch_device(batch[: DECODE_ROWS * BLOCK], DECODE_ROWS,
                                                  BLOCK, DECODE_ROWS, device=dev)
            staged = stage_planes(payloads, n_groups, dev)
            dec, raw = tlz_cuda.decode_fused(*staged, n_groups, poly)
            dec_p, raw_p = tlz.decode_fused_plain(*staged, n_groups, poly)
            assert torch.equal(dec, dec_p) and torch.equal(raw, raw_p), \
                "K3 on a decode-pool thread differs from the plain version"
            assert torch.equal(dec, want_rows), "K3 on a decode-pool thread did not decode"
            return int((raw - raw_p).abs().max())

    with LaunchThreads() as threads:
        k1_err = framing._get_encode_executor().submit(encode_side).result()
        k3_err = framing._get_decode_executor().submit(decode_side).result()
    for name, kind in (("tlz_planes", "encode"), ("crc_fold", "encode"),
                       ("tlz_decode_fused", "decode")):
        assert threads.counts[f"{name}@{kind}"] > 0, f"{name} was not launched on the {kind} thread"
    return {"max_abs_err": {"tlz_planes": 0, "crc_fold": k1_err, "tlz_decode_fused": k3_err},
            "launches_by_thread": dict(threads.counts)}


def java_hash(name: str) -> int:
    """Spark's JavaUtils.nonNegativeHash of Java's String.hashCode, computed
    here in int32 arithmetic, apart from the port's copy."""
    import numpy as np

    h = np.int32(0)
    with np.errstate(over="ignore"):
        for ch in name:
            h = np.int32(h * np.int32(31) + np.int32(ord(ch)))
    return 0 if h == np.iinfo(np.int32).min else abs(int(h))


def window_identity(data, dev, root: str) -> dict:
    """Phase 8a: phase 3's data plane written with the encode window at 2
    and at 1 (byte-equal object trees), each read with the decode window at
    2 and at 1 (bytes equal to the input), K1-K3 counted by the thread that
    launched them, then held against their plain versions on the executor
    threads."""
    import torch

    from s3shuffle_tpu_torch import ShuffleConfig
    from s3shuffle_tpu_torch.codec import codec_from_config
    from s3shuffle_tpu_torch.metadata.helper import ShuffleHelper
    from s3shuffle_tpu_torch.read.reader import ShuffleReader
    from s3shuffle_tpu_torch.storage.dispatcher import Dispatcher
    from s3shuffle_tpu_torch.write.map_output_writer import MapOutputWriter

    total = sum(len(p) for parts in data for p in parts)
    out = {"mib": total // MiB, "writes": {}, "reads": {}}
    trees = {}
    for enc in (2, 1):
        sub = os.path.join(root, f"encode{enc}")
        cfg = ShuffleConfig(root_dir=f"file://{sub}", checksum_algorithm="CRC32C",
                            codec_block_size=BLOCK, codec_batch_blocks=BATCH,
                            encode_inflight_batches=enc)
        disp = Dispatcher(cfg)
        helper = ShuffleHelper(disp)
        codec = codec_from_config(cfg, dev)
        with LaunchThreads() as threads:
            t0 = time.perf_counter()
            for m in range(MAPS):
                writer = MapOutputWriter(disp, helper, 0, m, PARTS, codec=codec)
                for p in range(PARTS):
                    pw = writer.get_encoding_partition_writer(p)
                    pw.write(data[m][p])
                    pw.close()
                writer.commit_all_partitions()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        trees[enc] = {}
        for path in files_under(sub):
            with open(path, "rb") as f:
                trees[enc][os.path.relpath(path, sub)] = f.read()
        counts = dict(codec.frame_counts)
        out["writes"][f"encode{enc}"] = {
            "wall_s": wall, "frames": counts["written"], "fused": counts["written_fused"],
            "launches_by_thread": dict(threads.counts)}
        for dec in (2, 1):
            rcfg = ShuffleConfig(root_dir=f"file://{sub}", checksum_algorithm="CRC32C",
                                 codec_block_size=BLOCK, codec_batch_blocks=BATCH,
                                 decode_inflight_batches=dec)
            rdisp = Dispatcher(rcfg)
            rcodec = codec_from_config(rcfg, dev)
            reader = ShuffleReader(rdisp, ShuffleHelper(rdisp), codec=rcodec)
            with LaunchThreads() as threads:
                t0 = time.perf_counter()
                for r in range(PARTS):
                    got = reader.read_partition(0, r, range(MAPS))
                    assert got == b"".join(data[m][r] for m in range(MAPS)), \
                        f"8a: encode {enc} / decode {dec}: partition {r} read back wrong bytes"
                wall = time.perf_counter() - t0
            counts = dict(rcodec.frame_counts)
            out["reads"][f"encode{enc}-decode{dec}"] = {
                "wall_s": wall, "frames": counts["read"], "fused": counts["read_fused"],
                "launches_by_thread": dict(threads.counts)}
    assert trees[2] == trees[1], "8a: the objects differ between encode windows 2 and 1"
    assert any(name.endswith(".data") for name in trees[2])
    on_write = out["writes"]["encode2"]["launches_by_thread"]
    on_read = out["reads"]["encode2-decode2"]["launches_by_thread"]
    off_read = out["reads"]["encode1-decode1"]["launches_by_thread"]
    for name in ("crc_fold", "tlz_planes"):
        assert on_write.get(f"{name}@encode", 0) > 0 and not on_write.get(f"{name}@task"), on_write
    assert on_read.get("tlz_decode_fused@decode", 0) > 0 and \
        not on_read.get("tlz_decode_fused@task"), on_read
    assert off_read.get("tlz_decode_fused@task", 0) > 0 and \
        not off_read.get("tlz_decode_fused@decode"), off_read
    for side in list(out["writes"].values()) + list(out["reads"].values()):
        assert side["fused"] > 0, side
    out["objects_equal"] = True
    first = b"".join(p for parts in data for p in parts)[: BATCH * BLOCK]
    out["executor_kernels"] = executor_kernel_check(first.ljust(BATCH * BLOCK, b"\0"), dev)
    print(f"8a windows' identity: {out['mib']} MiB; objects byte-equal at encode windows 2 and 1; "
          f"reads at decode windows 2 and 1 exact; {json.dumps(out['writes'])}; "
          f"{json.dumps(out['reads'])}; kernels on executor threads equal to plain: "
          f"{json.dumps(out['executor_kernels'])}")
    return out


def listing_read(manager, dev, n_records: int, input_rows) -> dict:
    """Phase 8c: the written shuffle read again through a second manager in
    listing mode (``use_block_manager=False``: its tracker knows no map),
    TeraValidated, with GETs and LIST calls counted by object kind."""
    import dataclasses

    from s3shuffle_tpu_torch import ShuffleManager

    cfg = dataclasses.replace(manager.config, use_block_manager=False, cleanup=False)
    lm = ShuffleManager(cfg, device=dev)
    counting = CountingBackend(lm.dispatcher.backend)
    lm.dispatcher.backend = counting
    handle = lm.register_shuffle(0, manager.handle(0).dependency)
    t0 = time.perf_counter()
    out = [lm.get_reader(handle, p, p + 1).read_result_batches() for p in range(PARTS)]
    wall = time.perf_counter() - t0
    teravalidate(out, n_records, input_rows)
    result = {"wall_s": wall, "gets": dict(counting.gets)}
    print(f"8c listing mode: {n_records} records read back in {wall:.2f} s, TeraValidate and "
          f"rows: ok; GETs and LISTs {json.dumps(result['gets'])}")
    assert counting.gets["list"] > 0 and counting.gets["data"] > 0, counting.gets
    return result


def windows_on_off(seed: int, total_mib: int, dev, root: str) -> dict:
    """Phase 8b (and 8c): 5a's TeraSort at ``total_mib`` with the codec
    windows at the defaults (2/32/2) and at 1/32/1, each TeraValidated, with
    K1-K3 counted by the thread that launched them and the most decode-pool
    threads in use; the windows-on shuffle is then read in listing mode."""
    parts = terasort_parts(seed, total_mib * MiB)
    input_rows = sort_rows(rows_of(parts))
    n_records = sum(p.n for p in parts)
    runs = {}
    listing = {}
    for label, knobs in WINDOW_RUNS:
        threads, pool, seen = LaunchThreads(), DecodePoolUse(), {}

        def after(manager, _label=label, _threads=threads, _pool=pool, _seen=seen):
            # the shuffle's own numbers first, then the listing read (8c)
            _seen.update(launches_by_thread=dict(_threads.counts), decode_pool_most=_pool.most,
                         decode_pool_threads=len(_pool.threads))
            if _label == "on":
                listing.update(listing_read(manager, dev, n_records, input_rows))

        with threads, pool:
            launches, wall, read = record_path(
                f"8b windows {label} {json.dumps(knobs, sort_keys=True)}", parts, input_rows,
                dev, os.path.join(root, label), bypass=200, after=after, **knobs)
        runs[label] = dict(read, knobs=knobs, launches={k: launches[k] for k in UNCODED_KERNELS},
                           records_per_s=read["records_read"] / wall, **seen)
        print(f"8b windows {label}: decode-pool threads: most at once {seen['decode_pool_most']}, "
              f"distinct {seen['decode_pool_threads']}; launches by thread "
              f"{json.dumps(seen['launches_by_thread'])}")
    on, off = runs["on"]["launches_by_thread"], runs["off"]["launches_by_thread"]
    for name in ("crc_fold", "tlz_planes"):
        assert on.get(f"{name}@encode", 0) > 0, on
        assert off.get(f"{name}@task", 0) > 0 and not off.get(f"{name}@encode"), off
    assert on.get("tlz_decode_fused@decode", 0) > 0 and runs["on"]["decode_pool_most"] > 0, on
    assert off.get("tlz_decode_fused@task", 0) > 0 and runs["off"]["decode_pool_most"] == 0, off
    return {"runs": runs, "listing": listing}


def fallback_layout(data, dev, root: str) -> dict:
    """Phase 8d: phase 3's data plane under ``use_fallback_fetch=True``, the
    maps enumerated by listing; every object's path must be
    ``{root}{appId}/{shuffleId}/{hash(name)}/{name}`` with Java's hash."""
    launches, t_write, t_read = main_path(data, dev, root, listing=True,
                                          use_fallback_fetch=True, use_block_manager=False)
    paths = files_under(root)
    for path in paths:
        name = os.path.basename(path)
        want = os.path.join(root, "app", "0", str(java_hash(name)), name)
        assert path == want, f"8d: {path} is not at the fallback layout's {want}"
    kinds = sorted({os.path.basename(p).split(".", 1)[1] for p in paths})
    print(f"8d fallback layout: {len(paths)} objects ({', '.join(kinds)}) at "
          f"{{root}}app/0/{{hash(name)}}/{{name}}; maps enumerated by listing")
    assert len(paths) == 3 * MAPS, paths
    return {"objects": len(paths), "write_s": t_write, "read_s": t_read,
            "launches": {k: launches[k] for k in UNCODED_KERNELS}}


def pickled_path(seed: int, dev, root: str) -> dict:
    """Phase 5c: group_by_key and fold_by_key (a sum) on pickled records,
    each against a dict computed in plain Python."""
    import collections
    import operator

    import numpy as np
    import torch

    from s3shuffle_tpu_torch import ShuffleConfig, ShuffleContext
    from s3shuffle_tpu_torch.ops import _build, tlz_cuda

    rng = np.random.default_rng(seed + 1)
    parts = []
    for _ in range(MAPS):
        keys = rng.integers(0, 65536, PICKLED_PER_MAP).tolist()
        vals = rng.integers(0, 256, (PICKLED_PER_MAP, 16), dtype=np.uint8).tobytes()
        parts.append([(k, vals[16 * i : 16 * i + 16]) for i, k in enumerate(keys)])
    n = MAPS * PICKLED_PER_MAP
    cfg = ShuffleConfig(root_dir=f"file://{root}", checksum_algorithm="CRC32C",
                        codec_block_size=BLOCK, codec_batch_blocks=BATCH)
    ctx = ShuffleContext(cfg, num_workers=WORKERS, device=dev)
    launches = {}
    _build.reset_launches()
    tlz_cuda.reset_general_route_rows()
    t0 = time.perf_counter()
    groups = ctx.group_by_key(parts, PARTS)
    torch.cuda.synchronize()
    t_group = time.perf_counter() - t0
    launches["group_by_key"] = dict(_build.LAUNCHES)
    general = tlz_cuda.general_route_rows(dev)
    want = collections.defaultdict(list)
    for part in parts:
        for k, v in part:
            want[k].append(v)
    assert len(groups) == len(want), "group_by_key: wrong key count"
    for k, vs in groups:
        assert sorted(vs) == sorted(want[k]), f"group_by_key: key {k} differs"
    folds_in = [[(k, v[0]) for k, v in part] for part in parts]
    _build.reset_launches()
    t0 = time.perf_counter()
    sums = ctx.fold_by_key(folds_in, 0, operator.add, PARTS)
    torch.cuda.synchronize()
    t_fold = time.perf_counter() - t0
    launches["fold_by_key"] = dict(_build.LAUNCHES)
    want_sums = collections.Counter()
    for part in folds_in:
        for k, v in part:
            want_sums[k] += v
    assert dict(sums) == dict(want_sums), "fold_by_key differs from the plain sums"
    ctx.stop()
    assert not files_under(root), "stop() with cleanup left objects behind"
    print(f"pickled records: {MAPS} maps x {PICKLED_PER_MAP} (int key in [0, 65536), "
          f"16-byte value), {PARTS} reducers; group_by_key {t_group:.2f} s "
          f"({n / t_group:.0f} records/s), fold_by_key (map-side combine) {t_fold:.2f} s; "
          "both equal to plain Python")
    print(f"pickled records: launches {json.dumps(launches)}; "
          f"K3 general-route rows (group_by_key): {general}")
    for name in UNCODED_KERNELS:
        assert launches["group_by_key"][name] > 0, f"group_by_key did not launch {name}"
    assert general == 0
    return launches


# --- phase 6a: the typed SQL queries of examples/sql_queries.py -------------


def gen_tables(sf: float, seed: int = SQL_SEED):
    """``examples/sql_queries.py``'s ``gen_tables`` (uniform ids; its Zipf
    skew option is left out): a seeded star-schema slice as int64 column
    arrays, ``200_000 * sf`` sales rows and ~8 % of them returned. Prices are
    integer cents, so every sum is exact in any order."""
    import numpy as np

    rng = np.random.default_rng(seed)
    n_sales = int(200_000 * sf)
    n_items = max(50, int(2_000 * sf))
    n_stores = max(4, int(40 * sf))
    order = np.arange(n_sales, dtype=np.int64)
    sales = {
        "item": rng.integers(0, n_items, n_sales, dtype=np.int64),
        "store": rng.integers(0, n_stores, n_sales, dtype=np.int64),
        "order": order,
        "year": 2001 + (order & 1),
        "month": 1 + rng.integers(0, 12, n_sales, dtype=np.int64),
        "qty": 1 + rng.integers(0, 10, n_sales, dtype=np.int64),
        "price": rng.integers(100, 10_000, n_sales, dtype=np.int64),
    }
    mask = rng.random(n_sales) < 0.08
    rq = 1 + np.floor(rng.random(int(mask.sum())) * sales["qty"][mask]).astype(np.int64)
    returns = {
        "item": sales["item"][mask],
        "order": sales["order"][mask],
        "rq": rq,
        "ramt": rq * sales["price"][mask] * 9 // 10,
    }
    return sales, returns


class TypedStages:
    """``examples/sql_queries.py``'s ``ColumnarStages`` on the port: each
    shuffle stage of a query through ``agg_shuffle`` / ``sort_shuffle_batches``
    on ``ctx``, its wall time summed into ``stage_seconds``. Its narrow-pack
    retry is left out: a value out of the declared narrow range raises."""

    def __init__(self, ctx):
        self.ctx = ctx
        self.stage_seconds = 0.0
        self.stages = 0

    def agg_typed(self, codec, key_cols, val_cols, ops, map_side_combine=True,
                  val_dtypes=None):
        from s3shuffle_tpu_torch.structured import agg_shuffle, make_batch, split_batch

        batch = make_batch(codec, key_cols, val_cols, val_dtypes=val_dtypes)
        t0 = time.perf_counter()
        out = agg_shuffle(self.ctx, codec, split_batch(batch, SQL_MAPS), ops,
                          num_partitions=SQL_REDUCERS, map_side_combine=map_side_combine,
                          val_dtypes=val_dtypes)
        self.stage_seconds += time.perf_counter() - t0
        self.stages += 1
        return out

    def sort(self, codec, batch, val_ncols):
        from s3shuffle_tpu_torch.structured import sort_shuffle_batches, split_batch

        t0 = time.perf_counter()
        out = list(sort_shuffle_batches(self.ctx, codec, split_batch(batch, SQL_MAPS),
                                        val_ncols, num_partitions=SQL_REDUCERS))
        self.stage_seconds += time.perf_counter() - t0
        self.stages += 1
        return out


def q5_inputs(sales, returns):
    """q5's unioned fact stream: (store, sales amount, returned amount)."""
    import numpy as np

    s_amt = sales["qty"] * sales["price"]
    r_store = sales["store"][returns["order"]]  # returns join their sale's store
    zeros_r = np.zeros(len(r_store), dtype=np.int64)
    zeros_s = np.zeros(len(s_amt), dtype=np.int64)
    return (np.concatenate([sales["store"], r_store]),
            np.concatenate([s_amt, zeros_r]),
            np.concatenate([zeros_s, returns["ramt"]]))


def q5(st, sales, returns):
    """``examples/sql_queries.py``'s q5, channel profit rollup: sales minus
    returns per store, one aggregate stage (map-side combine) over the
    unioned fact stream. Rows ``(store, sales, returns, profit)`` by store."""
    import numpy as np

    from s3shuffle_tpu_torch.structured import KeyCodec

    store, amt, ret = q5_inputs(sales, returns)
    (key,), vals = st.agg_typed(KeyCodec("i32"), (store,), (amt, ret), ("sum", "sum"),
                                val_dtypes=("i4", "i4"))
    order = np.argsort(key, kind="stable")
    return [(int(s), int(a), int(r), int(a - r))
            for s, a, r in zip(key[order], vals[order, 0], vals[order, 1])]


def q67(st, sales, returns):
    """``examples/sql_queries.py``'s q67, top items per category: the rollup
    of sales by (item, store, month) without map-side combine (category =
    item % 10 derived after it), rank pushdown with ``window_group_limit``,
    then a range-partitioned sort by (category, -amount, item, store,
    month) and a streaming rank scan keeping ``SQL_TOP_K`` per category."""
    import numpy as np

    from s3shuffle_tpu_torch.structured import KeyCodec, make_batch, window_group_limit

    (item1, store1, month1), v1 = st.agg_typed(
        KeyCodec("i32", "i32", "i32"), (sales["item"], sales["store"], sales["month"]),
        (sales["qty"] * sales["price"],), ("sum",), map_side_combine=False,
        val_dtypes=("i4",),
    )
    cat1 = item1 % 10
    keep = window_group_limit(cat1, v1[:, 0], SQL_TOP_K)
    cat1, item1, store1, month1, v1 = cat1[keep], item1[keep], store1[keep], month1[keep], v1[keep]
    codec5 = KeyCodec("i64", "i64", "i64", "i64", "i64")
    batches = st.sort(codec5, make_batch(codec5, (cat1, -v1[:, 0], item1, store1, month1), ()), 0)
    result = []
    last_cat = None
    carry = 0
    for (bc, bneg, bitem, bstore, bmonth), _v in batches:
        n = len(bc)
        newrun = np.empty(n, dtype=bool)
        newrun[0] = last_cat is None or bc[0] != last_cat
        np.not_equal(bc[1:], bc[:-1], out=newrun[1:])
        run_start = np.zeros(n, dtype=np.int64)
        idx = np.flatnonzero(newrun)
        run_start[idx] = idx
        np.maximum.accumulate(run_start, out=run_start)
        pos = np.arange(n, dtype=np.int64) - run_start
        if not newrun[0]:
            # rows before the first boundary continue the previous batch's cat
            pos[: int(idx[0]) if len(idx) else n] += carry
        for i in np.flatnonzero(pos < SQL_TOP_K).tolist():
            result.append((f"cat-{int(bc[i])}", int(bitem[i]), int(bstore[i]),
                           int(bmonth[i]), int(-bneg[i]), int(pos[i]) + 1))
        last_cat = int(bc[-1])
        carry = int(pos[-1]) + 1
    return result


def _run_starts(*cols):
    """Start of every run of equal rows over sorted columns."""
    import numpy as np

    new = np.zeros(len(cols[0]), dtype=bool)
    new[:1] = True
    for c in cols:
        new[1:] |= c[1:] != c[:-1]
    return np.flatnonzero(new)


def q5_numpy(sales, returns):
    """q5 recomputed in plain numpy (np.lexsort + np.add.reduceat), not
    through the shuffle."""
    import numpy as np

    store, amt, ret = q5_inputs(sales, returns)
    order = np.lexsort((store,))
    store, amt, ret = store[order], amt[order], ret[order]
    starts = _run_starts(store)
    a, r = np.add.reduceat(amt, starts), np.add.reduceat(ret, starts)
    return [(int(s), int(x), int(y), int(x - y)) for s, x, y in zip(store[starts], a, r)]


def q67_numpy(sales, returns):
    """q67 recomputed in plain numpy: the (item, store, month) sums by
    np.lexsort + np.add.reduceat, then every group ranked within its
    category by (-amount, item, store, month), not through the shuffle."""
    import numpy as np

    item, store, month = sales["item"], sales["store"], sales["month"]
    order = np.lexsort((month, store, item))
    item, store, month = item[order], store[order], month[order]
    starts = _run_starts(item, store, month)
    amt = np.add.reduceat((sales["qty"] * sales["price"])[order], starts)
    item, store, month = item[starts], store[starts], month[starts]
    cat = item % 10
    order = np.lexsort((month, store, item, -amt, cat))
    cat, item, store, month, amt = (c[order] for c in (cat, item, store, month, amt))
    first = np.zeros(len(cat), dtype=bool)
    first[:1] = True
    first[1:] = cat[1:] != cat[:-1]
    pos = np.arange(len(cat)) - np.maximum.accumulate(np.where(first, np.arange(len(cat)), 0))
    return [(f"cat-{int(cat[k])}", int(item[k]), int(store[k]), int(month[k]), int(amt[k]),
             int(pos[k]) + 1) for k in np.flatnonzero(pos < SQL_TOP_K)]


def typed_queries(sf: float, dev, root: str) -> dict:
    """Phase 6a: q5 and q67 as ``examples/sql_queries.py`` runs them, through
    ``ShuffleContext(cfg, num_workers=4)`` with ``codec="tpu"``, each held
    against its plain numpy recomputation. Returns the launches summed over
    both queries."""
    import threading

    import numpy as np
    import torch

    from s3shuffle_tpu_torch import ShuffleConfig, ShuffleContext, ShuffleManager
    from s3shuffle_tpu_torch.ops import _build, tlz_cuda

    class StoredBytesManager(ShuffleManager):
        """The manager ShuffleContext(cfg, device=...) builds, also summing
        the stored bytes of every committed map output."""

        stored = 0
        _stored_lock = threading.Lock()

        def _commit_map_output(self, shuffle_id, map_id, lengths, map_index, message):
            with self._stored_lock:
                self.stored += int(np.sum(lengths))
            super()._commit_map_output(shuffle_id, map_id, lengths, map_index, message)

    t0 = time.perf_counter()
    sales, returns = gen_tables(sf)
    rows_in = len(sales["order"]) + len(returns["order"])
    print(f"6a tables: SF {sf:g} (seed {SQL_SEED}), {len(sales['order'])} sales + "
          f"{len(returns['order'])} returns = {rows_in} rows in, generated in "
          f"{time.perf_counter() - t0:.1f} s")
    cfg = ShuffleConfig(root_dir=f"file://{root}", app_id="sql", codec="tpu",
                        checksum_algorithm="CRC32C", codec_block_size=BLOCK,
                        codec_batch_blocks=BATCH)
    manager = StoredBytesManager(cfg, device=dev)
    ctx = ShuffleContext(manager=manager, num_workers=WORKERS)
    total = dict.fromkeys(_build.LAUNCHES, 0)
    for name, query, plain in (("q5", q5, q5_numpy), ("q67", q67, q67_numpy)):
        st = TypedStages(ctx)
        manager.stored = 0
        manager.codec.timings = {}
        _build.reset_launches()
        tlz_cuda.reset_general_route_rows()
        t0 = time.perf_counter()
        result = query(st, sales, returns)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = dict(_build.LAUNCHES)
        general = tlz_cuda.general_route_rows(dev)
        stages = dict(manager.codec.timings)
        t0 = time.perf_counter()
        want = plain(sales, returns)
        t_plain = time.perf_counter() - t0
        assert result == want, f"{name}: {len(result)} rows differ from the numpy recomputation"
        print(f"6a {name}: {len(result)} rows out, equal to the numpy recomputation "
              f"({t_plain:.1f} s); {st.stages} shuffle stages, {SQL_MAPS} maps x "
              f"{SQL_REDUCERS} reducers, {WORKERS} workers")
        print(f"6a {name}: wall {wall:.2f} s, shuffle stages {st.stage_seconds:.2f} s, "
              f"{rows_in / wall:.0f} rows in/s, stored {manager.stored} bytes")
        parts_s = ", ".join(f"{k} {v:.2f}" for k, v in sorted(stages.items()))
        print(f"6a {name}: codec stages (s, summed over worker threads): {parts_s or 'none'}; "
              f"launches {json.dumps(launches)}; K3 general-route rows: {general}")
        if name == "q5":
            # what the map-side combine leaves: each map's distinct stores
            store = q5_inputs(sales, returns)[0]
            bounds = [len(store) * i // SQL_MAPS for i in range(SQL_MAPS + 1)]
            combined = sum(len(np.unique(store[bounds[i]:bounds[i + 1]]))
                           for i in range(SQL_MAPS))
            print(f"6a q5: rows after the map-side combine (each map's distinct "
                  f"stores): {combined}")
        else:
            for kernel in UNCODED_KERNELS:
                assert launches[kernel] > 0, f"6a q67: kernel {kernel} was not launched"
        assert general == 0, f"6a {name}: validated rows took K3's general route"
        for kernel, n in launches.items():
            total[kernel] += n
    ctx.stop()
    assert not files_under(root), "6a: stop() with cleanup left objects behind"
    return total


# --- phase 6b: the host codecs on the phase-3 data plane --------------------


def host_codec_paths(seed: int, dev, root: str) -> None:
    """Phase 6b: the phase-3 data plane at ``HOST_CODEC_MIB`` through each
    host codec, read back validated and byte-exact with no kernel launched,
    on the port's own native library built from this checkout's source."""
    from s3shuffle_tpu_torch import ShuffleConfig
    from s3shuffle_tpu_torch.codec import CODEC_IDS, codec_from_config, get_codec, native
    from s3shuffle_tpu_torch.metadata.helper import ShuffleHelper
    from s3shuffle_tpu_torch.ops import _build
    from s3shuffle_tpu_torch.read.reader import ShuffleReader
    from s3shuffle_tpu_torch.storage.dispatcher import Dispatcher
    from s3shuffle_tpu_torch.write.map_output_writer import MapOutputWriter

    here = os.path.dirname(os.path.abspath(__file__))
    # a library left in build/native by an earlier run goes, so this run
    # shows the port's source building on this machine
    if native.LIBRARY.exists():
        native.LIBRARY.unlink()
    auto = get_codec("auto")
    assert native.build_seconds > 0, "the native library was not built in this run"
    assert type(auto) is native.NativeLZCodec, f"codec='auto' chose {type(auto).__name__}"
    assert str(native.SOURCE) == os.path.join(here, "s3shuffle_tpu_torch", "native",
                                              "s3shuffle_native.cpp")
    assert str(native.LIBRARY).startswith(os.path.join(here, "build", "native") + os.sep)
    with open("/proc/self/maps") as f:
        mapped = f.read()
    assert str(native.LIBRARY) in mapped, "the port's native library is not loaded"
    assert os.path.join("s3shuffle_tpu", "native") not in mapped, \
        "the JAX package's native library is loaded"
    print(f"6b native library: {native.LIBRARY} built from {native.SOURCE} in "
          f"{native.build_seconds:.1f} s; codec='auto' chose {type(auto).__name__}")
    part_bytes = HOST_CODEC_MIB * MiB // (MAPS * PARTS)
    data = make_partitions(seed, part_bytes)
    total = HOST_CODEC_MIB * MiB
    for name in HOST_CODECS:
        cfg = ShuffleConfig(root_dir=f"file://{root}/{name}", codec=name,
                            checksum_algorithm="CRC32C")
        disp = Dispatcher(cfg)
        helper = ShuffleHelper(disp)
        codec = codec_from_config(cfg, dev)
        _build.reset_launches()
        t0 = time.perf_counter()
        stored = 0
        for m in range(MAPS):
            writer = MapOutputWriter(disp, helper, 0, m, PARTS, codec=codec, device=dev)
            for p in range(PARTS):
                pw = writer.get_encoding_partition_writer(p)
                pw.write(data[m][p])
                pw.close()
            stored += int(writer.commit_all_partitions().partition_lengths.sum())
        t_write = time.perf_counter() - t0
        reader = ShuffleReader(disp, helper, codec=codec, device=dev)
        t0 = time.perf_counter()
        for r in range(PARTS):
            got = reader.read_partition(0, r, range(MAPS))
            assert got == b"".join(data[m][r] for m in range(MAPS)), \
                f"6b {name}: reduce partition {r} read back wrong bytes"
        t_read = time.perf_counter() - t0
        launches = dict(_build.LAUNCHES)
        counts = dict(codec.frame_counts)
        print(f"6b {name} ({type(codec).__name__}, frame id {codec.codec_id}): "
              f"{HOST_CODEC_MIB} MiB, stored {stored} bytes (ratio {total / stored:.3f}); "
              f"write {total / MiB / t_write:.1f} MB/s, read+validate "
              f"{total / MiB / t_read:.1f} MB/s; frames {json.dumps(counts)}; "
              f"launches {json.dumps(launches)}")
        assert codec.codec_id == CODEC_IDS[{"native": "native-lz"}.get(name, name)]
        assert counts["written"] == counts["read"] > 0 and counts["read_fused"] == 0
        assert not any(launches.values()), f"6b {name} launched a kernel"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--total-mib", type=int, default=1024)
    ap.add_argument("--reps", type=int, default=20)
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from s3shuffle_tpu_torch.device import resolve_device
    from s3shuffle_tpu_torch.ops import _build

    dev = resolve_device("cuda")
    card = card_line()
    print(card)
    name = torch.cuda.get_device_name(0)
    bw = bandwidth_for(name)
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, device {name}, "
          f"bandwidth used for bounds {bw / 1e12:.2f} TB/s")
    t0 = time.perf_counter()
    _build.library()
    print(f"kernel build: {time.perf_counter() - t0:.1f} s "
          f"(nvcc {_build.build_seconds:.1f} s)")
    for line in _build.build_log.splitlines():
        if "registers" in line or "spill" in line or line.startswith("=="):
            print("  " + line.strip())

    part_bytes = args.total_mib * MiB // (MAPS * PARTS)
    if part_bytes % BLOCK:
        raise SystemExit("--total-mib must give whole 256 KiB blocks per partition")
    if args.total_mib != 1024:
        print(f"main path cut to {args.total_mib} MiB (from 1024 MiB)")
    t0 = time.perf_counter()
    data = make_partitions(args.seed, part_bytes)
    print(f"generated {args.total_mib} MiB of TeraSort bytes in {time.perf_counter() - t0:.1f} s")

    k4_len = K4_GROUPS * PARITY_K * PARITY_CHUNK
    kernels = kernel_phase(data[0][0][: BATCH * BLOCK].ljust(BATCH * BLOCK, b"\0"),
                           b"".join(data[0])[:k4_len].ljust(k4_len, b"\0"),
                           args.reps, bw, dev)

    tmp = tempfile.mkdtemp(prefix="chip_smoke_")
    by_path = {}  # launches per path, each zeroed just before it
    try:
        by_path["3"], _w, _r = main_path(data, dev, os.path.join(tmp, "uncoded"))
        by_path["4"] = coded_path(data, dev, os.path.join(tmp, "coded"))
        del data
        t0 = time.perf_counter()
        parts = terasort_parts(args.seed, args.total_mib * MiB)
        input_rows = sort_rows(rows_of(parts))
        print(f"generated the TeraSort input ({sum(p.n for p in parts)} records) and "
              f"its row order in {time.perf_counter() - t0:.1f} s")
        by_path["5a"], _wall, _read = record_path("5a bypass-merge", parts, input_rows, dev,
                                                  os.path.join(tmp, "terasort"), bypass=200)
        by_path["5b"], _wall, _read = record_path("5b serialized", parts, input_rows, dev,
                                                  os.path.join(tmp, "terasort-serialized"),
                                                  bypass=0)
        del parts, input_rows
        pickled = pickled_path(args.seed, dev, os.path.join(tmp, "pickled"))
        by_path["5c group"], by_path["5c fold"] = pickled["group_by_key"], pickled["fold_by_key"]
        by_path["6a"] = typed_queries(SQL_SF, dev, os.path.join(tmp, "sql"))
        host_codec_paths(args.seed, dev, os.path.join(tmp, "host-codecs"))
        split = read_plane_split(args.seed, min(SPLIT_MIB, args.total_mib), dev,
                                 os.path.join(tmp, "split"))
        window_mib = min(WINDOW_MIB, args.total_mib)
        window_data = make_partitions(args.seed, window_mib * MiB // (MAPS * PARTS))
        windows = {"8a": window_identity(window_data, dev, os.path.join(tmp, "identity"))}
        windows.update(windows_on_off(args.seed, min(WINDOW_SORT_MIB, args.total_mib), dev,
                                      os.path.join(tmp, "windows")))
        windows["8d"] = fallback_layout(window_data, dev, os.path.join(tmp, "fallback"))
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    for k in kernels:
        kernel = k["name"].split("[")[0]  # a kernel timed on a second batch
        # this slice's main path is 6a (the typed queries); K4 runs on the
        # coded path; every path's count is listed beside
        k["launches"] = (by_path["6a"] if kernel in UNCODED_KERNELS else by_path["4"])[kernel]
        k["launches_by_path"] = {path: counts[kernel] for path, counts in by_path.items()}
    print(json.dumps({"codec_windows": windows}))
    print(json.dumps({"read_plane_split": split}))
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({
        "ok": True,
        "device": {"platform": "gpu", "kind": name, "count": torch.cuda.device_count()},
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
