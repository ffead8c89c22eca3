#!/usr/bin/env python3
"""Split the device time of kernels K1 (CRC fold) and K2 (TLZ plane
decisions) of the PyTorch/CUDA port on one GPU.

    python3 kernel_split.py [--tree DIR] [--reps 50] [--out FILE]

``--tree`` names a checkout of the repository (default: the one holding
this script). The script recognises which design of the two kernels that
checkout holds by text anchors in its sources, writes variants of them with
parts of the work cut away, builds each variant with ``nvcc`` for
``sm_90a`` into ``build/kernel_split/`` and times it through the checkout's
own wrappers with CUDA events (median of ``--reps`` warm launches behind a
sleep kernel) at the main path's shapes: K2 on 64 TeraSort blocks of
256 KiB (the first batch ``chip_smoke.py`` times), K1 on those blocks plus
their literal planes with the main path's lengths. The difference between
two variants is the time of the part that one of them cuts. Where the
checkout's main path concatenates the blocks and literal planes for K1, the
script also times that staging. Last it times kernel K3 (the fused decode,
whose literal-plane CRC shares K1's code in the segmented design) whole, on
the same batch's payloads, from the checkout's own build.

Every variant is checked to build; only the full kernels' outputs are
compared with the plain versions (a cut variant computes something else).
Prints one line per variant and, last, one JSON object with every time.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import statistics
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

BLOCK = 256 * 1024
BATCH = 64

# A patch is (file, mode, anchor, text): mode "before" inserts text before
# the anchor, "replace" replaces it, "span" replaces from anchor[0] through
# anchor[1]. An anchor must occur once.

# --- the first design (K1: one CTA of 512 threads per row; K2: one CTA per
# 256-group tile, one group a thread) ---

_V1_K2_WRITE = """  {{
    const int t = threadIdx.x;
    const long long g = g0 + t;
    if (g < n_groups) {{
      const long long o = row * n_groups + g;
      m_out[o] = {m};
      d_out[o] = {d};
      c_out[o] = 0;
      s_out[o] = 0;
      k_out[o] = 0;
    }}
    return;
  }}
"""

V1 = {
    "anchor": ("tlz_planes.cu", "#define TILE_G 256"),
    "k2": {
        # the planes' reads and writes with no compare
        "io": [("tlz_planes.cu", "before", "  // pass 0: candidate verification", """  {
    const int t = threadIdx.x;
    const long long g = g0 + t;
    if (g < n_groups) {
      const long long o = row * n_groups + g;
      const int c = cr[g];
      const unsigned long long w = load8(rb, g * TLZ_GROUP);
      m_out[o] = (uint8_t)(w ^ (unsigned long long)c);
      d_out[o] = c;
      c_out[o] = 0;
      s_out[o] = 0;
      k_out[o] = (int)(w >> 32);
    }
    return;
  }
""")],
        "pass0": [("tlz_planes.cu", "before",
                   "  // pass 1: retry at the previous group's pass-0 distance",
                   _V1_K2_WRITE.format(m="s_m0[t + 3]", d="s_d0[t + 3]"))],
        "passes": [("tlz_planes.cu", "before",
                    "  // continuation flag + split tier; thread t <-> group g0 + t",
                    _V1_K2_WRITE.format(m="s_m2[t + 1]", d="s_d2[t + 1]"))],
        # the split tier (16 byte gathers) cut: continuation flag and stores stay
        "no_split_tier": [("tlz_planes.cu", "span",
                           ("  int prefix_run = 0;\n", "  const int ks = TLZ_GROUP - suffix_len;\n"),
                           "  const int prefix_run = 8 + (int)(grp & 0);\n  const int ks = 0;\n")],
        "full": [],
    },
    "k1": {
        "tables": [
            ("crc_common.cuh", "replace",
             "  s_red[t] = hi > lo ? crc_span(msg, lo, hi, s_tab8) : 0u;\n",
             "  s_red[t] = hi > lo ? (uint32_t)(lo ^ hi) : 0u;\n"),
            ("crc_common.cuh", "span", ("  for (int l = 0; l < CRC_LEVELS; ++l) {\n",
                                        "    __syncthreads();\n  }\n"), """  {
    uint32_t x = s_red[t];
    __syncthreads();
    if (t == 0) s_red[0] = 0u;
    __syncthreads();
    for (int off = 16; off > 0; off >>= 1) x ^= __shfl_xor_sync(0xffffffffu, x, off);
    if ((t & 31) == 0) atomicXor(&s_red[0], x);
    __syncthreads();
  }
"""),
        ],
        "tree": [("crc_common.cuh", "replace",
                  "  s_red[t] = hi > lo ? crc_span(msg, lo, hi, s_tab8) : 0u;\n",
                  "  s_red[t] = hi > lo ? (uint32_t)(lo ^ hi) : 0u;\n")],
        "walk": [],  # filled below: "tables" without its first patch
        "full": [],
    },
}
V1["k1"]["walk"] = V1["k1"]["tables"][1:]

# --- the segmented design (K1: 16 KiB segments, staged, nibble-table tree;
# K2: 124-group warp tiles, 4 groups a lane, word compares) ---

_V2_K2_WRITE = """  if (!tile_lane) return;
  {{
    const long long o = row * n_groups + gfirst;
    uint32_t mb = 0;
    for (int k = 0; k < GPT; ++k) mb |= (uint32_t)({m}) << (8 * k);
    *reinterpret_cast<uint32_t*>(m_out + o) = mb;
    *reinterpret_cast<uint32_t*>(c_out + o) = 0;
    *reinterpret_cast<uint32_t*>(s_out + o) = 0;
    *reinterpret_cast<int4*>(d_out + o) = make_int4({d0}, {d1}, {d2}, {d3});
    *reinterpret_cast<int4*>(k_out + o) = make_int4(0, 0, 0, 0);
    return;
  }}
"""

V2 = {
    "anchor": ("tlz_planes.cu", "#define WARP_TILE (GPT * 31)"),
    "k2": {
        "io": [("tlz_planes.cu", "before", "  // pass 0\n", _V2_K2_WRITE.format(
            m="(grp[k].bytes ^ (unsigned)c[k]) & 1", d0="c[0]", d1="c[1]", d2="c[2]", d3="c[3]"))],
        "pass0": [("tlz_planes.cu", "before", "  // passes 1 and 2, each reading", _V2_K2_WRITE.format(
            m="v[k] != NO_MATCH", d0="v[0]", d1="v[1]", d2="v[2]", d3="v[3]"))],
        "passes": [("tlz_planes.cu", "before",
                    "  // continuation flag + split tier on the tile's groups",
                    _V2_K2_WRITE.format(m="v[k] != NO_MATCH", d0="v[0]", d1="v[1]",
                                        d2="v[2]", d3="v[3]"))],
        # the whole function with the registers capped for 5 and 6 CTAs an SM
        "regs5": [("tlz_planes.cu", "replace", "__launch_bounds__(32 * PLANES_WARPS)",
                   "__launch_bounds__(32 * PLANES_WARPS, 5)")],
        "regs6": [("tlz_planes.cu", "replace", "__launch_bounds__(32 * PLANES_WARPS)",
                   "__launch_bounds__(32 * PLANES_WARPS, 6)")],
        "full": [],
    },
    "k1": {
        # launch, tables, join and the tree on zeros: no staging, no walk
        "tree_only": [
            ("crc_common.cuh", "replace", "  if ((hi & 7) == 0) {\n", "  if (false) {\n"),
            ("crc_common.cuh", "replace", "  } else if (t < CRC_NT) {", "  } else if (false) {"),
        ],
        # launch, the length read and the active test only
        "exit": [("crc_fold.cu", "replace", "  crc_load_tables(tab8, nib, sm);\n  __syncthreads();\n",
                  "  if (threadIdx.x == 0) out[row] = expected;\n  return;\n")],
        # ... and the table loads
        "tables": [("crc_fold.cu", "replace", "  crc_load_tables(tab8, nib, sm);\n  __syncthreads();\n",
                    "  crc_load_tables(tab8, nib, sm);\n  __syncthreads();\n"
                    "  if (threadIdx.x == 0) out[row] = s_tab8[row & 255] ^ s_nib[row & 127];\n"
                    "  return;\n")],
        # everything but the join (fence, arrival, fold): each CTA writes its remainder
        "no_join": [("crc_fold.cu", "span", ("  uint32_t crc;\n", "    out[row] = (long long)crc;\n"),
                     "  if (threadIdx.x == 0) out[row] = part;\n")],
        # staging and the walkers' shared-memory reads, no table lookups
        "stage": [("crc_common.cuh", "replace",
                   "      for (int i = 0; i < CRC_WORDS; ++i) r = crc_step8(r, mine[i], sm.tab8);\n",
                   "      for (int i = 0; i < CRC_WORDS; ++i) r ^= (uint32_t)mine[i] ^ "
                   "(uint32_t)(mine[i] >> 32);\n")],
        # everything but the tree: an XOR in its place
        "walk": [("crc_common.cuh", "span",
                  ("  // tree: levels 0-4 across the lanes of each walking warp\n",
                   "    if (lane == 0) sm.red[CRC_NT / 32] = r;\n  }\n"), """  if (t == 0) sm.red[CRC_NT / 32] = 0u;
  __syncthreads();
  for (int off = 16; off > 0; off >>= 1) r ^= __shfl_xor_sync(0xffffffffu, r, off);
  if (lane == 0 && r) atomicXor(&sm.red[CRC_NT / 32], r);
""")],
        "full": [],
    },
}


def _apply(text: str, mode: str, anchor, repl: str, name: str) -> str:
    if mode == "span":
        i = text.find(anchor[0])
        j = text.find(anchor[1], i)
        if i < 0 or j < 0:
            raise SystemExit(f"{name}: span anchors not found")
        return text[:i] + repl + text[j + len(anchor[1]):]
    if text.count(anchor) != 1:
        raise SystemExit(f"{name}: anchor not found once: {anchor.splitlines()[0]!r}")
    return text.replace(anchor, repl + anchor if mode == "before" else repl)


def write_variants(csrc: Path, out: Path, kernel: str, source: str, variants: dict) -> dict:
    """One directory per variant with the patched sources; returns
    variant -> path of its patched ``source``."""
    files = {p.name: p.read_text() for p in list(csrc.glob("*.cu")) + list(csrc.glob("*.cuh"))}
    made = {}
    for name, patches in variants.items():
        d = out / f"{kernel}_{name}"
        d.mkdir(parents=True, exist_ok=True)
        texts = dict(files)
        for fname, mode, anchor, repl in patches:
            texts[fname] = _apply(texts[fname], mode, anchor, repl, f"{kernel}/{name}")
        for fname, text in texts.items():
            (d / fname).write_text(text)
        made[name] = d / source
    return made


def build(sources: dict) -> dict:
    """nvcc every variant in parallel into its own shared library; returns
    name -> (library path, -Xptxas -v register and spill lines)."""
    nvcc = os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc")

    def one(item):
        name, src = item
        lib = src.with_suffix(".so")
        cmd = [nvcc, "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
               "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v", "-o", str(lib), str(src)]
        res = subprocess.run(cmd, capture_output=True, text=True)
        if res.returncode:
            raise SystemExit(f"nvcc failed for {src}:\n{res.stdout}{res.stderr}")
        regs = [ln.strip() for ln in (res.stdout + res.stderr).splitlines()
                if "registers" in ln or "spill" in ln]
        return name, (lib, regs)

    with ThreadPoolExecutor(len(sources)) as pool:
        return dict(pool.map(one, sources.items()))


def time_launch(fn, reps: int) -> float:
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


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--tree", default=os.path.dirname(os.path.abspath(__file__)))
    ap.add_argument("--reps", type=int, default=50)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)

    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("kernel_split: no CUDA device available", file=sys.stderr)
        return 2
    tree = Path(args.tree).resolve()
    sys.path.insert(0, str(tree))
    from s3shuffle_tpu_torch.ops import _build, checksum, crc_cuda, tlz, tlz_cuda

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True).stdout.strip().splitlines()[0]
    print(card)
    csrc = tree / "s3shuffle_tpu_torch" / "csrc"
    design = next((d for d in (V1, V2)
                   if d["anchor"][1] in (csrc / d["anchor"][0]).read_text()), None)
    if design is None:
        raise SystemExit(f"{csrc}: not kernel sources this script knows how to cut")
    out = Path(__file__).resolve().parent / "build" / "kernel_split" / tree.name
    srcs = {f"k2/{k}": v for k, v in
            write_variants(csrc, out, "tlz_planes", "tlz_planes.cu", design["k2"]).items()}
    srcs.update({f"k1/{k}": v for k, v in
                 write_variants(csrc, out, "crc_fold", "crc_fold.cu", design["k1"]).items()})
    t0 = time.perf_counter()
    libs = build(srcs)
    print(f"built {len(libs)} variants in {time.perf_counter() - t0:.1f} s")

    # the first batch chip_smoke.py times: map 0, partition 0 of seed 0
    rng = np.random.default_rng(0)
    pool = rng.integers(0, 256, (64, 90), dtype=np.uint8)
    n = BATCH * BLOCK // 100 + 1
    keys = rng.integers(0, 256, (n, 10), dtype=np.uint8)
    raw = np.concatenate([keys, pool[rng.integers(0, 64, n)]], axis=1).reshape(-1)[: BATCH * BLOCK]
    dev = torch.device("cuda")
    blocks = torch.from_numpy(raw.reshape(BATCH, BLOCK).copy()).to(dev)
    n_groups = BLOCK // tlz.GROUP
    cand = tlz.candidate_math(blocks, n_groups)
    planes = tlz.plane_decisions_plain(blocks, cand, n_groups)
    outs = tlz.compact_pack(blocks, *planes, n_groups)
    lits = outs[5].reshape(BATCH, BLOCK)
    lit_len = ((n_groups - outs[8] - outs[7]) * tlz.GROUP).to(torch.int32)
    full = torch.full((BATCH,), BLOCK, dtype=torch.int32, device=dev)
    rows = torch.cat([blocks, lits], dim=0)
    lengths = torch.cat([full, lit_len])
    poly = checksum.POLY_CRC32C
    k1_plain = checksum.crc_raw_plain(rows, poly, lengths)
    if hasattr(crc_cuda, "crc_raw_pair"):  # two row sets, no concatenation
        def k1():
            return crc_cuda.crc_raw_pair(blocks, lits, poly, more_lengths=lit_len)
    else:
        def k1():
            return crc_cuda.crc_raw(rows, poly, lengths)

    def k2():
        return tlz_cuda.plane_decisions(blocks, cand, n_groups)

    results = {"card": card, "tree": str(tree), "ms": {}, "ptxas": {}}
    for key, (lib_path, regs) in libs.items():
        lib = ctypes.CDLL(str(lib_path))
        for name, argtypes in _build._SIGNATURES.items():
            if hasattr(lib, name):
                getattr(lib, name).argtypes = argtypes
                getattr(lib, name).restype = ctypes.c_int
        _build._lib = lib  # the wrappers launch this variant
        fn = k2 if key.startswith("k2/") else k1
        ms = time_launch(fn, args.reps)
        if key == "k2/full":
            assert all(torch.equal(a, b) for a, b in zip(fn(), planes)), "K2 full != plain"
        if key == "k1/full":
            assert torch.equal(fn(), k1_plain), "K1 full != plain"
        torch.cuda.synchronize()
        results["ms"][key] = ms
        results["ptxas"][key] = regs
        print(f"{key}: {ms:.4f} ms/launch; {' | '.join(regs)}")
    _build._lib = None

    from chip_smoke import stage_planes

    payloads, _ = tlz.encode_batch_device(raw.tobytes(), BATCH, BLOCK, BATCH, device=dev)
    staged = stage_planes(payloads, n_groups, dev)
    assert torch.equal(tlz_cuda.decode_fused(*staged, n_groups, poly)[0], blocks)
    results["ms"]["k3/full"] = time_launch(
        lambda: tlz_cuda.decode_fused(*staged, n_groups, poly), args.reps)
    print(f"k3/full: {results['ms']['k3/full']:.4f} ms/launch")
    if not hasattr(crc_cuda, "crc_raw_pair"):
        def staging():
            torch.cat([blocks, lits], dim=0)
            torch.cat([torch.full((BATCH,), BLOCK, dtype=torch.int32, device=dev), lit_len])

        results["ms"]["k1/cat+lengths staging"] = time_launch(staging, args.reps)
        print(f"k1/cat+lengths staging: {results['ms']['k1/cat+lengths staging']:.4f} ms")
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(results, indent=1))
    print(json.dumps(results))
    return 0


if __name__ == "__main__":
    sys.exit(main())
