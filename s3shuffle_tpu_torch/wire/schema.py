"""Declarative wire-schema registry of the port (the JAX package's
``wire/schema.py``): every on-wire struct the port reads or writes, the
JAX package's byte for byte.

Each implementing module claims the structs it owns in a module-level
``_WIRE_STRUCTS`` tuple. shuffle-lint's rule WIRE01 cross-checks a module
against this table: magic, version and word-count constants must match
exactly, every historical ``read_versions`` entry needs a version guard in
the reader, and ``current_format`` may not exceed
``version.SHUFFLE_FORMAT_VERSION``, so a wire change on one side alone (the
code, or this table without a format bump) is a lint failure.
``tests/test_torch_wire.py`` runs WIRE01 over the port's modules, decodes
the golden blobs under ``tests/fixtures/wire/`` through the port's readers
and holds this table against the JAX one.

``WIRE_STRUCTS`` is read with ``ast.literal_eval``: keep it a pure literal
(no comprehensions, calls, f-strings or names).

Fields of an entry:

- ``module``: repo-relative path of the implementing module (the one whose
  ``_WIRE_STRUCTS`` tuple claims the struct);
- ``constants``: module-level constant name -> required value; a
  ``re.compile`` assignment is checked against its pattern string;
- ``read_versions`` / ``current_version``: every struct version the reader
  still decodes, and the one the writer emits (empty / None for a struct
  without a version word);
- ``since_format`` / ``current_format``: the ``SHUFFLE_FORMAT_VERSION`` at
  which the struct first shipped and at which its current version shipped;
- ``layout``: row descriptions (big-endian int64 words unless noted) for
  the rendered wire-format appendix.
"""

from __future__ import annotations

#: struct name -> declaration. PURE LITERAL — see module docstring.
WIRE_STRUCTS = {
    "per_map_index": {
        "title": "Per-map index sidecar (`.index`)",
        "kind": "store object",
        "module": "s3shuffle_tpu_torch/metadata/helper.py",
        "constants": {},
        "read_versions": [],
        "current_version": None,
        "since_format": 1,
        "current_format": 6,
        "doc": "Cumulative partition offsets of one map output — its "
               "existence is the COMMIT POINT of the map (index written "
               "last). Byte-compatible with reference-written index files "
               "when uncoded and skew-free.",
        "layout": [
            "`num_partitions + 1` words: cumulative offsets `[0, l0, l0+l1, ...]`",
            "optional 4-word skew trailer (format >= 6, a skew prong "
            "engaged; see `index_skew_trailer`)",
            "optional 4-word stripe-geometry trailer (format >= 4, parity "
            "on — always the blob's FINAL words; see "
            "`index_geometry_trailer`)",
        ],
    },
    "index_skew_trailer": {
        "title": "Skew index trailer (`S3SHSKEW`)",
        "kind": "store object (embedded)",
        "module": "s3shuffle_tpu_torch/skew.py",
        "constants": {
            "SKEW_MAGIC": 0x53335348534B4557,
            "SKEW_TRAILER_WORDS": 4,
            "FLAG_COMBINED": 1,
        },
        "read_versions": [],
        "current_version": None,
        "since_format": 6,
        "current_format": 6,
        "doc": "Appended to a per-map `.index` blob when a skew-mitigation "
               "prong engaged at commit: flags bit 0 marks partitions that "
               "carry map-side-combined partial rows, and split_bytes "
               "records the stripe granularity the scan planner fans hot "
               "partitions out at. Sits BEFORE the geometry trailer (which "
               "stays the blob's final words); recognized by magic and "
               "split back off before any offset consumer sees the words. "
               "Absent at combine/split=0 so the skew-free index stays "
               "byte-identical to the pre-skew wire.",
        "layout": [
            "word 0: magic `S3SHSKEW` (0x53335348534B4557)",
            "word 1: flags (bit 0 = combined partial rows)",
            "word 2: split_bytes (hot-partition stripe granularity; 0 = "
            "no partition crossed the split threshold)",
            "word 3: reserved (0)",
        ],
    },
    "index_geometry_trailer": {
        "title": "Stripe-geometry index trailer (`S3PARGMT`)",
        "kind": "store object (embedded)",
        "module": "s3shuffle_tpu_torch/coding/parity.py",
        "constants": {
            "GEOMETRY_MAGIC": 0x5333504152474D54,
            "TRAILER_WORDS": 4,
        },
        "read_versions": [],
        "current_version": None,
        "since_format": 4,
        "current_format": 4,
        "doc": "Appended to a per-map `.index` blob when the coded plane "
               "wrote parity sidecars; recognized by magic at word -4 and "
               "split back off before any offset consumer sees the words. "
               "Absent at parity=0 so the uncoded index stays "
               "reference-byte-identical.",
        "layout": [
            "word 0: magic `S3PARGMT` (0x5333504152474D54)",
            "word 1: parity segments m",
            "word 2: stripe k (data chunks per group)",
            "word 3: chunk bytes (payload_len is the index's own final "
            "cumulative offset)",
        ],
    },
    "checksum_sidecar": {
        "title": "Per-map checksum sidecar (`.checksum.<ALGO>`)",
        "kind": "store object",
        "module": "s3shuffle_tpu_torch/metadata/helper.py",
        "constants": {},
        "read_versions": [],
        "current_version": None,
        "since_format": 1,
        "current_format": 1,
        "doc": "One uint32-in-int64 checksum per reduce partition, over the "
               "stored (post-codec) bytes. PUT before the index — committed "
               "by it.",
        "layout": ["`num_partitions` words: per-partition checksum values"],
    },
    "fat_index": {
        "title": "Composite fat index (`.cindex`)",
        "kind": "store object",
        "module": "s3shuffle_tpu_torch/metadata/fat_index.py",
        "constants": {
            "_MAGIC": 0x5333464154494458,
            "_VERSION": 3,
            "_HEADER_V1": 7,
            "_HEADER_V2": 11,
            "_HEADER_V3": 12,
            "_MEMBER_WORDS_V3": 4,
        },
        "read_versions": [1, 2, 3],
        "current_version": 3,
        "since_format": 3,
        "current_format": 6,
        "doc": "One index object for every member of a composite group — "
               "the group's COMMIT POINT (data object first, fat index "
               "last). v2 (format 4) appended four stripe-geometry header "
               "words; v3 (format 6, the skew plane) appends a split_bytes "
               "header word and widens member rows to 4 words with a flags "
               "column — emitted ONLY when a skew prong engaged, so "
               "zero-skew groups keep writing v2 byte-identically. v1/v2 "
               "blobs still parse (geometry/skew default to none).",
        "layout": [
            "header v1 (7 words): magic `S3FATIDX`, version, shuffle_id, "
            "group_id, num_partitions, n_members, has_checksums",
            "header v2 (+4 words): parity_segments, parity_stripe_k, "
            "parity_chunk_bytes, payload_len (all zero when uncoded)",
            "header v3 (+1 word): split_bytes (hot-partition stripe "
            "granularity)",
            "`n_members` rows of `[map_id, map_index, base_offset]` "
            "(v3: `+[flags]`, bit 0 = combined partial rows)",
            "`n_members` rows of `num_partitions + 1` member-relative "
            "cumulative offsets",
            "when has_checksums: `n_members` rows of `num_partitions` "
            "checksum words",
        ],
    },
    "snapshot": {
        "title": "Map-output snapshot (`.snapmeta`)",
        "kind": "store object",
        "module": "s3shuffle_tpu_torch/metadata/snapshot.py",
        "constants": {
            "_MAGIC": 0x5333485348534E41,
            "_VERSION": 3,
            "_ROW_META_V1": 2,
            "_ROW_META_V2": 4,
            "_ROW_META_V3": 5,
        },
        "read_versions": [1, 2, 3],
        "current_version": 3,
        "since_format": 2,
        "current_format": 4,
        "doc": "Immutable epoch-stamped copy of one shuffle's deduped "
               "map-output table, published by the driver at map-stage "
               "close. v2 (format 3) added composite coordinates per row; "
               "v3 (format 4) added parity_segments. v1/v2 blobs still "
               "parse (rows default to the classic uncoded layout).",
        "layout": [
            "header (7 words): magic `S3SHSNAP`, version, shuffle_id, "
            "epoch, num_partitions, published_unix_micros, n_entries",
            "`n_entries` rows: v1 `[map_id, map_index]`, v2 "
            "`+[composite_group, base_offset]`, v3 `+[parity_segments]`, "
            "then `num_partitions` size words",
        ],
    },
    "parity_header": {
        "title": "Parity sidecar header (`.parity`)",
        "kind": "store object",
        "module": "s3shuffle_tpu_torch/coding/parity.py",
        "constants": {
            "PARITY_MAGIC": 0x5333504152495459,
            "_WIRE_VERSION": 1,
            "HEADER_WORDS": 8,
        },
        "read_versions": [1],
        "current_version": 1,
        "since_format": 4,
        "current_format": 4,
        "doc": "Self-describing header of one k-of-n parity sidecar object; "
               "the parity payload (one chunk-sized slice per stripe group "
               "at `HEADER + group * chunk_bytes`) follows. PUT before the "
               "index — committed by it, an orphan without it.",
        "layout": [
            "8 words: magic `S3PARITY`, wire version, shuffle_id, "
            "seg_index, m, k, chunk_bytes, payload_len",
            "parity payload bytes (not int64-aligned)",
        ],
    },
    "column_frame": {
        "title": "Columnar record frame (`S3COLFRM`)",
        "kind": "data-object framing",
        "module": "s3shuffle_tpu_torch/colframe.py",
        "constants": {
            "COLFRAME_MAGIC": 0x5333434F4C46524D,
            "_WIRE_VERSION": 1,
            "HEADER_WORDS": 5,
            "COLUMN_WORDS": 3,
        },
        "read_versions": [1],
        "current_version": 1,
        "since_format": 5,
        "current_format": 5,
        "doc": "Self-describing typed framing of columnar record batches "
               "inside shuffle data objects (written when `columnar=1`, the "
               "default). The per-column dtype/width/byte-count table lets "
               "the reduce side deserialize a whole frame into columns in "
               "one zero-copy pass; fixed-width columns ship no per-row "
               "lengths. Readers auto-detect per frame (magic in the first "
               "payload word), so legacy frames interleave freely; "
               "`columnar=0` emits only the legacy framing, byte-identical "
               "to format-4 data objects.",
        "layout": [
            "outer envelope: `[u32le payload_len]` (self-delimiting -> "
            "concatenatable/relocatable, same as legacy frames)",
            "header (5 words): magic `S3COLFRM`, wire version, schema word "
            "(app tag; 0 = untyped bytes-KV), n rows, n columns (2: keys, "
            "values)",
            "per column (3 words): dtype (1 = fixed-width, 2 = varlen), "
            "fixed row width (0 when varlen), column payload bytes",
            "column payloads back-to-back: fixed -> `n*width` raw bytes; "
            "varlen -> `n` i32-LE row lengths then the concatenated bytes",
        ],
    },
    "rpc_register": {
        "title": "Registration RPC payloads",
        "kind": "rpc (length-prefixed JSON)",
        "module": "s3shuffle_tpu_torch/metadata/service.py",
        "constants": {
            "REGISTER_FIELDS": 8,
            "REGISTER_MIN_FIELDS": 5,
            "BATCH_ENTRY_FIELDS": 7,
            "BATCH_ENTRY_MIN_FIELDS": 4,
        },
        "read_versions": [],
        "current_version": None,
        "since_format": 1,
        "current_format": 4,
        "doc": "`register_map_output` args `[shuffle_id, map_id, location, "
               "sizes, map_index, composite_group, base_offset, "
               "parity_segments]` (8; the server rejects fewer than 5 — "
               "pre-format-2 clients); batched `register_map_outputs` / "
               "`q_complete_task` entries drop the leading shuffle_id "
               "(7 fields, minimum 4 + map_index enforcement). Fields "
               "past the minimum default to the classic uncoded "
               "one-object-per-map layout.",
        "layout": [
            "register_map_output args: shuffle_id, map_id, location, "
            "sizes[], map_index (format 2+), composite_group (format 3+), "
            "base_offset (format 3+), parity_segments (format 4+)",
            "batch entry / q_complete_task map_output row: same minus the "
            "leading shuffle_id (q_complete_task keeps it: 8 fields, "
            "min 5)",
        ],
    },
    "object_names": {
        "title": "Store object-name grammar",
        "kind": "object names",
        "module": "s3shuffle_tpu_torch/block_ids.py",
        "constants": {
            "_INDEX_RE": "^shuffle_(\\d+)_(\\d+)_(\\d+)\\.index$",
            "_ANY_RE": "^shuffle_(\\d+)_(\\d+)_(?:(\\d+)\\.(?:data|index|"
                       "checksum\\..+)|par\\d+\\.parity)$",
            "_COMPOSITE_RE": "^shuffle_(\\d+)_comp_(\\d+)(?:\\.(data|cindex)"
                             "|_par\\d+\\.(parity))$",
            "_TOMBSTONE_RE": "^shuffle_(\\d+)_gen_(\\d+)\\.tomb$",
        },
        "read_versions": [],
        "current_version": None,
        "since_format": 1,
        "current_format": 4,
        "doc": "Object names ARE wire surface: listing-mode enumeration, "
               "the orphan/TTL sweeps, and the protocol witness all parse "
               "them back. The `comp` infix / `.snapmeta` / `.tomb` "
               "suffixes keep new object kinds invisible to the per-map "
               "parsers by construction.",
        "layout": [
            "data: `shuffle_<sid>_<mid>_0.data`; index: "
            "`shuffle_<sid>_<mid>_0.index`; checksum: "
            "`shuffle_<sid>_<mid>_0.checksum.<ALGO>`",
            "parity: `shuffle_<sid>_<mid>_par<i>.parity`",
            "composite: `shuffle_<sid>_comp_<gid>.data` / `.cindex` / "
            "`_par<i>.parity`",
            "snapshot: `shuffle_<sid>_snapshot_<epoch>.snapmeta`; "
            "tombstone: `shuffle_<sid>_gen_<gen>.tomb`",
        ],
    },
}


def max_current_format() -> int:
    """The registry's own view of the newest wire shape — must equal or
    trail ``version.SHUFFLE_FORMAT_VERSION`` (WIRE01 enforces per struct)."""
    return max(s["current_format"] for s in WIRE_STRUCTS.values())


def render_wire_doc() -> str:
    """Markdown "Wire formats" appendix, generated from the registry: the
    JAX package's appendix with this package's paths (the wire is one)."""
    from s3shuffle_tpu_torch.version import SHUFFLE_FORMAT_VERSION

    lines = [
        "All multi-word blobs are big-endian int64 words (the DataOutputStream",
        "idiom) unless noted. Current `SHUFFLE_FORMAT_VERSION`: "
        f"**{SHUFFLE_FORMAT_VERSION}**. Generated from",
        "`s3shuffle_tpu_torch/wire/schema.py` — do not edit by hand.",
        "",
    ]
    for name, spec in WIRE_STRUCTS.items():
        lines.append(f"### {spec['title']} (`{name}`)")
        lines.append("")
        meta = [f"declared in `{spec['module']}`", spec["kind"]]
        if spec["current_version"] is not None:
            meta.append(
                f"writes v{spec['current_version']}, reads "
                + "/".join(f"v{v}" for v in spec["read_versions"])
            )
        meta.append(
            f"format {spec['since_format']}"
            + (
                f"→{spec['current_format']}"
                if spec["current_format"] != spec["since_format"]
                else ""
            )
        )
        lines.append("*" + "; ".join(meta) + "*")
        lines.append("")
        lines.append(spec["doc"])
        lines.append("")
        for row in spec["layout"]:
            lines.append(f"- {row}")
        lines.append("")
    return "\n".join(lines).rstrip() + "\n"
