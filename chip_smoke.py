#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (``s3shuffle_tpu_torch``) on one GPU.

    python3 chip_smoke.py [--seed 0] [--total-mib 1024] [--reps 20]

Phases (any failure exits non-zero; no phase catches its own failure):

1. Card and build: the card's name and power limit as ``nvidia-smi`` gives
   them, the torch/CUDA versions, the build of every kernel from
   ``s3shuffle_tpu_torch/csrc`` (nvcc, sm_90a) with its compiler summary,
   and the build of the port's native library (g++).
2. Kernel vs plain: kernels K1 (CRC fold), K2 (TLZ plane decisions), K3
   (fused TLZ decode + CRC) and K4 (GF(2^8) parity encode) at the main
   paths' shapes (K1 on 64 raw blocks of 256 KiB and their 64 literal
   planes, two row sets in one launch as the write path runs it, K2 on 64
   rows x 32768 groups of TeraSort bytes, K3 on a decode run's 32 rows x
   32768 groups of them (also timed at 64 rows, the runs before the codec
   windows), on 32 all-zero blocks, whose distance-1 chains cross every
   segment, and at 4 and 128 rows of TeraSort bytes (the ends of the
   autotuner's ``decode_batch_frames`` ladder; 128 rows take a second
   batch), K4 on 16 stripe
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
      bypass_merge_threshold=0)``: ``SerializedSortMapWriter``), same checks,
      at 256 MiB (``SERIALIZED_MIB``; 1 GiB until phase 12 came).
   c. Pickled records: 8 maps x 250,000 records (500,000 until phase 18
      came; int key in [0, 65536),
      16-byte value); ``group_by_key`` and ``fold_by_key`` (a sum, map-side
      combine) each against a dict computed in plain Python;
      ``group_by_key`` must launch K1-K3.

6. Typed record paths and host codecs:
   a. q5 and q67 of the port's ``s3shuffle_tpu_torch/examples/
      sql_queries.py`` at SF 100 (21,600,792 rows in, tables from its
      ``gen_tables`` with seed 17), its ``ColumnarStages`` and queries run
      as the driver runs them: 4 maps,
      6 reducers, TOP_K 10, ``ShuffleContext(cfg, num_workers=4)`` with
      ``codec="tpu"`` and CRC32C; q5 one aggregate stage with the columnar
      map-side combine, q67 an aggregate without it, the rank pushdown
      (``window_group_limit``) and a range-partitioned sort. Each result
      equals a plain numpy recomputation over the same tables (sorts +
      np.add.reduceat, not through the shuffle). Launch counts are zeroed
      just before each query and read just after: q67 must launch K1-K3;
      q5's combine leaves every partition under one block, so it may
      launch none (its combined row count is printed). Prints per query
      the wall, the shuffle-stage wall, rows in/s, stored bytes, the
      launches and the codec's stage timings; ``stop()`` must leave no
      object.
   b. The phase-3 data plane at 64 MiB with ``codec="native"``, ``"lz4"``
      and ``"zlib"``: each read back validated and byte-exact with no
      kernel launched. The port's native library (built in phase 1 from
      ``s3shuffle_tpu_torch/native/``) must have been built in this run,
      ``codec="auto"`` must choose it, and the JAX package's library must
      not be loaded.

7. The read-plane split: phase 5a's TeraSort at 128 MiB (256 MiB until
   phase 18 came; ``--total-mib``
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
   b. Windows on and off: 5a's TeraSort at 128 MiB (256 MiB until phase 18 came), 4 workers, at the
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

9. Store weather: the resilient storage plane (every run exact; any
   failure exits non-zero):
   a. 5a's TeraSort again (1 GiB, 4 workers), the raw ``LocalBackend``
      under the port's ``FlakyBackend`` with the fault soak's seeded rules
      (reads 5 % connection resets, opens 5 % HTTP 503, status calls 5 %
      timeouts, one transient create) under its ``RetryingBackend`` at the
      soak's knobs (8 re-drives, 1 ms backoff base, 20 s per op).
      TeraValidated; every data, index and checksum object's SHA-256 equal
      to 5a's fault-free objects (5a records them before its ``stop()``);
      each rule's hits (reads at least one, the create exactly one);
      K1-K3 launched; no object left after ``stop()``. Prints the wall
      beside 5a's, and the GETs and status calls the store saw.
   b. Commit re-drives: 8a's data plane (64 MiB) written coded (k2m2, 1 MiB
      chunks) fault-free, then with one transient fault on the first
      ``.parity`` create and one on the first ``.index`` create, injected
      above the retry layer: the writer re-drives each sidecar, each rule
      hits once, the objects are byte-equal, K1, K2 and K4 launch. At
      ``storage_retries=0`` the index fault fails map 0's commit, and its
      abort leaves no data, parity or index object.
   c. fsspec: 5a's TeraSort at 128 MiB (256 MiB until phase 18 came) on a ``local://`` root (the port's
      ``FsspecBackend`` over fsspec's ``LocalFileSystem``, ranged
      ``cat_file`` GETs), TeraValidated, one status call per data object
      opened (the FileStatus cache).

      After the fail-fast case the orphan sweep (no registered winner)
      must remove the checksum sidecar the failed commit left, and nothing
      else.

10. Composite commits (the composite commit plane; every run exact):
   a. A tiny-map swarm: 5a's TeraSort at 128 MiB (256 MiB until phase 18 came) (``--total-mib`` when
      smaller) cut into 64 maps x 8 partitions (about 2 MiB raw per map),
      4 workers, once with ``composite_commit_maps=0`` and once with 16
      (the other composite knobs at their defaults), each TeraValidated
      and launching K1-K3. The store's creates are counted by object kind:
      192 per-map creates (data, index, checksum) off, only composite data
      and ``.cindex`` creates on. Prints the groups sealed and their member
      counts, the reduce scan's GETs by kind, and both walls.
   b. A coded composite under loss: phase 8a's data plane (64 MiB, 8 maps x
      8 partitions) written on one thread through ``MapOutputWriter`` with
      the manager's aggregator at ``composite_commit_maps=4`` (age seals
      off, so the groups are maps 0-3 and 4-7), k2m2 parity of 1 MiB
      chunks; the second group's composite data object is deleted and
      every partition read back byte for byte, the lost group rebuilt from
      its group parity. K1, K2 and K4 must launch on the write, K3 on the
      read.
   c. Compaction and the sweeps, on 10a's composite-off shuffle before its
      context stops: ``compact_shuffle(below_bytes=8 MiB,
      maps_per_group=16)``, a re-read TeraValidated, then
      ``sweep_expired_generations`` at TTL 0 and another re-read
      TeraValidated; no per-map data, index or checksum object may be
      left. Prints the compaction report and the data GETs before and
      after.

11. The skew plane and straggler speculation, with the port's metrics
    registry on (every run exact; any failure exits non-zero):
   a. A skewed aggregation in bench.py's skew-probe row shape (8-byte
      big-endian keys, 4 little-endian int64 sums, 40-byte rows,
      ``BytesHashPartitioner``, the columnar sum aggregator) at 8 maps x 8
      partitions: per map 8 MiB of uniform background, 32 MiB hot by
      duplicates (8 keys) and 32 MiB hot by volume (unique keys), 576 MiB
      raw, about 15 M rows; ``codec="tpu"``, k2m2 with 1 MiB chunks,
      speculation off. Written once with the three skew knobs at 0 and once
      with ``combine_threshold_bytes`` 4 MiB, ``split_threshold_bytes``
      8 MiB and ``hot_read_fanout`` 6, then read by 8 reduce tasks at once
      in one round per mode (off, on; two interleaved rounds until phase
      18 came). The outputs
      must equal each other and a numpy recomputation; the combine and
      split counters must be above 0 (and 0 in the off mode's writes); the
      hot-by-volume partition's reduce alone must issue more than one data
      GET per map with the knobs on; with ``hot_read_fanout`` GETs held on
      map 0's data object one reduce task must take a hot fan-out read and
      read the same sums; K1-K4 must launch. Prints per mode the reduce
      walls (p50 and max over tasks), data GETs by kind, each object's peak
      GET concurrency and the stored bytes, and the three counters.
   b. 5a's TeraSort at 256 MiB, coded k2m2, ``speculative_read_quantile``
      0.9: a fault-free warm-up (it must leave at least ``MIN_FILL_SAMPLES``
      samples in the size class of the next run's prefills), the same with
      map 3's data-object reads delayed 3 s below the retry layer (it must
      race the straggler and win at least once), and that with the registry
      off (no parity GET and no reconstruction). Each run TeraValidated.

12. The online autotuner, with the port's metrics registry on (every run
    exact; any failure exits non-zero):
   a. 5a's TeraSort (``--total-mib``, 4 workers, bypass-merge, 5a's seed)
      ``AUTOTUNE_RUNS`` times in a row (one; three until phase 17 came, two
      until phase 18 came)
      through one ``ShuffleContext`` with
      ``autotune=True``, ``autotune_interval_s=0`` and a warm-start profile
      path. Each run TeraValidated, its rows equal to the input's, K1-K3
      launched. Prints each tuner's rungs per knob in the order they took
      them, ``tune_decisions_total`` and how many decisions moved a rung;
      at least one must have moved and every rung must lie inside its
      clamps. Of the ladder knobs that shape stored bytes only
      ``columnar_batch_rows`` is on a ladder at 5a's settings (the
      composite and skew planes are off); every map written at its static
      rung must have the data, index and checksum objects of 5a (SHA-256).
   b. A fresh context on the same profile path must start from the rungs
      12a's ``stop()`` saved (both tables printed), then runs one sort.
   c. 5a with the registry on and autotune off: its GETs by object kind
      and its objects equal 5a's (the instrumented store changes no
      request), ``storage_read_bytes_total`` equals the bytes 5a's GETs
      returned, and its wall is printed beside 5a's.

13. The observability plane (the trace plane, the stats reports and the
    metric hooks; every run exact, any failure exits non-zero):
   a. Overhead pairs: 5a's TeraSort at 128 MiB (``OBS_MIB``; 256 MiB until
      phase 18 came; 8 x 8, 4
      workers, bypass-merge) through a fresh ``ShuffleContext`` per run in
      three modes, each set before the dispatcher is built (the store's
      wrap is decided then): ``off`` (tracing off, flight ring 0, registry
      off), ``flight`` (the ring at ``FLIGHT_RING_DEFAULT``, tracing and
      registry off) and ``full`` (tracing on to a temporary file without
      profiler annotations, the registry on, ``COLLECTOR`` recording).
      One untimed warm-up per mode, then ``OBS_ROUNDS`` rounds (one since
      phase 18 came) in alternating order (off, flight, full; full,
      flight, off; ...). Every
      run TeraValidated and launching K1-K3; the SHA-256 over the output
      rows equal across all runs, the data, index and checksum objects
      equal across the modes. Prints each mode's walls and the flight and
      full overheads against off, as min and as median (not asserted).
   b. What the plane recorded, on every full-mode run: the trace file
      parses as a Chrome trace, holds ``storage.op`` spans of reads, opens
      and creates, ``read.prefetch``, ``read.index_prefetch``,
      ``write.commit`` (one per map) and ``write.upload_chunk`` (and one
      ``read.chunked_prefill`` per chunked prefill the registry counted),
      every span's parent is in the document or absent, and no
      ``read.tasks`` count on this batch route (the JAX package counts
      reduce tasks that enter ``read()`` only); ``COLLECTOR.report(0)``
      holds 8 map and 8 reduce tasks, the maps' partition lengths as bytes
      written and every record as read; the registry holds encode and
      decode batch timings, fused-CRC validations, checksum validations
      and commit timings, and ``storage_read_bytes_total`` equals the bytes
      the GETs returned.
   c. Host spans beside the kernels: 5a's TeraSort at 64 MiB
      (``OBS_PROFILE_MIB``) in full mode with profiler annotations, through
      ``materialize="records"`` (so ``read.tasks`` counts its 8 reduce
      tasks), under ``torch.profiler.profile(activities=[CPU, CUDA])`` with
      every thread recorded: the profiler's events hold ``storage.op``,
      ``read.prefetch`` and ``write.commit`` and K1-K3's kernels. Prints the
      device's busy share, the union of the kernels' intervals over the
      sort's wall, taken under the profiler.
   The trace, flight, registry and collector state is reset between modes
   and when the phase ends.

14. The control plane, run last: the port's ``MetadataServer.from_config``
    at ``metadata_shards=4``, ``metadata_shard_endpoints=4``, started in
    this process on loopback, the port's metrics registry on (every run
    exact; any failure exits non-zero):
   a. 5a's TeraSort (``--total-mib``, 8 x 8, 4 workers, 5a's seed) through
      ``ShuffleManager(cfg, tracker=AsyncTrackerClient.from_config(addr,
      cfg))`` at ``metadata_batch_max=64``: TeraValidated, its rows equal to the input's,
      K1-K3 launched, its data, index and checksum objects equal to 5a's
      (SHA-256), one ``get_map_sizes_by_ranges`` RPC per reduce scan and
      the registrations batched; as 12c, its GETs by object kind
      equal 5a's (the instrumented store changes no request) and
      ``storage_read_bytes_total`` equals the bytes 5a's GETs returned.
      Prints ``meta_rpc_total`` by method and connection, the lookup RPCs
      per reduce scan and the wall beside 5a's.
   b. 14a's shuffle, before its context stops, re-read from its snapshot:
      ``publish_snapshot`` over the server's tracker (``build_snapshot``,
      written through the dispatcher as ``ShuffleSnapshotBlockId``),
      attached to a
      ``SnapshotBackedTracker`` over the same client; every partition read
      through a manager on it must make no tracker RPC, count its lookups
      under ``meta_lookup_source_total{source="snapshot"}``, launch K3,
      TeraValidate and give 14a's output SHA-256. Prints the ``.snapmeta``
      size.
   c. The control plane at the state size of a large Spark shuffle: 2,048
      maps x 1,000 partitions of map statuses registered from 8 threads
      through the client, one lookup RPC for every fourth of the 1,000
      partitions (``LOOKUP_STRIDE``; each of them until phase 18 came)
      from 8 threads, each equal to a local ``MapOutputTracker``'s; the
      snapshot built, published, read back, parsed and fetched over
      ``get_snapshot``, each exact. Host only: no kernel launches. Prints
      registrations/s, lookup RPCs/s, the split of one lookup (the
      tracker's dedupe and slice in process, the JSON of its reply, the
      rest: sockets, threads and the GIL), the snapshot's bytes and its
      build seconds.
   When the server has stopped, no thread of the server, the client or
   the reader is left.

15. The worker fleet, after phase 14: ``DistributedDriver`` (its metadata
    server in this process, on loopback) and ``WorkerAgent`` processes
    started with ``spawn`` (this process holds a CUDA context), each on
    the card, registered before any task is queued. Each worker writes its
    process's kernel launches, CUDA device, tasks and reconstructions to a
    JSON file when it leaves; the phase sums them. The card's compute mode
    is printed first, and an exclusive or prohibited mode fails the phase.
   a. 5a's TeraSort (``--total-mib``, 8 x 8) through
      ``run_sort_shuffle`` served by 4 workers: TeraValidated, its rows
      equal to the input's, K1-K3 launched in the workers. Prints the
      coordinator's requests by method (a wrapper of the server's request
      handler), the driver's stage spans (``driver.map_stage``,
      ``driver.reduce_stage`` and the rest, from the tracer), each
      worker's CUDA device, tasks and launches. The workers are drained and
      each must exit by itself with code 0 within 60 s.
   b. 256 MiB at ``worker_lease_s=3``, heartbeats every 0.5 s: a worker
      SIGKILLed as soon as it holds a map task; the lease reap requeues
      the task (``task_requeues_total`` >= 1), a live worker runs it, the
      membership records the victim's ``expire``, and the output
      TeraValidates.
   c. 256 MiB, a wrapper of ``cluster.publish_snapshot``: at the map
      barrier a worker that committed a map is killed, that map's data
      object deleted, and the driver's fleet beat left to see the death.
      Uncoded the planner must decide ``recompute`` once (the map runs
      again under a higher attempt id); coded (k2m2, 1 MiB chunks)
      ``reconstruct`` once, the reducers' degraded reads rebuilding the
      object (reconstructions > 0) and K4 launched in the workers.
   When every driver has shut down, no thread or socket the phase opened
   is left.
16. The codec bridge and the multi-GPU plane:
   a. An in-process ``CodecBridgeServer`` with the tpu codec on the card:
      four concurrent clients send 128 MiB (256 MiB until phase 18 came) of TeraSort bytes as requests
      of 64 x 256 KiB; every request compresses (K2) and decompresses (K3)
      back to its bytes, and ``CRC32C_BATCH`` / ``ADLER32_BATCH`` equal the
      host's. The same through the native codec (no launch). MB/s by op
      and codec.
   b. ``ShuffleContext.mesh_shuffle`` of 8 TeraSort batches (128 MiB, cut
      from 1 GiB, and from 256 MiB when phase 18 came) into 8 partitions:
      at ``mesh_devices=4`` on the one real
      card it keeps the store path (``used_mesh=False``) with the store
      requests of ``mesh_devices=0``; on four emulated lanes of the card
      (``dispatch.local_devices`` patched to ``[cuda:0] * 4``, a stream
      each) it takes the mesh route, its partitions equal the store
      path's by row count and an order-free digest,
      ``mesh_route_rows_total`` equals the input rows, K1 + K2 run on the
      write and K3 on the read; ``device_repartition``'s time.
   c. 5a's TeraSort at 128 MiB (256 MiB until phase 18 came) with the dispatcher armed over two emulated
      lanes of the card, uncoded and k2m2 coded: data, index, checksum
      and parity objects byte-equal to the disarmed runs', both lanes
      used, every slot released, K4 striped over the lanes. Both walls,
      labelled as emulated lanes on one H100; no gain is claimed.
17. The concurrency witnesses on the card. Two child processes of this
    script (``--witness-child``), one after the other: a plain one, and a
    witnessed one with ``S3SHUFFLE_LOCK_WITNESS``, ``S3SHUFFLE_RACE_WITNESS``
    and ``S3SHUFFLE_PROTOCOL_WITNESS`` set, which loads the port's lock and
    race witnesses by file spec before it imports torch or the port (locks
    built at import are witnessed too). Each runs:
   a. 5a's TeraSort at 128 MiB (``WITNESS_MIB``, cut from 1 GiB, and from
      256 MiB when phase 18 came), 4 task
      threads, bypass-merge, TeraValidated, K1-K3 launched;
   b. 10b's coded composite (k2m2, composite commits, one group's data
      object lost before the read), K4 launched, every lost block rebuilt;
   c. 15a's fleet at ``WITNESS_MIB``: ``DistributedDriver`` in the child and 4
      spawned workers running ``worker.main`` (the protocol witness's
      switch inherited), each exiting 0 past its witness check.
   The witnessed run's objects must equal the plain run's (17c: but the
   snapshots, which carry their publish time), 17a's K1-K3 launches must
   equal, the lock graph must have no cycle, the race witness no report
   and a check count above 0 in each of a, b and c, and no protocol
   witness a violation (one wraps 17a's manager, one 17b's, one each
   worker's). Prints the witnessed lock sites and edges, the edges with a
   site only the port builds, the race checks and both runs' walls (a
   cost, not a claim).
   5a and 6a also print their data GETs by size class (under 1 MiB, 1-4
   MiB, 4 MiB, over 4 MiB).

The record layer's row gathers take the port's native library, built in
phase 1 from ``s3shuffle_tpu_torch/native`` (a library left by an earlier
run is removed first); 5a, 5b, 6a and every TeraSort run print the
gathers by route, and 5a must take the native segmented gather.

Phases 5a, 5b, 6a, 7, 8b, 9, 10, 11, 12 and 14a count the store's GETs, LIST,
status and create calls by object kind with a wrapper defined here,
installed beneath the port's retry layer (and beneath its metrics layer,
stacked over the retry layer while the registry is on), so the counts are
requests that reach the store.

Every record read of phases 3-8 goes through the port's read plane: the
coalescing scan planner and the prefetcher at the read knobs' defaults
unless a run says otherwise (phases 3, 4, 8a and 8d read each partition
with ``ShuffleReader.read_partition``, one scan per partition), and every
phase runs at the codec windows' defaults unless it says otherwise.

The script prints the seconds each phase took (host clock, data
generation included) before its JSON lines.

Phase 5a also prints its GETs by object kind (at the defaults: 64 data, 8
index and 8 checksum GETs at 1 GiB, and no parity GET).

18. The user-facing drivers (``s3shuffle_tpu_torch/examples/``) and the
    public batch checksums, run last:
   a. q49, q75, q64 and q95 of the port's ``examples/sql_queries.py`` at
      SF 100 (21,600,792 rows in, seed 17), as 6a runs q5 and q67: each
      result equal to its numpy recomputation (``q49_numpy`` ...
      ``q95_numpy``), each launching K1-K3; per query the wall, the
      shuffle-stage wall, the stages (3 / 3 / 4 / 3), rows out beside the
      JAX package's record at this seed, and the launches.
   b. q67 at SF 100 over Zipf(1.2) item and store ids (``SQL_SKEW``),
      against numpy, launching K1-K3, with its narrow-pack fallbacks.
   c. Each driver's ``main`` in this process on the card
      (``DRIVER_RUNS``): terasort at 256 MiB, query_shuffles at scale
      1000, multihost_terasort at 64 MiB with two ``python -m
      s3shuffle_tpu_torch.worker`` processes (each writes its launches when
      it leaves; they are summed), ici_to_store on two emulated lanes of
      the card, sql_queries q49 at SF 10 verified; each exits 0, says valid
      or verified (TeraSort and the profiles validate inside), and
      launches K1-K3 through ``codec="tpu"``.
   d. ``ops.crc32_batch`` on 64 right-aligned rows of up to 256 KiB against
      the host's CRC32C (one K1 launch) and zlib's CRC32,
      ``ops.adler32_batch`` against ``zlib.adler32``, and
      ``codec.cuda.fused_compress_and_checksum`` on 64 full blocks against
      the staged route and the host.

Output: the JSON of phase 18, of phase 17, of phase 16, of phase 15, of
phase 14, of phase 13, of phase 12, of phase 11, of phase 10, of phase 9,
of phase 8, then of phase 7's runs, then the JSON kernel table on the line
before the last (launch counts of K1-K3 from 18a, the four queries summed,
this slice's main path, and of K4 from 17b's witnessed run; every path's
counts under
``launches_by_path``), and as the last line
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.
Exits non-zero without a CUDA device, and when run outside a checkout of
the repository.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import shutil
import statistics
import subprocess
import sys
import tempfile
import threading
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
#: examples/terasort.py, and the pickled phase's records per map (500,000
#: until phase 18 came: cut to keep the script's time)
KEY_BYTES, VALUE_BYTES = 10, 90
WORKERS = 4
PICKLED_PER_MAP = 250_000
#: phase 5b's TeraSort size (5a and phase 12 run --total-mib)
SERIALIZED_MIB = 256
#: phases 6a and 18a-18b: the scale factor of the typed queries and the
#: table seed (``s3shuffle_tpu_torch/examples/sql_queries.py`` gives the maps,
#: reducers and TOP_K)
SQL_SF = 100
SQL_SEED = 17
#: phase 6b: the host codecs and the size of their data plane run
HOST_CODECS = ("native", "lz4", "zlib")
HOST_CODEC_MIB = 64
#: phase 7: the TeraSort size of the read-plane split (256 MiB until phase
#: 18 came: cut to keep the script's time) and its six runs as (workers,
#: torch intra-op threads (None: the default), read knobs)
SPLIT_MIB = 128
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
WINDOW_SORT_MIB = 128  # 256 until phase 18 came: cut to keep the script's time
WINDOW_RUNS = (
    ("on", {}),
    ("off", {"encode_inflight_batches": 1, "decode_inflight_batches": 1}),
)
DECODE_ROWS = 32
#: the ends of the autotuner's decode_batch_frames ladder, where K3 is held
#: against its plain version too
K3_TUNED_ROWS = (4, 128)
#: phase 9: the fault soak's retry knobs (tests/test_fault_soak.py: 8
#: re-drives, 1 ms backoff base, 20 s per op) and the TeraSort size through
#: fsspec (9c); 9b writes phase 8a's data plane
WEATHER_KNOBS = {"storage_retries": 8, "storage_retry_base_ms": 1.0,
                 "storage_op_deadline_s": 20.0}
FSSPEC_MIB = 128  # 256 until phase 18 came: cut to keep the script's time
#: phase 10: the swarm's size, maps and composite group size (the JAX
#: autotune's "default" scenario, bench.py:2862), 10b's group size, and
#: 10c's compaction threshold
SWARM_MIB = 128  # 256 until phase 18 came: cut to keep the script's time
SWARM_MAPS = 64
SWARM_GROUP = 16
CODED_GROUP = 4
COMPACT_BELOW = 8 * MiB
#: phase 11a: the skewed aggregation (bench.py's skew probe row shape: 8-byte
#: big-endian keys, SKEW_VAL_COLS little-endian int64 sums), per map a
#: uniform background and two hot partitions (SKEW_HOT_KEYS duplicate keys,
#: and unique keys), the modes' knobs, the read rounds per mode, and the
#: k2m2 coding (parity chunks of PARITY_CHUNK) the fan-out reads through
SKEW_MAPS = 8
SKEW_PARTS = 8
SKEW_VAL_COLS = 4
SKEW_ROW = 8 + 8 * SKEW_VAL_COLS
SKEW_BASE = 8 * MiB
SKEW_DUP = 32 * MiB
SKEW_BULK = 32 * MiB
SKEW_HOT_KEYS = 8
SKEW_ON = {"combine_threshold_bytes": 4 * MiB, "split_threshold_bytes": 8 * MiB,
           "hot_read_fanout": 6}
#: (two read rounds per mode until phase 18 came: cut to keep the script's time)
SKEW_ROUNDS = 1
#: phase 11b: straggler speculation on 5a's TeraSort, coded k2m2: its size,
#: the quantile, the delay of the straggling map's data-object reads
SPEC_MIB = 256
SPEC_QUANTILE = 0.9
SPEC_DELAY_S = 3.0
SPEC_MAP = 3
#: phase 12: the autotuned TeraSort's runs through one context (three
#: until phase 17 came, two until phase 18 came: cut to keep the script's
#: time)
AUTOTUNE_RUNS = 1
#: phase 13: the TeraSort size of the overhead pairs, its modes, the timed
#: rounds after one warm-up per mode (three until phase 15 came, two until
#: phase 18 came: cut to keep the script's time), and the size of the
#: profiled run
OBS_MIB = 128  # 256 until phase 18 came: cut to keep the script's time
OBS_MODES = ("off", "flight", "full")
OBS_ROUNDS = 1
OBS_PROFILE_MIB = 64
# phase 14: the control plane
CONTROL_SHARDS = 4
CONTROL_ENDPOINTS = 4
CONTROL_BATCH = 64
STATE_MAPS = 2048
STATE_PARTS = 1000
STATE_THREADS = 8
#: 14c looks up every LOOKUP_STRIDE-th partition (each until phase 18 came:
#: cut to keep the script's time)
LOOKUP_STRIDE = 4
# lookups 14c times in process (the tracker alone, and its reply's JSON)
SPLIT_LOOKUPS = 20
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


def kernel_phase(first_batch: bytes, second_batch: bytes, k4_bytes: bytes, reps: int,
                 bw: float, dev):
    """Phase 2: each kernel against its plain version at main-path shapes
    (K3 also at the autotuner's decode-run ends, ``K3_TUNED_ROWS``, from
    the two batches)."""
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
    # the autotuner's decode_batch_frames ladder ends (4 and 128 rows of
    # TeraSort bytes; 128 takes a second batch) beside the default's 32
    lo_rows, hi_rows = K3_TUNED_ROWS
    for name, rows, batch in (
        ("tlz_decode_fused", DECODE_ROWS, first_batch[: DECODE_ROWS * BLOCK]),
        ("tlz_decode_fused[zeros]", DECODE_ROWS, bytes(DECODE_ROWS * BLOCK)),
        (f"tlz_decode_fused[{lo_rows} rows]", lo_rows, first_batch[: lo_rows * BLOCK]),
        (f"tlz_decode_fused[{hi_rows} rows]", hi_rows,
         (first_batch + second_batch)[: hi_rows * BLOCK]),
    ):
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


def terasort_parts(seed: int, total_bytes: int, maps: int = MAPS):
    """TeraSort input as ``examples/terasort.py`` generates it: per map, a
    columnar batch of random 10-byte keys and 90-byte values drawn from a
    64-entry pool, ``total_bytes // 100 // maps`` records."""
    import numpy as np

    from s3shuffle_tpu_torch.batch import RecordBatch

    per_map = total_bytes // (KEY_BYTES + VALUE_BYTES) // maps
    rng = np.random.default_rng(seed)
    pool = rng.integers(0, 256, (64, VALUE_BYTES), dtype=np.uint8)
    parts = []
    for _ in range(maps):
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
    both ordered by the whole row (the order of equal keys is not defined);
    ``input_rows=None`` leaves the rows to the caller (phase 13 holds every
    later run's output SHA-256 to its first run's, whose rows it checks)."""
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
    if input_rows is not None:
        assert np.array_equal(sort_rows(rows_of(merged)), input_rows), \
            "the output rows are not the input rows"


def files_under(root: str):
    return [os.path.join(d, f) for d, _dirs, files in os.walk(root) for f in files]


class CountingBackend:
    """Counts the positioned reads (GETs), LIST calls, status calls and
    creates (PUTs) issued through a backend, by object kind (a composite
    object's kind is ``comp-data``, ``comp-cindex`` or ``comp-parity``),
    and the objects opened; everything else passes through. Installed beneath the port's retry
    layer (:func:`count_store`), it counts the requests that reach the
    store, each re-driven attempt included. An instrument of this script,
    not a feature of the port."""

    KINDS = (".data", ".index", ".checksum", ".parity")

    def __init__(self, inner):
        import collections
        import threading

        self._inner = inner
        self.gets = collections.Counter()
        self.get_bytes = collections.Counter()  # bytes the GETs returned
        self.statuses = collections.Counter()
        self.creates = collections.Counter()
        self.data_get_sizes = collections.Counter()  # data GETs by size class
        self.opened = set()  # paths opened for ranged reads
        self._lock = threading.Lock()

    def __getattr__(self, name):
        return getattr(self._inner, name)

    def _kind(self, path):
        name = path.rsplit("/", 1)[-1]
        if "_comp_" in name:
            return "comp-" + ("parity" if name.endswith(".parity") else name.rsplit(".", 1)[1])
        return next((k[1:] for k in self.KINDS if k in name), "other")

    def create(self, path):
        with self._lock:
            self.creates[self._kind(path)] += 1
        return self._inner.create(path)

    def open_ranged(self, path, size_hint=None):
        with self._lock:
            self.opened.add(path)
        return _CountingReader(self, self._kind(path), self._inner.open_ranged(path, size_hint))

    def read_all(self, path):
        with self.open_ranged(path) as r:
            return r.read_fully(0, r.size)

    def status(self, path):
        with self._lock:
            self.statuses[self._kind(path)] += 1
        return self._inner.status(path)

    def list_prefix(self, prefix):
        with self._lock:
            self.gets["list"] += 1
        return self._inner.list_prefix(prefix)


GET_SIZE_CLASSES = ((MiB, "< 1 MiB"), (4 * MiB, "1-4 MiB"), (4 * MiB + 1, "4 MiB"))


def get_size_class(length: int) -> str:
    """The size class of one GET: under 1 MiB, 1-4 MiB, exactly 4 MiB (the
    serial prefill's cap) or over 4 MiB."""
    return next((name for bound, name in GET_SIZE_CLASSES if length < bound), "> 4 MiB")


def retry_layer(dispatcher):
    """The dispatcher's retry layer: its backend, or the one beneath the
    metrics layer the port stacks while its registry is on, or beneath the
    protocol witness."""
    from s3shuffle_tpu_torch.storage.instrumented import InstrumentedBackend
    from s3shuffle_tpu_torch.storage.retrying import RetryingBackend

    from s3shuffle_tpu_torch.utils.protowitness import WitnessedBackend

    top = dispatcher.backend
    if isinstance(top, WitnessedBackend):  # the protocol witness wraps last (phase 17)
        top = top._inner
    if isinstance(top, InstrumentedBackend):
        top = top.inner
    assert isinstance(top, RetryingBackend), "the port stacks its retry layer by default"
    return top


def count_store(dispatcher, inner=None) -> CountingBackend:
    """Install a :class:`CountingBackend` beneath the dispatcher's retry
    layer (over ``inner`` when given, else over the backend the retry layer
    wraps), so its counts are requests that reach the store."""
    top = retry_layer(dispatcher)
    counting = CountingBackend(inner if inner is not None else top.inner)
    top.inner = counting
    return counting


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
            if self._kind == "data":
                self._owner.data_get_sizes[get_size_class(length)] += 1
        data = self._inner.read_fully(position, length)
        with self._owner._lock:
            self._owner.get_bytes[self._kind] += len(data)
        return data

    def close(self):
        self._inner.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def fresh_dispatchers() -> None:
    """Forget the port's process dispatchers. A ``ShuffleManager`` takes
    ``Dispatcher.get(config)``, shared with every later manager of an equal
    config, and several paths wrap their manager's backend in place
    (:func:`count_store`, :func:`retry_layer`) or choose its layers by the
    tracer and registry switches: each manager of this script starts from a
    reset registry, so each has a dispatcher of its own."""
    from s3shuffle_tpu_torch.storage.dispatcher import Dispatcher

    Dispatcher.reset()


def record_path(label: str, parts, input_rows, dev, root: str, bypass: int,
                workers: int = WORKERS, after=None, stack=None, scheme: str = "file",
                digest: bool = False, tracker=None, **knobs):
    """Phase 5a/5b (and each run of phases 7, 8b, 9a, 9c and 10a): TeraSort
    through ShuffleContext.sort_by_key, as examples/terasort.py runs it, on
    ``workers`` task threads, then TeraValidate; ``bypass`` is the manager's
    bypass-merge threshold (0 selects the serialized handle), ``scheme`` the
    root's URI scheme (``local`` is fsspec's local filesystem), ``knobs``
    further ShuffleConfig fields. The store's GETs and status calls are
    counted (:class:`CountingBackend`; ``stack(dispatcher)``, when given,
    installs it instead of :func:`count_store`) and every reduce task's
    read metrics summed; ``after(manager)``, when given, runs on the
    written shuffle before the context stops (after the read side's numbers
    were taken); ``tracker``, when given, is the manager's map-output
    tracker (else its own in-process one). Returns the launches, the wall seconds and the read side's
    numbers (with the store's creates, the record layer's gathers by route
    and, with ``digest``, the SHA-256 over the output rows in partition
    order)."""
    import torch

    from s3shuffle_tpu_torch import ShuffleConfig, ShuffleContext, ShuffleManager, batch
    from s3shuffle_tpu_torch.ops import _build, tlz_cuda
    from s3shuffle_tpu_torch.serializer import ColumnarKVSerializer

    cfg = ShuffleConfig(root_dir=f"{scheme}://{root}", checksum_algorithm="CRC32C",
                        codec_block_size=BLOCK, codec_batch_blocks=BATCH, **knobs)
    fresh_dispatchers()
    manager = ShuffleManager(cfg, bypass_merge_threshold=bypass, tracker=tracker, device=dev)
    manager.codec.timings = {}
    counting = count_store(manager.dispatcher) if stack is None else stack(manager.dispatcher)
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
    batch.reset_gather_routes()
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
    read = {key: sum(getattr(r.metrics, key) for r in readers)
            for key in ("remote_blocks_fetched", "remote_bytes_read", "records_read",
                        "wait_ns", "prefetch_ns")}
    read["threads"] = max((r.prefetch_stats or {}).get("threads", 0) for r in readers)
    read["gets"] = dict(counting.gets)
    read["get_bytes"] = dict(counting.get_bytes)
    read["statuses"] = dict(counting.statuses)
    read["creates"] = dict(counting.creates)
    read["data_get_sizes"] = dict(counting.data_get_sizes)
    read["opened"] = {kind: sum(1 for path in counting.opened if counting._kind(path) == kind)
                      for kind in ("data", "index", "checksum")}
    read["gather_routes"] = dict(batch.GATHER_ROUTES)
    read["reconstructions"] = sum(r.reconstructions for r in readers)
    if after is not None:
        after(manager)
    ctx.stop()
    assert not files_under(root), "stop() with cleanup left objects behind"
    teravalidate(out, n_records, input_rows)
    if digest:
        sha = hashlib.sha256()
        for partition in out:
            if any(b.n for b in partition):
                sha.update(rows_of(partition).tobytes())
        read["out_sha256"] = sha.hexdigest()
    rows = "rows" if input_rows is not None else "rows by the output SHA-256"
    print(f"{label}: TeraSort {raw / MiB:.0f} MiB, {n_records} records, {len(parts)} maps x "
          f"{PARTS} reducers, {workers} workers, {kind} handle; TeraValidate: ok ({rows})")
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
          f"over reduce tasks); GETs {json.dumps(read['gets'])}; status calls "
          f"{json.dumps(read['statuses'])}; objects opened {json.dumps(read['opened'])}; "
          f"prefetch threads (most in a reduce task) {read['threads']}")
    print(f"{label}: frames {json.dumps(counts)}; launches {json.dumps(launches)}; "
          f"K3 general-route rows: {general}")
    print(f"{label}: store creates {json.dumps(read['creates'])}; record-layer gathers by "
          f"route {json.dumps(read['gather_routes'])}")
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
    fresh_dispatchers()
    lm = ShuffleManager(cfg, device=dev)
    counting = count_store(lm.dispatcher)
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


def object_digests(root: str) -> dict:
    """SHA-256 of every object under ``root``, keyed by its path below it."""
    import hashlib

    out = {}
    for path in files_under(root):
        with open(path, "rb") as f:
            out[os.path.relpath(path, root)] = hashlib.sha256(f.read()).hexdigest()
    return out


def weather_rules():
    """The fault soak's four seeded rules (tests/test_fault_soak.py): reads
    5 % connection resets, opens 5 % HTTP 503, status calls 5 % timeouts,
    and exactly one transient create."""
    from s3shuffle_tpu_torch.storage import fault

    return [
        fault.FaultRule("read", prob=0.05, rng_seed=11, times=None,
                        exc=fault.transient_connection_reset),
        fault.FaultRule("open", prob=0.05, rng_seed=22, times=None,
                        exc=fault.transient_http_503),
        fault.FaultRule("status", prob=0.05, rng_seed=33, times=None,
                        exc=fault.transient_timeout),
        fault.FaultRule("create", times=1, exc=fault.transient_timeout),
    ]


def weather_soak(parts, input_rows, dev, root: str, clean_digests: dict,
                 clean_wall: float):
    """Phase 9a: 5a's TeraSort again, the raw ``LocalBackend`` under the
    port's ``FlakyBackend`` (the soak's rules) under its ``RetryingBackend``
    at the soak's knobs, the counting wrapper beneath the retry layer.
    TeraValidated; every object's digest must equal 5a's fault-free one.
    Returns the launches and the phase's numbers."""
    from s3shuffle_tpu_torch.storage.fault import FlakyBackend
    from s3shuffle_tpu_torch.storage.local import LocalBackend

    rules = weather_rules()
    digests = {}

    def stack(dispatcher):
        assert dispatcher.retry_policy.retries == WEATHER_KNOBS["storage_retries"]
        return count_store(dispatcher, inner=FlakyBackend(LocalBackend(), rules=rules))

    launches, wall, read = record_path(
        "9a weather", parts, input_rows, dev, root, bypass=200, stack=stack,
        after=lambda _m: digests.update(object_digests(root)), **WEATHER_KNOBS)
    hits = {rule.op: rule.hits for rule in rules}
    same = sum(digests.get(name) == d for name, d in clean_digests.items())
    print(f"9a weather: wall {wall:.2f} s against 5a's {clean_wall:.2f} s fault-free; rule "
          f"hits {json.dumps(hits)}; store saw GETs {json.dumps(read['gets'])} and status "
          f"calls {json.dumps(read['statuses'])}; {same} of {len(clean_digests)} objects' "
          f"digests equal to 5a's; no object left after stop()")
    assert digests == clean_digests, "9a: objects differ from 5a's fault-free objects"
    assert hits["read"] >= 1 and hits["create"] == 1, hits
    return launches, dict(read, hits=hits, clean_wall_s=clean_wall, objects=len(digests))


def commit_redrives(data, dev, root: str):
    """Phase 9b: phase 4's coded write (k2m2, 1 MiB chunks) of ``data``,
    fault-free and then with one transient fault on the first ``.parity``
    create and one on the first ``.index`` create, injected above the retry
    layer so that the writer's own re-drives must heal them: the objects
    must be byte-equal, and K1, K2 and K4 must launch. Then the index fault
    at ``storage_retries=0``: map 0's commit must raise, and its abort
    leaves no data, parity or index object (the checksum sidecar, PUT before
    the failed index, stays, as in the JAX package). Returns the launches of
    the healed write and the phase's numbers."""
    import torch

    from s3shuffle_tpu_torch import ShuffleConfig
    from s3shuffle_tpu_torch.codec import codec_from_config
    from s3shuffle_tpu_torch.metadata.helper import ShuffleHelper
    from s3shuffle_tpu_torch.ops import _build
    from s3shuffle_tpu_torch.storage import fault
    from s3shuffle_tpu_torch.storage.dispatcher import Dispatcher
    from s3shuffle_tpu_torch.write.map_output_writer import MapOutputWriter

    def coded_write(sub: str, rules, maps: int = MAPS, **knobs) -> str:
        path = os.path.join(root, sub)
        cfg = ShuffleConfig(root_dir=f"file://{path}", checksum_algorithm="CRC32C",
                            codec_block_size=BLOCK, codec_batch_blocks=BATCH,
                            parity_segments=PARITY_M, parity_stripe_k=PARITY_K,
                            parity_chunk_bytes=PARITY_CHUNK, **knobs)
        disp = Dispatcher(cfg)
        disp.backend = fault.FlakyBackend(disp.backend, rules=rules)
        helper = ShuffleHelper(disp)
        codec = codec_from_config(cfg, dev)
        for m in range(maps):
            writer = MapOutputWriter(disp, helper, 1, m, PARTS, codec=codec)
            try:
                for p in range(PARTS):
                    pw = writer.get_encoding_partition_writer(p)
                    pw.write(data[m][p])
                    pw.close()
                writer.commit_all_partitions()
            except Exception as e:
                writer.abort(e)
                raise
        torch.cuda.synchronize()
        return path

    def transient(kind):
        return fault.FaultRule("create", match=kind, times=1,
                               exc=fault.transient_connection_reset)

    total = sum(len(p) for parts in data for p in parts)
    clean = object_digests(coded_write("clean", []))
    rules = [transient(".parity"), transient(".index")]
    _build.reset_launches()
    t0 = time.perf_counter()
    healed = object_digests(coded_write("healed", rules))
    wall = time.perf_counter() - t0
    launches = dict(_build.LAUNCHES)
    hits = {"parity": rules[0].hits, "index": rules[1].hits}
    fail_rule = transient(".index")
    try:
        coded_write("fail-fast", [fail_rule], maps=1, storage_retries=0)
    except ConnectionResetError as e:
        raised = f"{type(e).__name__}: {e}"
    else:
        raise AssertionError("9b: the index fault did not fail the commit at storage_retries=0")
    left = sorted(os.path.basename(f).split(".", 1)[1]
                  for f in files_under(os.path.join(root, "fail-fast")))
    # the orphan sweep with no registered winner reclaims what it left
    sweep_cfg = ShuffleConfig(root_dir=f"file://{os.path.join(root, 'fail-fast')}",
                              checksum_algorithm="CRC32C")
    swept = sorted(os.path.basename(p)
                   for p in Dispatcher(sweep_cfg).sweep_orphan_attempts(1, winner_map_ids=[]))
    left_after_sweep = files_under(os.path.join(root, "fail-fast"))
    kinds = sorted({name.rsplit("/", 1)[-1].split(".", 1)[1] for name in clean})
    print(f"9b commit re-drives: {total / MiB:.0f} MiB coded k={PARITY_K} m={PARITY_M} in "
          f"{wall:.2f} s; rule hits {json.dumps(hits)}; {len(healed)} objects "
          f"({', '.join(kinds)}) byte-equal to the fault-free write: "
          f"{healed == clean}; launches {json.dumps(launches)}")
    print(f"9b fail-fast at storage_retries=0: the commit raised {raised!r}; "
          f"{fail_rule.hits} hit; objects left of map 0: {left}; the orphan sweep removed "
          f"{swept}, {len(left_after_sweep)} objects left")
    assert healed == clean and len(clean) == MAPS * (3 + PARITY_M), "9b: objects differ"
    assert hits == {"parity": 1, "index": 1}, hits
    for name in ("crc_fold", "tlz_planes", "gf_encode"):
        assert launches[name] > 0, f"9b: kernel {name} was not launched"
    assert fail_rule.hits == 1 and left == ["checksum.CRC32C"], left
    assert swept == ["shuffle_1_0_0.checksum.CRC32C"] and not left_after_sweep, swept
    return launches, {"wall_s": wall, "hits": hits, "objects": len(healed),
                      "fail_fast_left": left, "orphan_sweep_removed": swept}


def fsspec_path(seed: int, total_mib: int, dev, root: str):
    """Phase 9c: 5a's TeraSort at ``total_mib`` on a ``local://`` root: the
    port's ``FsspecBackend`` over fsspec's ``LocalFileSystem`` (ranged
    ``cat_file`` GETs). TeraValidated, with GETs and status calls by object
    kind; one status call per data object opened (the FileStatus cache).
    Returns the launches and the phase's numbers."""
    import fsspec

    parts = terasort_parts(seed, total_mib * MiB)
    input_rows = sort_rows(rows_of(parts))
    backends = []

    def after(manager):
        backends.append(type(manager.dispatcher.backend.inner._inner).__name__)

    launches, wall, read = record_path(
        "9c fsspec local://", parts, input_rows, dev, root, bypass=200, after=after,
        scheme="local", storage_options={"auto_mkdir": True})
    print(f"9c fsspec {fsspec.__version__}: backend {backends}; {read['opened']['data']} data "
          f"objects opened, status calls {json.dumps(read['statuses'])}")
    assert backends == ["FsspecBackend"], backends
    assert read["statuses"] == {"data": read["opened"]["data"]} == {"data": MAPS}, read
    return launches, dict(read, fsspec=fsspec.__version__)


# --- phase 10: the composite commit plane ---------------------------------

def reread(manager, dev):
    """Every reduce partition of shuffle 0 read again, key-ordered batches
    per partition, through readers of the manager's helper and tracker
    (not the ones record_path sums)."""
    from s3shuffle_tpu_torch.read.reader import ShuffleReader

    dep = manager.handle(0).dependency
    return [list(ShuffleReader(manager.dispatcher, manager.helper, manager.tracker, dep, p,
                               p + 1, codec=manager.codec, device=dev).read_result_batches())
            for p in range(PARTS)]


def per_map_objects(root: str):
    """The per-map data, index and checksum objects under ``root``."""
    import re

    pattern = re.compile(r"^shuffle_\d+_\d+_\d+\.(data|index|checksum\..+)$")
    return [f for f in files_under(root) if pattern.match(os.path.basename(f))]


def composite_swarm(seed: int, total_mib: int, dev, root: str):
    """Phases 10a and 10c: the tiny-map swarm with composite commits off and
    on, and on the off run's shuffle the compaction, the TTL sweep and their
    re-reads. Returns the launches of the off run, the on run and 10c, and
    the phase's numbers."""
    import torch

    from s3shuffle_tpu_torch.ops import _build
    from s3shuffle_tpu_torch.write.compactor import compact_shuffle

    parts = terasort_parts(seed, total_mib * MiB, maps=SWARM_MAPS)
    input_rows = sort_rows(rows_of(parts))
    n_records = sum(p.n for p in parts)
    out = {}

    def compaction(manager):
        """10c on the composite-off shuffle, before its context stops."""
        counting = manager.dispatcher.backend.inner
        _build.reset_launches()
        t0 = time.perf_counter()
        report = compact_shuffle(manager.dispatcher, manager.helper, 0, tracker=manager.tracker,
                                 below_bytes=COMPACT_BELOW, maps_per_group=SWARM_GROUP)
        t_compact = time.perf_counter() - t0
        counting.gets.clear()
        teravalidate(reread(manager, dev), n_records, input_rows)
        gets_compacted = dict(counting.gets)
        removed = manager.dispatcher.sweep_expired_generations(0, ttl_s=0)
        left = per_map_objects(root + "-off")
        counting.gets.clear()
        teravalidate(reread(manager, dev), n_records, input_rows)
        torch.cuda.synchronize()
        out["10c"] = {
            "report": {"groups": report.groups, "maps": report.maps, "bytes": report.bytes,
                       "tombstoned": report.tombstoned},
            "compact_s": t_compact, "gets_after_compaction": gets_compacted,
            "swept": len(removed), "gets_after_sweep": dict(counting.gets),
            "per_map_left": len(left), "launches": dict(_build.LAUNCHES),
        }
        assert report.maps == SWARM_MAPS and report.tombstoned == 3 * SWARM_MAPS, report
        assert not left, f"10c: per-map objects left after the sweep: {left[:4]}"
        assert len(removed) == 3 * SWARM_MAPS + report.groups, len(removed)

    def groups_of(manager):
        helper, disp = manager.helper, manager.dispatcher
        out["groups"] = [len(helper.read_fat_index(0, g).members)
                         for g in disp.list_composite_groups(0)]

    runs = {}
    for label, maps, after in (("off", 0, compaction), ("on", SWARM_GROUP, groups_of)):
        launches, wall, read = record_path(
            f"10a composite {label}", parts, input_rows, dev, f"{root}-{label}", bypass=200,
            after=after, composite_commit_maps=maps)
        runs[label] = (launches, dict(read, wall_s=wall))
    off, on = runs["off"][1], runs["on"][1]
    c = out["10c"]
    print(f"10a swarm: {SWARM_MAPS} maps x {PARTS} partitions, {total_mib} MiB; creates off "
          f"{json.dumps(off['creates'])} (total {sum(off['creates'].values())}), on "
          f"{json.dumps(on['creates'])} (total {sum(on['creates'].values())}); groups sealed on: "
          f"{len(out['groups'])}, members {out['groups']}")
    print(f"10a swarm: wall off {off['wall_s']:.2f} s, on {on['wall_s']:.2f} s; reduce GETs "
          f"off {json.dumps(off['gets'])}, on {json.dumps(on['gets'])}")
    print(f"10c compaction: report {json.dumps(c['report'])} in {c['compact_s']:.2f} s; data "
          f"GETs of the reduce scan before {off['gets'].get('data', 0)}, after compaction "
          f"{json.dumps(c['gets_after_compaction'])}, after the TTL sweep ({c['swept']} objects "
          f"removed) {json.dumps(c['gets_after_sweep'])}; per-map objects left "
          f"{c['per_map_left']}; launches {json.dumps(c['launches'])}")
    assert off["creates"] == {"data": SWARM_MAPS, "index": SWARM_MAPS,
                              "checksum": SWARM_MAPS}, off["creates"]
    groups = len(out["groups"])
    assert on["creates"] == {"comp-data": groups, "comp-cindex": groups}, on["creates"]
    assert sum(out["groups"]) == SWARM_MAPS and max(out["groups"]) <= SWARM_GROUP, out["groups"]
    assert c["launches"].get("tlz_decode_fused", 0) > 0, "10c: the re-reads launched no K3"
    numbers = {"off": off, "on": on, "groups": out["groups"], "10c": c}
    return runs["off"][0], runs["on"][0], c["launches"], numbers


def coded_composite(data, dev, root: str, digests=None):
    """Phase 10b: ``data`` written on one thread into composite groups of
    ``CODED_GROUP`` maps with k2m2 group parity, the second group's
    composite data object lost, every reduce partition read back. Returns
    the launches (write and read) and the phase's numbers; ``digests``,
    when given, receives the objects' digests as the write left them."""
    import torch

    from s3shuffle_tpu_torch import ShuffleConfig, ShuffleManager
    from s3shuffle_tpu_torch.block_ids import ShuffleCompositeDataBlockId
    from s3shuffle_tpu_torch.dependency import HashPartitioner, ShuffleDependency
    from s3shuffle_tpu_torch.ops import _build, tlz_cuda
    from s3shuffle_tpu_torch.read.reader import ShuffleReader
    from s3shuffle_tpu_torch.write.map_output_writer import MapOutputWriter

    cfg = ShuffleConfig(root_dir=f"file://{root}", checksum_algorithm="CRC32C",
                        codec_block_size=BLOCK, codec_batch_blocks=BATCH,
                        composite_commit_maps=CODED_GROUP, composite_flush_ms=0.0,
                        parity_segments=PARITY_M, parity_stripe_k=PARITY_K,
                        parity_chunk_bytes=PARITY_CHUNK)
    fresh_dispatchers()
    manager = ShuffleManager(cfg, device=dev)
    disp, helper = manager.dispatcher, manager.helper
    manager.register_shuffle(1, ShuffleDependency(1, HashPartitioner(PARTS)))
    total = sum(len(p) for parts in data for p in parts)
    _build.reset_launches()
    tlz_cuda.reset_general_route_rows()
    t0 = time.perf_counter()
    for m in range(MAPS):
        writer = MapOutputWriter(disp, helper, 1, m, PARTS, codec=manager.codec,
                                 aggregator=manager.composite)
        for p in range(PARTS):
            pw = writer.get_encoding_partition_writer(p)
            pw.write(data[m][p])
            pw.close()
        msg = writer.commit_all_partitions()
        assert msg.deferred and msg.composite_group == m - m % CODED_GROUP, msg
    manager.composite.flush_shuffle(1)
    torch.cuda.synchronize()
    t_write = time.perf_counter() - t0
    write_launches = dict(_build.LAUNCHES)
    if digests is not None:
        digests.update(object_digests(root))
    groups = disp.list_composite_groups(1)
    parity = sorted(os.path.basename(f) for f in files_under(root) if f.endswith(".parity"))
    lost = disp.get_path(ShuffleCompositeDataBlockId(1, groups[1]))
    assert os.path.exists(lost[len("file://"):])
    disp.backend.delete(lost)
    reader = ShuffleReader(disp, helper, codec=manager.codec)
    t0 = time.perf_counter()
    for r in range(PARTS):
        got = reader.read_partition(1, r, range(MAPS))
        assert got == b"".join(data[m][r] for m in range(MAPS)), \
            f"10b: reduce partition {r} read back wrong bytes"
    t_read = time.perf_counter() - t0
    launches = dict(_build.LAUNCHES)
    general = tlz_cuda.general_route_rows(dev)
    print(f"10b coded composite: {total / MiB:.0f} MiB in {MAPS} maps x {PARTS} partitions, "
          f"groups {groups} of {CODED_GROUP} maps, k={PARITY_K} m={PARITY_M} chunk "
          f"{PARITY_CHUNK // 1024} KiB, parity objects {parity}; write {t_write:.2f} s, "
          f"read with group {groups[1]} lost {t_read:.2f} s; reconstructions "
          f"{reader.reconstructions}; launches: write {json.dumps(write_launches)}, "
          f"write+read {json.dumps(launches)}; K3 general-route rows: {general}")
    assert groups == [0, CODED_GROUP], groups
    assert parity == [f"shuffle_1_comp_{g}_par{s}.parity" for g in groups
                      for s in range(PARITY_M)], parity
    for name in ("crc_fold", "tlz_planes", "gf_encode"):
        assert write_launches[name] > 0, f"10b: kernel {name} was not launched on the write"
    assert launches["tlz_decode_fused"] > write_launches["tlz_decode_fused"], \
        "10b: K3 was not launched on the read"
    assert reader.reconstructions >= PARTS, reader.reconstructions
    assert general == 0, "10b: validated rows took K3's general route"
    manager.stop()
    assert not files_under(root), "10b: stop() with cleanup left objects behind"
    return launches, {"write_s": t_write, "read_s": t_read, "groups": groups,
                      "reconstructions": reader.reconstructions,
                      "write_launches": write_launches}


# --- phase 11: the skew plane and straggler speculation ------------------------

def skew_rows(seed: int):
    """Phase 11a's input, as bench.py's skew probe shapes it: per map a
    RecordBatch of SKEW_BASE bytes of unique keys over every partition,
    SKEW_DUP bytes cycling SKEW_HOT_KEYS keys of one partition (hot by
    duplicates) and SKEW_BULK bytes of unique keys of another (hot by
    volume). Values are SKEW_VAL_COLS random int32-range int64 columns.
    Returns the batches, the two hot partitions and every row's key and
    values (for the numpy recomputation)."""
    import struct

    import numpy as np

    from s3shuffle_tpu_torch.batch import RecordBatch
    from s3shuffle_tpu_torch.dependency import BytesHashPartitioner

    part_fn = BytesHashPartitioner(SKEW_PARTS)
    rng = np.random.default_rng(seed)

    def batch_of(keys, vals):
        return RecordBatch.from_fixed(
            len(keys), 8, 8 * SKEW_VAL_COLS,
            np.ascontiguousarray(keys, dtype=">i8").view(np.uint8).reshape(-1),
            np.ascontiguousarray(vals, dtype="<i8").view(np.uint8).reshape(-1))

    def pid_of(i: int) -> int:
        return part_fn(struct.pack(">q", i))

    pid_dup = pid_of(1)
    pid_bulk, probe = pid_dup, 2
    while pid_bulk == pid_dup:
        pid_bulk, probe = pid_of(probe), probe + 1
    dup_keys, i = [], 1 << 20
    while len(dup_keys) < SKEW_HOT_KEYS:
        if pid_of(i) == pid_dup:
            dup_keys.append(i)
        i += 1
    batches, all_keys, all_vals = [], [], []
    for _m in range(SKEW_MAPS):
        uniform = rng.integers(1 << 40, 1 << 50, SKEW_BASE // SKEW_ROW)
        n_dup = SKEW_DUP // SKEW_ROW
        dup = np.asarray(dup_keys, np.int64)[np.arange(n_dup) % SKEW_HOT_KEYS]
        n_bulk = SKEW_BULK // SKEW_ROW
        kept, total = [], 0
        while total < n_bulk:  # unique keys of the bulk partition, by rejection
            cand = rng.integers(1 << 50, 1 << 60, n_bulk * SKEW_PARTS // 2)
            pids = part_fn.partition_batch(batch_of(cand, np.zeros((len(cand), SKEW_VAL_COLS))))
            sel = cand[np.asarray(pids) == pid_bulk]
            kept.append(sel)
            total += len(sel)
        keys = np.concatenate([uniform, dup, np.concatenate(kept)[:n_bulk]])
        vals = rng.integers(-(1 << 31), 1 << 31, (len(keys), SKEW_VAL_COLS))
        batches.append(batch_of(keys, vals))
        all_keys.append(keys)
        all_vals.append(vals)
    return batches, pid_dup, pid_bulk, np.concatenate(all_keys), np.concatenate(all_vals)


def sums_by_key(keys, vals):
    """The aggregation computed apart from the port: (sorted unique keys,
    their column sums) by a stable argsort and np.add.reduceat."""
    import numpy as np

    order = np.argsort(keys, kind="stable")
    k = keys[order]
    starts = np.flatnonzero(np.r_[True, k[1:] != k[:-1]])
    return k[starts], np.add.reduceat(vals[order], starts, axis=0)


def aggregated(outs):
    """Reduce tasks' result batches as (sorted keys, sums), like
    :func:`sums_by_key`."""
    import numpy as np

    keys, vals = [], []
    for batches in outs:
        for b in batches:
            if b.n:
                keys.append(np.asarray(b.keys).view(">i8").astype(np.int64))
                vals.append(np.asarray(b.values).view("<i8").reshape(b.n, SKEW_VAL_COLS))
    keys, vals = np.concatenate(keys), np.concatenate(vals)
    order = np.argsort(keys, kind="stable")
    keys, vals = keys[order], vals[order]
    assert (keys[1:] != keys[:-1]).all(), "a key came out of two reduce tasks"
    return keys, vals


class SkewMode:
    """One mode of phase 11a: the skewed maps written once (WORKERS map
    threads) under ``knobs``, then read in rounds by SKEW_PARTS reduce
    tasks at once."""

    def __init__(self, label, batches, dev, root, knobs):
        from concurrent.futures import ThreadPoolExecutor

        import torch

        from s3shuffle_tpu_torch import ShuffleConfig, ShuffleManager
        from s3shuffle_tpu_torch.colagg import ColumnarAggregator
        from s3shuffle_tpu_torch.dependency import BytesHashPartitioner, ShuffleDependency
        from s3shuffle_tpu_torch.serializer import ColumnarKVSerializer

        self.label = label
        # the straggler race off: 11a isolates the three skew prongs (11b
        # runs the race)
        cfg = ShuffleConfig(root_dir=f"file://{root}", checksum_algorithm="CRC32C",
                            codec_block_size=BLOCK, codec_batch_blocks=BATCH,
                            parity_segments=PARITY_M, parity_stripe_k=PARITY_K,
                            parity_chunk_bytes=PARITY_CHUNK, speculative_read_quantile=0.0,
                            **knobs)
        fresh_dispatchers()
        self.manager = ShuffleManager(cfg, device=dev)
        self.counting = count_store(self.manager.dispatcher)
        dep = ShuffleDependency(0, BytesHashPartitioner(SKEW_PARTS),
                                serializer=ColumnarKVSerializer(),
                                aggregator=ColumnarAggregator(("sum",) * SKEW_VAL_COLS))
        self.handle = self.manager.register_shuffle(0, dep)

        def write(m):
            writer = self.manager.get_writer(self.handle, m)
            writer.write(batches[m])
            writer.stop(success=True)

        t0 = time.perf_counter()
        with ThreadPoolExecutor(WORKERS) as pool:
            list(pool.map(write, range(len(batches))))
        torch.cuda.synchronize()
        self.write_s = time.perf_counter() - t0
        self.stored = {kind: sum(os.path.getsize(f) for f in files_under(root)
                                 if f.endswith("." + kind))
                       for kind in ("data", "parity", "index")}
        self.locations = [self.manager.helper.resolve_map_location(0, m)
                          for m in range(len(batches))]
        self.walls = []
        self.gets = []
        self.peaks = {}
        self.out = None

    def reduce(self, rid):
        return self.manager.get_reader(self.handle, rid, rid + 1).read_result_batches()

    def run_round(self):
        """SKEW_PARTS reduce tasks at once; the output must equal every
        earlier round's."""
        from concurrent.futures import ThreadPoolExecutor

        from s3shuffle_tpu_torch.skew import OBJECT_GETS

        OBJECT_GETS.reset_peaks()
        before = dict(self.counting.gets)
        walls, outs = [0.0] * SKEW_PARTS, [None] * SKEW_PARTS

        def task(rid):
            t0 = time.perf_counter()
            outs[rid] = self.reduce(rid)
            walls[rid] = time.perf_counter() - t0

        with ThreadPoolExecutor(SKEW_PARTS) as pool:
            list(pool.map(task, range(SKEW_PARTS)))
        self.walls.append(walls)
        self.gets.append({k: v - before.get(k, 0) for k, v in self.counting.gets.items()
                          if v - before.get(k, 0)})
        for m in range(SKEW_MAPS):
            name = f"shuffle_0_{m}_0.data"
            self.peaks[name] = max(self.peaks.get(name, 0), OBJECT_GETS.peak(name))
        out = aggregated(outs)
        if self.out is None:
            self.out = out
        import numpy as np

        assert all(np.array_equal(a, b) for a, b in zip(out, self.out)), \
            f"11a {self.label}: a round's output drifted"

    def single_task_gets(self, rid):
        """One reduce task alone: its output and its GETs by kind."""
        before = dict(self.counting.gets)
        out = self.reduce(rid)
        return out, {k: v - before.get(k, 0) for k, v in self.counting.gets.items()
                     if v - before.get(k, 0)}


def skewed_aggregation(seed: int, dev, root: str):
    """Phase 11a, with the port's metrics registry on. Returns the launches
    (every write and read of both modes, the deterministic fan-out check
    included) and the numbers."""
    from s3shuffle_tpu_torch.metrics import registry as reg

    reg.REGISTRY.reset_values()
    reg.enable()
    try:
        return _skewed_aggregation(seed, dev, root)
    finally:
        reg.disable()
        reg.REGISTRY.reset_values()


def _skewed_aggregation(seed: int, dev, root: str):
    import numpy as np
    import torch

    from s3shuffle_tpu_torch.metrics import registry as reg
    from s3shuffle_tpu_torch.ops import _build
    from s3shuffle_tpu_torch.skew import OBJECT_GETS

    t0 = time.perf_counter()
    batches, pid_dup, pid_bulk, keys, vals = skew_rows(seed)
    rows = len(keys)
    want = sums_by_key(keys, vals)
    del keys, vals
    gen_s = time.perf_counter() - t0
    _build.reset_launches()
    modes = {"off": SkewMode("off", batches, dev, f"{root}-off", {k: 0 for k in SKEW_ON})}
    off_counters = {name: _counter_total(reg, name) for name in (
        "shuffle_map_combine_rows_total", "shuffle_partition_splits_total")}
    modes["on"] = SkewMode("on", batches, dev, f"{root}-on", SKEW_ON)
    del batches
    for _round in range(SKEW_ROUNDS):
        for mode in modes.values():
            mode.run_round()
    off, on = modes["off"], modes["on"]
    for mode in (off, on):
        assert all(np.array_equal(a, b) for a, b in zip(mode.out, want)), \
            f"11a {mode.label}: the aggregation differs from numpy's"
    # the hot-by-volume partition's reduce alone: its output and data GETs
    # per mode
    alone = {label: mode.single_task_gets(pid_bulk) for label, mode in modes.items()}
    single = {label: gets for label, (_out, gets) in alone.items()}
    # the deterministic fan-out check: hot_read_fanout GETs held on map 0's
    # data object around one reduce task of the on mode
    fan0 = _counter_total(reg, "shuffle_hot_fanout_reads_total")
    hot = "shuffle_0_0_0.data"
    for _ in range(SKEW_ON["hot_read_fanout"]):
        OBJECT_GETS.start(hot)
    try:
        held_out, held_gets = on.single_task_gets(pid_bulk)
    finally:
        for _ in range(SKEW_ON["hot_read_fanout"]):
            OBJECT_GETS.finish(hot)
    fanned = _counter_total(reg, "shuffle_hot_fanout_reads_total") - fan0
    torch.cuda.synchronize()
    launches = dict(_build.LAUNCHES)
    assert all(np.array_equal(a, b) for a, b in zip(aggregated([held_out]),
                                                    aggregated([alone["on"][0]]))), \
        "11a: the reduce task with held GETs read other sums"
    counters = {name: _counter_total(reg, name) for name in (
        "shuffle_map_combine_rows_total", "shuffle_partition_splits_total",
        "shuffle_hot_fanout_reads_total")}

    def walls(mode):
        flat = [w for r in mode.walls for w in r]
        best = [min(r[i] for r in mode.walls) for i in range(SKEW_PARTS)]
        return {"p50_s": statistics.median(best), "max_s": max(best),
                "rounds_max_s": max(flat)}

    numbers = {
        "rows": rows, "raw_mib": rows * SKEW_ROW / MiB, "generate_s": gen_s,
        "pid_dup": pid_dup, "pid_bulk": pid_bulk, "output_keys": int(len(want[0])),
        "counters": counters, "off_mode_write_counters": off_counters,
        "fanout_held": fanned, "launches": launches,
    }
    for label, mode in modes.items():
        numbers[label] = {
            "write_s": mode.write_s, "walls": walls(mode), "round_walls": mode.walls,
            "gets_by_round": mode.gets, "peaks": mode.peaks, "stored": mode.stored,
            "bulk_task_gets": single[label],
            "split_bytes": sorted({loc.split_bytes for loc in mode.locations}),
            "combined_maps": sum(loc.combined for loc in mode.locations),
        }
        print(f"11a {label}: {SKEW_MAPS} maps x {SKEW_PARTS} partitions, {rows} rows "
              f"({rows * SKEW_ROW / MiB:.0f} MiB raw), knobs "
              f"{json.dumps(SKEW_ON if label == 'on' else {k: 0 for k in SKEW_ON})}; write "
              f"{mode.write_s:.2f} s; stored {json.dumps(mode.stored)}; reduce walls over "
              f"{SKEW_PARTS} concurrent tasks (best of {SKEW_ROUNDS} rounds) p50 "
              f"{walls(mode)['p50_s']:.3f} s, max {walls(mode)['max_s']:.3f} s; data GETs by "
              f"round {json.dumps(mode.gets)}; peak GETs per data object "
              f"{json.dumps(mode.peaks)}; the hot-by-volume partition {pid_bulk} alone: GETs "
              f"{json.dumps(single[label])}")
    print(f"11a: outputs equal between the modes and to numpy ({len(want[0])} keys); counters "
          f"{json.dumps(counters)}; held {SKEW_ON['hot_read_fanout']} GETs on {hot} around "
          f"partition {pid_bulk}'s reduce: {fanned:.0f} hot fan-out reads, GETs "
          f"{json.dumps(held_gets)}; launches {json.dumps(launches)}")
    assert counters["shuffle_map_combine_rows_total"] > 0, counters
    assert counters["shuffle_partition_splits_total"] > 0, counters
    assert not any(off_counters.values()), f"11a: a prong engaged with the knobs at 0: {off_counters}"
    assert on.locations[0].split_bytes == SKEW_ON["split_threshold_bytes"], on.locations[0]
    assert single["on"].get("data", 0) > SKEW_MAPS, single["on"]
    assert fanned >= 1, "11a: no hot fan-out read with the object held hot"
    for name in ("crc_fold", "tlz_planes", "tlz_decode_fused", "gf_encode"):
        assert launches.get(name, 0) > 0, f"11a: kernel {name} was not launched"
    for mode in modes.values():
        mode.manager.stop()
    return launches, numbers


def _counter_total(reg, name) -> float:
    snap = reg.REGISTRY.snapshot(compact=True)
    return sum(float(s.get("value", 0)) for s in snap.get(name, {}).get("series", []))


def _counter_total_labels(reg, name, **labels) -> float:
    snap = reg.REGISTRY.snapshot(compact=True)
    return sum(float(s.get("value", 0)) for s in snap.get(name, {}).get("series", [])
               if all(s.get("labels", {}).get(k) == v for k, v in labels.items()))


def straggler_speculation(seed: int, total_mib: int, dev, root: str):
    """Phase 11b: 5a's TeraSort at ``total_mib``, coded k2m2, at
    ``speculative_read_quantile=SPEC_QUANTILE``: a fault-free warm-up with
    the registry on, the same with map SPEC_MAP's data-object reads delayed
    SPEC_DELAY_S below the retry layer, and that again with the registry
    off. Returns each run's launches and the numbers."""
    from s3shuffle_tpu_torch.coding.degraded import MIN_FILL_SAMPLES
    from s3shuffle_tpu_torch.metrics import registry as reg
    from s3shuffle_tpu_torch.read.prefetch import fill_size_class
    from s3shuffle_tpu_torch.storage.fault import FlakyBackend, LatencyRule

    parts = terasort_parts(seed, total_mib * MiB)
    input_rows = sort_rows(rows_of(parts))
    knobs = dict(parity_segments=PARITY_M, parity_stripe_k=PARITY_K,
                 parity_chunk_bytes=PARITY_CHUNK, speculative_read_quantile=SPEC_QUANTILE)
    rules = []

    def straggling(dispatcher):
        rule = LatencyRule("read", match=f"shuffle_0_{SPEC_MAP}_0.data", delay_s=SPEC_DELAY_S)
        rules.append(rule)
        flaky = FlakyBackend(retry_layer(dispatcher).inner)
        flaky.add_latency(rule)
        return count_store(dispatcher, inner=flaky)

    runs, launches = {}, {}
    reg.REGISTRY.reset_values()
    reg.enable()
    try:
        launches["warm-up"], wall, read = record_path(
            "11b warm-up", parts, input_rows, dev, f"{root}-warm", bypass=200, **knobs)
        hist = reg.REGISTRY.histogram("read_prefetch_fill_per_mib_seconds",
                                      labelnames=("size_class",))
        block = read["remote_bytes_read"] // max(1, read["remote_blocks_fetched"])
        size_class = fill_size_class(block)
        samples = hist.labels(size_class=size_class).read().count
        runs["warm-up"] = dict(read, wall_s=wall, size_class=size_class, samples=samples)
        print(f"11b warm-up: prefills of ~{block} bytes fall in size class {size_class}, which "
              f"now holds {samples} samples (a threshold needs {MIN_FILL_SAMPLES})")
        assert samples >= MIN_FILL_SAMPLES, (size_class, samples)
        launches["straggler"], wall, read = record_path(
            "11b straggler", parts, input_rows, dev, f"{root}-straggler", bypass=200,
            stack=straggling, **knobs)
        raced = _counter_total(reg, "shuffle_parity_speculative_reads_total")
        runs["straggler"] = dict(read, wall_s=wall, raced=raced, delayed=rules[-1].hits)
        print(f"11b straggler: map {SPEC_MAP}'s data-object reads delayed {SPEC_DELAY_S} s "
              f"({rules[-1].hits} delayed reads); wall {wall:.2f} s beside the warm-up's "
              f"{runs['warm-up']['wall_s']:.2f} s; races {raced:.0f}, won (reconstructions) "
              f"{read['reconstructions']}; GETs {json.dumps(read['gets'])}")
        assert raced >= 1, "11b: the straggler was not raced"
        assert read["reconstructions"] >= 1, "11b: no race was won"
        reg.disable()
        launches["registry off"], wall, read = record_path(
            "11b registry off", parts, input_rows, dev, f"{root}-off", bypass=200,
            stack=straggling, **knobs)
        runs["registry off"] = dict(read, wall_s=wall, delayed=rules[-1].hits)
        print(f"11b registry off: the same straggler ({rules[-1].hits} delayed reads); wall "
              f"{wall:.2f} s; reconstructions {read['reconstructions']}; GETs "
              f"{json.dumps(read['gets'])}")
        assert read["gets"].get("parity", 0) == 0, "11b: a parity GET with the registry off"
        assert read["reconstructions"] == 0, "11b: a reconstruction with the registry off"
    finally:
        reg.disable()
        reg.REGISTRY.reset_values()
    return launches, runs


# --- phase 12: the online autotuner -------------------------------------------

class TunerTrace:
    """Each tuner's rungs after every cost sample it took, and each map
    writer's chunk rows, by wrapping the tuners' sample hook and the map
    writers' chunk-rows consult while in use. An instrument of this script,
    not a feature of the port."""

    def __enter__(self):
        import collections
        import threading

        from s3shuffle_tpu_torch.tuning import tuners
        from s3shuffle_tpu_torch.write.spill_writer import MapWriterBase

        self.samples = {"ScanTuner": [], "CommitTuner": []}
        self.chunk_rows = collections.defaultdict(set)  # (shuffle, map) -> rows
        self._lock = threading.Lock()
        self._tuner_cls, self._writer_cls = tuners._BaseTuner, MapWriterBase
        self._observe = tuners._BaseTuner._observe_cost
        self._rows = MapWriterBase._chunk_rows

        def observe(tuner, cost, _real=self._observe):
            _real(tuner, cost)
            with self._lock:
                self.samples[type(tuner).__name__].append(tuner.overrides())

        def chunk_rows(writer, _real=self._rows):
            rows = _real(writer)
            with self._lock:
                self.chunk_rows[(writer.handle.shuffle_id, writer.map_id)].add(rows)
            return rows

        tuners._BaseTuner._observe_cost = observe
        MapWriterBase._chunk_rows = chunk_rows
        return self

    def __exit__(self, *exc):
        self._tuner_cls._observe_cost = self._observe
        self._writer_cls._chunk_rows = self._rows

    def trajectory(self, tuner: str, start: dict) -> dict:
        """Per knob, the values it took in order (each change once)."""
        out = {k: [v] for k, v in start.items()}
        for sample in self.samples[tuner]:
            for k, v in sample.items():
                if out[k][-1] != v:
                    out[k].append(v)
        return out


def digests_by_map(digests: dict, shuffle_id: int) -> dict:
    """``object_digests`` of one shuffle keyed by (map, object kind)."""
    out = {}
    for path, digest in digests.items():
        name = path.rsplit("/", 1)[-1]
        prefix = f"shuffle_{shuffle_id}_"
        if name.startswith(prefix):
            stem, kind = name.rsplit(".", 1)
            out[(int(stem[len(prefix):].split("_")[0]), kind)] = digest
    return out


def _decisions(reg) -> dict:
    snap = reg.REGISTRY.snapshot(compact=True)
    out = {}
    for series in snap.get("tune_decisions_total", {}).get("series", []):
        labels = series["labels"]
        out.setdefault(labels["knob"], {})[labels["direction"]] = int(series["value"])
    return out


def autotuned_terasort(parts, input_rows, dev, root: str, digests_5a: dict, read_5a: dict,
                       wall_5a: float):
    """Phase 12, with the port's metrics registry on: 12a the autotuned
    TeraSort, 12b its warm start, 12c 5a with the registry on and autotune
    off. Returns each run's launches and the phase's numbers."""
    from s3shuffle_tpu_torch.metrics import registry as reg

    reg.REGISTRY.reset_values()
    reg.enable()
    try:
        return _autotuned_terasort(parts, input_rows, dev, root, digests_5a, read_5a, wall_5a)
    finally:
        reg.disable()
        reg.REGISTRY.reset_values()


def _autotuned_terasort(parts, input_rows, dev, root, digests_5a, read_5a, wall_5a):
    import torch

    from s3shuffle_tpu_torch import ShuffleConfig, ShuffleContext, ShuffleManager
    from s3shuffle_tpu_torch.metrics import registry as reg
    from s3shuffle_tpu_torch.ops import _build, tlz_cuda
    from s3shuffle_tpu_torch.serializer import ColumnarKVSerializer
    from s3shuffle_tpu_torch.tuning import CommitTuner, ScanTuner, tuner_state

    n_records = sum(p.n for p in parts)
    profile_path = os.path.join(os.path.dirname(root), "autotune-profile.json")
    base = dict(checksum_algorithm="CRC32C", codec_block_size=BLOCK, codec_batch_blocks=BATCH)
    tuned = dict(base, autotune=True, autotune_interval_s=0.0,
                 autotune_profile_path=profile_path)
    launches, numbers = {}, {}
    maps_5a = digests_by_map(digests_5a, 0)

    def context(label):
        cfg = ShuffleConfig(root_dir=f"file://{root}-{label}", **tuned)
        fresh_dispatchers()
        manager = ShuffleManager(cfg, bypass_merge_threshold=200, device=dev)
        return ShuffleContext(manager=manager, num_workers=WORKERS), count_store(manager.dispatcher)

    def sort_once(ctx, label, counting, sid):
        counting.gets.clear()
        _build.reset_launches()
        tlz_cuda.reset_general_route_rows()
        t0 = time.perf_counter()
        out = ctx.sort_by_key(parts, PARTS, serializer=ColumnarKVSerializer(),
                              materialize="batches", cleanup=False)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = dict(_build.LAUNCHES)
        general = tlz_cuda.general_route_rows(dev)
        digests = digests_by_map(object_digests(f"{root}-{label}"), sid)
        ctx.manager.unregister_shuffle(sid)
        teravalidate(out, n_records, input_rows)
        for name in UNCODED_KERNELS:
            assert counts.get(name, 0) > 0, f"{label} run {sid}: kernel {name} was not launched"
        assert general == 0, f"{label}: validated rows took K3's general route"
        return counts, wall, digests, dict(counting.gets)

    # --- 12a: AUTOTUNE_RUNS runs through one context, the loop live ---
    with TunerTrace() as trace:
        ctx, counting = context("12a")
        disp = ctx.manager.dispatcher
        start = {"ScanTuner": disp.scan_tuner.overrides(),
                 "CommitTuner": disp.commit_tuner.overrides()}
        ladder = {type(t).__name__: {k.field: (k.controller.lo, k.controller.hi)
                                     for k in t._knobs}
                  for t in (disp.scan_tuner, disp.commit_tuner)}
        # the ladder knobs that shape stored bytes at 5a's settings: the
        # composite and skew knobs are off their ladders (their planes are
        # off), the chunk rows are on (columnar=1, rows > 1)
        shaping = {"columnar_batch_rows", "composite_commit_maps", "composite_flush_bytes",
                   "combine_threshold_bytes", "split_threshold_bytes"}
        on_ladder = sorted(shaping & set(ladder["CommitTuner"]))
        assert on_ladder == ["columnar_batch_rows"], on_ladder
        static_rows = start["CommitTuner"]["columnar_batch_rows"]
        runs, total = [], {}
        for sid in range(AUTOTUNE_RUNS):
            counts, wall, digests, gets = sort_once(ctx, "12a", counting, sid)
            for k, v in counts.items():
                total[k] = total.get(k, 0) + v
            at_static = sorted(m for (s_id, m), rows in trace.chunk_rows.items()
                               if s_id == sid and rows == {static_rows})
            same = [m for m in at_static
                    if all(digests.get((m, kind)) == maps_5a.get((m, kind))
                           for kind in ("data", "index", "checksum"))]
            equal_all = sum(digests.get(key) == d for key, d in maps_5a.items())
            runs.append({"wall_s": wall, "launches": counts, "gets": gets,
                         "maps_at_static_rows": at_static, "objects_equal_to_5a": equal_all,
                         "chunk_rows": {m: sorted(rows) for (s_id, m), rows
                                        in sorted(trace.chunk_rows.items()) if s_id == sid}})
            print(f"12a run {sid}: wall {wall:.2f} s (5a {wall_5a:.2f} s); TeraValidate and "
                  f"rows: ok; GETs {json.dumps(gets)}; maps written at the static "
                  f"{static_rows} chunk rows {at_static}; objects equal to 5a's "
                  f"{equal_all} of {len(maps_5a)}; launches {json.dumps(counts)}")
            assert same == at_static, \
                f"12a run {sid}: maps {sorted(set(at_static) - set(same))} at the static " \
                f"rungs differ from 5a's objects"
        ctx.stop()
        saved = {"ScanTuner": tuner_state(disp.scan_tuner),
                 "CommitTuner": tuner_state(disp.commit_tuner)}
        trajectories = {name: trace.trajectory(name, start[name]) for name in start}
        samples = {name: len(v) for name, v in trace.samples.items()}
    assert os.path.exists(profile_path), "12a: stop() wrote no profile"
    decisions = _decisions(reg)
    moved = sum(v for d in decisions.values() for k, v in d.items() if k != "hold")
    held = sum(d.get("hold", 0) for d in decisions.values())
    clamps = {"ScanTuner": ScanTuner.CLAMPS, "CommitTuner": CommitTuner.CLAMPS}
    for name, knobs in trajectories.items():
        for knob, values in knobs.items():
            lo, hi = clamps[name][knob]
            if knob == "max_buffer_size_task":
                hi = start[name][knob]  # a memory cap: tuned down only
            assert all(lo <= v <= hi for v in values), f"12a: {knob} left its clamps: {values}"
            print(f"12a {name} {knob}: rungs {values} (clamps {lo}-{hi})")
    print(f"12a: {samples} cost samples; tune_decisions_total {json.dumps(decisions)}; "
          f"{moved} decisions moved a rung, {held} held")
    assert moved >= 1, "12a: no rung moved"
    launches["12a"] = total
    numbers["12a"] = {"runs": runs, "trajectories": trajectories, "decisions": decisions,
                      "moved": moved, "held": held, "samples": samples,
                      "wall_s": sum(r["wall_s"] for r in runs)}

    # --- 12b: a fresh context warm-starts from 12a's profile ---
    ctx, counting = context("12b")
    disp = ctx.manager.dispatcher
    warm = {"ScanTuner": tuner_state(disp.scan_tuner),
            "CommitTuner": tuner_state(disp.commit_tuner)}
    print(f"12b: rungs saved by 12a's stop() {json.dumps(saved)}")
    print(f"12b: rungs of the fresh context   {json.dumps(warm)}")
    assert warm == saved, "12b: the fresh context did not start from 12a's rungs"
    counts, wall, _digests, gets = sort_once(ctx, "12b", counting, 0)
    ctx.stop()
    print(f"12b: wall {wall:.2f} s; TeraValidate and rows: ok; GETs {json.dumps(gets)}")
    launches["12b"] = counts
    numbers["12b"] = {"saved": saved, "warm": warm, "wall_s": wall, "gets": gets}

    # --- 12c: 5a with the registry on and autotune off ---
    reg.REGISTRY.reset_values()
    digests = {}
    root_c = f"{root}-12c"
    launches["12c"], wall, read = record_path(
        "12c registry on", parts, input_rows, dev, root_c, bypass=200,
        after=lambda _m: digests.update(object_digests(root_c)))
    read_bytes = reg.read_counter_total("storage_read_bytes_total")
    get_bytes_5a = sum(read_5a["get_bytes"].values())
    print(f"12c: wall {wall:.2f} s with the registry on against 5a's {wall_5a:.2f} s off "
          f"({100 * (wall / wall_5a - 1):+.1f} %); GETs {json.dumps(read['gets'])} (5a "
          f"{json.dumps(read_5a['gets'])}); storage_read_bytes_total {read_bytes:.0f}, 5a's "
          f"GETs returned {get_bytes_5a}")
    assert read["gets"] == read_5a["gets"], "12c: the instrumented store changed the GETs"
    assert digests == digests_5a, "12c: objects differ from 5a's"
    assert read_bytes == get_bytes_5a == sum(read["get_bytes"].values()), \
        (read_bytes, get_bytes_5a, read["get_bytes"])
    numbers["12c"] = dict(read, wall_s=wall, wall_5a_s=wall_5a,
                          storage_read_bytes_total=read_bytes)
    return launches, numbers


def obs_reset() -> None:
    """The port's tracer off and empty with the flight ring at its default,
    the metrics registry off and zero, the stats collector empty."""
    from s3shuffle_tpu_torch.metrics import registry as reg
    from s3shuffle_tpu_torch.metrics.stats import COLLECTOR
    from s3shuffle_tpu_torch.utils import trace

    trace.disable()
    trace.reset()
    trace.configure_flight(dir="", ring=trace.FLIGHT_RING_DEFAULT, worker_id="")
    reg.disable()
    reg.REGISTRY.reset_values()
    COLLECTOR.reset()


def obs_mode(mode: str, trace_path: str, annotations: bool = False) -> None:
    """Phase 13's modes: ``off`` (no tracing, flight ring 0, registry off),
    ``flight`` (the ring at its default only) and ``full`` (tracing onto
    ``trace_path``, the registry on, the stats collector recording)."""
    from s3shuffle_tpu_torch.metrics import registry as reg
    from s3shuffle_tpu_torch.utils import trace

    obs_reset()
    if mode == "off":
        trace.configure_flight(ring=0)
    elif mode == "full":
        trace.enable(trace_path, torch_annotations=annotations)
        reg.enable()


def observability(seed: int, dev, root: str):
    """Phase 13: 13a the overhead pairs with 13b's checks on every
    full-mode run, then 13c under the profiler. The trace, flight,
    registry and collector state is reset whatever happens."""
    try:
        return _observability(seed, dev, root)
    finally:
        obs_reset()


def _span_names(doc: dict):
    import collections

    return collections.Counter(
        (e["name"], e.get("args", {}).get("op")) for e in doc["traceEvents"] if e["ph"] == "X")


def _full_mode_checks(label: str, doc: dict, report, snapshot: dict, data_bytes: int,
                      n_records: int, get_bytes: int) -> dict:
    """13b: what the plane recorded on one full-mode run."""
    names = _span_names(doc)
    for op in ("read", "open", "create"):
        assert names[("storage.op", op)] > 0, f"{label}: no storage.op {op} span"
    for name in ("read.prefetch", "read.index_prefetch", "write.upload_chunk"):
        assert names[(name, None)] > 0, f"{label}: no {name} span"
    assert names[("write.commit", None)] == MAPS, names
    ids = {e["args"]["span_id"] for e in doc["traceEvents"] if e["ph"] == "X"}
    orphans = [e["name"] for e in doc["traceEvents"]
               if e["ph"] == "X" and e["args"].get("parent_id", next(iter(ids))) not in ids]
    assert not orphans, f"{label}: spans with a parent outside the document: {orphans[:5]}"
    counters = doc["otherData"]["counters"]
    # the batch route (read_result_batches -> read_batches) never enters
    # read(), where the JAX package counts reduce tasks; 13c counts them
    assert "read.tasks" not in counters, counters

    def counter(name):
        return sum(s.get("value", 0) for s in snapshot.get(name, {}).get("series", []))

    def count(name):
        return sum(s.get("count", 0) for s in snapshot.get(name, {}).get("series", []))

    chunked = counter("read_chunked_prefills_total")
    assert names[("read.chunked_prefill", None)] == chunked, (names, chunked)
    assert (report.map_tasks, report.reduce_tasks) == (MAPS, PARTS), report
    assert report.bytes_written == data_bytes, (report.bytes_written, data_bytes)
    assert report.records_written == report.records_read == n_records, report
    for name in ("codec_encode_batch_seconds", "codec_decode_batch_seconds",
                 "read_checksum_validate_seconds"):
        assert count(name) > 0, f"{label}: {name} observed nothing"
    assert count("write_commit_seconds") == MAPS, count("write_commit_seconds")
    assert counter("codec_fused_crc_validated_total") > 0, label
    assert counter("storage_read_bytes_total") == get_bytes, \
        (counter("storage_read_bytes_total"), get_bytes)
    return {"spans": {f"{n}{'' if op is None else ' ' + op}": c for (n, op), c
                      in sorted(names.items(), key=lambda kv: (kv[0][0], kv[0][1] or ""))},
            "counters": counters, "chunked_prefills": chunked,
            "report": {k: v for k, v in report.to_dict().items() if k != "metrics"},
            "registry": {name: count(name) or counter(name) for name in (
                "codec_encode_batch_seconds", "codec_decode_batch_seconds",
                "codec_assembly_seconds", "codec_frames_total", "codec_fused_crc_total",
                "codec_fused_crc_validated_total", "read_checksum_validate_seconds",
                "write_commit_seconds", "write_upload_seconds", "record_rows_total",
                "storage_read_bytes_total")}}


def _observability(seed: int, dev, root: str):
    import torch

    from s3shuffle_tpu_torch.metrics import registry as reg
    from s3shuffle_tpu_torch.metrics.stats import COLLECTOR
    from s3shuffle_tpu_torch.utils import trace

    parts = terasort_parts(seed, OBS_MIB * MiB)
    input_rows = sort_rows(rows_of(parts))
    n_records = sum(p.n for p in parts)
    schedule = [(mode, False) for mode in OBS_MODES]
    for r in range(OBS_ROUNDS):
        schedule += [(mode, True) for mode in (OBS_MODES if r % 2 == 0 else OBS_MODES[::-1])]
    walls = {mode: [] for mode in OBS_MODES}
    shas, digests, launches, checks = set(), {}, {}, []
    for i, (mode, timed) in enumerate(schedule):
        label = f"13a {mode} {'run' if timed else 'warm-up'} {i}"
        run_root = os.path.join(root, f"{i}-{mode}")
        trace_path = os.path.join(root, f"{i}-trace.json")
        obs_mode(mode, trace_path)
        seen = {}

        def after(_manager, mode=mode, run_root=run_root, seen=seen, timed=timed):
            if not timed:
                seen["digests"] = object_digests(run_root)
            if mode == "full":
                seen["trace"] = trace.flush()
                seen["report"] = COLLECTOR.report(0)
                seen["snapshot"] = reg.REGISTRY.snapshot(compact=True)
                seen["data_bytes"] = sum(os.path.getsize(f) for f in files_under(run_root)
                                         if f.endswith(".data"))

        # the first run's rows are held against the input's; every later
        # run's against the first's, by the output SHA-256
        counts, wall, read = record_path(label, parts, input_rows if i == 0 else None, dev,
                                         run_root, bypass=200, after=after, digest=True)
        shas.add(read["out_sha256"])
        if not timed:
            digests[mode] = seen["digests"]
        else:
            walls[mode].append(wall)
            launches[f"13a {mode}"] = counts
        if mode == "full":
            with open(seen["trace"]) as f:
                doc = json.load(f)
            checks.append(_full_mode_checks(label, doc, seen["report"], seen["snapshot"],
                                            seen["data_bytes"], n_records,
                                            sum(read["get_bytes"].values())))
            print(f"{label}: trace {len(doc['traceEvents'])} events, spans "
                  f"{json.dumps(checks[-1]['spans'])}; stats report "
                  f"{json.dumps(checks[-1]['report'])}; registry "
                  f"{json.dumps(checks[-1]['registry'])}")
        obs_reset()
    assert len(shas) == 1, f"13a: the output rows differ across runs: {shas}"
    kinds = (".data", ".index", ".checksum.CRC32C")
    objects = {mode: {k: v for k, v in d.items() if k.endswith(kinds)}
               for mode, d in digests.items()}
    assert objects["off"] and objects["off"] == objects["flight"] == objects["full"], \
        "13a: the data, index and checksum objects differ across the modes"
    summary = {mode: {"walls_s": w, "min_s": min(w), "median_s": statistics.median(w)}
               for mode, w in walls.items()}
    for mode in ("flight", "full"):
        for stat in ("min", "median"):
            off = summary["off"][f"{stat}_s"]
            summary[mode][f"{stat}_overhead_pct"] = 100.0 * (summary[mode][f"{stat}_s"] / off
                                                             - 1.0)
    for mode, row in summary.items():
        extra = "" if mode == "off" else (
            f"; overhead against off: min {row['min_overhead_pct']:+.2f} %, median "
            f"{row['median_overhead_pct']:+.2f} %")
        print(f"13a {mode}: walls {', '.join(f'{w:.3f}' for w in row['walls_s'])} s; min "
              f"{row['min_s']:.3f} s, median {row['median_s']:.3f} s{extra}")
    print(f"13a: {len(schedule)} runs TeraValidated, one output SHA-256 "
          f"{next(iter(shas))[:16]}..., objects equal across {', '.join(OBS_MODES)}")
    numbers = {"13a": summary, "13b": checks[-1], "output_sha256": next(iter(shas))}
    launches["13c"], numbers["13c"] = profiled_run(seed, dev, os.path.join(root, "13c"))
    return launches, numbers


def profiled_run(seed: int, dev, root: str):
    """13c: one full-mode run with profiler annotations under
    ``torch.profiler`` (every thread recorded); the span names and K1-K3's
    kernels among the profiler's events, and the device's busy share over
    the sort's wall."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    from s3shuffle_tpu_torch import ShuffleConfig, ShuffleContext, ShuffleManager
    from s3shuffle_tpu_torch.batch import RecordBatch
    from s3shuffle_tpu_torch.ops import _build
    from s3shuffle_tpu_torch.serializer import ColumnarKVSerializer
    from s3shuffle_tpu_torch.utils import trace

    parts = terasort_parts(seed, OBS_PROFILE_MIB * MiB)
    input_rows = sort_rows(rows_of(parts))
    n_records = sum(p.n for p in parts)
    obs_mode("full", root + "-trace.json", annotations=True)
    cfg = ShuffleConfig(root_dir=f"file://{root}", checksum_algorithm="CRC32C",
                        codec_block_size=BLOCK, codec_batch_blocks=BATCH)
    fresh_dispatchers()
    ctx = ShuffleContext(manager=ShuffleManager(cfg, bypass_merge_threshold=200, device=dev),
                         num_workers=WORKERS)
    options = {}
    try:  # spans run on task, prefetch and upload threads
        from torch._C._profiler import _ExperimentalConfig

        options["experimental_config"] = _ExperimentalConfig(profile_all_threads=True)
    except (ImportError, TypeError) as e:
        print(f"13c: this torch cannot record every thread ({e}); main thread only")
    _build.reset_launches()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA], **options) as prof:
        with record_function("phase13c.sort"):
            t0 = time.perf_counter()
            out = ctx.sort_by_key(parts, PARTS, serializer=ColumnarKVSerializer(),
                                  materialize="records", cleanup=False)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
    launches = dict(_build.LAUNCHES)
    counters = trace.counters()
    ctx.stop()
    obs_reset()
    teravalidate([[RecordBatch.from_records(p)] for p in out], n_records, input_rows)
    events = prof.events()
    names = {e.name for e in events}
    for name in ("storage.op", "read.prefetch", "write.commit"):
        assert name in names, f"13c: the profiler recorded no {name} span"
    kernels = [e for e in events if e.device_type == torch.autograd.DeviceType.CUDA]
    for fn in ("crc_fold_kernel", "tlz_planes_kernel", "tlz_decode_seg_kernel"):
        assert any(fn in e.name for e in kernels), \
            f"13c: no {fn} among the profiler's device events"
    (sort_event,) = [e for e in events if e.name == "phase13c.sort"]
    lo, hi = sort_event.time_range.start, sort_event.time_range.end
    intervals = sorted((max(lo, e.time_range.start), min(hi, e.time_range.end))
                       for e in kernels if e.time_range.end > lo and e.time_range.start < hi)
    busy, cur_lo, cur_hi = 0.0, None, None
    for a, b in intervals:
        if cur_hi is None or a > cur_hi:
            if cur_hi is not None:
                busy += cur_hi - cur_lo
            cur_lo, cur_hi = a, b
        else:
            cur_hi = max(cur_hi, b)
    if cur_hi is not None:
        busy += cur_hi - cur_lo
    share = busy / (hi - lo)
    by_kernel = {}
    for e in kernels:
        key = next((fn for fn in ("crc_fold_kernel", "tlz_planes_kernel", "tlz_decode_count_kernel",
                                  "tlz_decode_seg_kernel", "tlz_decode_general_kernel")
                    if fn in e.name), "other kernels and copies")
        by_kernel[key] = by_kernel.get(key, 0.0) + (e.time_range.end - e.time_range.start)
    assert counters.get("read.tasks") == PARTS, counters
    for name in UNCODED_KERNELS:
        assert launches.get(name, 0) > 0, f"13c: kernel {name} was not launched"
    print(f"13c: TeraSort {OBS_PROFILE_MIB} MiB, records route, full mode with profiler "
          f"annotations; wall {wall:.3f} s under the profiler; TeraValidate and rows: ok; "
          f"read.tasks {counters.get('read.tasks')}; launches {json.dumps(launches)}")
    print(f"13c: device busy share (union of kernel intervals over the sort's "
          f"{(hi - lo) / 1e3:.1f} ms, taken under torch.profiler): {100 * share:.3f} % "
          f"({busy / 1e3:.3f} ms busy); device ms by kernel "
          f"{json.dumps({k: round(v / 1e3, 3) for k, v in sorted(by_kernel.items())})}")
    return launches, {"wall_s": wall, "busy_share": share, "busy_ms": busy / 1e3,
                      "window_ms": (hi - lo) / 1e3, "read_tasks": counters.get("read.tasks"),
                      "device_ms_by_kernel": {k: v / 1e3 for k, v in by_kernel.items()},
                      "all_threads": bool(options)}


# --- phase 14: the control plane ---------------------------------------------

def rpc_counts(reg) -> dict:
    """``meta_rpc_total`` as ``{"<method> <connection>": n}``."""
    metric = reg.REGISTRY.get("meta_rpc_total")
    return {f"{s['labels']['method']} {s['labels']['shard']}": int(s["value"])
            for s in metric.snapshot()["series"] if s["value"]}


def by_method(counts: dict) -> dict:
    out = {}
    for key, n in counts.items():
        method = key.split(" ")[0]
        out[method] = out.get(method, 0) + n
    return out


def _meta_threads(before) -> list:
    """Threads of the metadata server, client or readers started since
    ``before`` (a set of thread idents) and still alive."""
    return sorted(t.name for t in threading.enumerate() if t.ident not in before)


def control_plane(parts, input_rows, dev, root: str, digests_5a: dict, read_5a: dict,
                  wall_5a: float, seed: int):
    """Phase 14: the port's metadata server (``MetadataServer.from_config``
    at ``metadata_shards=4``, ``metadata_shard_endpoints=4``, in this
    process, on loopback) behind every tracker call, with the port's
    metrics registry on. When the server has stopped, no thread this phase
    started may be left. Returns the launches of 14a and 14b and the
    phase's numbers."""
    import gc

    from s3shuffle_tpu_torch import ShuffleConfig
    from s3shuffle_tpu_torch.metadata.async_client import AsyncTrackerClient
    from s3shuffle_tpu_torch.metadata.service import MetadataServer
    from s3shuffle_tpu_torch.metrics import registry as reg

    knobs = dict(metadata_shards=CONTROL_SHARDS, metadata_shard_endpoints=CONTROL_ENDPOINTS,
                 metadata_batch_max=CONTROL_BATCH)
    cfg = ShuffleConfig(**knobs)
    threads_before = {t.ident for t in threading.enumerate()}
    gc.collect()
    objects_before = len(gc.get_objects())
    server = MetadataServer.from_config(cfg).start()
    reg.REGISTRY.reset_values()
    reg.enable()
    try:
        client = AsyncTrackerClient.from_config(server.address, cfg, timeout=60.0)
        try:
            assert client.connections == 1 + CONTROL_ENDPOINTS, client.connections
            assert client.batch_max == CONTROL_BATCH, client.batch_max
            launches, numbers = service_terasort(parts, input_rows, dev, root, client, server,
                                                 digests_5a, read_5a, wall_5a, knobs)
            numbers["14c"] = tracker_state(client, server, root, seed)
        finally:
            client.close()
    finally:
        reg.disable()
        reg.REGISTRY.reset_values()
        server.stop()
    # the server's handler threads are daemons and end once their
    # connection closes: give them a moment
    deadline = time.monotonic() + 10.0
    while _meta_threads(threads_before) and time.monotonic() < deadline:
        time.sleep(0.05)
    left = _meta_threads(threads_before)
    gc.collect()
    objects_after = len(gc.get_objects())
    print(f"14: after the server stopped: threads started by the phase and alive "
          f"{json.dumps(left)}; Python objects {objects_before} before the phase, "
          f"{objects_after} after")
    assert not left, f"14: threads left behind: {left}"
    numbers["left_behind"] = {"threads": left, "objects_before": objects_before,
                              "objects_after": objects_after}
    return launches, numbers


def service_terasort(parts, input_rows, dev, root, client, server, digests_5a, read_5a,
                     wall_5a, knobs):
    """14a: 5a's TeraSort with an ``AsyncTrackerClient`` as the manager's
    tracker and the registry on; TeraValidated, K1-K3 launched, one lookup
    RPC per reduce scan, and (12c's checks) its objects and
    GETs equal to 5a's and ``storage_read_bytes_total`` equal to the bytes
    5a's GETs returned. 14b, on the written shuffle before the context
    stops: the re-read from its published snapshot."""
    from s3shuffle_tpu_torch.metrics import registry as reg

    root_a = os.path.join(root, "terasort")
    n_records = sum(p.n for p in parts)
    seen = {}

    def after(manager):
        seen["rpc"] = rpc_counts(reg)
        seen["read_bytes"] = reg.read_counter_total("storage_read_bytes_total")
        seen["digests"] = object_digests(root_a)
        seen["launches_b"], seen["14b"] = snapshot_reread(manager, client, server, dev,
                                                          n_records, input_rows)

    launches, wall, read = record_path("14a control plane", parts, input_rows, dev, root_a,
                                       bypass=200, tracker=client, after=after, digest=True,
                                       **knobs)
    rpc = seen["rpc"]
    methods = by_method(rpc)
    assert seen["digests"] == digests_5a, "14a: the objects differ from 5a's"
    get_bytes_5a = sum(read_5a["get_bytes"].values())
    assert read["gets"] == read_5a["gets"], "14a: the GETs differ from 5a's"
    assert seen["read_bytes"] == get_bytes_5a == sum(read["get_bytes"].values()), \
        (seen["read_bytes"], get_bytes_5a, read["get_bytes"])
    assert methods.get("get_map_sizes_by_ranges") == PARTS, methods
    assert "get_map_sizes_by_range" not in methods and "register_map_output" not in methods, \
        methods
    assert methods.get("register_shuffle") == 1 and methods.get("register_map_outputs", 0) >= 1
    assert seen["14b"]["out_sha256"] == read["out_sha256"], "14b: rows differ from 14a's"
    print(f"14a: meta_rpc_total by method and connection {json.dumps(rpc)}; lookup RPCs per "
          f"reduce scan {methods['get_map_sizes_by_ranges'] / PARTS:g}; wall {wall:.2f} s "
          f"beside 5a's {wall_5a:.2f} s ({100 * (wall / wall_5a - 1):+.1f} %, the registry "
          f"on); objects ({len(digests_5a)}) and GETs {json.dumps(read['gets'])} equal to "
          f"5a's; storage_read_bytes_total {seen['read_bytes']:.0f} = 5a's GET bytes")
    numbers = {
        "14a": {"wall_s": wall, "wall_5a_s": wall_5a, "rpc": rpc, "rpc_by_method": methods,
                "lookups_per_scan": methods["get_map_sizes_by_ranges"] / PARTS,
                "gets": read["gets"], "data_get_sizes": read["data_get_sizes"],
                "storage_read_bytes_total": seen["read_bytes"]},
        "14b": seen["14b"],
    }
    return {"14a": launches, "14b": seen["launches_b"]}, numbers


def snapshot_reread(manager, client, server, dev, n_records, input_rows):
    """14b: the server-side tracker's snapshot of shuffle 0, published
    through the dispatcher as ``ShuffleSnapshotBlockId``
    (``publish_snapshot``, ``metadata_snapshots`` on), pulled once by a
    ``SnapshotBackedTracker`` over the same client; every partition read
    through a manager on that tracker must make no tracker RPC, count its
    lookups as served by the snapshot, launch K3 and TeraValidate."""
    from concurrent.futures import ThreadPoolExecutor

    import torch

    from s3shuffle_tpu_torch import ShuffleManager
    from s3shuffle_tpu_torch.block_ids import ShuffleSnapshotBlockId
    from s3shuffle_tpu_torch.metadata import SnapshotBackedTracker
    from s3shuffle_tpu_torch.metadata.snapshot import publish_snapshot
    from s3shuffle_tpu_torch.metrics import registry as reg
    from s3shuffle_tpu_torch.ops import _build

    disp = manager.dispatcher
    t0 = time.perf_counter()
    epoch = publish_snapshot(server.tracker, disp, 0)
    build_s = time.perf_counter() - t0
    assert epoch == server.tracker.epoch(0), f"14b: publish_snapshot returned {epoch}"
    blob = disp.backend.read_all(disp.get_path(ShuffleSnapshotBlockId(0, epoch)))
    loads = []

    def loader(shuffle_id, want_epoch):
        loads.append(want_epoch)
        return disp.backend.read_all(disp.get_path(ShuffleSnapshotBlockId(shuffle_id,
                                                                          want_epoch)))

    facade = SnapshotBackedTracker(client, loader)
    assert facade.ensure(0, epoch) and loads == [epoch], "14b: the snapshot did not attach"
    fresh_dispatchers()
    reader_mgr = ShuffleManager(manager.config, tracker=facade, device=dev)
    reg.REGISTRY.reset_values()
    _build.reset_launches()
    t0 = time.perf_counter()
    handle = reader_mgr.register_shuffle(0, manager.handle(0).dependency)
    with ThreadPoolExecutor(WORKERS) as pool:
        out = list(pool.map(
            lambda p: reader_mgr.get_reader(handle, p, p + 1).read_result_batches(),
            range(PARTS)))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(_build.LAUNCHES)
    rpc = rpc_counts(reg)
    source = {s["labels"]["source"]: int(s["value"])
              for s in reg.REGISTRY.get("meta_lookup_source_total").snapshot()["series"]}
    reader_mgr.purge_caches(0)
    teravalidate(out, n_records, input_rows)
    sha = hashlib.sha256()
    for partition in out:
        if any(b.n for b in partition):
            sha.update(rows_of(partition).tobytes())
    assert rpc == {}, f"14b: tracker RPCs while a snapshot was attached: {rpc}"
    assert source.get("rpc", 0) == 0 and source.get("snapshot", 0) >= PARTS, source
    assert launches["tlz_decode_fused"] > 0, f"14b: K3 was not launched: {launches}"
    print(f"14b: re-read of 14a's shuffle from its snapshot (epoch {epoch}, .snapmeta "
          f"{len(blob)} bytes, built and published in {build_s * 1e3:.2f} ms): TeraValidate "
          f"ok, rows equal "
          f"to 14a's; wall {wall:.2f} s; lookups by source {json.dumps(source)}; tracker RPCs "
          f"{len(rpc)}; launches {json.dumps(launches)}")
    return launches, {"wall_s": wall, "snapmeta_bytes": len(blob), "publish_s": build_s,
                      "epoch": epoch, "lookups_by_source": source, "rpc": rpc,
                      "out_sha256": sha.hexdigest()}


def tracker_state(client, server, root: str, seed: int) -> dict:
    """14c: the control plane at the state size of a large Spark shuffle,
    ``STATE_MAPS`` maps x ``STATE_PARTS`` partitions of map statuses,
    registered from ``STATE_THREADS`` threads through the shared
    ``AsyncTrackerClient``, then one lookup RPC per reduce partition from as
    many threads for every partition, each equal to a local
    ``MapOutputTracker``'s answer; one lookup's cost split into the
    server-side tracker's answer in process, the JSON of its reply, and the
    rest; the snapshot built, published through a dispatcher, read back
    and parsed, and fetched over the ``get_snapshot`` RPC, each round trip
    exact. Host only: it launches no kernel."""
    from concurrent.futures import ThreadPoolExecutor

    import numpy as np

    from s3shuffle_tpu_torch import ShuffleConfig
    from s3shuffle_tpu_torch.block_ids import ShuffleSnapshotBlockId
    from s3shuffle_tpu_torch.metadata import MapOutputSnapshot, build_snapshot
    from s3shuffle_tpu_torch.metadata.map_output import (
        STORE_LOCATION,
        MapOutputTracker,
        MapStatus,
    )
    from s3shuffle_tpu_torch.metrics import registry as reg
    from s3shuffle_tpu_torch.ops import _build
    from s3shuffle_tpu_torch.storage.dispatcher import Dispatcher

    sid = 1
    rng = np.random.default_rng(seed + 14)
    sizes = rng.integers(0, 1 << 24, (STATE_MAPS, STATE_PARTS), dtype=np.int64)
    statuses = [MapStatus(m, STORE_LOCATION, sizes[m], map_index=m) for m in range(STATE_MAPS)]
    local = MapOutputTracker()
    local.register_shuffle(sid, STATE_PARTS)
    local.register_map_outputs(sid, statuses)
    reg.REGISTRY.reset_values()
    _build.reset_launches()
    client.register_shuffle(sid, STATE_PARTS)

    def register(chunk):
        for status in chunk:
            client.register_map_output(sid, status)

    t0 = time.perf_counter()
    with ThreadPoolExecutor(STATE_THREADS) as pool:
        list(pool.map(register, [statuses[i::STATE_THREADS] for i in range(STATE_THREADS)]))
    client.flush()
    register_s = time.perf_counter() - t0
    assert server.tracker.epoch(sid) == STATE_MAPS, server.tracker.epoch(sid)
    registrations = rpc_counts(reg)

    looked_up = range(0, STATE_PARTS, LOOKUP_STRIDE)
    t0 = time.perf_counter()
    with ThreadPoolExecutor(STATE_THREADS) as pool:
        answers = list(pool.map(
            lambda p: client.get_map_sizes_by_ranges(sid, 0, None, [(p, p + 1)])[0],
            looked_up))
    lookup_s = time.perf_counter() - t0
    for p, got in zip(looked_up, answers):
        assert got == local.get_map_sizes_by_range(sid, 0, None, p, p + 1), \
            f"14c: lookup of partition {p} differs from the local tracker's"
    # one lookup, split: the server's tracker in process (dedupe the
    # attempts, slice the sizes), then the JSON of its reply both ways; the
    # rest of an RPC is sockets, threads and the GIL
    split = range(0, STATE_PARTS, STATE_PARTS // SPLIT_LOOKUPS)
    t0 = time.perf_counter()
    in_process = [server.tracker.get_map_sizes_by_ranges(sid, 0, None, [(p, p + 1)])
                  for p in split]
    tracker_ms = (time.perf_counter() - t0) * 1e3 / len(split)
    t0 = time.perf_counter()
    for reply in in_process:
        json.loads(json.dumps({"ok": True, "result": reply}))
    json_ms = (time.perf_counter() - t0) * 1e3 / len(split)
    wall_ms = lookup_s * 1e3 / len(looked_up)  # the wall per lookup, 8 in flight
    half, lo, hi = STATE_PARTS // 2, STATE_MAPS // 20, STATE_MAPS * 9 // 20
    ranges = [(0, 7), (half, half + 1), (STATE_PARTS - 3, STATE_PARTS)]
    assert client.get_map_sizes_by_ranges(sid, lo, hi, ranges) == \
        local.get_map_sizes_by_ranges(sid, lo, hi, ranges), "14c: a batch lookup differs"

    t0 = time.perf_counter()
    snap = build_snapshot(server.tracker, sid)
    blob = snap.to_bytes()
    build_s = time.perf_counter() - t0
    disp = Dispatcher(ShuffleConfig(root_dir=f"file://{os.path.join(root, 'state')}"))
    path = disp.get_path(ShuffleSnapshotBlockId(sid, snap.epoch))
    t0 = time.perf_counter()
    with disp.backend.create(path) as sink:
        sink.write(blob)
    publish_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    parsed = MapOutputSnapshot.from_bytes(disp.backend.read_all(path))
    parse_s = time.perf_counter() - t0
    assert parsed.to_bytes() == blob and parsed.epoch == STATE_MAPS, "14c: snapshot round trip"
    assert np.array_equal(np.stack([s.sizes for _i, s in parsed.entries]), sizes)
    assert [m for m, _s in parsed.get_map_sizes_by_range(0, None, 0, 1)] == list(
        range(STATE_MAPS))
    t0 = time.perf_counter()
    rpc_epoch, rpc_blob = client.get_snapshot(sid)
    rpc_snapshot_s = time.perf_counter() - t0
    over_rpc = MapOutputSnapshot.from_bytes(rpc_blob)
    assert rpc_epoch == snap.epoch and np.array_equal(
        np.stack([s.sizes for _i, s in over_rpc.entries]), sizes), "14c: get_snapshot differs"
    client.unregister_shuffle(sid)
    disp.remove_shuffle(sid)
    assert not any(_build.LAUNCHES.values()), f"14c launched a kernel: {_build.LAUNCHES}"
    numbers = {
        "maps": STATE_MAPS, "partitions": STATE_PARTS, "threads": STATE_THREADS,
        "register_s": register_s, "registrations_per_s": STATE_MAPS / register_s,
        "registration_rpc": by_method(registrations),
        "lookups": len(looked_up), "lookup_s": lookup_s,
        "lookup_rpcs_per_s": len(looked_up) / lookup_s,
        "lookup_split_ms": {"wall_per_lookup": wall_ms, "tracker": tracker_ms,
                            "reply_json": json_ms,
                            "rest": wall_ms - tracker_ms - json_ms},
        "snapshot_bytes": len(blob), "snapshot_build_s": build_s,
        "snapshot_publish_s": publish_s, "snapshot_parse_s": parse_s,
        "get_snapshot_rpc_s": rpc_snapshot_s,
    }
    print(f"14c: {STATE_MAPS} maps x {STATE_PARTS} partitions from {STATE_THREADS} threads: "
          f"registered in {register_s:.2f} s ({numbers['registrations_per_s']:.0f}/s, RPCs "
          f"{json.dumps(numbers['registration_rpc'])}); {len(looked_up)} lookup RPCs in "
          f"{lookup_s:.2f} s ({numbers['lookup_rpcs_per_s']:.0f}/s), each equal to the local "
          f"tracker's; of the wall per lookup, {wall_ms:.2f} ms, the tracker in process takes "
          f"{tracker_ms:.2f} ms, its reply's JSON both ways {json_ms:.2f} ms and the rest "
          f"(sockets, threads, the GIL) {wall_ms - tracker_ms - json_ms:.2f} ms; snapshot {len(blob)} bytes, built in {build_s:.3f} s, published in "
          f"{publish_s:.3f} s, parsed in {parse_s:.3f} s, over get_snapshot in "
          f"{rpc_snapshot_s:.3f} s; host only, no kernel launched")
    return numbers


# --- phase 15: the worker fleet ---------------------------------------------

FLEET_WORKERS = 4
FLEET_LOST_MIB = 256
FLEET_LEASE_S = 3.0
FLEET_HEARTBEAT_S = 0.5
#: the longest wait for a worker's exit after its drain, and for the
#: fleet to register (spawn, torch import, CUDA context)
FLEET_JOIN_S = 60.0
FLEET_START_S = 180.0
FLEET_JOB_S = 600.0
#: the workers' device ("cpu" only to rehearse the phase off the card)
FLEET_DEVICE = "cuda"
#: threads of the process-wide pools an earlier phase may have started
PROCESS_POOLS = ("s3shuffle-torch-encode", "s3shuffle-torch-decode", "s3shuffle-torch-fetch",
                 "s3shuffle-torch-speculate")


def fleet_agent(coordinator, cfg_dict, worker_id, out_path, heartbeat_s, device):
    """Phase 15's worker process (started with ``spawn``): a ``WorkerAgent``
    on ``device`` (the CUDA device) until it is drained or stopped. Then it writes its
    process's kernel launches, CUDA device, tasks run and the reduce reads'
    reconstructions to ``out_path`` as JSON. A worker that cannot load the
    kernels or reach the card exits non-zero before it registers."""
    import torch

    from s3shuffle_tpu_torch.config import ShuffleConfig
    from s3shuffle_tpu_torch.ops import _build
    from s3shuffle_tpu_torch.storage.dispatcher import Dispatcher
    from s3shuffle_tpu_torch.worker import WorkerAgent

    if device != "cpu":
        _build.library()
    Dispatcher.reset()
    agent = WorkerAgent(tuple(coordinator), config=ShuffleConfig(**cfg_dict),
                        worker_id=worker_id, device=device)
    readers = []
    get_reader = agent.manager.get_reader

    def tracked_reader(*args, **kwargs):
        reader = get_reader(*args, **kwargs)
        readers.append(reader)
        return reader

    agent.manager.get_reader = tracked_reader
    _build.reset_launches()
    try:
        agent.run_forever(poll_interval=0.01, heartbeat_s=heartbeat_s)
    finally:
        agent.client.close()
    on_card = agent.manager.device.type == "cuda"
    if on_card:
        torch.cuda.synchronize()
    info = {"worker": worker_id, "pid": os.getpid(), "device": str(agent.manager.device),
            "current_device": torch.cuda.current_device() if on_card else None,
            "tasks": agent.tasks_run,
            "launches": dict(_build.LAUNCHES),
            "reconstructions": sum(r.reconstructions for r in readers)}
    with open(out_path + ".tmp", "w") as f:
        json.dump(info, f)
    os.replace(out_path + ".tmp", out_path)


class ServerRpcs:
    """Counts the requests the metadata server answers, by method, while
    entered (a wrapper of its request handler's two dispatch methods)."""

    def __enter__(self):
        from s3shuffle_tpu_torch.metadata import service

        self.counts, self._lock = {}, threading.Lock()
        self._handler = service._Handler
        self._saved = (self._handler._dispatch, self._handler._dispatch_queue)
        dispatch, dispatch_queue = self._saved

        def count(req):
            with self._lock:
                method = req.get("method")
                self.counts[method] = self.counts.get(method, 0) + 1

        def counted(handler, tracker, req):
            count(req)
            return dispatch(handler, tracker, req)

        def counted_queue(handler, req):
            count(req)
            return dispatch_queue(handler, req)

        self._handler._dispatch, self._handler._dispatch_queue = counted, counted_queue
        return self

    def __exit__(self, *exc):
        self._handler._dispatch, self._handler._dispatch_queue = self._saved


def open_sockets() -> int:
    """Sockets this process holds open."""
    n = 0
    for fd in os.listdir("/proc/self/fd"):
        try:
            n += os.readlink(f"/proc/self/fd/{fd}").startswith("socket:")
        except OSError:
            pass
    return n


class Fleet:
    """One phase-15 (or 17c) run's ``DistributedDriver`` and its
    ``WorkerAgent`` processes, started with ``spawn`` (this process holds a
    CUDA context) and registered before any task is queued; ``target`` is
    the workers' entry (default :func:`fleet_agent`)."""

    def __init__(self, label: str, cfg, tmp: str, heartbeat_s: float = 5.0, target=None):
        import dataclasses
        import multiprocessing as mp

        from s3shuffle_tpu_torch.cluster import DistributedDriver

        fresh_dispatchers()
        self.label = label
        self.driver = DistributedDriver(cfg)
        ctx = mp.get_context("spawn")
        self.info_paths = {f"w{i}": os.path.join(tmp, f"{label}-w{i}.json")
                           for i in range(FLEET_WORKERS)}
        self.procs = {
            wid: ctx.Process(target=target or fleet_agent, name=f"{label}-{wid}", daemon=True,
                             args=(list(self.driver.coordinator_address),
                                   dataclasses.asdict(cfg), wid, path, heartbeat_s,
                                   FLEET_DEVICE))
            for wid, path in self.info_paths.items()
        }
        self.killed = set()
        self._shut = False
        t0 = time.perf_counter()
        for proc in self.procs.values():
            proc.start()
        membership = self.driver.server.membership
        deadline = time.monotonic() + FLEET_START_S
        while set(membership.live_workers()) != set(self.procs):
            dead = {w: p.exitcode for w, p in self.procs.items() if p.exitcode is not None}
            assert not dead, f"{label}: worker processes exited before registering: {dead}"
            assert time.monotonic() < deadline, \
                f"{label}: workers not registered after {FLEET_START_S} s"
            time.sleep(0.05)
        self.start_s = time.perf_counter() - t0

    def start_job(self, parts):
        """``run_sort_shuffle`` of ``parts`` into PARTS partitions on a
        thread of its own; ``result()`` of the returned future waits."""
        from concurrent.futures import Future

        future = Future()

        def job():
            try:
                future.set_result(self.driver.run_sort_shuffle(parts, PARTS))
            except BaseException as e:  # noqa: BLE001 (handed to the waiter)
                future.set_exception(e)

        threading.Thread(target=job, name=f"{self.label}-job", daemon=True).start()
        return future

    def kill(self, wid: str) -> None:
        self.procs[wid].kill()
        self.procs[wid].join(FLEET_JOIN_S)
        self.killed.add(wid)

    def finish(self) -> dict:
        """Drain every live worker, wait for each to exit by itself (at
        most FLEET_JOIN_S), shut the driver down and read the workers'
        files. Returns their contents by worker id."""
        live = [w for w in self.procs if w not in self.killed]
        flagged = self.driver.drain_workers(live)
        assert sorted(flagged) == sorted(live), (flagged, live)
        codes = {}
        for wid in live:
            self.procs[wid].join(FLEET_JOIN_S)
            codes[wid] = self.procs[wid].exitcode
        assert all(code == 0 for code in codes.values()), \
            f"{self.label}: workers did not exit by themselves after the drain: {codes}"
        states = {w: self.driver.server.membership.state_of(w) for w in live}
        assert set(states.values()) == {"left"}, states
        self.driver.shutdown()
        self._shut = True
        infos = {}
        for wid in live:
            with open(self.info_paths[wid]) as f:
                infos[wid] = json.load(f)
        return infos

    def close(self) -> None:
        for proc in self.procs.values():
            if proc.is_alive():
                proc.kill()
                proc.join(FLEET_JOIN_S)
        if not self._shut:
            self.driver.shutdown()


def summed_launches(infos: dict) -> dict:
    total = {}
    for info in infos.values():
        for name, n in info["launches"].items():
            total[name] = total.get(name, 0) + n
    return total


def span_walls(names) -> dict:
    """Seconds of the tracer's last recorded span of each name."""
    from s3shuffle_tpu_torch.utils import trace

    walls = {}
    for e in trace.events_snapshot():
        if e.get("ph") == "X" and e["name"] in names:
            walls[e["name"]] = e["dur"] / 1e6
    return walls


def fleet(parts, input_rows, tmp: str, seed: int):
    """Phase 15: the worker fleet (15a-15c). Returns the launches by path
    and the phase's numbers. When every driver has shut down, no thread or
    socket this phase opened may be left."""
    compute_mode = subprocess.run(
        ["nvidia-smi", "--query-gpu=compute_mode", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    print(f"15: compute mode {compute_mode}")
    # four worker processes share the one card
    assert "Exclusive" not in compute_mode and "Prohibited" not in compute_mode, \
        f"15: the card's compute mode {compute_mode!r} admits no process fleet"
    threads_before = {t.ident for t in threading.enumerate()}
    sockets_before = open_sockets()
    launches, numbers = {}, {"compute_mode": compute_mode}
    try:
        launches["15a"], numbers["15a"] = fleet_terasort(parts, input_rows,
                                                         os.path.join(tmp, "15a"))
        small = terasort_parts(seed, FLEET_LOST_MIB * MiB)
        small_rows = sort_rows(rows_of(small))
        launches["15b"], numbers["15b"] = fleet_lost_worker(small, small_rows,
                                                            os.path.join(tmp, "15b"))
        for coded in (False, True):
            label = "15c coded" if coded else "15c uncoded"
            launches[label], numbers[label] = fleet_recovery(
                small, small_rows, os.path.join(tmp, label.replace(" ", "-")), coded)
    finally:
        obs_reset()
    deadline = time.monotonic() + 10.0
    while True:
        left = [t.name for t in threading.enumerate()
                if t.ident not in threads_before and not t.name.startswith(PROCESS_POOLS)]
        sockets = open_sockets()
        if (not left and sockets <= sockets_before) or time.monotonic() > deadline:
            break
        time.sleep(0.05)
    print(f"15: after the drivers shut down: threads started by the phase and alive "
          f"{json.dumps(left)}; sockets {sockets} (before the phase {sockets_before})")
    assert not left, f"15: threads left behind: {left}"
    assert sockets <= sockets_before, f"15: sockets left open: {sockets} > {sockets_before}"
    numbers["left_behind"] = {"threads": left, "sockets": sockets,
                              "sockets_before": sockets_before}
    return launches, numbers


def fleet_config(tmp: str, **knobs):
    from s3shuffle_tpu_torch import ShuffleConfig

    return ShuffleConfig(root_dir=f"file://{os.path.join(tmp, 'store')}", app_id="fleet",
                         checksum_algorithm="CRC32C", codec_block_size=BLOCK,
                         codec_batch_blocks=BATCH, **knobs)


def fleet_terasort(parts, input_rows, tmp: str):
    """15a: 5a's TeraSort through ``DistributedDriver.run_sort_shuffle``
    served by FLEET_WORKERS spawned ``WorkerAgent`` processes on the card,
    TeraValidated; the coordinator's requests counted by method, the
    driver's stage spans timed, K1-K3 launched in the workers."""
    from s3shuffle_tpu_torch.utils import trace

    os.makedirs(tmp)
    n_records = sum(p.n for p in parts)
    obs_reset()
    trace.enable(os.path.join(tmp, "driver-trace.json"), torch_annotations=False)
    fleet_run = Fleet("15a", fleet_config(tmp), tmp)
    try:
        with ServerRpcs() as rpcs:
            t0 = time.perf_counter()
            out = fleet_run.start_job(parts).result(FLEET_JOB_S)
            wall = time.perf_counter() - t0
            infos = fleet_run.finish()
    finally:
        fleet_run.close()
    walls = span_walls(("driver.job", "driver.stage_inputs", "driver.map_stage",
                        "driver.publish_snapshot", "driver.reduce_stage", "driver.collect"))
    obs_reset()
    teravalidate([[b] for b in out], n_records, input_rows)
    launches = summed_launches(infos)
    raw = n_records * (KEY_BYTES + VALUE_BYTES)
    print(f"15a fleet: TeraSort {raw / MiB:.0f} MiB, {n_records} records, {len(parts)} maps x "
          f"{PARTS} reducers, {len(infos)} worker processes; TeraValidate: ok (rows); fleet "
          f"registered in {fleet_run.start_s:.1f} s")
    print(f"15a fleet: job wall {wall:.2f} s, {n_records / wall:.0f} records/s; driver spans "
          f"(s) {json.dumps({k: round(v, 3) for k, v in walls.items()})}")
    print(f"15a fleet: workers' CUDA devices "
          f"{json.dumps({w: i['current_device'] for w, i in sorted(infos.items())})}; tasks "
          f"{json.dumps({w: i['tasks'] for w, i in sorted(infos.items())})}; launches by "
          f"worker {json.dumps({w: i['launches'] for w, i in sorted(infos.items())})}")
    print(f"15a fleet: coordinator requests by method {json.dumps(rpcs.counts, sort_keys=True)}")
    for name in UNCODED_KERNELS:
        assert launches[name] > 0, f"15a: kernel {name} was not launched in the workers"
    assert sum(i["tasks"] for i in infos.values()) == len(parts) + PARTS, infos
    return launches, {"wall_s": wall, "start_s": fleet_run.start_s, "spans_s": walls,
                      "rpcs": rpcs.counts, "tasks": {w: i["tasks"] for w, i in infos.items()},
                      "current_device": {w: i["current_device"] for w, i in infos.items()}}


def fleet_lost_worker(parts, input_rows, tmp: str):
    """15b: a worker SIGKILLed while it holds a map task; the lease reap
    requeues the task, a live worker runs it, the membership records the
    expiry, and the output TeraValidates."""
    from s3shuffle_tpu_torch.metrics import registry as reg

    os.makedirs(tmp)
    n_records = sum(p.n for p in parts)
    obs_reset()
    reg.enable()
    fleet_run = Fleet("15b", fleet_config(tmp, worker_lease_s=FLEET_LEASE_S), tmp,
                      heartbeat_s=FLEET_HEARTBEAT_S)
    try:
        queue = fleet_run.driver.server.task_queue
        t0 = time.perf_counter()
        job = fleet_run.start_job(parts)
        victim = task = None
        deadline = time.monotonic() + FLEET_JOB_S
        while victim is None:
            with queue._lock:
                for stage_id, st in queue._stages.items():
                    if stage_id.endswith("-map") and st["running"]:
                        task, entry = next(iter(st["running"].items()))
                        victim = entry["worker"]
                        break
            assert victim is not None or time.monotonic() < deadline, "15b: no map task taken"
            time.sleep(0.002)
        fleet_run.kill(victim)
        out = job.result(FLEET_JOB_S)
        wall = time.perf_counter() - t0
        membership = fleet_run.driver.server.membership
        deadline = time.monotonic() + 30.0
        while membership.state_of(victim) != "expired" and time.monotonic() < deadline:
            fleet_run.driver._reap_fleet()
            time.sleep(0.1)
        events = [e["event"] for e in membership.snapshot()["events"] if e["worker"] == victim]
        requeues = _counter_total(reg, "task_requeues_total")
        infos = fleet_run.finish()
    finally:
        fleet_run.close()
        obs_reset()
    teravalidate([[b] for b in out], n_records, input_rows)
    launches = summed_launches(infos)
    print(f"15b lost worker: {victim} SIGKILLed holding map task {task}; its membership "
          f"events {json.dumps(events)}; task requeues {requeues:.0f}; job wall {wall:.2f} s "
          f"(lease {FLEET_LEASE_S} s, heartbeat {FLEET_HEARTBEAT_S} s); TeraValidate: ok "
          f"({n_records} records); tasks by live worker "
          f"{json.dumps({w: i['tasks'] for w, i in sorted(infos.items())})}")
    assert "expire" in events, f"15b: no expire event for {victim}: {events}"
    assert requeues >= 1, "15b: the lost worker's task was not requeued"
    for name in UNCODED_KERNELS:
        assert launches[name] > 0, f"15b: kernel {name} was not launched in the workers"
    return launches, {"victim": victim, "task": task, "events": events,
                      "requeues": requeues, "wall_s": wall}


def fleet_recovery(parts, input_rows, tmp: str, coded: bool):
    """15c: at the map-stage barrier (a wrapper of
    ``cluster.publish_snapshot``), a worker that committed a map is killed,
    that map's data object deleted, and the fleet left to notice the death
    (its lease runs out) before the reducers run. Uncoded, the planner must
    recompute the map; coded (k2m2, 1 MiB chunks) it must reconstruct,
    the reducers' degraded reads rebuilding the object on the card."""
    from s3shuffle_tpu_torch import cluster
    from s3shuffle_tpu_torch.block_ids import ShuffleDataBlockId
    from s3shuffle_tpu_torch.metrics import registry as reg

    label = "15c coded" if coded else "15c uncoded"
    os.makedirs(tmp)
    n_records = sum(p.n for p in parts)
    knobs = dict(worker_lease_s=FLEET_LEASE_S)
    if coded:
        knobs.update(parity_segments=PARITY_M, parity_stripe_k=PARITY_K,
                     parity_chunk_bytes=PARITY_CHUNK)
    obs_reset()
    reg.enable()
    fleet_run = Fleet(label, fleet_config(tmp, **knobs), tmp, heartbeat_s=FLEET_HEARTBEAT_S)
    driver = fleet_run.driver
    sabotaged = {}
    real_publish = cluster.publish_snapshot

    def sabotage_then_publish(tracker, config, shuffle_id):
        dispatcher = driver.dispatcher
        if not sabotaged:
            queue = driver.server.task_queue
            victim = next(w for w in sorted(fleet_run.procs) if queue.tasks_done_by(w))
            logical = int(queue.tasks_done_by(victim)[0][1])
            fleet_run.kill(victim)
            status = dict(tracker.deduped_statuses(shuffle_id))[logical]
            path = dispatcher.get_path(ShuffleDataBlockId(shuffle_id, status.map_id))
            dispatcher.backend.delete(path)
            sabotaged.update(worker=victim, map_index=logical, map_id=status.map_id)
            # the fleet notices the death (its lease runs out) before the
            # reducers run, and plans the recovery
            deadline = time.monotonic() + 30.0
            while driver.server.membership.state_of(victim) != "expired":
                assert time.monotonic() < deadline, f"{label}: {victim} never expired"
                driver._reap_fleet()
                time.sleep(0.1)
            sabotaged["map_id_after"] = dict(tracker.deduped_statuses(shuffle_id))[logical].map_id
        return real_publish(tracker, config, shuffle_id)

    cluster.publish_snapshot = sabotage_then_publish
    try:
        t0 = time.perf_counter()
        out = fleet_run.start_job(parts).result(FLEET_JOB_S)
        wall = time.perf_counter() - t0
        decisions = {choice: _counter_total_labels(reg, "recovery_decisions_total",
                                                   choice=choice)
                     for choice in ("recompute", "reconstruct")}
        infos = fleet_run.finish()
    finally:
        cluster.publish_snapshot = real_publish
        fleet_run.close()
        obs_reset()
    teravalidate([[b] for b in out], n_records, input_rows)
    launches = summed_launches(infos)
    reconstructions = sum(i["reconstructions"] for i in infos.values())
    print(f"{label}: {sabotaged['worker']} killed at the map barrier, map "
          f"{sabotaged['map_index']}'s data object (map id {sabotaged['map_id']}) deleted; "
          f"decisions {json.dumps(decisions)}; map id after recovery "
          f"{sabotaged['map_id_after']}; reconstructions in the reducers {reconstructions}; "
          f"job wall {wall:.2f} s; TeraValidate: ok ({n_records} records); launches in the "
          f"workers {json.dumps(launches)}")
    if coded:
        assert decisions == {"recompute": 0, "reconstruct": 1}, decisions
        assert sabotaged["map_id_after"] == sabotaged["map_id"], sabotaged
        assert reconstructions > 0, f"{label}: nothing was reconstructed"
        assert launches["gf_encode"] > 0, f"{label}: K4 was not launched in the workers"
    else:
        assert decisions == {"recompute": 1, "reconstruct": 0}, decisions
        assert sabotaged["map_id_after"] > sabotaged["map_id"], sabotaged
        assert reconstructions == 0, reconstructions
    for name in UNCODED_KERNELS:
        assert launches[name] > 0, f"{label}: kernel {name} was not launched in the workers"
    return launches, {"victim": sabotaged["worker"], "map_index": sabotaged["map_index"],
                      "decisions": decisions, "reconstructions": reconstructions,
                      "wall_s": wall}


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
    fresh_dispatchers()
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


# --- phase 6a: the typed SQL queries of the port's examples/sql_queries.py --


def sql_module():
    """The port's ``examples/sql_queries.py``: its ``gen_tables``,
    ``ColumnarStages`` and queries run phases 6a and 18a-18b as a user runs
    them."""
    from s3shuffle_tpu_torch.examples import sql_queries

    return sql_queries


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


def _run_starts(*cols):
    """Start of every run of equal rows over sorted columns."""
    import numpy as np

    new = np.zeros(len(cols[0]), dtype=bool)
    new[:1] = True
    for c in cols:
        new[1:] |= c[1:] != c[:-1]
    return np.flatnonzero(new)


def _group_sums(keys, vals):
    """Rows grouped by the key columns ``keys`` (first key major): the
    sorted distinct keys and the sums of each column of ``vals`` per group
    (np.add.reduceat). The columns fold into one int64 key for a single
    stable argsort where their spans fit, else np.lexsort."""
    import numpy as np

    spans = [(int(k.min()), int(k.max()) - int(k.min()) + 1) if len(k) else (0, 1)
             for k in keys]
    if float(np.prod([float(n) for _lo, n in spans])) < 2.0 ** 62:
        folded = np.zeros(len(keys[0]), dtype=np.int64)
        for k, (lo, n) in zip(keys, spans):
            folded = folded * n + (k - lo)
        order = np.argsort(folded, kind="stable")
    else:
        order = np.lexsort(tuple(reversed(keys)))
    keys = [k[order] for k in keys]
    starts = _run_starts(*keys) if len(order) else np.zeros(0, dtype=np.int64)
    return ([k[starts] for k in keys],
            [np.add.reduceat(v[order], starts) if len(order) else v[:0] for v in vals])


def q5_numpy(sales, returns):
    """q5 recomputed in plain numpy (np.lexsort + np.add.reduceat), not
    through the shuffle."""
    store, amt, ret = q5_inputs(sales, returns)
    (store,), (a, r) = _group_sums([store], [amt, ret])
    return [(int(s), int(x), int(y), int(x - y)) for s, x, y in zip(store, a, r)]


def q67_numpy(sales, returns):
    """q67 recomputed in plain numpy: the (item, store, month) sums by
    np.lexsort + np.add.reduceat, then every group ranked within its
    category by (-amount, item, store, month), not through the shuffle."""
    import numpy as np

    top_k = sql_module().TOP_K
    (item, store, month), (amt,) = _group_sums(
        [sales["item"], sales["store"], sales["month"]], [sales["qty"] * sales["price"]])
    cat = item % 10
    # only a group whose amount reaches its category's top_k-th can rank
    # within top_k (ties kept): rank the rest out before the full sort
    keep = np.zeros(len(cat), dtype=bool)
    for c in np.unique(cat):
        in_cat = cat == c
        amounts = amt[in_cat]
        kth = np.partition(amounts, len(amounts) - min(top_k, len(amounts)))[
            len(amounts) - min(top_k, len(amounts))]
        keep |= in_cat & (amt >= kth)
    cat, item, store, month, amt = (c[keep] for c in (cat, item, store, month, amt))
    order = np.lexsort((month, store, item, -amt, cat))
    cat, item, store, month, amt = (c[order] for c in (cat, item, store, month, amt))
    first = np.zeros(len(cat), dtype=bool)
    first[:1] = True
    first[1:] = cat[1:] != cat[:-1]
    pos = np.arange(len(cat)) - np.maximum.accumulate(np.where(first, np.arange(len(cat)), 0))
    return [(f"cat-{int(cat[k])}", int(item[k]), int(store[k]), int(month[k]), int(amt[k]),
             int(pos[k]) + 1) for k in np.flatnonzero(pos < top_k)]


def q49_numpy(sales, returns):
    """q49 recomputed in plain numpy, not through the shuffle: each return
    joined to its sale (``order`` is the sale's row), the returned and sold
    quantities summed per item, the ratio rounded to 6 places, and the
    ``TOP_K`` worst (highest ratio, then highest item) first."""
    import numpy as np

    top_k = sql_module().TOP_K
    sold = sales["qty"][returns["order"]]
    (item,), (ret, sold) = _group_sums([returns["item"]], [returns["rq"], sold])
    ratio = np.round(ret / sold, 6)
    order = np.lexsort((item, ratio))[-top_k:][::-1]
    return [(int(item[k]), float(ratio[k])) for k in order]


def q75_numpy(sales, returns):
    """q75 recomputed in plain numpy: each sale's quantity less its
    returned quantity, summed per (year, item); the items present in both
    years whose 2002 net is below the 2001 net, by item."""
    import numpy as np

    ret = np.zeros(len(sales["order"]), dtype=np.int64)
    np.add.at(ret, returns["order"], returns["rq"])
    (year, item), (net,) = _group_sums([sales["year"], sales["item"]], [sales["qty"] - ret])
    a = dict(zip(item[year == 2001].tolist(), net[year == 2001].tolist()))
    b = dict(zip(item[year == 2002].tolist(), net[year == 2002].tolist()))
    return [(i, a[i], b[i]) for i in sorted(a.keys() & b.keys()) if b[i] < a[i]]


def q64_numpy(sales, returns):
    """q64 recomputed in plain numpy: quantity and amount per (item, year),
    returned quantity per item; the items sold in both years whose 2002
    amount grew, by (growth, item)."""
    import numpy as np

    (item, year), (qty, amt) = _group_sums(
        [sales["item"], sales["year"]], [sales["qty"], sales["qty"] * sales["price"]])
    (r_item,), (r_qty,) = _group_sums([returns["item"]], [returns["rq"]])
    rets = dict(zip(r_item.tolist(), r_qty.tolist()))
    y1 = {i: (q, a) for i, y, q, a in zip(item.tolist(), year.tolist(), qty.tolist(),
                                          amt.tolist()) if y == 2001}
    y2 = {i: (q, a) for i, y, q, a in zip(item.tolist(), year.tolist(), qty.tolist(),
                                          amt.tolist()) if y == 2002}
    rows = sorted((y2[i][1] - y1[i][1], i) for i in y1.keys() & y2.keys()
                  if y2[i][1] > y1[i][1])
    return [(i, y1[i], y2[i], rets.get(i, 0)) for _g, i in rows]


def q95_numpy(sales, returns):
    """q95 recomputed in plain numpy: the orders with a return (their
    returned amounts summed per order), then per store the order count,
    the quantity and the returned amount, and the total row."""
    import numpy as np

    ramt = np.zeros(len(sales["order"]), dtype=np.int64)
    np.add.at(ramt, returns["order"], returns["ramt"])
    hit = ramt > 0
    (store,), (count, qty, amt) = _group_sums(
        [sales["store"][hit]], [np.ones(int(hit.sum()), dtype=np.int64),
                                sales["qty"][hit], ramt[hit]])
    rows = [(int(s), (int(c), int(q), int(a))) for s, c, q, a in zip(store, count, qty, amt)]
    total = [("ALL", (int(count.sum()), int(qty.sum()), int(amt.sum())))] if rows else []
    return rows, total


#: each query of the example beside its numpy recomputation
NUMPY_QUERIES = {"q5": q5_numpy, "q49": q49_numpy, "q75": q75_numpy, "q67": q67_numpy,
                 "q64": q64_numpy, "q95": q95_numpy}
#: rows out at SF 100, seed 17, uniform ids, as the JAX package's query
#: suite recorded them (QUERYBENCH_r05.json): a cross-check, not the gate
JAX_ROWS_OUT = {"q49": 10, "q75": 99_342, "q64": 100_021, "q95": 2}


def summed(counts: dict) -> dict:
    """Kernel launches summed over the entries of ``counts``."""
    total = dict.fromkeys(next(iter(counts.values())), 0)
    for launches in counts.values():
        for kernel, n in launches.items():
            total[kernel] += n
    return total


def typed_queries(sf: float, dev, root: str, label: str = "6a", names=("q5", "q67"),
                  skew: float = 0.0, launching=("q67",)) -> tuple:
    """The typed queries ``names`` of the port's ``examples/sql_queries.py``
    as it runs them (its ``gen_tables``, ``ColumnarStages`` and queries),
    through ``ShuffleContext(cfg, num_workers=4)`` with ``codec="tpu"``, each
    held against its plain numpy recomputation; the queries in
    ``launching`` must launch K1-K3. Phase 6a runs q5 and q67, 18a q49,
    q75, q64 and q95, 18b q67 over Zipf-skewed tables. Returns the launches
    and the numbers of each query."""
    import threading

    import numpy as np
    import torch

    from s3shuffle_tpu_torch import ShuffleConfig, ShuffleContext, ShuffleManager, batch
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
    sq = sql_module()
    sales, returns = sq.gen_tables(sf, seed=SQL_SEED, skew=skew)
    rows_in = len(sales["order"]) + len(returns["order"])
    ids = f"Zipf({skew:g}) item and store ids" if skew else "uniform ids"
    print(f"{label} tables: SF {sf:g} (seed {SQL_SEED}, {ids}), {len(sales['order'])} sales + "
          f"{len(returns['order'])} returns = {rows_in} rows in, generated in "
          f"{time.perf_counter() - t0:.1f} s")
    cfg = ShuffleConfig(root_dir=f"file://{root}", app_id="sql", codec="tpu",
                        checksum_algorithm="CRC32C", codec_block_size=BLOCK,
                        codec_batch_blocks=BATCH)
    fresh_dispatchers()
    manager = StoredBytesManager(cfg, device=dev)
    counting = count_store(manager.dispatcher)
    ctx = ShuffleContext(manager=manager, num_workers=WORKERS)
    launches_by_query, numbers = {}, {}
    for name in names:
        st = sq.ColumnarStages(ctx)
        manager.stored = 0
        manager.codec.timings = {}
        counting.data_get_sizes.clear()
        _build.reset_launches()
        tlz_cuda.reset_general_route_rows()
        batch.reset_gather_routes()
        t0 = time.perf_counter()
        result, _reference = sq.QUERIES[name](st, sales, returns)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = dict(_build.LAUNCHES)
        routes = dict(batch.GATHER_ROUTES)
        general = tlz_cuda.general_route_rows(dev)
        stages = dict(manager.codec.timings)
        t0 = time.perf_counter()
        want = NUMPY_QUERIES[name](sales, returns)
        t_plain = time.perf_counter() - t0
        assert result == want, \
            f"{label} {name}: {len(result)} rows differ from the numpy recomputation"
        print(f"{label} {name}: {len(result)} rows out, equal to the numpy recomputation "
              f"({t_plain:.1f} s); {st.stages} shuffle stages, {sq.N_MAPS} maps x "
              f"{sq.N_REDUCERS} reducers, {WORKERS} workers")
        print(f"{label} {name}: wall {wall:.2f} s, shuffle stages {st.stage_seconds:.2f} s, "
              f"{rows_in / wall:.0f} rows in/s, stored {manager.stored} bytes; narrow-pack "
              f"fallbacks {st.narrow_fallbacks}")
        parts_s = ", ".join(f"{k} {v:.2f}" for k, v in sorted(stages.items()))
        print(f"{label} {name}: codec stages (s, summed over worker threads): "
              f"{parts_s or 'none'}; launches {json.dumps(launches)}; K3 general-route "
              f"rows: {general}")
        print(f"{label} {name}: record-layer gathers by route {json.dumps(routes)}; data GETs "
              f"by size {json.dumps(dict(counting.data_get_sizes))}")
        if name == "q5":
            # what the map-side combine leaves: each map's distinct stores
            store = q5_inputs(sales, returns)[0]
            bounds = [len(store) * i // sq.N_MAPS for i in range(sq.N_MAPS + 1)]
            combined = sum(len(np.unique(store[bounds[i]:bounds[i + 1]]))
                           for i in range(sq.N_MAPS))
            print(f"{label} q5: rows after the map-side combine (each map's distinct "
                  f"stores): {combined}")
        if name in JAX_ROWS_OUT and sf == 100 and not skew:
            jax_rows = JAX_ROWS_OUT[name]
            print(f"{label} {name}: rows out {len(result)} against the JAX package's record "
                  f"{jax_rows} at this seed: "
                  + ("equal" if len(result) == jax_rows else "DIFFERENT (a finding)"))
        if name in launching:
            for kernel in UNCODED_KERNELS:
                assert launches[kernel] > 0, f"{label} {name}: kernel {kernel} was not launched"
        assert general == 0, f"{label} {name}: validated rows took K3's general route"
        launches_by_query[name] = launches
        numbers[name] = {
            "rows_in": rows_in, "rows_out": len(result), "wall_s": round(wall, 3),
            "shuffle_stage_wall_s": round(st.stage_seconds, 3), "shuffle_stages": st.stages,
            "narrow_fallbacks": st.narrow_fallbacks, "stored_bytes": manager.stored,
            "numpy_s": round(t_plain, 3), "launches": launches,
        }
    ctx.stop()
    assert not files_under(root), f"{label}: stop() with cleanup left objects behind"
    return launches_by_query, numbers


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


# --- phase 16: the codec bridge and the multi-GPU plane ---------------------

#: 16a: TeraSort bytes through the bridge, requests of 64 blocks of 256 KiB
#: from four concurrent clients, under each codec
BRIDGE_MIB = 128  # 256 until phase 18 came: cut to keep the script's time
BRIDGE_CLIENTS = 4
BRIDGE_REQUEST_BLOCKS = 64
BRIDGE_CODECS = ("tpu", "native")
#: 16b: 8 TeraSort batches into 8 partitions, cut from 1 GiB (each run
#: materializes every record as a Python tuple, and 16b runs three), and
#: from 256 MiB when phase 18 came, to keep the script's time
MESH_MIB = 128
MESH_LANES = 4
#: 16c: phase 5a's TeraSort with the dispatcher armed over two lanes (at
#: 256 MiB until phase 18 came: cut to keep the script's time)
ARMED_MIB = 128
ARMED_LANES = 2


class emulated_lanes:
    """Make ``dispatch.local_devices`` answer ``[dev] * n`` for ``dev``'s
    type while in use: ``n`` lanes, each with its own stream, on one card
    (the seam the port's CPU tests patch the same way). The dispatcher
    cache is dropped on entry and exit. An instrument of this script: every
    number taken under it is an emulated-lanes number, never a multi-GPU
    one."""

    def __init__(self, dev, n: int):
        self.dev, self.n = dev, n

    def __enter__(self):
        from s3shuffle_tpu_torch.parallel import dispatch

        self._dispatch = dispatch
        self._real = dispatch.local_devices
        dev, n, real = self.dev, self.n, self._real
        dispatch.local_devices = (
            lambda device_type="cuda": [dev] * n if device_type == dev.type else real(device_type))
        dispatch.reset_for_testing()
        return self

    def __exit__(self, *exc):
        self._dispatch.local_devices = self._real
        self._dispatch.reset_for_testing()


class LaneUse:
    """Counts the dispatcher's placements by lane label, by wrapping
    ``DeviceDispatcher.acquire`` while in use. An instrument of this
    script, not a feature of the port."""

    def __enter__(self):
        import collections

        from s3shuffle_tpu_torch.parallel import dispatch

        self.counts = collections.Counter()
        self._cls = dispatch.DeviceDispatcher
        self._real = self._cls.acquire
        lock = threading.Lock()

        def acquire(disp, _real=self._real):
            idx = _real(disp)
            with lock:
                self.counts[disp.label(idx)] += 1
            return idx

        self._cls.acquire = acquire
        return self

    def __exit__(self, *exc):
        self._cls.acquire = self._real


def bridge_run(codec_name: str, requests, dev, card: str) -> tuple:
    """16a for one codec: an in-process ``CodecBridgeServer`` on ``dev``,
    :data:`BRIDGE_CLIENTS` clients splitting ``requests`` (lists of
    blocks) between them. Each op runs on every client at once (a barrier
    between ops); every compressed request decompresses to its blocks and
    the batch checksums equal the host's. Returns the launches and MB/s by
    op."""
    import zlib

    import numpy as np
    import torch

    from s3shuffle_tpu_torch.bridge import CodecBridgeClient, CodecBridgeServer
    from s3shuffle_tpu_torch.codec.native import NativeLZCodec
    from s3shuffle_tpu_torch.ops import _build

    host = NativeLZCodec()
    total = sum(len(b) for req in requests for b in req)
    server = CodecBridgeServer(port=0, codec_name=codec_name, device=dev).start()
    ops = ("compress", "decompress", "crc32c", "adler32")
    barrier = threading.Barrier(BRIDGE_CLIENTS + 1, timeout=600)
    errors, framed_bytes = [], [0] * BRIDGE_CLIENTS

    def client_main(i):
        mine = requests[i::BRIDGE_CLIENTS]
        client = CodecBridgeClient(port=server.port)
        try:
            barrier.wait()  # compress
            framed = [client.compress_framed(req) for req in mine]
            framed_bytes[i] = sum(len(f) for f in framed)
            barrier.wait()
            barrier.wait()  # decompress
            for req, f in zip(mine, framed):
                assert client.decompress(f) == b"".join(req), f"16a {codec_name}: round trip"
            barrier.wait()
            barrier.wait()  # crc32c
            crcs = [client.crc32c(req) for req in mine]
            barrier.wait()
            barrier.wait()  # adler32
            adlers = [client.adler32(req) for req in mine]
            barrier.wait()
            for req, c, a in zip(mine, crcs, adlers):
                concat = np.frombuffer(b"".join(req), dtype=np.uint8)
                offsets = np.concatenate([[0], np.cumsum([len(b) for b in req])])
                assert c == host.crc32c_batch(concat, offsets).tolist(), "16a: CRC32C_BATCH"
                assert a == [zlib.adler32(b) for b in req], "16a: ADLER32_BATCH"
        except Exception as e:  # noqa: BLE001 - re-raised by the main thread
            errors.append(e)
            barrier.abort()
        finally:
            client.close()

    threads = [threading.Thread(target=client_main, args=(i,), name=f"bridge-client-{i}")
               for i in range(BRIDGE_CLIENTS)]
    _build.reset_launches()
    rates = {}
    try:
        for t in threads:
            t.start()
        for op in ops:
            try:
                barrier.wait()
                t0 = time.perf_counter()
                barrier.wait()
            except threading.BrokenBarrierError:
                break
            torch.cuda.synchronize()
            rates[op] = total / MiB / (time.perf_counter() - t0)
        for t in threads:
            t.join(600)
    finally:
        server.stop()
    if errors:
        raise errors[0]
    assert not any(t.is_alive() for t in threads), "16a: a bridge client did not finish"
    launches = dict(_build.LAUNCHES)
    stored = sum(framed_bytes)
    print(f"16a bridge codec={codec_name} [{card}]: {total / MiB:.0f} MiB of TeraSort bytes, "
          f"{len(requests)} requests of {BRIDGE_REQUEST_BLOCKS} x {BLOCK // 1024} KiB from "
          f"{BRIDGE_CLIENTS} concurrent clients; framed {stored / MiB:.1f} MiB (ratio "
          f"{total / stored:.3f}); MB/s by op "
          + ", ".join(f"{op} {rate:.1f}" for op, rate in rates.items())
          + f"; launches {json.dumps(launches)}")
    return launches, {"mb_s": rates, "ratio": total / stored}


def bridge_phase(seed: int, dev, card: str) -> tuple:
    """16a: the codec bridge on the card under ``tpu`` (K2 on every
    compress request, K3 on every decompress) and under ``native`` (no
    launch)."""
    import numpy as np

    rng = np.random.default_rng(seed + 16)
    pool = rng.integers(0, 256, (64, 90), dtype=np.uint8)
    data = terasort_bytes(rng, BRIDGE_MIB * MiB, pool)
    request_bytes = BRIDGE_REQUEST_BLOCKS * BLOCK
    requests = [
        [data[o + i * BLOCK:o + (i + 1) * BLOCK] for i in range(BRIDGE_REQUEST_BLOCKS)]
        for o in range(0, len(data), request_bytes)
    ]
    launches, numbers = {}, {}
    for codec_name in BRIDGE_CODECS:
        launches[f"16a {codec_name}"], numbers[codec_name] = bridge_run(
            codec_name, requests, dev, card)
    tpu = launches["16a tpu"]
    assert tpu["tlz_planes"] > 0 and tpu["tlz_decode_fused"] > 0, f"16a tpu: {tpu}"
    assert not any(launches["16a native"].values()), launches["16a native"]
    return launches, numbers


def partition_digests(partitions) -> list:
    """Per partition: (records, sum and xor of each record's CRC32), an
    order-free digest of its (key, value) records."""
    import zlib

    out = []
    for recs in partitions:
        total = xor = 0
        for k, v in recs:
            c = zlib.crc32(v, zlib.crc32(k))
            total += c
            xor ^= c
        out.append((len(recs), total & 0xFFFFFFFFFFFFFFFF, xor))
    return out


def mesh_run(label: str, parts, dev, root: str, mesh_devices: int, registry=False):
    """One ``ShuffleContext.mesh_shuffle`` of ``parts`` into :data:`PARTS`
    partitions on ``dev`` at ``mesh_devices``, the store requests counted.
    Returns (used_mesh, partition digests, store counts, launches, wall
    seconds, repartition seconds, routed rows)."""
    import torch

    from s3shuffle_tpu_torch import ShuffleConfig, ShuffleContext, ShuffleManager
    from s3shuffle_tpu_torch.metrics import registry as reg
    from s3shuffle_tpu_torch.ops import _build
    from s3shuffle_tpu_torch.parallel import ici_shuffle

    cfg = ShuffleConfig(root_dir=f"file://{root}", checksum_algorithm="CRC32C",
                        codec_block_size=BLOCK, codec_batch_blocks=BATCH,
                        mesh_devices=mesh_devices)
    fresh_dispatchers()
    if registry:
        reg.REGISTRY.reset_values()
        reg.enable()
    repartition_s = []
    real = ici_shuffle.device_repartition

    def timed(*args, **kwargs):
        t0 = time.perf_counter()
        out = real(*args, **kwargs)
        repartition_s.append(time.perf_counter() - t0)  # it synchronizes its lanes
        return out

    ici_shuffle.device_repartition = timed
    try:
        manager = ShuffleManager(cfg, device=dev)
        counting = count_store(manager.dispatcher)
        ctx = ShuffleContext(manager=manager)
        _build.reset_launches()
        t0 = time.perf_counter()
        out, used_mesh = ctx.mesh_shuffle(parts, PARTS)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = dict(_build.LAUNCHES)
        routed = _counter_total(reg, "mesh_route_rows_total") if registry else None
        ctx.stop()
    finally:
        ici_shuffle.device_repartition = real
        if registry:
            reg.disable()
            reg.REGISTRY.reset_values()
    assert not files_under(root), f"{label}: stop() with cleanup left objects behind"
    counts = {"creates": dict(counting.creates), "gets": dict(counting.gets),
              "statuses": dict(counting.statuses)}
    return (used_mesh, partition_digests(out), counts, launches, wall,
            repartition_s[0] if repartition_s else None, routed)


def mesh_semantics(parts, dev, root: str, card: str) -> tuple:
    """16b: ``mesh_shuffle`` at ``mesh_devices=4`` on the one real card
    keeps the store path with the store requests of ``mesh_devices=0``;
    then on :data:`MESH_LANES` emulated lanes it takes the mesh route, its
    partitions equal the store path's, every row is routed, and K1 + K2 run
    on the write and K3 on the read."""
    from s3shuffle_tpu_torch.parallel import dispatch

    n_rows = sum(p.n for p in parts)
    raw = n_rows * (KEY_BYTES + VALUE_BYTES)
    used4, dig4, counts4, _l4, wall4, _r, _n = mesh_run(
        "16b one card", parts, dev, os.path.join(root, "one-card"), MESH_LANES)
    assert dispatch.get_dispatcher(dev.type) is None, "one card armed the dispatcher"
    used0, dig0, counts0, _l0, wall0, _r, _n = mesh_run(
        "16b disarmed", parts, dev, os.path.join(root, "disarmed"), 0)
    assert used4 is False and used0 is False, (used4, used0)
    assert counts4 == counts0, f"16b: store requests differ: {counts4} vs {counts0}"
    assert dig4 == dig0, "16b: the one-card partitions differ from mesh_devices=0's"
    print(f"16b one card [{card}]: mesh_devices={MESH_LANES} on the one real card: "
          f"used_mesh={used4}, store requests {json.dumps(counts4)} (equal to "
          f"mesh_devices=0's); wall {wall4:.2f} s vs {wall0:.2f} s")
    with emulated_lanes(dev, MESH_LANES):
        used, dig, counts, launches, wall, rep_s, routed = mesh_run(
            "16b emulated", parts, dev, os.path.join(root, "emulated"), MESH_LANES,
            registry=True)
    assert used is True, "16b: the emulated lanes did not take the mesh route"
    assert [d[0] for d in dig] == [d[0] for d in dig0], "16b: per-partition row counts differ"
    assert dig == dig0, "16b: partition digests differ from the store path's"
    assert routed == n_rows, f"16b: mesh_route_rows_total {routed} != {n_rows}"
    for name in UNCODED_KERNELS:
        assert launches[name] > 0, f"16b: kernel {name} was not launched"
    print(f"16b emulated lanes on one H100 [{card}]: {MESH_LANES} lanes of {dev}, "
          f"{raw / MiB:.0f} MiB ({n_rows} records) in {len(parts)} batches -> {PARTS} "
          f"partitions: used_mesh=True, partitions equal the store path's (rows "
          f"{[d[0] for d in dig]}); device_repartition {rep_s:.3f} s "
          f"({n_rows / rep_s:.0f} rows/s); mesh_route_rows_total {routed:.0f}; mesh_shuffle "
          f"wall {wall:.2f} s; launches {json.dumps(launches)}")
    numbers = {"one_card_used_mesh": used4, "one_card_store_requests": counts4,
               "emulated_used_mesh": used, "repartition_s": rep_s, "rows": n_rows,
               "wall_s": {"one_card": wall4, "disarmed": wall0, "emulated": wall}}
    return {"16b emulated": launches}, numbers


def armed_dispatcher(parts, input_rows, dev, root: str, card: str) -> tuple:
    """16c: phase 5a's TeraSort with the dispatcher armed over
    :data:`ARMED_LANES` emulated lanes of the one card (two streams), its
    objects byte-equal to the disarmed run's, both lanes used and every
    slot released; then the k2m2 coded write, K4 striped over both lanes
    and the parity objects byte-equal to the disarmed ones."""
    from s3shuffle_tpu_torch.parallel import dispatch

    coded = dict(parity_segments=PARITY_M, parity_stripe_k=PARITY_K,
                 parity_chunk_bytes=PARITY_CHUNK)
    launches, walls, lanes = {}, {}, {}
    for kind, knobs in (("uncoded", {}), ("coded", coded)):
        digests = {}
        for armed in (False, True):
            run = f"16c {kind} {'armed' if armed else 'disarmed'}"
            root_run = os.path.join(root, run.replace(" ", "-"))
            state = {}

            def after(_manager, root_run=root_run, digests=digests, armed=armed, state=state):
                digests[armed] = object_digests(root_run)
                disp = dispatch.get_dispatcher(dev.type)
                state["outstanding"] = disp.outstanding_snapshot() if disp else None

            if armed:
                with emulated_lanes(dev, ARMED_LANES), LaneUse() as use:
                    launches[run], walls[run], _read = record_path(
                        run, parts, input_rows, dev, root_run, bypass=200, after=after,
                        mesh_devices=ARMED_LANES, **knobs)
                lanes[run] = dict(use.counts)
                assert state["outstanding"] == [0] * ARMED_LANES, state
                assert sorted(use.counts) == [f"{dev}/{i}" for i in range(ARMED_LANES)], \
                    f"{run}: lanes used {dict(use.counts)}"
            else:
                launches[run], walls[run], _read = record_path(
                    run, parts, input_rows, dev, root_run, bypass=200, after=after, **knobs)
                assert state["outstanding"] is None, "the disarmed run armed a dispatcher"
        assert digests[True] == digests[False], f"16c {kind}: objects differ armed vs disarmed"
        kinds = sorted({os.path.basename(p).split(".")[1] for p in digests[True]})
        print(f"16c {kind} [{card}]: {len(digests[True])} objects ({', '.join(kinds)}) "
              f"byte-equal armed vs disarmed")
    assert launches["16c coded armed"]["gf_encode"] > 0, "16c: K4 was not launched armed"
    print(f"16c emulated lanes on one H100 [{card}]: dispatches by lane "
          f"{json.dumps(lanes)}; walls (s) "
          + ", ".join(f"{run} {wall:.2f}" for run, wall in walls.items())
          + "; no gain is claimed")
    return launches, {"walls_s": walls, "lanes": lanes}


def mesh_plane_and_bridge(seed: int, dev, tmp: str, card: str) -> tuple:
    """Phase 16 (16a-16c). Returns the launches by path and the numbers."""
    t0 = time.perf_counter()
    launches, bridge_numbers = bridge_phase(seed, dev, card)
    t_a = time.perf_counter()
    parts = terasort_parts(seed, MESH_MIB * MiB)
    mesh_launches, mesh_numbers = mesh_semantics(parts, dev, os.path.join(tmp, "mesh"), card)
    launches.update(mesh_launches)
    t_b = time.perf_counter()
    if ARMED_MIB != MESH_MIB:
        parts = terasort_parts(seed, ARMED_MIB * MiB)
    armed_launches, armed_numbers = armed_dispatcher(
        parts, sort_rows(rows_of(parts)), dev, os.path.join(tmp, "armed"), card)
    launches.update(armed_launches)
    seconds = {"16a": t_a - t0, "16b": t_b - t_a, "16c": time.perf_counter() - t_b}
    print("16: seconds by part " + ", ".join(f"{k} {v:.1f}" for k, v in seconds.items()))
    return launches, {"card": card, "16a_bridge": bridge_numbers, "16b_mesh": mesh_numbers,
                      "16c_armed": armed_numbers, "seconds": seconds}



# --- phase 17: the concurrency witnesses on the card ---------------------------

#: 17a's and 17c's TeraSort size (cut from 5a's 1 GiB, and from 256 MiB when
#: phase 18 came, to keep the script's time)
WITNESS_MIB = 128
#: the three witnesses' switches; a witnessed child process sets all three
WITNESS_VARS = ("S3SHUFFLE_LOCK_WITNESS", "S3SHUFFLE_RACE_WITNESS",
                "S3SHUFFLE_PROTOCOL_WITNESS")
#: the longest a phase-17 child process may take
WITNESS_CHILD_S = 900


def load_witnesses():
    """Load the port's lock and race witnesses by file spec, under their
    canonical ``sys.modules`` names, and install each its environment
    switch asks for: before any import of the port, so that the locks its
    modules build at import are witnessed too (the package's ``__init__``
    imports modules that build locks). Returns ``(lock, race)`` witnesses
    (None where not installed)."""
    import importlib.util

    here = os.path.dirname(os.path.abspath(__file__))
    loaded = {}
    for name in ("lockwitness", "racewitness"):
        full = f"s3shuffle_tpu_torch.utils.{name}"
        assert full not in sys.modules, f"{full} was imported before the witnesses"
        spec = importlib.util.spec_from_file_location(
            full, os.path.join(here, "s3shuffle_tpu_torch", "utils", f"{name}.py"))
        module = importlib.util.module_from_spec(spec)
        sys.modules[full] = module
        spec.loader.exec_module(module)
        loaded[name] = module
    return loaded["lockwitness"].install_from_env(), loaded["racewitness"].install_from_env()


def fleet_main_agent(coordinator, cfg_dict, worker_id, out_path, heartbeat_s, device):
    """17c's worker process (started with ``spawn``): ``worker.main``, the
    entry of ``python -m s3shuffle_tpu_torch.worker``, with the config in
    ``S3SHUFFLE_*`` variables. ``main`` drains the protocol witnesses
    ``S3SHUFFLE_PROTOCOL_WITNESS`` installed and raises on a violation
    before it returns 0. Then the process's kernel launches, tasks and the
    witnesses ``main`` checked go to ``out_path`` as JSON."""
    import dataclasses
    import logging

    logging.basicConfig(level=logging.WARNING)  # main's INFO set-up then does nothing
    from s3shuffle_tpu_torch.config import ShuffleConfig
    from s3shuffle_tpu_torch.ops import _build
    from s3shuffle_tpu_torch.utils import protowitness

    defaults = ShuffleConfig()
    for field in dataclasses.fields(ShuffleConfig):
        value = cfg_dict[field.name]
        if value != getattr(defaults, field.name):
            os.environ[f"S3SHUFFLE_{field.name.upper()}"] = (
                json.dumps(value) if isinstance(value, dict) else str(value))
    if device != "cpu":
        _build.library()
    checked = []
    drain = protowitness.drain_installed

    def drain_installed():
        witnesses = drain()
        checked.extend(witnesses)
        return witnesses

    protowitness.drain_installed = drain_installed
    from s3shuffle_tpu_torch import worker

    agents = []
    agent_init = worker.WorkerAgent.__init__

    def init(self, *args, **kwargs):
        agent_init(self, *args, **kwargs)
        agents.append(self)

    worker.WorkerAgent.__init__ = init
    _build.reset_launches()
    code = worker.main(["--coordinator", "%s:%d" % tuple(coordinator), "--worker-id", worker_id,
                        "--device", device, "--metrics-port", "0", "--poll-interval", "0.01"])
    assert code == 0, code
    info = {"worker": worker_id, "pid": os.getpid(), "tasks": agents[0].tasks_run,
            "launches": dict(_build.LAUNCHES), "protocol_witnesses": len(checked),
            "violations": [v for w in checked for v in w.violations]}
    with open(out_path + ".tmp", "w") as f:
        json.dump(info, f)
    os.replace(out_path + ".tmp", out_path)


def store_digests(root: str) -> dict:
    """:func:`object_digests` of a fleet's store, but for the snapshot
    objects, which carry their publish time."""
    return {k: v for k, v in object_digests(root).items() if not k.endswith(".snapmeta")}


def witnessed_fleet(parts, input_rows, tmp: str):
    """17c: 5a's TeraSort at WITNESS_MIB through ``DistributedDriver`` and
    FLEET_WORKERS spawned ``worker.main`` processes; every worker must exit
    0. Returns the launches summed over the workers and the numbers."""
    os.makedirs(tmp)
    n_records = sum(p.n for p in parts)
    fleet_run = Fleet("17c", fleet_config(tmp), tmp, target=fleet_main_agent)
    try:
        t0 = time.perf_counter()
        out = fleet_run.start_job(parts).result(FLEET_JOB_S)
        wall = time.perf_counter() - t0
        digests = store_digests(os.path.join(tmp, "store"))
        infos = fleet_run.finish()
    finally:
        fleet_run.close()
    teravalidate([[b] for b in out], n_records, input_rows)
    launches = summed_launches(infos)
    for name in UNCODED_KERNELS:
        assert launches.get(name, 0) > 0, f"17c: kernel {name} was not launched in the workers"
    assert sum(i["tasks"] for i in infos.values()) == len(parts) + PARTS, infos
    return launches, {"wall_s": wall, "start_s": fleet_run.start_s, "digests": digests,
                      "objects": len(digests),
                      "tasks": {w: i["tasks"] for w, i in sorted(infos.items())},
                      "protocol_witnesses": {w: i["protocol_witnesses"]
                                             for w, i in sorted(infos.items())},
                      "violations": [v for i in infos.values() for v in i["violations"]]}


def witness_child(mode: str, seed: int, tmp: str, out_path: str) -> int:
    """One phase-17 child process: ``witnessed`` runs with every witness
    installed (the lock and race witnesses loaded before the port), the
    ``plain`` one with none. Both run 17a, 17b and 17c on the card and
    write what they saw to ``out_path`` as JSON."""
    t_child = time.perf_counter()
    lock_w = race_w = None
    acquired = set()  # every witnessed lock site acquired at least once
    if mode == "witnessed":
        lock_w, race_w = load_witnesses()
        assert lock_w is not None and race_w is not None, "the witnesses' switches are off"

        def on_acquired(lock, site, _real=lock_w.on_acquired):
            acquired.add(site)
            _real(lock, site)

        lock_w.on_acquired = on_acquired  # an instrument of this script
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 2
    from s3shuffle_tpu_torch.device import resolve_device
    from s3shuffle_tpu_torch.ops import _build
    from s3shuffle_tpu_torch.utils import protowitness

    dev = resolve_device("cuda")
    _build.library()
    result = {"mode": mode}

    def checks():
        return race_w.checks if race_w is not None else 0

    def drained():
        return [{"violations": list(w.violations)} for w in protowitness.drain_installed()]

    # 17a: 5a's TeraSort at WITNESS_MIB
    parts = terasort_parts(seed, WITNESS_MIB * MiB)
    input_rows = sort_rows(rows_of(parts))
    root = os.path.join(tmp, "terasort")
    digests, installed = {}, []
    c0 = checks()
    launches, wall, read = record_path(
        f"17a {mode}", parts, input_rows, dev, root, bypass=200,
        after=lambda m: (digests.update(object_digests(root)),
                         installed.append(m.protocol_witness is not None)))
    result["17a"] = {"launches": launches, "wall_s": wall, "digests": digests,
                     "race_checks": checks() - c0, "protocol": drained(),
                     "protocol_installed": installed == [True]}
    # 17b: 10b's coded composite, one group's data object lost
    window = make_partitions(seed, WINDOW_MIB * MiB // (MAPS * PARTS))
    digests_b = {}
    c0 = checks()
    launches_b, numbers_b = coded_composite(window, dev, os.path.join(tmp, "coded-composite"),
                                            digests=digests_b)
    del window
    result["17b"] = {"launches": launches_b, "write_launches": numbers_b["write_launches"],
                     "write_s": numbers_b["write_s"], "read_s": numbers_b["read_s"],
                     "reconstructions": numbers_b["reconstructions"], "digests": digests_b,
                     "race_checks": checks() - c0, "protocol": drained()}
    # 17c: the fleet; the workers inherit S3SHUFFLE_PROTOCOL_WITNESS
    c0 = checks()
    launches_c, numbers_c = witnessed_fleet(parts, input_rows, os.path.join(tmp, "fleet"))
    result["17c"] = dict(numbers_c, launches=launches_c, race_checks=checks() - c0)
    if lock_w is not None:
        edges = lock_w.edges()
        result["lock"] = {"edges": sorted([a, b] for a, bs in edges.items() for b in bs),
                          "acquired": sorted(acquired), "cycles": lock_w.find_cycles(),
                          "report": lock_w.format_report()}
    if race_w is not None:
        result["race"] = {"checks": race_w.checks, "reports": list(race_w.reports)}
    result["wall_s"] = time.perf_counter() - t_child
    with open(out_path, "w") as f:
        json.dump(result, f)
    return 0


def run_witness_child(mode: str, seed: int, tmp: str) -> dict:
    """Start one phase-17 child (``python3 chip_smoke.py --witness-child``)
    and return what it wrote."""
    env = {k: v for k, v in os.environ.items() if k not in WITNESS_VARS}
    if mode == "witnessed":
        env.update({k: "1" for k in WITNESS_VARS})
    out_path = os.path.join(tmp, f"{mode}.json")
    os.makedirs(os.path.join(tmp, mode))
    sys.stdout.flush()
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, os.path.abspath(__file__), "--witness-child", mode,
                           "--seed", str(seed), "--child-dir", os.path.join(tmp, mode),
                           "--child-out", out_path], env=env, timeout=WITNESS_CHILD_S)
    assert proc.returncode == 0, f"17 {mode}: the child process exited {proc.returncode}"
    with open(out_path) as f:
        result = json.load(f)
    result["process_s"] = time.perf_counter() - t0
    return result


def _source_lines(path: str) -> set:
    with open(path) as f:
        return {line.strip() for line in f}


def port_only_sites(sites) -> list:
    """The witnessed lock sites (``file:line`` below the port's package
    root) whose constructor line has no twin in the JAX package's file of
    the same path: the locks only the port builds (its launch counter, the
    kernels' counter buffers, its codec windows). Read as text; nothing of
    the JAX package is imported."""
    here = os.path.dirname(os.path.abspath(__file__))
    out = []
    for site in sorted(sites):
        rel, line = site.rsplit(":", 1)
        if rel.startswith(".."):
            continue  # the script's own locks
        port_file = os.path.join(here, "s3shuffle_tpu_torch", rel)
        twin = os.path.join(here, "s3shuffle_tpu", rel)
        with open(port_file) as f:
            text = f.read().splitlines()[int(line) - 1].strip()
        if not os.path.exists(twin) or text not in _source_lines(twin):
            out.append(site)
    return out


def concurrency_witnesses(seed: int, tmp: str, card: str) -> tuple:
    """Phase 17: the plain and witnessed child processes, one after the
    other, and their comparison. Returns the launches by path and the
    phase's numbers."""
    plain = run_witness_child("plain", seed, tmp)
    witnessed = run_witness_child("witnessed", seed, tmp)
    for part in ("17a", "17b", "17c"):
        assert witnessed[part]["digests"] == plain[part]["digests"], \
            f"{part}: the witnessed run's objects differ from the plain run's"
        assert witnessed[part]["digests"], f"{part}: no object was digested"
    for name in UNCODED_KERNELS:
        assert witnessed["17a"]["launches"].get(name, 0) == plain["17a"]["launches"].get(name, 0), \
            (witnessed["17a"]["launches"], plain["17a"]["launches"])
        assert witnessed["17c"]["launches"].get(name, 0) > 0, name
    assert witnessed["17b"]["write_launches"].get("gf_encode", 0) > 0, "17b: K4 not launched"
    assert witnessed["17b"]["reconstructions"] == plain["17b"]["reconstructions"] >= PARTS
    # the witnesses were there, and saw nothing
    assert plain["17a"]["protocol_installed"] is False
    assert witnessed["17a"]["protocol_installed"] is True
    protocol = [v for part in ("17a", "17b") for w in witnessed[part]["protocol"]
                for v in w["violations"]] + witnessed["17c"]["violations"]
    assert protocol == [], "17: protocol violations:\n" + "\n".join(protocol)
    assert len(witnessed["17a"]["protocol"]) == 1 and len(witnessed["17b"]["protocol"]) == 1
    assert set(witnessed["17c"]["protocol_witnesses"].values()) == {1}, \
        witnessed["17c"]["protocol_witnesses"]
    assert set(plain["17c"]["protocol_witnesses"].values()) == {0}
    lock, race = witnessed["lock"], witnessed["race"]
    assert lock["cycles"] == [], lock["report"]
    assert race["reports"] == [], "\n".join(race["reports"])
    for part in ("17a", "17b", "17c"):
        assert witnessed[part]["race_checks"] > 0, f"{part}: the race witness checked nothing"
    sites = {s for edge in lock["edges"] for s in edge}
    own = port_only_sites(set(lock["acquired"]) | sites)
    own_edges = [e for e in lock["edges"] if e[0] in own or e[1] in own]
    walls = {part: {"plain": plain[part]["wall_s"], "witnessed": witnessed[part]["wall_s"]}
             for part in ("17a", "17c")}
    walls["17b write"] = {m: r["17b"]["write_s"] for m, r in (("plain", plain),
                                                             ("witnessed", witnessed))}
    walls["17b read"] = {m: r["17b"]["read_s"] for m, r in (("plain", plain),
                                                           ("witnessed", witnessed))}
    walls["process"] = {"plain": plain["process_s"], "witnessed": witnessed["process_s"]}
    print(f"17 ({card}): objects byte-equal witnessed vs plain: 17a "
          f"{len(plain['17a']['digests'])}, 17b {len(plain['17b']['digests'])}, 17c "
          f"{plain['17c']['objects']} (snapshots aside); lock witness: "
          f"{len(lock['acquired'])} sites acquired, {len(sites)} of them in "
          f"{len(lock['edges'])} edges, no cycle; race witness: "
          f"{race['checks']} checks (17a {witnessed['17a']['race_checks']}, 17b "
          f"{witnessed['17b']['race_checks']}, 17c driver "
          f"{witnessed['17c']['race_checks']}), 0 reports; protocol witness: 17a 1, 17b 1, "
          f"17c one per worker {json.dumps(witnessed['17c']['protocol_witnesses'])}, 0 "
          f"violations; every worker exited 0")
    print(f"17 lock-order edges: {json.dumps(lock['edges'])}")
    print(f"17 witnessed lock sites acquired: {json.dumps(lock['acquired'])}")
    print(f"17 sites only the port builds: {json.dumps(own)}; the edges with one of them: "
          f"{json.dumps(own_edges)}")
    print(f"17 walls (s), plain / witnessed: " + "; ".join(
        f"{k} {v['plain']:.2f} / {v['witnessed']:.2f}" for k, v in walls.items()))
    launches = {f"17{p[-1]} {mode}": r[p]["launches"] for p in ("17a", "17b", "17c")
                for mode, r in (("plain", plain), ("witnessed", witnessed))}
    return launches, {"card": card, "walls_s": walls, "lock_sites": len(lock["acquired"]),
                      "lock_sites_in_edges": len(sites),
                      "lock_edges": len(lock["edges"]), "port_only_sites": own,
                      "port_only_edges": own_edges, "race_checks": race["checks"],
                      "race_checks_by_part": {p: witnessed[p]["race_checks"]
                                              for p in ("17a", "17b", "17c")},
                      "race_reports": 0, "protocol_violations": 0,
                      "objects_equal": {"17a": len(plain["17a"]["digests"]),
                                        "17b": len(plain["17b"]["digests"]),
                                        "17c": plain["17c"]["objects"]}}


# --- phase 18: the user-facing drivers and the public batch checksums -----

#: phase 18b: the Zipf exponent of the skewed q67 (the JAX suite's skewed run)
SQL_SKEW = 1.2
#: phase 18c: each driver's run as (label, module of
#: s3shuffle_tpu_torch.examples, argv (``--device`` is added), S3SHUFFLE_*
#: variables set around it), in order. The drivers that take their
#: checksum from the environment (as a deployment sets it) run with CRC32C,
#: as TeraSort and the query profiles set it: at the default ADLER32 no
#: fused CRC is asked for, so K1 would not run.
DRIVER_RUNS = (
    ("terasort", "terasort", ["--size", "256m", "--codec", "tpu"], {}),
    ("query_shuffles", "query_shuffles", ["--query", "all", "--scale", "1000",
                                          "--codec", "tpu"], {}),
    ("multihost_terasort", "multihost_terasort", ["--local-workers", "2", "--size", "64m",
                                                  "--codec", "tpu"],
     {"S3SHUFFLE_CHECKSUM_ALGORITHM": "CRC32C"}),
    ("ici_to_store", "ici_to_store", ["--devices", "2", "--codec", "tpu"],
     {"S3SHUFFLE_CHECKSUM_ALGORITHM": "CRC32C"}),
    # SF 10: at SF 1 every q49 partition holds under one 256 KiB block, so
    # its frames take the host encoder and no kernel runs
    ("sql_queries q49", "sql_queries", ["--query", "q49", "--sf", "10", "--codec", "tpu"],
     {"S3SHUFFLE_CHECKSUM_ALGORITHM": "CRC32C"}),
)
#: phase 18c: the emulated lanes of the ici_to_store run
ICI_LANES = 2
#: phase 18d: rows of the batch checksums (each up to one 256 KiB block)
CRC_ROWS = 64


def run_driver(module: str, argv, dev, env: dict) -> list:
    """``main(argv + ["--device", dev])`` of ``s3shuffle_tpu_torch.examples.
    <module>`` in this process, as ``python -m`` runs it, with ``env`` set
    (the processes it starts inherit it): it must return 0. Returns the
    JSON lines it printed, parsed (and echoes them)."""
    import contextlib
    import importlib
    import io

    mod = importlib.import_module(f"s3shuffle_tpu_torch.examples.{module}")
    out = io.StringIO()
    saved = {key: os.environ.get(key) for key in env}
    os.environ.update(env)
    try:
        with contextlib.redirect_stdout(out):
            rc = mod.main([*argv, "--device", str(dev)])
    finally:
        for key, value in saved.items():
            if value is None:
                del os.environ[key]
            else:
                os.environ[key] = value
    assert rc == 0, f"{module} exited with {rc}"
    lines = [json.loads(line) for line in out.getvalue().splitlines() if line.startswith("{")]
    assert lines, f"{module} printed no JSON line"
    for line in lines:
        print(f"18c {module}: {json.dumps(line)}")
    return lines


def driver_runs(dev, tmp: str) -> tuple:
    """Phase 18c: every driver of ``s3shuffle_tpu_torch/examples`` on the
    card, through its ``main``. Each must exit 0 and say valid or verified
    (TeraSort and the query profiles validate inside and raise), and each
    run, through ``codec="tpu"``, must launch K1-K3: multihost_terasort's
    in its two worker processes (each writes its launches when it leaves),
    ici_to_store's on two emulated lanes of the one card. Returns the
    launches and the numbers of each run."""
    import torch

    from s3shuffle_tpu_torch.ops import _build

    launches_by_run, numbers = {}, {}
    for label, module, argv, env in DRIVER_RUNS:
        fresh_dispatchers()
        _build.reset_launches()
        t0 = time.perf_counter()
        if module == "multihost_terasort":
            launch_dir = tempfile.mkdtemp(dir=tmp, prefix="launches-")
            lines = run_driver(module, argv, dev, {**env, "S3SHUFFLE_LAUNCHES_DIR": launch_dir})
            workers = {}
            for name in sorted(os.listdir(launch_dir)):
                with open(os.path.join(launch_dir, name)) as f:
                    info = json.load(f)
                workers[info["worker_id"]] = info["launches"]
            assert len(workers) == 2, f"18c {label}: launches of {sorted(workers)}"
            print(f"18c {label}: launches by worker process {json.dumps(workers)}")
            launches = summed(workers)
        elif module == "ici_to_store":
            with emulated_lanes(dev, ICI_LANES):
                lines = run_driver(module, argv, dev, env)
            launches = dict(_build.LAUNCHES)
        else:
            lines = run_driver(module, argv, dev, env)
            launches = dict(_build.LAUNCHES)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        last = lines[-1]
        if module == "terasort":
            from s3shuffle_tpu_torch.utils import parse_size

            size = parse_size(argv[argv.index("--size") + 1])
            assert last["runs"][0]["records"] == size // 100 // 8 * 8, last
        elif module == "query_shuffles":
            assert [r["query"] for r in last["results"]] == ["q5", "q49", "q75", "q67"], last
            for r in last["results"]:
                # a sort returns every record, a count per key at least one
                assert (r["out_records"] == r["records"] if r["op"] == "sort"
                        else 0 < r["out_records"] <= r["records"]), r
        elif module in ("multihost_terasort", "ici_to_store"):
            assert last["valid"] is True, last
        else:
            assert last["verified"] is True and last["shuffle_stages"] == 3, last
        for kernel in UNCODED_KERNELS:
            assert launches[kernel] > 0, f"18c {label}: kernel {kernel} was not launched"
        lanes = f", {ICI_LANES} emulated lanes on one H100" if module == "ici_to_store" else ""
        print(f"18c {label}: exit 0, wall {wall:.2f} s{lanes}; launches {json.dumps(launches)}")
        launches_by_run[label] = launches
        numbers[label] = {"wall_s": round(wall, 3), "launches": launches, "json": last,
                          "env": env}
    return launches_by_run, numbers


def batch_checksums(seed: int, dev) -> tuple:
    """Phase 18d: the public batch checksums on the card. ``ops.crc32_batch``
    on :data:`CRC_ROWS` right-aligned rows of up to 256 KiB (ragged, empty
    and full rows among them) must equal the host's CRC32C in one K1
    launch, and zlib's CRC32; ``ops.adler32_batch`` must equal
    ``zlib.adler32``; ``codec.cuda.fused_compress_and_checksum`` on one
    batch of 64 full TeraSort blocks (the fused route, K1 + K2) must give
    the frames and frame CRCs of the staged route (``compress_blocks``,
    then one ``crc32_batch``) and of the host. Returns the launches."""
    import zlib

    import numpy as np
    import torch

    from s3shuffle_tpu_torch.codec.cuda import CudaCodec, fused_compress_and_checksum
    from s3shuffle_tpu_torch.ops import POLY_CRC32, POLY_CRC32C, _build, adler32_batch, crc32_batch
    from s3shuffle_tpu_torch.ops.checksum import stage_right_aligned
    from s3shuffle_tpu_torch.utils.checksums import crc32c

    rng = np.random.default_rng(seed)
    lengths = rng.integers(0, BLOCK + 1, CRC_ROWS)
    lengths[:4] = (0, 1, BLOCK - 1, BLOCK)
    chunks = [rng.integers(0, 256, int(n), dtype=np.uint8).tobytes() for n in lengths]
    rows, lens = stage_right_aligned(chunks, BLOCK)
    launches = {}
    _build.reset_launches()
    t0 = time.perf_counter()
    got = crc32_batch(rows, lens, POLY_CRC32C, device=dev)
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3
    launches["crc32_batch"] = dict(_build.LAUNCHES)
    assert launches["crc32_batch"] == {**dict.fromkeys(_build.LAUNCHES, 0), "crc_fold": 1}, \
        launches["crc32_batch"]
    assert got.tolist() == [crc32c(c) for c in chunks], "crc32_batch differs from CRC32C"
    assert crc32_batch(rows, lens, POLY_CRC32, device=dev).tolist() == \
        [zlib.crc32(c) for c in chunks], "crc32_batch differs from zlib.crc32"
    assert adler32_batch(rows, lens, device=dev).tolist() == \
        [zlib.adler32(c) for c in chunks], "adler32_batch differs from zlib.adler32"
    print(f"18d crc32_batch: {CRC_ROWS} right-aligned rows of 0-{BLOCK} bytes "
          f"({int(lens.sum())} bytes) equal the host's CRC32C in one K1 launch "
          f"({wall_ms:.2f} ms with both copies, host clock) and zlib.crc32; "
          "adler32_batch equals zlib.adler32")
    pool = rng.integers(0, 256, (64, 90), dtype=np.uint8)
    data = terasort_bytes(rng, BATCH * BLOCK, pool)
    blocks = [data[i * BLOCK:(i + 1) * BLOCK] for i in range(BATCH)]
    codec = CudaCodec(BLOCK, BATCH, device=dev)
    _build.reset_launches()
    frames, crcs = fused_compress_and_checksum(codec, blocks)
    launches["fused"] = dict(_build.LAUNCHES)
    _build.reset_launches()
    staged = [codec.frame_from(raw, comp)
              for raw, comp in zip(blocks, codec.compress_blocks(blocks))]
    staged_rows, staged_lens = stage_right_aligned(staged)
    staged_crcs = crc32_batch(staged_rows, staged_lens, POLY_CRC32C, device=dev).tolist()
    launches["staged"] = dict(_build.LAUNCHES)
    assert frames == staged, "the fused route's frames differ from the staged route's"
    assert crcs == staged_crcs == [crc32c(f) for f in frames], "frame CRCs differ"
    for route in ("fused", "staged"):
        for kernel in ("crc_fold", "tlz_planes"):
            assert launches[route][kernel] > 0, f"18d {route}: {kernel} was not launched"
    print(f"18d fused_compress_and_checksum: {BATCH} TeraSort blocks, frames "
          f"({sum(map(len, frames))} bytes) and frame CRCs equal to the staged route's and "
          f"the host's; launches fused {json.dumps(launches['fused'])}, staged "
          f"{json.dumps(launches['staged'])}")
    return launches


def drivers_and_queries(seed: int, dev, tmp: str, card: str) -> tuple:
    """Phase 18: 18a q49, q75, q64 and q95 at SF 100, 18b q67 at SF 100 over
    Zipf(1.2) tables, 18c every driver's ``main``, 18d the batch checksums.
    Returns the launches by path and the numbers."""
    launches, numbers = {}, {"card": card}
    t0 = time.perf_counter()
    by_query, numbers["18a"] = typed_queries(
        SQL_SF, dev, os.path.join(tmp, "sql-18a"), label="18a",
        names=("q49", "q75", "q64", "q95"), launching=("q49", "q75", "q64", "q95"))
    launches.update({f"18a {name}": n for name, n in by_query.items()})
    launches["18a"] = summed(by_query)
    numbers["18a_s"] = round(time.perf_counter() - t0, 1)
    t0 = time.perf_counter()
    by_query, numbers["18b"] = typed_queries(
        SQL_SF, dev, os.path.join(tmp, "sql-skew"), label="18b", names=("q67",),
        skew=SQL_SKEW, launching=("q67",))
    launches["18b q67 skewed"] = by_query["q67"]
    numbers["18b_s"] = round(time.perf_counter() - t0, 1)
    t0 = time.perf_counter()
    by_run, numbers["18c"] = driver_runs(dev, tmp)
    launches.update({f"18c {label}": n for label, n in by_run.items()})
    numbers["18c_s"] = round(time.perf_counter() - t0, 1)
    t0 = time.perf_counter()
    by_check = batch_checksums(seed, dev)
    launches.update({f"18d {label}": n for label, n in by_check.items()})
    numbers["18d"] = by_check
    numbers["18d_s"] = round(time.perf_counter() - t0, 1)
    print("18 seconds by part (host clock): " + ", ".join(
        f"{part} {numbers[part + '_s']:.1f}" for part in ("18a", "18b", "18c", "18d")))
    return launches, numbers


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--total-mib", type=int, default=1024)
    ap.add_argument("--reps", type=int, default=20)
    # phase 17's child processes (run_witness_child starts them)
    ap.add_argument("--witness-child", choices=("plain", "witnessed"), help=argparse.SUPPRESS)
    ap.add_argument("--child-dir", help=argparse.SUPPRESS)
    ap.add_argument("--child-out", help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.witness_child:
        # before torch and the port: the witnesses load first
        return witness_child(args.witness_child, args.seed, args.child_dir, args.child_out)
    t_script = time.perf_counter()
    phase_s, last = {}, [t_script]

    def mark(name):
        """Seconds since the last mark, under ``name``."""
        now = time.perf_counter()
        phase_s[name] = now - last[0]
        last[0] = now

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
    from s3shuffle_tpu_torch.codec import native

    # a library left in build/native by an earlier run (or another machine)
    # goes, so this run shows the port's source building on this machine
    if native.LIBRARY.exists():
        native.LIBRARY.unlink()
    assert native.native_available(), "the port's native library did not build"
    print(f"native library (host codecs, record-layer gathers): built in "
          f"{native.build_seconds:.1f} s")

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
                           data[0][1][: BATCH * BLOCK].ljust(BATCH * BLOCK, b"\0"),
                           b"".join(data[0])[:k4_len].ljust(k4_len, b"\0"),
                           args.reps, bw, dev)

    mark("1-2")
    tmp = tempfile.mkdtemp(prefix="chip_smoke_")
    by_path = {}  # launches per path, each zeroed just before it
    try:
        by_path["3"], _w, _r = main_path(data, dev, os.path.join(tmp, "uncoded"))
        by_path["4"] = coded_path(data, dev, os.path.join(tmp, "coded"))
        mark("3-4")
        del data
        t0 = time.perf_counter()
        parts = terasort_parts(args.seed, args.total_mib * MiB)
        input_rows = sort_rows(rows_of(parts))
        print(f"generated the TeraSort input ({sum(p.n for p in parts)} records) and "
              f"its row order in {time.perf_counter() - t0:.1f} s")
        digests_5a = {}
        root_5a = os.path.join(tmp, "terasort")
        by_path["5a"], wall_5a, read_5a = record_path(
            "5a bypass-merge", parts, input_rows, dev, root_5a, bypass=200,
            after=lambda _m: digests_5a.update(object_digests(root_5a)))
        assert read_5a["gather_routes"]["native-segmented"] > 0, \
            f"5a: the native segmented gather was not taken: {read_5a['gather_routes']}"
        # the defaults' request pattern (speculative_read_quantile 0.99, the
        # registry off, the skew knobs at 0): one GET per (map, reduce)
        # segment, one per index and checksum object, no parity GET
        gets_5a = {kind: read_5a["gets"].get(kind, 0) for kind in ("data", "index", "checksum")}
        print(f"5a GETs by object kind at the defaults: {json.dumps(read_5a['gets'])}; "
              f"data GETs by size {json.dumps(read_5a['data_get_sizes'])}")
        assert "parity" not in read_5a["gets"], read_5a["gets"]
        if args.total_mib == 1024:
            assert gets_5a == {"data": MAPS * PARTS, "index": MAPS, "checksum": MAPS}, gets_5a
        mark("5a")
        # 5b at SERIALIZED_MIB (cut from 1 GiB when phase 12 came, to keep
        # the script's time)
        parts_5b = terasort_parts(args.seed, min(SERIALIZED_MIB, args.total_mib) * MiB)
        by_path["5b"], _wall, _read = record_path("5b serialized", parts_5b,
                                                  sort_rows(rows_of(parts_5b)), dev,
                                                  os.path.join(tmp, "terasort-serialized"),
                                                  bypass=0)
        del parts_5b
        mark("5b")
        pickled = pickled_path(args.seed, dev, os.path.join(tmp, "pickled"))
        by_path["5c group"], by_path["5c fold"] = pickled["group_by_key"], pickled["fold_by_key"]
        mark("5c")
        by_path["6a"] = summed(typed_queries(SQL_SF, dev, os.path.join(tmp, "sql"))[0])
        host_codec_paths(args.seed, dev, os.path.join(tmp, "host-codecs"))
        mark("6")
        split = read_plane_split(args.seed, min(SPLIT_MIB, args.total_mib), dev,
                                 os.path.join(tmp, "split"))
        mark("7")
        window_mib = min(WINDOW_MIB, args.total_mib)
        window_data = make_partitions(args.seed, window_mib * MiB // (MAPS * PARTS))
        windows = {"8a": window_identity(window_data, dev, os.path.join(tmp, "identity"))}
        windows.update(windows_on_off(args.seed, min(WINDOW_SORT_MIB, args.total_mib), dev,
                                      os.path.join(tmp, "windows")))
        windows["8d"] = fallback_layout(window_data, dev, os.path.join(tmp, "fallback"))
        mark("8")
        weather = {}
        by_path["9a"], weather["9a"] = weather_soak(parts, input_rows, dev,
                                                    os.path.join(tmp, "weather"), digests_5a,
                                                    wall_5a)
        mark("9a")
        tune_launches, autotune = autotuned_terasort(parts, input_rows, dev,
                                                     os.path.join(tmp, "autotune"), digests_5a,
                                                     read_5a, wall_5a)
        by_path.update(tune_launches)
        mark("12")
        by_path["9b"], weather["9b"] = commit_redrives(window_data, dev,
                                                       os.path.join(tmp, "commit"))
        by_path["9c"], weather["9c"] = fsspec_path(args.seed, min(FSSPEC_MIB, args.total_mib),
                                                   dev, os.path.join(tmp, "fsspec"))
        mark("9b-9c")
        by_path["10a off"], by_path["10a on"], by_path["10c"], composite = composite_swarm(
            args.seed, min(SWARM_MIB, args.total_mib), dev, os.path.join(tmp, "swarm"))
        by_path["10b"], composite["10b"] = coded_composite(window_data, dev,
                                                           os.path.join(tmp, "coded-composite"))
        del window_data
        mark("10")
        skew = {}
        by_path["11a"], skew["11a"] = skewed_aggregation(args.seed, dev, os.path.join(tmp, "skew"))
        mark("11a")
        spec_launches, skew["11b"] = straggler_speculation(
            args.seed, min(SPEC_MIB, args.total_mib), dev, os.path.join(tmp, "speculation"))
        by_path.update({f"11b {run}": counts for run, counts in spec_launches.items()})
        mark("11b")
        obs_launches, observability_numbers = observability(args.seed, dev,
                                                            os.path.join(tmp, "observability"))
        by_path.update(obs_launches)
        mark("13")
        # last, so that no earlier phase runs after it: what it leaves
        # behind is checked at its end
        control_launches, control = control_plane(parts, input_rows, dev,
                                                  os.path.join(tmp, "control"), digests_5a,
                                                  read_5a, wall_5a, args.seed)
        by_path.update(control_launches)
        mark("14")
        fleet_launches, fleet_numbers = fleet(parts, input_rows, os.path.join(tmp, "fleet"),
                                              args.seed)
        by_path.update(fleet_launches)
        del parts, input_rows
        mark("15")
        mesh_launches, mesh_numbers = mesh_plane_and_bridge(args.seed, dev,
                                                            os.path.join(tmp, "phase16"), card)
        by_path.update(mesh_launches)
        mark("16")
        witness_launches, witness_numbers = concurrency_witnesses(
            args.seed, os.path.join(tmp, "phase17"), card)
        by_path.update(witness_launches)
        mark("17")
        driver_launches, driver_numbers = drivers_and_queries(
            args.seed, dev, os.path.join(tmp, "phase18"), card)
        by_path.update(driver_launches)
        mark("18")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    print("seconds by phase (host clock, data generation included): "
          + ", ".join(f"{name} {dt:.1f}" for name, dt in phase_s.items())
          + f"; whole script {time.perf_counter() - t_script:.1f}")
    for k in kernels:
        kernel = k["name"].split("[")[0]  # a kernel timed on another batch or shape
        # this slice's main path is phase 18a: K1-K3 from the four queries
        # q49, q75, q64 and q95 at SF 100 (summed); K4 from 17b witnessed,
        # the coded composite (phase 18 runs nothing coded); every path's
        # count is listed beside
        k["launches"] = by_path["18a" if kernel != "gf_encode"
                                else "17b witnessed"].get(kernel, 0)
        k["launches_by_path"] = {path: counts.get(kernel, 0) for path, counts in by_path.items()}
    print(json.dumps({"drivers_and_queries": driver_numbers}))
    print(json.dumps({"concurrency_witnesses": witness_numbers}))
    print(json.dumps({"mesh_plane_and_bridge": mesh_numbers}))
    print(json.dumps({"worker_fleet": fleet_numbers}))
    print(json.dumps({"control_plane": control}))
    print(json.dumps({"observability": observability_numbers}))
    print(json.dumps({"autotune": autotune}))
    print(json.dumps({"skew_and_speculation": skew}))
    print(json.dumps({"composite_commits": composite}))
    print(json.dumps({"store_weather": weather}))
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
