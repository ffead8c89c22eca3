"""Batched, pipelined control-plane client (the JAX package's
``metadata/async_client.py``): fewer, fatter RPCs.

:class:`~s3shuffle_tpu_torch.metadata.service.RemoteMapOutputTracker` is one
socket behind one lock: every registration is its own blocking round-trip,
and a worker's concurrent callers queue on the socket. This client keeps
that class as its transport (its reconnect and retries ride unchanged) and
batches along two axes:

- **registrations**: ``register_map_output`` buffers, and :meth:`flush`
  sends one ``register_map_outputs`` RPC per connection for everything
  buffered; it flushes itself at ``batch_max``, before every read (so the
  client reads its own writes) and on close;
- **lookups**: the ``*_async`` variants return futures from a small
  executor over K connections (one per shard endpoint the server
  advertises, else the primary only), so K lookups are in flight at once.

The synchronous :class:`~s3shuffle_tpu_torch.metadata.map_output.MapOutputTrackerLike`
surface is kept: it drops into
:class:`~s3shuffle_tpu_torch.manager.ShuffleManager` as its tracker.
"""

from __future__ import annotations

import logging
import threading
import time
from concurrent.futures import Future, ThreadPoolExecutor
from typing import Dict, List, Optional, Tuple

from s3shuffle_tpu_torch.metadata.map_output import MapStatus
from s3shuffle_tpu_torch.metadata.service import RemoteMapOutputTracker
from s3shuffle_tpu_torch.metrics import registry as _metrics

logger = logging.getLogger("s3shuffle_tpu_torch.metadata.async_client")

_H_BATCH_FLUSH = _metrics.REGISTRY.histogram(
    "meta_batch_flush_seconds",
    "Wall time of one batched map-output registration flush (all "
    "connections, one RPC each)",
)


class AsyncTrackerClient:
    """Batched/pipelined tracker client over K transport connections.

    ``connections`` defaults to the number of shard endpoints the
    coordinator advertises (``shard_addresses``), falling back to 1. Thread
    safety matches the wrapped transports: each connection has its own lock,
    the registration buffer has its own; callers may share one instance.
    """

    def __init__(
        self,
        address: Tuple[str, int],
        connections: Optional[int] = None,
        batch_max: int = 64,
        **transport_kwargs,
    ):
        self.address = (address[0], int(address[1]))
        self.batch_max = max(1, int(batch_max))
        primary = RemoteMapOutputTracker(
            self.address, shard_label="0", **transport_kwargs
        )
        self._conns: List[RemoteMapOutputTracker] = [primary]
        try:
            shard_addrs = primary.shard_addresses()
        except Exception as e:  # pre-sharding coordinator: primary only
            logger.debug("coordinator advertises no shard endpoints: %s", e)
            shard_addrs = []
        # a coordinator bound to a wildcard (0.0.0.0 / ::) advertises that
        # bind address verbatim; substitute the host we actually reached —
        # the wildcard would point a remote worker at its own loopback
        targets = [
            (self.address[0] if a[0] in ("0.0.0.0", "::", "") else a[0], int(a[1]))
            for a in shard_addrs
        ]
        if not targets and connections and int(connections) > 1:
            targets = [self.address] * (int(connections) - 1)
        for i, addr in enumerate(targets):
            self._conns.append(
                RemoteMapOutputTracker(
                    (addr[0], int(addr[1])),
                    shard_label=str(i + 1),
                    **transport_kwargs,
                )
            )
        self._rr = 0
        self._rr_lock = threading.Lock()
        self._buf_lock = threading.Lock()
        self._buffer: List[Tuple[int, MapStatus]] = []
        # held through a whole flush: a flush (and so a read) that finds
        # the buffer drained waits for the RPCs of one still in flight
        self._flush_lock = threading.Lock()
        self._pool = ThreadPoolExecutor(
            max_workers=len(self._conns), thread_name_prefix="s3shuffle-meta"
        )
        self._closed = False

    @classmethod
    def from_config(cls, address: Tuple[str, int], config,
                    **transport_kwargs) -> "AsyncTrackerClient":
        """A client that flushes at ``config.metadata_batch_max``, as the JAX
        package's workers build theirs (``cluster.py``: ``_init_worker``)."""
        return cls(address, batch_max=config.metadata_batch_max, **transport_kwargs)

    # -- connection routing --------------------------------------------
    @property
    def connections(self) -> int:
        return len(self._conns)

    def _route_index(self, shuffle_id: int, map_index: int) -> int:
        """Which connection a registration rides — one expression, used by
        every routing site."""
        return (shuffle_id * 1000003 + map_index) % len(self._conns)

    def _next_conn(self) -> RemoteMapOutputTracker:
        with self._rr_lock:
            self._rr = (self._rr + 1) % len(self._conns)
            return self._conns[self._rr]

    @property
    def primary(self) -> RemoteMapOutputTracker:
        return self._conns[0]

    # -- batched registration ------------------------------------------
    def register_map_output(self, shuffle_id: int, status: MapStatus) -> None:
        """Buffer one registration; durable only after :meth:`flush` (called
        automatically at ``batch_max``, before any read, and on close).
        Callers with a commit barrier flush AT the barrier — the registration
        then rides one RPC for the whole commit."""
        with self._buf_lock:
            self._buffer.append((int(shuffle_id), status))
            need_flush = len(self._buffer) >= self.batch_max
        if need_flush:
            self.flush()

    def register_map_outputs(self, shuffle_id: int, statuses: List[MapStatus]) -> None:
        for status in statuses:
            with self._buf_lock:
                self._buffer.append((int(shuffle_id), status))
        self.flush()

    def pending_registrations(self) -> int:
        with self._buf_lock:
            return len(self._buffer)

    def flush(self) -> None:
        """Drain the registration buffer: group by (shuffle, route), one
        ``register_map_outputs`` RPC per connection touched, issued
        concurrently. Raises the first failure AFTER all sends settle (no
        buffered registration is silently dropped — failures re-raise to the
        committing caller, whose task then fails and retries).

        A departure from the JAX client: flushes are serialized, so a flush
        returns only once every registration buffered before it is on the
        server, including those another thread's flush drained and is still
        sending. In the JAX client a concurrent reader finds the buffer
        empty and looks up before those RPCs land (its reduce tasks of one
        ``ShuffleContext`` can miss a map's blocks). The RPCs are the same."""
        with self._flush_lock:
            with self._buf_lock:
                if not self._buffer:
                    return
                drained, self._buffer = self._buffer, []
            self._send(drained)

    def _send(self, drained: List[Tuple[int, MapStatus]]) -> None:
        t0 = time.perf_counter_ns()
        groups: Dict[Tuple[int, int], List[MapStatus]] = {}
        for shuffle_id, status in drained:
            conn_idx = self._route_index(shuffle_id, status.map_index)
            groups.setdefault((conn_idx, shuffle_id), []).append(status)
        futures = [
            self._pool.submit(
                self._conns[conn_idx].register_map_outputs, shuffle_id, statuses
            )
            for (conn_idx, shuffle_id), statuses in groups.items()
        ]
        first_error: Optional[BaseException] = None
        for fut in futures:
            try:
                fut.result()
            except BaseException as e:
                if first_error is None:
                    first_error = e
        if _metrics.enabled():
            _H_BATCH_FLUSH.observe((time.perf_counter_ns() - t0) / 1e9)
        if first_error is not None:
            raise first_error

    # -- pipelined lookups ---------------------------------------------
    def get_map_sizes_by_range_async(
        self, shuffle_id, start_map_index, end_map_index,
        start_partition, end_partition,
    ) -> Future:
        self.flush()
        conn = self._next_conn()
        return self._pool.submit(
            conn.get_map_sizes_by_range,
            shuffle_id, start_map_index, end_map_index,
            start_partition, end_partition,
        )

    def get_map_sizes_by_ranges_async(
        self, shuffle_id, start_map_index, end_map_index, partition_ranges
    ) -> Future:
        self.flush()
        conn = self._next_conn()
        return self._pool.submit(
            conn.get_map_sizes_by_ranges,
            shuffle_id, start_map_index, end_map_index, partition_ranges,
        )

    # -- synchronous MapOutputTrackerLike surface ----------------------
    # Reads flush first (read-your-writes); fan over connections round-robin
    # so concurrent callers don't serialize on one socket lock.
    def get_map_sizes_by_range(
        self, shuffle_id, start_map_index, end_map_index,
        start_partition, end_partition,
    ):
        self.flush()
        return self._next_conn().get_map_sizes_by_range(
            shuffle_id, start_map_index, end_map_index,
            start_partition, end_partition,
        )

    def get_map_sizes_by_ranges(
        self, shuffle_id, start_map_index, end_map_index, partition_ranges
    ):
        self.flush()
        return self._next_conn().get_map_sizes_by_ranges(
            shuffle_id, start_map_index, end_map_index, partition_ranges
        )

    def register_shuffle(self, shuffle_id: int, num_partitions: int) -> None:
        self.primary.register_shuffle(shuffle_id, num_partitions)

    def contains(self, shuffle_id: int) -> bool:
        self.flush()
        return self._next_conn().contains(shuffle_id)

    def num_partitions(self, shuffle_id: int) -> int:
        return self._next_conn().num_partitions(shuffle_id)

    def registered_map_ids(self, shuffle_id: int) -> List[int]:
        self.flush()
        return self._next_conn().registered_map_ids(shuffle_id)

    def composite_locations(self, shuffle_id: int):
        self.flush()
        return self._next_conn().composite_locations(shuffle_id)

    def shuffle_ids(self) -> List[int]:
        self.flush()
        return self.primary.shuffle_ids()

    def unregister_shuffle(self, shuffle_id: int) -> None:
        self.flush()
        self.primary.unregister_shuffle(shuffle_id)

    def epoch(self, shuffle_id: int) -> int:
        self.flush()
        return self.primary.epoch(shuffle_id)

    def get_snapshot(self, shuffle_id: int):
        self.flush()
        return self.primary.get_snapshot(shuffle_id)

    # -- stats passthrough ---------------------------------------------
    def report_task_stats(self, entries: List[dict]) -> None:
        self.primary.report_task_stats(entries)

    def get_shuffle_stats(self, shuffle_id: int) -> Optional[dict]:
        return self.primary.get_shuffle_stats(shuffle_id)

    # -- lifecycle ------------------------------------------------------
    def close(self) -> None:
        if self._closed:
            return
        self._closed = True
        try:
            self.flush()
        except Exception:
            logger.warning("final registration flush failed on close", exc_info=True)
        self._pool.shutdown(wait=True)
        for conn in self._conns:
            conn.close()

    def __enter__(self) -> "AsyncTrackerClient":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
