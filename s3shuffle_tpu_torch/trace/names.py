"""Span-name registry: every trace span and counter name (the JAX
package's ``trace/names.py``, whole, so both packages name their spans
alike and ``tools/critical_path.py`` buckets either's trace, plus the
port's own stage spans: ``driver.sample`` and ``driver.cleanup`` of
``ShuffleContext``'s jobs, the ``record.*`` spans of the record layer and
the ``codec.*`` batch stages, each timed into the codec's ``timings``; and
the typed layer's ``record.expand`` (a rollup's expansion), ``record.combine``
(the columnar combine) and ``record.rank`` (a window's rank) with the
``combine_rows_in`` / ``combine_rows_out`` counts of the map-side combine,
which the codec's ``timings`` hold under the same names).

Kinds:

- ``span``: a timed ``with trace.span(name): ...`` region (a Chrome-trace
  complete event; also a flight-recorder record name);
- ``counter``: a ``trace.count(name)`` accumulator exported in the trace
  file's ``otherData.counters``.

Names follow ``<plane>.<operation>``; the plane prefix is what the
critical-path analyzer buckets blame by. The port has the sites of the
storage, read, write, codec, ``meta.rpc`` (the metadata service),
``worker.*`` (``worker.py``), ``driver.*`` (``cluster.py``) and
``witness.violation`` (``utils/protowitness.py``) names; ``shuffle.py``
opens ``driver.map_stage``, ``driver.reduce_stage`` and ``worker.task``
too. ``KNOWN_SPANS`` stays a pure literal.
"""

#: name -> kind ("span" | "counter"); a pure literal
KNOWN_SPANS = {
    "combine_rows_in": "counter",
    "combine_rows_out": "counter",
    "codec.compress_batch": "span",
    "codec.crc_host": "span",
    "codec.decode_emit": "span",
    "codec.decode_parse": "span",
    "codec.decode_validate": "span",
    "codec.device_wait": "span",
    "codec.encode_assembly": "span",
    "codec.encode_stage": "span",
    "driver.cleanup": "span",
    "driver.collect": "span",
    "driver.compact": "span",
    "driver.job": "span",
    "driver.map_stage": "span",
    "driver.publish_snapshot": "span",
    "driver.reduce_stage": "span",
    "driver.sample": "span",
    "driver.stage_inputs": "span",
    "meta.rpc": "span",
    "read.chunked_prefill": "span",
    "read.index_prefetch": "span",
    "read.prefetch": "span",
    "read.tasks": "counter",
    "record.combine": "span",
    "record.deserialize": "span",
    "record.expand": "span",
    "record.partition": "span",
    "record.rank": "span",
    "record.serialize": "span",
    "record.sort": "span",
    "storage.op": "span",
    "witness.violation": "span",
    "worker.drain": "span",
    "worker.task": "span",
    "write.commit": "span",
    "write.composite_flush": "span",
    "write.upload_chunk": "span",
}
