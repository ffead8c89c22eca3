"""Span-name registry: every trace span and counter name (the JAX
package's ``trace/names.py``, whole, so both packages name their spans
alike and ``tools/critical_path.py`` buckets either's trace).

Kinds:

- ``span``: a timed ``with trace.span(name): ...`` region (a Chrome-trace
  complete event; also a flight-recorder record name);
- ``counter``: a ``trace.count(name)`` accumulator exported in the trace
  file's ``otherData.counters``.

Names follow ``<plane>.<operation>``; the plane prefix is what the
critical-path analyzer buckets blame by. The port has the sites of the
storage, read, write, codec, ``meta.rpc`` (the metadata service),
``worker.*`` (``worker.py``), ``driver.*`` (``cluster.py``) and
``witness.violation`` (``utils/protowitness.py``) names. ``KNOWN_SPANS``
stays a pure literal.
"""

#: name -> kind ("span" | "counter"); a pure literal
KNOWN_SPANS = {
    "codec.compress_batch": "span",
    "driver.collect": "span",
    "driver.compact": "span",
    "driver.job": "span",
    "driver.map_stage": "span",
    "driver.publish_snapshot": "span",
    "driver.reduce_stage": "span",
    "driver.stage_inputs": "span",
    "meta.rpc": "span",
    "read.chunked_prefill": "span",
    "read.index_prefetch": "span",
    "read.prefetch": "span",
    "read.tasks": "counter",
    "storage.op": "span",
    "witness.violation": "span",
    "worker.drain": "span",
    "worker.task": "span",
    "write.commit": "span",
    "write.composite_flush": "span",
    "write.upload_chunk": "span",
}
