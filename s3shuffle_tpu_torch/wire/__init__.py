"""Wire-format registry of the port (the JAX package's ``wire/``).

:mod:`s3shuffle_tpu_torch.wire.schema` declares every on-wire struct the
port reads or writes: store-object blobs (index, fat index, snapshot,
parity sidecars), object-name grammars and the versioned RPC payloads.
"""

from s3shuffle_tpu_torch.wire.schema import WIRE_STRUCTS, render_wire_doc

__all__ = ["WIRE_STRUCTS", "render_wire_doc"]
