"""The coded shuffle plane: GF(2^8) parity sidecars (``parity.py``, written
beside each data object) and loss reconstruction on read (``degraded.py``),
on the batched parity encode kernel K4 (``gf.py``, ``gf_cuda.py``)."""
