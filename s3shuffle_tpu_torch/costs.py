"""Object-storage economics: the rate card and the $/shuffle cost digest
(the JAX package's ``costs.py``).

Object stores price per request class and per byte moved, so PUT and GET
counts are a cost, not only a latency. This module converts a metrics
registry snapshot's store counters (``storage_op_seconds{scheme,op}``,
``storage_read/write_bytes_total``) into dollars through a configurable
rate card (the ``cost_rate_card`` knob; the default is S3-Standard-like).
The conversion is a pure function of a snapshot, so it prices one process
or a merged snapshot alike. ``config.py`` validates the knob with
:func:`parse_rate_card`.
"""

from __future__ import annotations

from typing import Dict, Optional

from s3shuffle_tpu_torch.metrics import registry as _metrics

GiB = 1 << 30

#: dollars per unit: per single request for the op classes, per GiB moved
#: for the byte classes. Defaults approximate S3 Standard (us-east-1):
#: $0.0004/1k GET-class, $0.005/1k PUT-class, DELETE free, intra-region
#: transfer free. Override per deployment with the ``cost_rate_card`` knob.
DEFAULT_RATE_CARD = {
    "get": 0.0000004,
    "put": 0.000005,
    "list": 0.000005,
    "delete": 0.0,
    "gb_read": 0.0,
    "gb_written": 0.0,
}

#: ``storage_op_seconds`` op label -> rate-card class. ``write`` is absent
#: deliberately: per-buffer-flush stream writes are not store requests — the
#: request is the ``write_close`` commit (and ``create`` the initiate).
OP_TO_CLASS = {
    "read": "get",
    "open": "get",
    "status": "get",
    "create": "put",
    "write_close": "put",
    "rename": "put",  # server-side copy bills as a PUT-class request
    "list": "list",
    "delete": "delete",
}

_C_COST = _metrics.REGISTRY.counter(
    "cost_dollars_total",
    "Dollars attributed to storage activity, by rate-card op class",
    labelnames=("op_class",),
)


def parse_rate_card(spec: str) -> Dict[str, float]:
    """``"get=4e-7,put=5e-6"`` → a full rate card (unnamed classes keep
    their defaults). Empty/None → the default card. Raises ``ValueError``
    on unknown classes, malformed entries, or negative rates; config
    construction calls this, so a mistyped card fails up front."""
    card = dict(DEFAULT_RATE_CARD)
    if not spec:
        return card
    for item in spec.split(","):
        item = item.strip()
        if not item:
            continue
        key, sep, value = item.partition("=")
        key = key.strip()
        if not sep or key not in card:
            raise ValueError(
                f"cost_rate_card entry {item!r}: expected <class>=<rate> with "
                f"class in {sorted(card)}"
            )
        rate = float(value)
        if rate < 0:
            raise ValueError(f"cost_rate_card rate for {key!r} must be >= 0")
        card[key] = rate
    return card


def _op_counts(snapshot: dict) -> Dict[str, float]:
    """Request count per rate-card class from the op-latency histogram
    (every timed op observed exactly once, so ``count`` IS the op count)."""
    by_class: Dict[str, float] = {}
    for series in snapshot.get("storage_op_seconds", {}).get("series", []):
        cls = OP_TO_CLASS.get(series.get("labels", {}).get("op", ""))
        if cls is not None:
            by_class[cls] = by_class.get(cls, 0.0) + float(series.get("count", 0))
    return by_class


def _counter_total(snapshot: dict, name: str) -> float:
    return sum(
        float(s.get("value", 0)) for s in snapshot.get(name, {}).get("series", [])
    )


def cost_digest(
    snapshot: dict,
    rate_card: Optional[Dict[str, float]] = None,
    shuffles: int = 1,
) -> dict:
    """Price a metrics-registry snapshot. Returns the per-class op counts,
    bytes moved, per-class dollars, the total, and ``dollars_per_shuffle``
    (total / max(1, shuffles))."""
    card = dict(rate_card) if rate_card is not None else dict(DEFAULT_RATE_CARD)
    ops = _op_counts(snapshot)
    read_b = _counter_total(snapshot, "storage_read_bytes_total")
    written_b = _counter_total(snapshot, "storage_write_bytes_total")
    dollars: Dict[str, float] = {}
    for cls, n in ops.items():
        dollars[cls] = n * card.get(cls, 0.0)
    if read_b > 0:
        dollars["gb_read"] = (read_b / GiB) * card.get("gb_read", 0.0)
    if written_b > 0:
        dollars["gb_written"] = (written_b / GiB) * card.get("gb_written", 0.0)
    total = sum(dollars.values())
    return {
        "rate_card": card,
        "ops": ops,
        "read_bytes": read_b,
        "written_bytes": written_b,
        "dollars": dollars,
        "dollars_total": total,
        "shuffles": max(1, int(shuffles)),
        "dollars_per_shuffle": total / max(1, int(shuffles)),
    }


def record_cost_metrics(digest: dict) -> None:
    """Mirror a digest's per-class dollars into ``cost_dollars_total``, so
    the cost rides the same registry and renders as every other metric."""
    for cls, value in digest.get("dollars", {}).items():
        if value:
            _C_COST.labels(op_class=cls).inc(value)
