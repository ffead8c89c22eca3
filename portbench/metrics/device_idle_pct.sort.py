"""The share of the traced window with no kernel or copy on the card,
in %."""

from portbench.readings import device_idle_pct as read  # noqa: F401
