"""The codec's least time at the card's memory bandwidth over the union
of all kernel intervals in the traced window, in %."""

from portbench.readings import codec_roofline as read  # noqa: F401
