"""codec_stored_ratio: stored payload bytes of the frames the port wrote
per raw byte of them (TLZ frames and raw escapes together), in the traced
window."""

from portbench.readings import codec_stored_ratio as read  # noqa: F401
