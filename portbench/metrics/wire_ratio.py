"""wire_ratio: raw bytes of the frames the port wrote (their headers'
uncompressed lengths, read as the data objects reach the store) per user
byte, in the traced window."""

from portbench.readings import wire_ratio as read  # noqa: F401
