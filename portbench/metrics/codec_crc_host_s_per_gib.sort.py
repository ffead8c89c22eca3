"""codec_crc_host_s_per_gib.sort: host seconds of the CRC32C of frame
headers and TLZ metadata prefixes that the codec stitches to the kernels'
CRCs (the ``codec.crc_host`` span, ``crc_host_s`` in the codec's timings,
summed over threads) per user GiB, in the traced window."""

from portbench.readings import per_user_gib


def read(obs):
    t = obs["codec_timings"]
    if "crc_host_s" not in t:
        return None
    return per_user_gib(obs, t["crc_host_s"])
