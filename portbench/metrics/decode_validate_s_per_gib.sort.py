"""decode_validate_s_per_gib.sort: host seconds of the TLZ decode's plane
validation (the ``codec.decode_validate`` span, ``decode_validate_s`` in
the codec's timings, a part of ``decode_parse_s``, summed over threads) per
user GiB, in the traced window."""

from portbench.readings import per_user_gib


def read(obs):
    t = obs["codec_timings"]
    if "decode_validate_s" not in t:
        return None
    return per_user_gib(obs, t["decode_validate_s"])
