"""combine_host_s_per_gib.q67: host seconds of the columnar combine, the
map-side combine and the reduce-side merge together (the ``record.combine``
span, ``combine_host_s`` in the codec's timings, summed over threads) per
user GiB, in the traced window."""

from portbench.readings import per_user_gib


def read(obs):
    t = obs["codec_timings"]
    if "combine_host_s" not in t:
        return None
    return per_user_gib(obs, t["combine_host_s"])
