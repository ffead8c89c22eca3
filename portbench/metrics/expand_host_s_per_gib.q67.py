"""expand_host_s_per_gib.q67: host seconds of the rollup's expansion in
the map tasks (the ``record.expand`` span, ``expand_host_s`` in the
codec's timings, summed over threads) per user GiB, in the traced window."""

from portbench.readings import per_user_gib


def read(obs):
    t = obs["codec_timings"]
    if "expand_host_s" not in t:
        return None
    return per_user_gib(obs, t["expand_host_s"])
