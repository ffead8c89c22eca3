"""record_host_s_per_gib.sort: host seconds of the record layer (the
``record.partition``, ``record.serialize``, ``record.deserialize`` and
``record.sort`` spans, ``record_host_s`` in the codec's timings, summed
over threads) per user GiB, in the traced window."""

from portbench.readings import per_user_gib


def read(obs):
    t = obs["codec_timings"]
    if "record_host_s" not in t:
        return None
    return per_user_gib(obs, t["record_host_s"])
