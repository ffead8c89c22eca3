"""map_stage_s_per_gib.sort: wall seconds of the jobs' map stages (the
``driver.map_stage`` span of ``ShuffleContext.run_shuffle``, ``map_stage_s``
in the codec's timings) per user GiB, in the traced window."""

from portbench.readings import per_user_gib


def read(obs):
    t = obs["codec_timings"]
    if "map_stage_s" not in t:
        return None
    return per_user_gib(obs, t["map_stage_s"])
