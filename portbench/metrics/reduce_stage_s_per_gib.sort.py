"""reduce_stage_s_per_gib.sort: wall seconds of the jobs' reduce stages
(the ``driver.reduce_stage`` span of ``ShuffleContext.run_shuffle``,
``reduce_stage_s`` in the codec's timings) per user GiB, in the traced
window."""

from portbench.readings import per_user_gib


def read(obs):
    t = obs["codec_timings"]
    if "reduce_stage_s" not in t:
        return None
    return per_user_gib(obs, t["reduce_stage_s"])
