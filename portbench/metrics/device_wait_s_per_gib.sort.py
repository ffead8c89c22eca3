"""device_wait_s_per_gib.sort: host seconds the codec spends on the card's
copies, launches and the waits for their results (the ``codec.device_wait``
span, ``encode_device_wait_s + decode_device_wait_s`` in the codec's
timings, summed over threads) per user GiB, in the traced window."""

from portbench.readings import per_user_gib

KEYS = ("encode_device_wait_s", "decode_device_wait_s")


def read(obs):
    t = obs["codec_timings"]
    if not any(k in t for k in KEYS):
        return None
    return per_user_gib(obs, sum(t.get(k, 0.0) for k in KEYS))
