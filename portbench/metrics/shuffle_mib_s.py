"""shuffle_mib_s: raw user bytes of the shuffle jobs completed in the
window, in MiB, over the whole window (the unit in flight at its end
included), on the host clock."""

from portbench.readings import MiB


def read(obs):
    if not obs["units"]:
        return None
    return obs["user_bytes"] / MiB / obs["window_s"]
