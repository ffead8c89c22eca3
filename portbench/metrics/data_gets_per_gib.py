"""data_gets_per_gib: positioned reads of data objects that reached the
store (beneath the retry layer) per GiB of user bytes, in the traced
window."""

from portbench.readings import GiB


def read(obs):
    if not obs["user_bytes"]:
        return None
    return obs["data_gets"] / (obs["user_bytes"] / GiB)
