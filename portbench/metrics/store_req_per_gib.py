"""store_req_per_gib: requests that reached the store in the window
(creates, renames, GETs, LIST and status calls, counted beneath the retry
layer) per GiB of user bytes of the units completed in it."""

from portbench.readings import GiB


def read(obs):
    if not obs["user_bytes"]:
        return None
    return obs["requests"] / (obs["user_bytes"] / GiB)
