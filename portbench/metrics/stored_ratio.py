"""stored_ratio: bytes created in the store in the window (data, index and
checksum objects, counted beneath the retry layer) per user byte of the
units completed in it."""


def read(obs):
    if not obs["user_bytes"]:
        return None
    return obs["created_bytes"] / obs["user_bytes"]
