"""combine_rows_ratio.q67: rows leaving the map-side combine per row
entering it (``combine_rows_out`` / ``combine_rows_in`` in the codec's
timings), in the traced window."""


def read(obs):
    t = obs["codec_timings"]
    if not t.get("combine_rows_in"):
        return None
    return t.get("combine_rows_out", 0.0) / t["combine_rows_in"]
