"""``decode_step_ms``: each round's decode wall (host clock, ending in a
synchronize) over its decode steps; the median over the window's rounds.
Layer: the serving loop (``launch/steps.py`` ``make_decode_step``)."""

import statistics


def read(readings):
    per_step = [r["decode_s"] / r["decode_steps"] * 1e3
                for r in readings["rounds"] if r["decode_steps"]]
    return statistics.median(per_step) if per_step else None
