"""``prefill_mfu``: the useful model FLOPs of every prefill round of the
window (``counts/<family>.py``) over the sum of their walls (host clock,
ending in a synchronize) times the card's bf16 peak, in %. Layer: the
model step (``make_prefill_step`` -> ``models/model.py`` ``prefill``)."""

from portbench import spec
from portbench.counts.peaks import BF16_FLOP_PER_S


def read(readings):
    rounds = readings["rounds"]
    wall = sum(r["prefill_s"] for r in rounds)
    if not rounds or wall <= 0:
        return None
    config = readings["config"]
    counts = spec.counts(config["family"])
    flops = sum(counts.prefill_flops(config, r["batch"],
                                     r["length"]) for r in rounds)
    return 100.0 * flops / (wall * BF16_FLOP_PER_S)
