"""The one generator of traffic: it reads a mix's parameters and makes its
rounds. A mix file (``traffic/<mix>.json``) holds:

- ``loop``: ``"closed"``: ``clients`` clients, each waiting for its reply
  before it sends again, served as one round of ``clients`` requests at a
  time, all of one prompt length, as a bucketing server groups them;
- ``prompt_lengths``: the prompt length of each round, in a cycle;
- ``output_tokens``: the tokens each reply holds (the first from the
  prefill, the rest from decode steps through the cache);
- ``max_len``: the length of the cache a round runs with;
- ``sampling``: ``"greedy"``.

The seed draws the prompts' tokens and nothing of the mix: every seed sends
the same lengths in the same order.
"""

from __future__ import annotations

import numpy as np

SEED_MOD = 2 ** 63


def validate(mix: dict) -> None:
    if mix["loop"] != "closed":
        raise ValueError(f"{mix['name']}: loop {mix['loop']!r} is not "
                         f"generated (closed only)")
    if mix["sampling"] != "greedy":
        raise ValueError(f"{mix['name']}: sampling {mix['sampling']!r}")
    longest = max(mix["prompt_lengths"]) + mix["output_tokens"]
    if longest > mix["max_len"]:
        raise ValueError(f"{mix['name']}: {longest} tokens exceed max_len "
                         f"{mix['max_len']}")


def round_length(mix: dict, i: int) -> int:
    """The prompt length of round ``i`` (0-based)."""
    lengths = mix["prompt_lengths"]
    return lengths[i % len(lengths)]


def cycle(mix: dict) -> int:
    """Rounds in one pass over the mix's lengths."""
    return len(mix["prompt_lengths"])


def prompts(mix: dict, seed: int, i: int, vocab: int) -> np.ndarray:
    """The prompts of round ``i``: (clients, length) int32 token ids, drawn
    from ``seed`` and ``i`` alone."""
    rng = np.random.default_rng([int(seed) % SEED_MOD, i])
    return rng.integers(0, vocab, (mix["clients"], round_length(mix, i)),
                        dtype=np.int32)


def warmup_prompts(mix: dict, seed: int, vocab: int) -> np.ndarray:
    """Prompts at the mix's longest length for the warm-up, drawn apart from
    every round's."""
    rng = np.random.default_rng([int(seed) % SEED_MOD, 2 ** 62])
    return rng.integers(0, vocab, (mix["clients"],
                                   max(mix["prompt_lengths"])),
                        dtype=np.int32)


def tokens_of_round(mix: dict, i: int) -> int:
    """Prompt plus generated tokens of a completed round."""
    return mix["clients"] * (round_length(mix, i) + mix["output_tokens"])
