"""The general traffic generator: a mix is a data file
(``traffic/<name>.json``) of request parameters, and this module turns it
and a seed into requests.

A mix names the entry (``entries/<entry>.py``) and the loop
(``loops/<loop>.py``) with its clients, the images a request (``batch``),
the words of each prompt, the negative prompt, the warm-up's steps, the
requests of a traced run, and the ``source`` of its settings.  Every other
key (size, sampler, steps, timestep grid, guidance scale, and what an
entry adds, such as the hires fix's base size and strength) is copied into
each request for the entry.  Every request of a run has the same sizes;
the seed draws its prompts and its noise seed.

Prompts are words of a fixed vocabulary: "q" and three of the 25 other
letters, 15,625 words.  The benchmark writes the tokenizer's vocabulary and
merges itself (each word merges left to right into one token: no word
holds a "q" after its first letter, so no merge of another word applies
inside it), and both the program and the reference read them.
"""

from __future__ import annotations

import itertools
import random
from typing import Dict, Iterator, List, Tuple

LETTERS = "abcdefghijklmnoprstuvwxyz"
#: per-run seed streams: request i of a run draws from (seed, STREAM, i)
STREAM = 0x7AFF1C
#: a mix's keys that shape the run rather than each request
RUN_KEYS = ("entry", "loop", "clients", "batch", "prompt_words", "uncond_prompt",
            "warmup_steps", "trace_requests", "source")


def words() -> List[str]:
    return ["q" + "".join(t) for t in itertools.product(LETTERS, repeat=3)]


def vocabulary() -> Tuple[Dict[str, int], List[Tuple[str, str]]]:
    """The tokenizer's vocabulary and merges: every letter alone and as a
    word end, each word's left-to-right merges, then the start and end of
    text."""
    vocab: Dict[str, int] = {}
    merges: List[Tuple[str, str]] = []

    def add(tok: str) -> None:
        if tok not in vocab:
            vocab[tok] = len(vocab)

    for ch in "q" + LETTERS:
        add(ch)
        add(ch + "</w>")
    seen = set()
    for w in words():
        parts = list(w)
        parts[-1] += "</w>"
        while len(parts) > 1:
            pair = (parts[0], parts[1])
            if pair not in seen:
                seen.add(pair)
                merges.append(pair)
                add(pair[0] + pair[1])
            parts[:2] = [parts[0] + parts[1]]
    add("<|startoftext|>")
    add("<|endoftext|>")
    return vocab, merges


def request(mix: dict, seed: int, i: int, vocab_words: List[str]) -> dict:
    """Request ``i`` of a run of ``seed``."""
    rng = random.Random(f"{seed}/{STREAM}/{i}")
    prompts = [" ".join(rng.choice(vocab_words) for _ in range(mix["prompt_words"]))
               for _ in range(mix["batch"])]
    req = {k: v for k, v in mix.items() if k not in RUN_KEYS}
    req.update(prompts=prompts, uncond=mix["uncond_prompt"], seed=rng.getrandbits(31),
               index=i)
    return req


def requests(mix: dict, seed: int) -> Iterator[dict]:
    vocab_words = words()
    for i in itertools.count():
        yield request(mix, seed, i, vocab_words)


def warmup(mix: dict, seed: int) -> dict:
    """A short request at the mix's own shapes: the warm-up of set-up."""
    req = request(mix, seed, -1, words())
    req["steps"] = mix["warmup_steps"]
    return req
