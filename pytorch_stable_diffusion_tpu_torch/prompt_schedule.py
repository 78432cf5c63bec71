"""A1111 prompt editing / alternation — per-step conditioning schedules
(port of ``prompt_schedule.py``).

Syntax (the A1111 ``prompt_parser`` conventions):

  * ``[from:to:when]`` — use "from" while step <= when, then "to".
    ``when`` is a 1-based step number, or a fraction of the total step
    count when < 1 (e.g. ``[cat:dog:0.5]`` switches halfway).
  * ``[to:when]``   — add "to" after step ``when``.
  * ``[from::when]`` — drop "from" after step ``when``.
  * ``[a|b|c]``     — alternate per step: step 1 -> a, 2 -> b, 3 -> c,
    4 -> a, ...
  * ``[word]`` with no top-level ``:``/``|`` is NOT schedule syntax — it
    stays verbatim for the emphasis parser (A1111 down-weighting).

The realized per-step prompts are deduplicated into K distinct
conditionings plus an (n_steps,) index map; the pipeline encodes all K in
one batched CLIP call and each step indexes its conditioning from the
stack with the host-side map.

This is a copy of ``pytorch_stable_diffusion_tpu/prompt_schedule.py``:
the module is pure Python, and importing the JAX package would import jax.
tests/test_torch_import.py checks that the copy is verbatim below this
docstring.
"""

from __future__ import annotations

import re
from typing import List, Sequence, Tuple

import numpy as np


def _match_bracket(text: str, i: int) -> int:
    """Index of the ']' matching the '[' at ``i`` (len(text) if unclosed)."""
    depth = 0
    for j in range(i, len(text)):
        if text[j] == "[":
            depth += 1
        elif text[j] == "]":
            depth -= 1
            if depth == 0:
                return j
    return len(text)


def _split_top(s: str, sep: str) -> List[str]:
    parts, cur, depth = [], [], 0
    for ch in s:
        if ch in "[(":
            depth += 1
        elif ch in "])":
            depth -= 1
        if ch == sep and depth == 0:
            parts.append("".join(cur))
            cur = []
        else:
            cur.append(ch)
    parts.append("".join(cur))
    return parts


def _is_number(s: str) -> bool:
    try:
        float(s)
        return True
    except ValueError:
        return False


def _realize_bracket(inner: str, step: int, n_steps: int) -> str:
    alts = _split_top(inner, "|")
    if len(alts) > 1:  # alternation
        return realize(alts[(step - 1) % len(alts)], step, n_steps)
    parts = _split_top(inner, ":")
    if len(parts) >= 2 and _is_number(parts[-1].strip()):
        when = float(parts[-1])
        if when < 1.0:
            when *= n_steps
        when = int(when)
        body = parts[:-1]
        if len(body) == 1:
            before, after = "", body[0]
        else:
            before, after = ":".join(body[:-1]), body[-1]
        return realize(before if step <= when else after, step, n_steps)
    # plain emphasis bracket: keep it (but realize anything nested inside)
    return "[" + realize(inner, step, n_steps) + "]"


def realize(text: str, step: int, n_steps: int) -> str:
    """The prompt as realized at sampling step ``step`` (1-based)."""
    out, i = [], 0
    while i < len(text):
        if text[i] == "[":
            j = _match_bracket(text, i)
            if j == len(text):  # unclosed: literal
                out.append(text[i:])
                break
            out.append(_realize_bracket(text[i + 1:j], step, n_steps))
            i = j + 1
        else:
            out.append(text[i])
            i += 1
    return "".join(out)


def has_schedule(text: str) -> bool:
    """Cheap syntactic pre-check (exact answer comes from realizing)."""
    return "[" in text and (":" in text or "|" in text)


def schedule_prompts(
    prompts: Sequence[str], uncond: Sequence[str], n_steps: int,
) -> Tuple[List[Tuple[Tuple[str, ...], Tuple[str, ...]]], np.ndarray]:
    """-> (K distinct (cond-batch, uncond-batch) realizations in first-use
    order, (n_steps,) int32 index map).  K == 1 means no scheduling."""
    uniq: List[Tuple[Tuple[str, ...], Tuple[str, ...]]] = []
    seen = {}
    idx = np.empty((n_steps,), np.int32)
    for s in range(1, n_steps + 1):
        key = (tuple(realize(p, s, n_steps) for p in prompts),
               tuple(realize(u, s, n_steps) for u in uncond))
        if key not in seen:
            seen[key] = len(uniq)
            uniq.append(key)
        idx[s - 1] = seen[key]
    return uniq, idx


# ------------------------------------------------- composable diffusion
_AND_WEIGHT = re.compile(r"^(.*):([+-]?\d+(?:\.\d+)?)\s*$", re.S)


def split_composable(text: str) -> Tuple[List[str], List[float]]:
    """A1111 composable-diffusion ``AND`` syntax -> (sub-prompts, weights).

    ``"a cat AND a dog:1.2"`` denoises against BOTH conditionings:
    ``eps = eps_uncond + cfg Σ w_i (eps_cond_i − eps_uncond)``.  The weight
    is a trailing ``:number`` on each segment (default 1.0); the greedy
    match takes the LAST colon, so emphasis weights like ``(cat:1.3)``
    inside the segment are untouched.  A prompt with no ``AND`` returns a
    single unit-weight segment.
    """
    if " AND " not in text:
        return [text], [1.0]
    parts, ws = [], []
    for seg in text.split(" AND "):
        m = _AND_WEIGHT.match(seg)
        if m and not m.group(1).rstrip().endswith(("(", "[")):
            parts.append(m.group(1).strip())
            ws.append(float(m.group(2)))
        else:
            parts.append(seg.strip())
            ws.append(1.0)
    return parts, ws


def has_composable(text: str) -> bool:
    return " AND " in text
