"""What decides ``correct``: the program's served tokens against the plain
reference.

Once the window has closed, a sample of the requests the program finished
is drawn from the seed, the longest of them always in it, until it holds
``check.sample_tokens`` served tokens.  The reference runs once over each
sampled prompt followed by its served tokens and gives, at every position
where a token was served, the logits of the next token.  The number
compared is the widest gap by which a served token's reference logit lies
below the reference's best logit there (greedy serving would give 0 with
exact arithmetic); its limit is the configuration's
``check.max_logit_gap``.  Also compared: every finished request served
exactly its output length (limit 0 errors).

``control`` runs the reference's float8 version in the program's place:
at the same positions, the gap of the token that the float8 logits put
first.
"""

from __future__ import annotations

import importlib
from typing import Dict, List

import numpy as np
import torch


def sample(finished: List, seed: int, tokens: int) -> List:
    """``finished``: (rid, prompt ids, served ids) of the finished
    requests.  The longest, then others in an order drawn from the seed,
    until ``tokens`` served tokens are in."""
    if not finished:
        return []
    longest = max(range(len(finished)), key=lambda i: len(finished[i][2]))
    rng = np.random.default_rng([seed % 2**63, 3])
    order = [longest] + [int(i) for i in rng.permutation(len(finished))
                         if i != longest]
    out, n = [], 0
    for i in order:
        if n >= tokens:
            break
        out.append(finished[i])
        n += len(finished[i][2])
    return out


def _inputs(picked, device):
    seqs, at, served = [], [], []
    for _, prompt, out in picked:
        toks = np.concatenate([np.asarray(prompt, np.int64),
                               np.asarray(out[:-1], np.int64)])
        seqs.append(torch.as_tensor(toks, device=device))
        P = len(prompt)
        at.append(torch.arange(P - 1, P - 1 + len(out), device=device))
        served.append(torch.as_tensor(np.asarray(out, np.int64),
                                      device=device))
    return seqs, at, served


def gaps(cfg: Dict, seed: int, picked, device, control: bool = False
         ) -> Dict[str, float]:
    """The widest gap of the served tokens (``program``) and, with
    ``control``, of the float8 reference's first tokens (``control``)."""
    ref = importlib.import_module(f"portbench.reference.{cfg['arch']}")
    w = ref.draw_weights(cfg, seed, device)
    seqs, at, served = _inputs(picked, device)
    exact = ref.logits(cfg, w, seqs, at)
    out = {"program": max(float((lg.max(-1).values - lg.gather(
        -1, tok[:, None])[:, 0]).max()) for lg, tok in zip(exact, served))}
    if control:
        low = ref.logits(cfg, w, seqs, at, fp8=True)
        out["control"] = max(
            float((lg.max(-1).values
                   - lg.gather(-1, lo.argmax(-1)[:, None])[:, 0]).max())
            for lg, lo in zip(exact, low))
    return out
