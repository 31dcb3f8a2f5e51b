"""The comparison that decides ``correct`` for a served model.

For each sampled request the reference runs once over its prompt and its
served tokens; at each served position the gap is how far the served
token's logit lies below the reference's best there. The number compared
is the widest gap over the sample. The control reads, at the same
positions, the gap of the token its lower precision puts first.
"""

from __future__ import annotations

import torch

from .model import Reference


def positions(prompt: list, served: list) -> tuple[list, range]:
    """(the tokens to run, the positions whose logits predict ``served``)."""
    seq = list(prompt) + list(served[:-1])
    return seq, range(len(prompt) - 1, len(prompt) - 1 + len(served))


def gaps(logits: torch.Tensor, picked: torch.Tensor) -> torch.Tensor:
    """Per position: best logit less the picked token's."""
    return logits.max(dim=-1).values - logits.gather(
        -1, picked[:, None]).squeeze(-1)


def widest_gaps(ref: Reference, samples: list, variants: tuple = ()
                ) -> dict:
    """``samples``: [(prompt ids, served ids)]. Returns ``"served"``: the
    widest gap per request, ``"served_all"``: every position's gap,
    ``"margin_all"``: the reference's lead of its best token over its
    second; and for each precision in ``variants`` (model.Reference) the
    same two gap lists for the tokens that precision puts first."""
    seqs, wanted = zip(*(positions(p, s) for p, s in samples))
    out = ref.logits(list(seqs), list(wanted), ("f32",) + tuple(variants))
    dev = ref.device
    res: dict = {"served": [], "served_all": [], "margin_all": []}
    for v in variants:
        res[v], res[v + "_all"] = [], []
    for i, (_, served) in enumerate(samples):
        r = out["f32"][i]
        g = gaps(r, torch.tensor(served, device=dev))
        res["served"].append(float(g.max()))
        res["served_all"] += g.tolist()
        top2 = r.topk(2, dim=-1).values
        res["margin_all"] += (top2[:, 0] - top2[:, 1]).tolist()
        for v in variants:
            c = gaps(r, out[v][i].argmax(-1))
            res[v].append(float(c.max()))
            res[v + "_all"] += c.tolist()
    return res
