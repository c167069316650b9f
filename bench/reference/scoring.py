"""Scores of one accuracy point and the row-wise KL used to compare logits,
computed in blocks of rows (float32)."""
from __future__ import annotations

import math

import torch

F32 = torch.float32
BLOCK = 512


def kl_rows(p_logits: torch.Tensor, q_logits: torch.Tensor) -> torch.Tensor:
    """KL(softmax(p) || softmax(q)) of every row (last axis the vocab)."""
    V = p_logits.shape[-1]
    p2 = p_logits.reshape(-1, V)
    q2 = q_logits.reshape(-1, V).to(p2.device)
    out = []
    for r0 in range(0, p2.shape[0], BLOCK):
        lp = torch.log_softmax(p2[r0:r0 + BLOCK].to(F32), dim=-1)
        lq = torch.log_softmax(q2[r0:r0 + BLOCK].to(F32), dim=-1)
        out.append(torch.sum(torch.exp(lp) * (lp - lq), dim=-1))
    return torch.cat(out)


def point_scores(exact: torch.Tensor, analog: torch.Tensor,
                 tokens: torch.Tensor) -> tuple:
    """(mean KL(exact || analog) over positions, share of positions whose
    greedy token agrees, perplexity of the next token under the analog and
    under the exact logits) of (B, S, V) logits and (B, S) tokens."""
    B, S, V = exact.shape
    kl = kl_rows(exact, analog)
    agree, nll_a, nll_e = 0, 0.0, 0.0
    for b in range(B):
        for s0 in range(0, S, BLOCK):
            e = exact[b, s0:s0 + BLOCK].to(F32)
            a = analog[b, s0:s0 + BLOCK].to(F32)
            agree += int(torch.sum(torch.argmax(e, -1) == torch.argmax(a, -1)))
            nxt = tokens[b, s0 + 1:s0 + BLOCK + 1].long()
            n = nxt.shape[0]
            if n:
                la = torch.log_softmax(a[:n], dim=-1)
                le = torch.log_softmax(e[:n], dim=-1)
                nll_a -= float(torch.sum(la.gather(-1, nxt[:, None])))
                nll_e -= float(torch.sum(le.gather(-1, nxt[:, None])))
    n_pred = B * (S - 1)
    return (float(torch.mean(kl)), agree / (B * S),
            math.exp(nll_a / n_pred), math.exp(nll_e / n_pred))
