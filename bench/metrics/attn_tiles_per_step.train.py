"""Computed (query block, key chunk) tiles of the chunked training
attention per step: the program's ``repro.attn.tile`` spans (one a tile
that ``models.attention.chunked_attention`` computes, in the forward and
again in the backward's per-repeat recompute) in the traced window, over
the window's steps.  A program without the span reads nothing."""

SPAN = "repro.attn.tile"


def read(run):
    n = len(run.records)
    if not n or run.traced is None:
        return None
    tiles = sum(1 for e in run.traced.host if e.name == SPAN)
    return tiles / n if tiles else None
