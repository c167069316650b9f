"""FLOPs audit of a step function (port of ``repro.launch.flops_audit``).

``audit_step_flops`` runs the step once, on meta tensors (shapes and
dtypes, no storage), under ``torch.utils.flop_counter.FlopCounterMode``
and returns the global matmul / convolution FLOPs it dispatched
(2 M N K per product).  Torch runs every loop iteration (layers,
microbatches, attention chunks) eagerly, and a train step's backward and
its recompute run inside the mode, so each is counted as often as it
runs.

The reference's ``count_jaxpr_flops`` walks a jaxpr and multiplies each
``scan`` body by its trip count, because XLA's cost analysis visits a
loop body once.  It has no counterpart here: a torch step has no jaxpr,
and nothing in it is visited only once.

Elementwise FLOPs are not counted, on either side.  Where the two
programs differ (ROADMAP C20): an einsum without a contracted index, or
with a contraction of size 1, is a broadcast multiply in torch, which
the counter does not count, where the reference's jaxpr has a
``dot_general`` that it does (the Mamba-2 state products); and the port
routes a MoE layer's tokens by index (``models.ffn``: gathers and a k-way
weighted sum), where the reference builds a one-hot (Tg, E, C) combine
tensor and runs the dispatch and the return as einsums over it, so the
reference counts those three einsums, their recompute and their
transposes, and the port counts none.
"""
from __future__ import annotations

from torch.utils.flop_counter import FlopCounterMode


def audit_step_flops(fn, *abstract_args) -> float:
    """Matmul / conv FLOPs of one call of ``fn(*abstract_args)``: global
    for the unsharded step (the reference's count), one rank's for a
    rank's step (``launch.dryrun``)."""
    with FlopCounterMode(display=False) as counter:
        fn(*abstract_args)
    return float(counter.get_total_flops())
