"""The paper's six workloads as device-independent op traces (Sec. IV-A).

Each workload is characterized on two targets:

* CPU (Cortex-A72): scalar-equivalent instructions / element, the fraction
  that NEON-vectorizes, memory traffic and footprint (picks the stream level).
* IMC: bit-serial in-array op counts per element — 2-row logic (XOR/NAND...),
  3-row majority (the carry primitive), row writes and reads.  Counts follow
  the standard Pinatubo/MAGIC-style bit-serial arithmetic decompositions:
    8-bit add       : per bit 2x XOR + 1x MAJ + 2 writes (sum, carry)
    8-bit multiply  : 8 shifted partial-product adds => ~16x the add counts
    8-bit compare   : borrow-chain subtract, 1-bit output
  BNN layers use the native XNOR + popcount path (the paper's headline
  workload — binary weights stay resident, only activations are written
  back, but EVERY output bit is a fresh in-array write => write-intensive).
"""
from __future__ import annotations

import dataclasses
from typing import Dict


@dataclasses.dataclass(frozen=True)
class Workload:
    name: str
    n_elems: int
    # CPU side
    cpu_instrs_per_elem: float
    cpu_simd_fraction: float
    cpu_bytes_per_elem: float
    footprint_bytes: int
    # IMC side (per element)
    logic2: float
    logic3: float
    writes: float
    reads: float
    bits_per_elem: float = 8.0   # 1.0 for binary (bnn) elements


def _mb(x: float) -> int:
    return int(x * 1024 * 1024)


# 8-bit add: 16 logic2 + 8 maj + 17 writes; 8-bit mul ~ 8 partial adds.
_ADD = dict(logic2=16.0, logic3=8.0, writes=17.0, reads=2.0)
_MUL = dict(logic2=128.0, logic3=64.0, writes=136.0, reads=8.0)

WORKLOADS: Dict[str, Workload] = {
    # Binarized NN layer: 1M binary MACs; weights resident in-array.
    # CPU must pack bits / popcount per word; IMC XNORs whole rows and
    # writes back binarized activations + popcount partials (write-heavy).
    "bnn": Workload(
        "bnn", n_elems=1 << 18,
        cpu_instrs_per_elem=0.8, cpu_simd_fraction=0.75,
        cpu_bytes_per_elem=0.25, footprint_bytes=_mb(0.0625),
        logic2=1.0, logic3=2.0, writes=3.0, reads=0.25,
        bits_per_elem=1.0,
    ),
    # RGB -> gray: y = (77r + 150g + 29b) >> 8 per pixel.
    "img-grayscale": Workload(
        "img-grayscale", n_elems=1 << 19,
        cpu_instrs_per_elem=8.0, cpu_simd_fraction=0.9,
        cpu_bytes_per_elem=4.0, footprint_bytes=_mb(2),
        logic2=3 * 16.0, logic3=3 * 8.0, writes=3 * 17.0, reads=4.0,
    ),
    # Per-pixel compare against a constant threshold.
    "img-threshold": Workload(
        "img-threshold", n_elems=1 << 19,
        cpu_instrs_per_elem=3.0, cpu_simd_fraction=0.95,
        cpu_bytes_per_elem=2.0, footprint_bytes=_mb(1),
        logic2=16.0, logic3=8.0, writes=9.0, reads=2.0,
    ),
    # Multiply-accumulate streams: c += a*b (8-bit x 8-bit -> 16-bit acc).
    "mac": Workload(
        "mac", n_elems=1 << 18,
        cpu_instrs_per_elem=2.0, cpu_simd_fraction=0.9,
        cpu_bytes_per_elem=6.0, footprint_bytes=_mb(1.5),
        logic2=_MUL["logic2"] + 2 * 16.0, logic3=_MUL["logic3"] + 2 * 8.0,
        writes=_MUL["writes"] + 2 * 17.0, reads=_MUL["reads"],
    ),
    # Elementwise matrix addition (the paper's write-intensive example).
    "mat_add": Workload(
        "mat_add", n_elems=1 << 20,
        cpu_instrs_per_elem=3.0, cpu_simd_fraction=0.9,
        cpu_bytes_per_elem=3.0, footprint_bytes=_mb(3),
        **_ADD,
    ),
    # Root-mean-square error: (a-b)^2 accumulated, sqrt once at the end.
    "rmse": Workload(
        "rmse", n_elems=1 << 19,
        cpu_instrs_per_elem=4.0, cpu_simd_fraction=0.9,
        cpu_bytes_per_elem=2.0, footprint_bytes=_mb(1.5),
        logic2=16.0 + _MUL["logic2"] + 2 * 16.0,
        logic3=8.0 + _MUL["logic3"] + 2 * 8.0,
        writes=17.0 + _MUL["writes"] + 2 * 17.0,
        reads=_MUL["reads"],
    ),
}
