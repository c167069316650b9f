"""XNOR-popcount GEMM, the paper's *bnn* workload (port of
``repro.kernels.xnor_gemm``).

out[m, n] = K - 2 popcount(a XOR w) = dot(a_pm1, w_pm1) over +-1 operands
(0 = padding, contributes nothing), optionally re-binarized with an
explicit tie sign for acc == 0 (``binarize_acc``).

``xnor_gemm_kernel`` wraps the CUDA kernel in ``csrc/xnor_gemm.cu``
(replaces the Pallas ``_xnor_kernel``; bf16 tensor-core MMAs, exact on the
operand contract below): CPU tensors run the plain version
``ref.ref_xnor_gemm``, CUDA tensors (float32 or bfloat16) launch the kernel
or raise.  Grids under one wave split K (``analog_mac.split_count``) and
add a reduce pass; the partials are integers, so any split gives the same
result.  ``xnor_gemm_kernel.launches`` counts mainloop launches,
``.reduce_launches`` reduce-pass launches and ``.launch_shapes`` mainloop
launches by (M, K, N) (``analog_mac`` module note).
"""
from __future__ import annotations

import torch

from repro_torch.kernels import analog_mac
from repro_torch.kernels.ref import ref_xnor_gemm


def binarize_acc(acc: torch.Tensor, tie: int) -> torch.Tensor:
    """Sign with an explicit tie convention for acc == 0, as float32 (the
    reference's ``jnp.where`` over Python floats)."""
    one = torch.ones((), dtype=torch.float32, device=acc.device)
    sign = torch.where(acc > 0.0, one, -one)
    return torch.where(acc == 0.0, one * float(tie), sign)


def xnor_gemm_kernel(a: torch.Tensor, w: torch.Tensor, binarize: bool = False,
                     tie: int = 1) -> torch.Tensor:
    """(M, K) @ (K, N) -> (M, N) float32, exact.

    Operand contract (the reference's, ``repro/kernels/xnor_gemm.py``):
    every element of ``a`` and ``w`` is -1, 0 or +1.  The kernel converts
    float32 operands to bfloat16 on chip, exact only on that alphabet; it
    does not check it (that would cost a pass over ``w`` and a host sync).
    """
    M, K, N = analog_mac.gemm_shapes("xnor_gemm", a, w)
    assert tie in (1, -1), tie
    if a.is_cpu:
        return ref_xnor_gemm(a, w, binarize, tie)
    index = analog_mac.cuda_index("xnor_gemm", a, w)
    if a.dtype != w.dtype or a.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"xnor_gemm: operands must both be float32 or both "
                         f"bfloat16, got {a.dtype} and {w.dtype}")
    a, w = a.contiguous(), w.contiguous()
    out = torch.empty((M, N), dtype=torch.float32, device=a.device)
    if M and N:
        bf16 = a.dtype == torch.bfloat16
        per_chunk = 8 if bf16 else 4          # elements per 16-byte copy
        lib, splits, ws = analog_mac.plan("xnor_gemm", M, K, N, a)
        vec = (K % per_chunk == 0 and N % per_chunk == 0
               and analog_mac.aligned(a, w))
        analog_mac.launch("xnor_gemm", lib.xnor_gemm_launch, index,
                          a.data_ptr(), w.data_ptr(), out.data_ptr(),
                          analog_mac.ptr(ws), M, K, N, splits, int(vec),
                          int(bf16), int(bool(binarize)), int(tie))
        analog_mac.count(xnor_gemm_kernel, M, K, N, splits)
    return out


analog_mac.reset_counts(xnor_gemm_kernel)
