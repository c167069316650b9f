"""XNOR-popcount GEMM, the paper's *bnn* workload (port of
``repro.kernels.xnor_gemm``).

out[m, n] = K - 2 popcount(a XOR w) = dot(a_pm1, w_pm1) over +-1 operands
(0 = padding, contributes nothing), optionally re-binarized with an
explicit tie sign for acc == 0 (``binarize_acc``).

``xnor_gemm_kernel`` wraps the CUDA kernel in ``csrc/analog_mac.cu``
(replaces the Pallas ``_xnor_kernel``): CPU tensors run the plain version
``ref.ref_xnor_gemm``, CUDA tensors (float32 or bfloat16) launch the kernel
or raise.  ``xnor_gemm_kernel.launches`` counts kernel launches only.
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
    """(M, K) @ (K, N) over {-1, +1} -> (M, N) float32, exact."""
    M, K, N = analog_mac.gemm_shapes("xnor_gemm", a, w)
    assert tie in (1, -1), tie
    if a.device.type == "cpu":
        return ref_xnor_gemm(a, w, binarize, tie)
    analog_mac.check_cuda("xnor_gemm", a, w)
    if a.dtype != w.dtype or a.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"xnor_gemm: operands must both be float32 or both "
                         f"bfloat16, got {a.dtype} and {w.dtype}")
    a, w = a.contiguous(), w.contiguous()
    out = torch.empty((M, N), dtype=torch.float32, device=a.device)
    if M and N:
        with torch.cuda.device(a.device):
            lib = analog_mac.library()
            analog_mac.launch("xnor_gemm", lib.xnor_gemm_launch,
                              a.data_ptr(), w.data_ptr(), out.data_ptr(),
                              M, K, N, int(a.dtype == torch.bfloat16),
                              int(bool(binarize)), int(tie))
        xnor_gemm_kernel.launches += 1
    return out


xnor_gemm_kernel.launches = 0
