"""``models.ffn.moe_ffn`` on the card at the shape of the benchmark's
olmoe-1b-7b surface cell (8 x 512 tokens in groups of 1,024, d 2,048, 64
experts of 1,024, top 8, capacity 160), float32 with TF32 off, against
the one-hot einsum formulation it replaced (``tests/_moe_oracle.py``).

The dispatched rows are a copy: equal.  The output sums each token's
slots in ascending expert order, as the one-hot GEMM adds its non-zero
terms, in another rounding: max |d| <= 1e-6 x max |y|; ``pytest -s``
prints the gap and whether it is 0.  Two backward passes give equal
gradients (no atomics).  Needs a CUDA device; skips without one:

    PYTHONPATH=src python -m pytest -m cuda -s tests/test_torch_moe_cuda.py
"""
import pytest
import torch

from _moe_oracle import one_hot_moe
from repro_torch.configs.registry import get_arch
from repro_torch.models import ffn as TF

pytestmark = pytest.mark.cuda

OUT_TOL = 1e-6


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the test holds the card's GEMMs)")
    return torch.device("cuda")


def _layer(dev):
    cfg = get_arch("olmoe-1b-7b")
    d, e, f = cfg.d_model, cfg.moe.num_experts, cfg.moe.d_expert
    gen = torch.Generator(device=dev).manual_seed(0)

    def draw(*shape, fan_in):
        return torch.randn(shape, generator=gen, device=dev) * fan_in ** -0.5
    p = {"router": draw(d, e, fan_in=d), "w_gate": draw(e, d, f, fan_in=d),
         "w_up": draw(e, d, f, fan_in=d), "w_down": draw(e, f, d, fan_in=f)}
    x = torch.randn((8, 512, d), generator=gen, device=dev)
    return cfg, p, x


def _backward(cfg, p, x, w):
    p = {k: v.clone().requires_grad_() for k, v in p.items()}
    x = x.clone().requires_grad_()
    y, aux = TF.moe_ffn(p, x, cfg)
    grads = torch.autograd.grad((y * w).sum() + aux, [x, *p.values()])
    torch.cuda.synchronize()
    return grads


def test_moe_ffn_at_the_olmoe_cell_shape(dev):
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        cfg, p, x = _layer(dev)
        _, _, _, _, routes, keep = TF.moe_route(p, x, cfg)
        assert routes.slot_token.numel() == 64 * 4 * 160
        xe = TF.MoEDispatch.apply(x.reshape(-1, cfg.d_model), routes)
        y_o, _, xe_o = one_hot_moe(p, x, cfg)
        assert torch.equal(xe, xe_o.reshape(xe.shape))
        del xe, xe_o
        y, _ = TF.moe_ffn(p, x, cfg)
        gap = float((y - y_o).abs().max())
        scale = float(y_o.abs().max())
        print(f"\nolmoe cell shape, {torch.cuda.get_device_name(0)}: "
              f"{int((~keep).sum())} of {keep.numel()} choices dropped; "
              f"output max |d| {gap:.3e} = {gap / scale:.3e} x max |y| "
              f"({scale:.4f}); bit-equal: "
              f"{'yes' if torch.equal(y, y_o) else 'no'}")
        assert gap <= OUT_TOL * scale
        del y, y_o
        w = torch.randn(x.shape, generator=torch.Generator(
            device=dev).manual_seed(1), device=dev)
        first = _backward(cfg, p, x, w)
        again = _backward(cfg, p, x, w)
        assert all(torch.equal(a, b) for a, b in zip(first, again))
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32
