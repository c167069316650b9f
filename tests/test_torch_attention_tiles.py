"""The chunked attention's tile loop (``models/attention.chunked_attention``)
against the loop it replaced, which scores every query against every key
chunk, on the CPU: outputs and gradients bit-equal in float32 and bfloat16;
and the tile plan against a brute-force look at the mask."""
import pytest
import torch

from repro_torch.configs import registry
from repro_torch.models import attention as A

CHUNK = 16


def all_tiles_attention(q, k, v, cfg, causal, window, offset=0):
    """The loop before the tile plan: each key chunk against all S queries
    (a fully masked tile adds exact zeros or is wiped by alpha 0)."""
    F32 = torch.float32
    B, S, h, hd = q.shape
    kvh, Skv = k.shape[2], k.shape[1]
    g = h // kvh
    dev = q.device
    qg = q.reshape(B, S, kvh, g, hd)
    n_chunks = (Skv + A.KV_CHUNK - 1) // A.KV_CHUNK
    pad = n_chunks * A.KV_CHUNK - Skv
    if pad:
        k = torch.nn.functional.pad(k, (0, 0, 0, 0, 0, pad))
        v = torch.nn.functional.pad(v, (0, 0, 0, 0, 0, pad))
    qi = torch.arange(S, device=dev)[:, None] + offset
    zero = torch.zeros((), dtype=F32, device=dev)
    m = torch.full((B, kvh, g, S), -1e30, dtype=F32, device=dev)
    l = torch.zeros((B, kvh, g, S), dtype=F32, device=dev)
    acc = torch.zeros((B, kvh, g, S, hd), dtype=F32, device=dev)
    for ci in range(n_chunks):
        kci = k[:, ci * A.KV_CHUNK:(ci + 1) * A.KV_CHUNK]
        vci = v[:, ci * A.KV_CHUNK:(ci + 1) * A.KV_CHUNK]
        ki = ci * A.KV_CHUNK + torch.arange(A.KV_CHUNK, device=dev)[None, :]
        s = torch.einsum("bskgd,btkd->bkgst", qg, kci).to(F32)
        s = A._scale_scores(s, hd, cfg)
        s = A.softcap(s, cfg.attn.logit_softcap)
        ok = ki < Skv
        if causal:
            ok = ok & (ki <= qi)
        if window is not None:
            ok = ok & (ki > qi - window)
        s = s + torch.where(ok, zero, zero - 1e30)[None, None, None, :, :]
        m_new = torch.maximum(m, torch.amax(s, dim=-1))
        alpha = torch.exp(m - m_new)
        pexp = torch.exp(s - m_new[..., None])
        l = l * alpha + torch.sum(pexp, dim=-1)
        acc = acc * alpha[..., None] + torch.einsum(
            "bkgst,btkd->bkgsd", pexp.to(q.dtype), vci).to(F32)
        m = m_new
    o = (acc / torch.clamp_min(l, 1e-30)[..., None]).to(q.dtype)
    return o.permute(0, 3, 1, 2, 4).reshape(B, S, h, hd)


# (S, Skv, offset, causal, window) at a key chunk of 16
CASES = {
    "causal": (64, 64, 0, True, None),
    "padding": (37, 37, 0, True, None),
    "offset": (24, 40, 16, True, None),
    "window_narrow": (64, 64, 0, True, 5),
    "window_wide": (64, 64, 0, True, 24),
    "noncausal": (40, 40, 0, False, None),
    "noncausal_window": (48, 48, 0, False, 20),
}


def _inputs(S, Skv, dtype=torch.float32, seed=0):
    g = torch.Generator().manual_seed(seed)
    return [torch.randn(shape, generator=g).to(dtype).requires_grad_()
            for shape in ((2, S, 4, 16), (2, Skv, 2, 16), (2, Skv, 2, 16))]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", list(CASES))
def test_outputs_and_gradients_equal_the_all_tiles_loop(monkeypatch, case,
                                                        dtype):
    S, Skv, offset, causal, window = CASES[case]
    monkeypatch.setattr(A, "KV_CHUNK", CHUNK)
    cfg = registry.smoke_config("qwen2-0.5b")
    q, k, v = _inputs(S, Skv, dtype)
    got = A.chunked_attention(q, k, v, cfg, causal, window, offset)
    want = all_tiles_attention(q, k, v, cfg, causal, window, offset)
    assert got.dtype == dtype
    assert torch.equal(got, want)
    dout = torch.randn(got.shape, generator=torch.Generator().manual_seed(1))
    dout = dout.to(dtype)
    for a, b in zip(torch.autograd.grad(got, (q, k, v), dout),
                    torch.autograd.grad(want, (q, k, v), dout)):
        assert torch.equal(a, b)


@pytest.mark.parametrize("case", ["causal", "offset", "window_narrow",
                                  "window_wide"])
def test_products_cover_only_the_live_tiles(monkeypatch, case):
    """The two einsums of each key chunk run over the rows of its live
    query blocks alone: their FLOPs are 4 B h hd KV_CHUNK per such row."""
    from torch.utils.flop_counter import FlopCounterMode

    S, Skv, offset, causal, window = CASES[case]
    monkeypatch.setattr(A, "KV_CHUNK", CHUNK)
    cfg = registry.smoke_config("qwen2-0.5b")
    q, k, v = _inputs(S, Skv)
    rows = sum(min(r.stop * CHUNK, S) - r.start * CHUNK
               for r in A.tile_plan(S, Skv, offset, causal, window) if r)
    with FlopCounterMode(display=False) as fc:
        with torch.no_grad():
            A.chunked_attention(q, k, v, cfg, causal, window, offset)
    B, _, h, hd = q.shape
    assert fc.get_total_flops() == 4 * B * h * hd * CHUNK * rows
    if case == "causal":
        assert rows == 10 * CHUNK


def test_rows_no_chunk_reaches_come_out_zero(monkeypatch):
    """Rows 32-47 have no key in their window (keys 0-15, window 8, no
    causal mask): no chunk computes them.  The rows of the live blocks are
    the all-tiles loop's, the fully masked ones among them too."""
    monkeypatch.setattr(A, "KV_CHUNK", CHUNK)
    cfg = registry.smoke_config("qwen2-0.5b")
    q, k, v = _inputs(48, 16)
    assert [list(r) for r in A.tile_plan(48, 16, 0, False, 8)] == [[0, 1]]
    got = A.chunked_attention(q, k, v, cfg, False, 8)
    want = all_tiles_attention(q, k, v, cfg, False, 8)
    assert torch.equal(got[:, :32], want[:, :32])
    assert not got[:, 32:].any()


def _live_by_mask(S, Skv, offset, causal, window):
    """Per key chunk, the query blocks whose tile has a live mask entry."""
    ok = A._mask_full(S, Skv, causal, window, offset) == 0
    return [[qb for qb in range((S + A.KV_CHUNK - 1) // A.KV_CHUNK)
             if ok[qb * A.KV_CHUNK:(qb + 1) * A.KV_CHUNK,
                   k0:k0 + A.KV_CHUNK].any()]
            for k0 in range(0, Skv, A.KV_CHUNK)]


@pytest.mark.parametrize("case", list(CASES) + ["odd_offset", "window_1"])
def test_plan_keeps_exactly_the_tiles_the_mask_leaves_live(monkeypatch,
                                                           case):
    monkeypatch.setattr(A, "KV_CHUNK", CHUNK)
    S, Skv, offset, causal, window = {
        "odd_offset": (29, 53, 24, True, 9),
        "window_1": (64, 64, 0, True, 1),
    }.get(case) or CASES[case]
    plan = A.tile_plan(S, Skv, offset, causal, window)
    assert [list(r) for r in plan] == _live_by_mask(S, Skv, offset, causal,
                                                    window)


@pytest.mark.parametrize("causal, window, live", [
    (True, None, 10),       # query blocks qb >= ci
    (True, 512, 7),         # the diagonal and the block after it
    (True, 1024, 7),
    (True, 2048, 9),
    (True, 4096, 10),       # a window as long as the sequence skips nothing
    (False, None, 16),
])
def test_plan_at_the_training_shape(causal, window, live):
    """S 4,096 in key chunks of 1,024: 16 (query block, key chunk) tiles."""
    assert A.KV_CHUNK == 1024
    plan = A.tile_plan(4096, 4096, 0, causal, window)
    assert len(plan) == 4
    assert sum(len(r) for r in plan) == live


def test_one_divisor_copy_a_call(monkeypatch):
    """sqrt(hd) is copied to the device once a call, not once a tile."""
    monkeypatch.setattr(A, "KV_CHUNK", CHUNK)
    calls = []
    sqrt_hd = A._sqrt_hd
    monkeypatch.setattr(A, "_sqrt_hd",
                        lambda *a: calls.append(a) or sqrt_hd(*a))
    cfg = registry.smoke_config("qwen2-0.5b")
    q, k, v = _inputs(64, 64)
    A.chunked_attention(q, k, v, cfg, True, None)
    assert len(calls) == 1
