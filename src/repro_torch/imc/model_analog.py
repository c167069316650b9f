"""Model-level analog accuracy: whole transformer forwards through the
AFMTJ differential-conductance MVM (port of ``repro.imc.model_analog``,
DESIGN.md §12).

Every ``models.common.linear`` site of a decoder-only forward
(``models.model``) is routed through the analog MVM by the linear hook,
and the logits are scored against the exact forward: KL, greedy token
match, perplexity.  The sites are the reference's: attention projections,
dense FFNs (a shared expert among them) and the unembed.  MoE routers and
experts and the Mamba projections are plain products in the reference and
stay exact here too (olmoe-1b-7b routes 16 x 4 + 1 = 65 linears per
forward, mamba2-780m only its tied unembed).  Encoder-decoder archs have
no analog path, as in the reference.  Three execution modes per linear:

  * ``fake``   — the fused fake-analog kernel (``kernels.fake_analog``):
                 programming replayed inside the product, the operand
                 preamble (scales, fail plane, IR rows) on tensors, the ADC
                 full scale and decode gain sized on the device
                 (``kernels.adc_sizing``) exactly as the device path sizes
                 them on the host (``fake_operands``); what a product needs
                 of its configuration is decided once, by ``fake_setup``;
  * ``device`` — ``program_weights`` + ``analog_matmul`` through the
                 bit-line kernel, behind the content-keyed programming
                 cache below;
  * ``bnn``    — the 1-bit XNOR path (``analog_pipeline.binary_matmul``).

PyTorch runs eagerly, so the reference's ``jax.jit`` / ``lru_cache`` of
executables has no counterpart: each linear is one kernel launch.  The
forward is ``models.model.forward_logits``, unrolled over layers as in
the reference.

Random draws: model init (``init_model_params``) and the write-BER masks
(``analog_pipeline.write_ber_masks``) come from ``torch.Generator``s; the
tokens come from numpy's ``default_rng``, exactly the reference's.
"""
from __future__ import annotations

import dataclasses
import hashlib
from typing import Any, Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch._device import resolve_device
from repro_torch.campaign import cache as _cache
from repro_torch.circuit.bitline import BitlineParams, column_ir_drop
from repro_torch.configs.base import ArchConfig
from repro_torch.configs.registry import get_arch, smoke_config
from repro_torch.core.params import PROCESS_CORNERS, VariationSpec
from repro_torch.imc import analog_pipeline as ap
from repro_torch.imc import faults as hard_faults
from repro_torch.imc.analog_pipeline import (AnalogConfig, ProgrammedArray,
                                             _device_for, _resolved_variation,
                                             analog_matmul, binary_matmul,
                                             effective_conductances,
                                             program_weights)
from repro_torch.imc.faults import FaultSpec, RepairPolicy
from repro_torch.kernels.adc_sizing import adc_aux_kernel
from repro_torch.kernels.fake_analog import (fake_analog_kernel,
                                             pos_neg_conductance)
from repro_torch.models import model as model_mod
from repro_torch.models.common import intercept_linears

# bumped when the programming chain changes numerically
PROGRAMMING_VERSION = 1
_F32 = torch.float32


# ---------------------------------------------------------------------------
# fake-analog fast path (single projection)
# ---------------------------------------------------------------------------
def _abs_max(t: torch.Tensor) -> torch.Tensor:
    """max |t| as a 0-dim float32 tensor on ``t``'s device (exact: a
    maximum rounds nothing, so any reduction order gives it)."""
    return torch.linalg.vector_norm(t, float("inf"))


def _scale(t_max: torch.Tensor, one: torch.Tensor) -> torch.Tensor:
    """The normalizing scale: ``t_max`` with 0 read as 1 (``one``, a 0-dim
    float32 1 on the device: a Python 1.0 would cost a fill launch)."""
    return torch.where(t_max == 0.0, one, t_max)


@dataclasses.dataclass(frozen=True)
class FakeSetup:
    """What every fake-analog product of one (kind, ``AnalogConfig``)
    needs, decided once by ``fake_setup``: the cell constants as the
    device's float32 tensors, the sizing kernel's host floats, the read-out
    and fault switches and the ADC's full scale and decode."""

    # 0-dim float32 tensors on the device, program_weights' roundings
    one: torch.Tensor                # the 1 of the zero-scale rule
    g_ap: torch.Tensor
    g_fs: torch.Tensor
    g_scale: torch.Tensor            # 1 / r_factor of the systematic corner
    r_access: torch.Tensor
    v_read: torch.Tensor
    # the host floats adc_aux_kernel sizes with (float64)
    g_fs_host: float
    v_read_host: float
    fs_sigmas: float
    adc_bits: int
    ir_drop: bool
    apply_fet: bool                  # a systematic process corner is set
    ber: float                       # residual write errors drawn if > 0
    seed: int
    faults: Optional[FaultSpec]      # hard-fault planes drawn if set
    repair: Optional[RepairPolicy]
    fail_plane: bool                 # B5 reads a fail plane
    i_max: Optional[float]           # None: sized from the operands
    decode: bool                     # False: raw quantized currents


def fake_setup(kind: str, cfg: AnalogConfig, device, *,
               bl: Optional[BitlineParams] = None,
               i_max: Optional[float] = None,
               decode: bool = True) -> FakeSetup:
    """The fake path's ``FakeSetup`` for ``kind`` under ``cfg`` on
    ``device``.  The cell constants do not depend on the line length (the
    FET series combination has no wire term), so one setup serves every
    layer.  Systematic corners only: per-cell D2D spreads and conductance
    drift need the device path."""
    spec = _resolved_variation(cfg)
    g_scale = 1.0
    if spec is not None:
        c = spec.corners[0]
        if c.sigma_alpha or c.sigma_b_aniso or c.sigma_volume or c.sigma_r:
            raise NotImplementedError(
                "fake-analog path models systematic process corners only; "
                "per-cell D2D spreads need the device path (mode='device')")
        g_scale = 1.0 / c.r_factor
    fs = cfg.faults
    if fs is not None and fs.drift_sigma > 0.0:
        raise NotImplementedError(
            "fake-analog path models hard fault codes only; conductance "
            "drift draws per-cell factors — use mode='device'")
    bl = bl or BitlineParams()
    g_p_eff, g_ap_eff = effective_conductances(_device_for(kind, cfg), bl)

    def f32(val):
        return torch.tensor(float(val), dtype=_F32, device=device)

    return FakeSetup(
        one=torch.ones((), dtype=_F32, device=device),
        g_ap=f32(g_ap_eff),
        g_fs=f32(g_p_eff - g_ap_eff),
        g_scale=f32(g_scale),
        r_access=f32(bl.r_access),
        v_read=f32(cfg.v_read),
        g_fs_host=g_p_eff - g_ap_eff,
        v_read_host=float(cfg.v_read),
        fs_sigmas=float(cfg.full_scale_sigmas),
        adc_bits=cfg.adc_bits,
        ir_drop=cfg.ir_drop,
        apply_fet=spec is not None,
        ber=float(cfg.write_ber),
        seed=int(cfg.seed),
        faults=fs,
        repair=cfg.repair,
        fail_plane=cfg.write_ber > 0.0 or fs is not None,
        i_max=None if i_max is None else float(i_max),
        decode=decode)


def fake_operands(x, w, setup: FakeSetup, bl: BitlineParams):
    """(v, wn, fail, aux): the fused kernel's operands for ``x @ w``, the
    preamble of the reference's ``_fake_mvm_body`` step for step.

    One deliberate difference: the reference keeps the ADC full scale and
    the decode gain as traced float32 scalars (``_round_2sig``), because its
    forward is jitted.  The port sizes both from the same float32
    statistics in float64, exactly as the device path sizes them on the
    host (``adc_sizing.adc_full_scale`` / ``decode_gain``): the fake
    and device modes then agree bit for bit on the same inputs.  The
    float32 version differs by ulps, which 24 random layers of qwen2-0.5b
    amplify to a logits KL of ~4e-3 between the modes (H100 measurement,
    PERF.md).  Every statistic stays a tensor on the operands' device and
    ``kernels.adc_sizing`` sizes both scalars into the aux plane (on the
    card a kernel), so the preamble reads nothing back to the host and
    copies nothing onto the card."""
    s = setup
    x = x.to(_F32)
    w = w.to(_F32)
    dev = w.device
    k_rows, n_cols = w.shape

    w_max = _abs_max(w)
    wn = w / _scale(w_max, s.one)

    if s.ber > 0.0:
        # the same cells as program_weights' residual write errors
        f_pos, f_neg = ap.write_ber_masks(s.seed, s.ber, wn.shape, dev)
        fail = f_pos.to(_F32) + 2.0 * f_neg.to(_F32)
    else:
        fail = torch.zeros_like(wn)

    col_ok = None
    if s.faults is not None:
        # fault bits are disjoint from the write-ber bits: + is bitwise OR
        code, col_ok = s.faults.planes(k_rows, n_cols, device=dev)
        code, col_ok = hard_faults.apply_repair(code, col_ok, s.repair)
        fail = fail + code

    tp, tn = pos_neg_conductance(wn, fail, s.g_ap, s.g_fs, s.g_scale,
                                 s.r_access, apply_fet=s.apply_fet,
                                 use_fail=s.fail_plane)
    att_mean = None
    if s.ir_drop:
        att_p = column_ir_drop(torch.sum(tp, dim=0), bl)
        att_n = column_ir_drop(torch.sum(tn, dim=0), bl)
        if col_ok is None:
            att_mean = 0.5 * (torch.mean(att_p) + torch.mean(att_n))
        else:
            # dead bit lines read zero; the decode gain calibrates over
            # live columns only (the device path's association)
            live = torch.clamp_min(torch.sum(col_ok), 1.0)
            att_mean = 0.5 * (torch.sum(att_p * col_ok) / live
                              + torch.sum(att_n * col_ok) / live)
            att_p = att_p * col_ok
            att_n = att_n * col_ok
    else:
        ones = torch.ones((n_cols,), dtype=_F32, device=dev)
        att_p = ones if col_ok is None else ones * col_ok
        att_n = att_p

    x_max = _abs_max(x)
    v = (s.v_read * x) / _scale(x_max, s.one)

    g_rms = v_rms = None
    if s.i_max is None:
        g_diff = att_p[None, :] * tp - att_n[None, :] * tn
        g_rms = torch.sqrt(torch.mean(g_diff * g_diff))
        v_rms = torch.sqrt(torch.mean(v * v))
    aux = adc_aux_kernel(
        att_p, att_n, (s.g_ap, s.g_fs, s.g_scale, s.r_access),
        w_max=w_max, x_max=x_max, att_mean=att_mean, g_rms=g_rms,
        v_rms=v_rms, k_rows=k_rows, fs_sigmas=s.fs_sigmas,
        v_read=s.v_read_host, g_fs=s.g_fs_host, decode=s.decode,
        i_max=s.i_max)
    return v, wn, fail, aux


def _fake_mvm_body(x, w, setup: FakeSetup, bl: BitlineParams):
    """Fake-analog ``x @ w``: ``fake_operands`` + the fused kernel."""
    v, wn, fail, aux = fake_operands(x, w, setup, bl)
    return fake_analog_kernel(v, wn, fail, aux, adc_bits=setup.adc_bits,
                              apply_fet=setup.apply_fet,
                              use_fail=setup.fail_plane)


def fake_analog_matmul(
    w,                               # (K, N) float weights
    x,                               # (M, K) activations (signed)
    kind: str = "afmtj",
    cfg: AnalogConfig = AnalogConfig(),
    bl: Optional[BitlineParams] = None,
    i_max: Optional[float] = None,   # explicit ADC full scale (parity pins)
    decode: bool = True,             # False: raw quantized currents
    device=None,
) -> torch.Tensor:
    """``x @ w`` through the fused fake-analog kernel — the equivalent of
    ``program_weights`` + ``analog_matmul`` in one pass."""
    dev = resolve_device(device)
    w = ap._as_f32(w, dev)
    x = ap._as_f32(x, dev)
    assert w.dim() == 2 and x.dim() == 2 and x.shape[1] == w.shape[0], (
        tuple(x.shape), tuple(w.shape))
    bl = bl or BitlineParams(rows=w.shape[0])
    setup = fake_setup(kind, cfg, dev, bl=bl, i_max=i_max, decode=decode)
    return _fake_mvm_body(x, w, setup, bl)


# ---------------------------------------------------------------------------
# weight-programming cache (device path)
# ---------------------------------------------------------------------------
def _host_f32(a) -> np.ndarray:
    if torch.is_tensor(a):
        a = a.detach().to(_F32).cpu().numpy()
    return np.ascontiguousarray(np.asarray(a, np.float32))


def _array_digest(a) -> str:
    a = _host_f32(a)
    h = hashlib.sha256(a.tobytes())
    h.update(str(a.shape).encode())
    return h.hexdigest()


def _tree_leaves(tree, path=""):
    if isinstance(tree, dict):
        out = []
        for k in tree:
            out += _tree_leaves(tree[k], f"{path}[{k!r}]")
        return out
    if isinstance(tree, (list, tuple)):
        out = []
        for i, v in enumerate(tree):
            out += _tree_leaves(v, f"{path}[{i}]")
        return out
    return [(path, tree)]


def param_tree_hash(tree: Any) -> str:
    """Content hash of a parameter tree, stable under dict-key order
    (leaves keyed by their tree path)."""
    payload = sorted((p, _array_digest(leaf)) for p, leaf in _tree_leaves(tree))
    return _cache.content_key({"params": payload})


def programming_key(w, kind: str, cfg: AnalogConfig,
                    bl: BitlineParams) -> str:
    """Content key over the programming-relevant axes only: read-out knobs
    (``adc_bits``, ``full_scale_sigmas``, ``v_read``) reuse an entry; TMR,
    corner, BER, seed, IR drop, faults, bit line and the weights re-key.
    The port tag and the weights' device type keep entries of the port's
    CUDA and CPU runs (equal to float32 rounding, not bit for bit) apart."""
    spec = _resolved_variation(cfg)
    return _cache.content_key({
        "port": _cache.PORT_TAG,
        "backend": w.device.type if torch.is_tensor(w) else "cpu",
        "v": PROGRAMMING_VERSION,
        "kind": kind,
        "w": _array_digest(w),
        "tmr": cfg.tmr,
        "ir_drop": cfg.ir_drop,
        "seed": cfg.seed,
        "write_ber": cfg.write_ber,
        "variation": None if spec is None else {
            "corners": [dataclasses.asdict(c) for c in spec.corners],
            "seed": spec.seed,
            "distribution": spec.distribution,
        },
        "faults": (None if cfg.faults is None
                   else dataclasses.asdict(cfg.faults)),
        "repair": (None if cfg.repair is None
                   else dataclasses.asdict(cfg.repair)),
        "bitline": dataclasses.asdict(bl),
    })


def program_weights_cached(
    w,
    kind: str = "afmtj",
    cfg: AnalogConfig = AnalogConfig(),
    bl: Optional[BitlineParams] = None,
    cache_dir: Optional[str] = None,
    device=None,
) -> ProgrammedArray:
    """``program_weights`` behind the content-keyed store: a hit returns the
    identical conductance plane and calibration scalars.  Entries are
    stored uncompressed."""
    dev = resolve_device(device)
    w = ap._as_f32(w, dev) if not torch.is_tensor(w) else w.to(dev)
    bl = bl or BitlineParams(rows=w.shape[0])
    key = programming_key(w, kind, cfg, bl)
    hit = _cache.load_arrays(key, cache_dir)
    if hit is not None and "g_diff" in hit:
        s = hit["scalars"]
        return ProgrammedArray(
            g_diff=torch.from_numpy(hit["g_diff"]).to(device=dev, dtype=_F32),
            w_scale=float(s[0]), g_fs=float(s[1]), att_mean=float(s[2]),
            g_rms=float(s[3]), dev=_device_for(kind, cfg), bl=bl, cfg=cfg)
    arr = program_weights(w, kind, cfg, bl, device=dev)
    _cache.store_arrays(
        key,
        {"g_diff": _host_f32(arr.g_diff),
         "scalars": np.asarray([arr.w_scale, arr.g_fs, arr.att_mean,
                                arr.g_rms], np.float64)},
        {"kind": kind, "shape": list(arr.g_diff.shape), "tmr": cfg.tmr,
         "seed": cfg.seed, "write_ber": cfg.write_ber, "key": key},
        cache_dir, compress=False)
    return arr


# ---------------------------------------------------------------------------
# model forward + interception hooks
# ---------------------------------------------------------------------------
def model_forward_logits(params, cfg: ArchConfig, tokens, hook=None):
    """``models.model.forward_logits``; ``hook(x2d, w, tag)`` intercepts
    every linear (None = the exact forward)."""
    assert cfg.n_encoder_layers == 0, "analog routing covers decoder-only"
    with torch.no_grad():
        if hook is None:
            return model_mod.forward_logits(params, cfg, tokens)
        with intercept_linears(hook):
            return model_mod.forward_logits(params, cfg, tokens)


def analog_model_logits(
    params, cfg: ArchConfig, tokens,
    acfg: AnalogConfig = AnalogConfig(),
    kind: str = "afmtj",
    mode: str = "fake",              # fake | device | bnn
    tie: int = 1,
    cache_dir: Optional[str] = None,
    device=None,
) -> torch.Tensor:
    """Full-sequence logits with every linear routed through the analog
    MVM, on ``device`` (None = the CUDA device; ``params`` and ``tokens``
    are moved there)."""
    dev = resolve_device(device)
    params = model_mod.params_to(params, dev)
    tokens = torch.as_tensor(tokens).to(dev)
    if mode == "fake":
        setup = fake_setup(kind, acfg, dev)

        def hook(x2, w, tag):
            return _fake_mvm_body(x2, w, setup,
                                  BitlineParams(rows=w.shape[0]))
    elif mode == "bnn":
        def hook(x2, w, tag):
            return binary_matmul(x2, w, tie=tie, device=dev)
    elif mode == "device":
        def hook(x2, w, tag):
            arr = program_weights_cached(w, kind, acfg,
                                         BitlineParams(rows=w.shape[0]),
                                         cache_dir, device=dev)
            return analog_matmul(arr, x2)
    else:
        raise ValueError(f"unknown mode {mode!r}")
    return model_forward_logits(params, cfg, tokens, hook)


# ---------------------------------------------------------------------------
# accuracy metrics + surfaces
# ---------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class ModelAccuracyReport:
    """Model-level accuracy of one analog configuration point."""

    arch: str
    kind: str
    mode: str                      # fake | device | bnn
    adc_bits: int
    tmr: float
    corner: str                    # systematic process corner name
    write_ber: float
    kl: float                      # mean KL(ref || analog) over positions
    token_match: float             # greedy-argmax agreement rate
    ppl_analog: float              # next-token perplexity, analog logits
    ppl_ref: float                 # next-token perplexity, exact logits
    batch: int
    seq_len: int
    fault_rate: float = 0.0        # headline hard-fault rate (FaultSpec.rate)
    repair: str = "none"           # repair policy name


def logit_metrics(ref_logits, ana_logits, tokens
                  ) -> Tuple[float, float, float, float]:
    """(kl, token_match, ppl_analog, ppl_ref) from two (B, S, V) logit sets
    (tensors or numpy arrays)."""
    def as_tensor(a):
        return a if torch.is_tensor(a) else torch.from_numpy(np.array(a))

    ref_logits = as_tensor(ref_logits)
    dev = ref_logits.device
    ana_logits = as_tensor(ana_logits).to(dev)
    tokens = as_tensor(tokens).to(device=dev, dtype=torch.int64)
    lr = torch.log_softmax(ref_logits.to(_F32), dim=-1)
    la = torch.log_softmax(ana_logits.to(_F32), dim=-1)
    p = torch.exp(lr)
    kl = float(torch.mean(torch.sum(p * (lr - la), dim=-1)))
    match = float(torch.mean(
        (torch.argmax(la, dim=-1) == torch.argmax(lr, dim=-1)).to(_F32)))

    def ppl(lp):
        gold = torch.gather(lp[:, :-1], -1, tokens[:, 1:][..., None])
        return float(torch.exp(-torch.mean(gold)))

    return kl, match, ppl(la), ppl(lr)


def _arch_config(arch: str, smoke: bool) -> ArchConfig:
    return smoke_config(arch) if smoke else get_arch(arch)


def init_model_params(cfg: ArchConfig, seed: int, device):
    """The study's random model: ``models.model.init_params`` from a
    ``torch.Generator`` on ``device`` seeded with ``seed``.  The reference
    draws with ``jax.random``; the tests hand its parameters over by
    replacing this function."""
    gen = torch.Generator(device=device).manual_seed(int(seed))
    return model_mod.init_params(cfg, gen, device)


def _setup(arch: str, smoke: bool, batch: int, seq_len: int, seed: int,
           device=None):
    """(cfg, params, tokens, ref_logits) shared across surface points."""
    dev = resolve_device(device)
    cfg = _arch_config(arch, smoke)
    params = init_model_params(cfg, seed, dev)
    rng = np.random.default_rng(seed)
    tokens = torch.from_numpy(rng.integers(0, cfg.vocab, (batch, seq_len))
                              ).to(dev)
    ref_logits = model_forward_logits(params, cfg, tokens)
    return cfg, params, tokens, ref_logits


def _corner_spec(corner: str, seed: int) -> Optional[VariationSpec]:
    if corner in ("", "tt"):
        # tt is the all-1.0 nominal corner: identical conductances with or
        # without the FET round trip, so no spec
        return None
    return VariationSpec(corners=(PROCESS_CORNERS[corner],), seed=seed)


def model_accuracy(
    arch: str = "qwen2-0.5b",
    acfg: AnalogConfig = AnalogConfig(),
    kind: str = "afmtj",
    mode: str = "fake",
    corner: str = "tt",
    batch: int = 2,
    seq_len: int = 64,
    seed: int = 0,
    smoke: bool = True,
    tie: int = 1,
    cache_dir: Optional[str] = None,
    device=None,
    _setup_state=None,
) -> ModelAccuracyReport:
    """One surface point: the forward through the analog path, scored
    against the exact logits on synthetic token sequences."""
    dev = resolve_device(device)
    if _setup_state is None:
        _setup_state = _setup(arch, smoke, batch, seq_len, seed, dev)
    cfg, params, tokens, ref_logits = _setup_state
    spec = _corner_spec(corner, acfg.seed)
    if spec is not None:
        acfg = dataclasses.replace(acfg, variation=spec)
    ana = analog_model_logits(params, cfg, tokens, acfg, kind=kind,
                              mode=mode, tie=tie, cache_dir=cache_dir,
                              device=dev)
    kl, match, ppl_a, ppl_r = logit_metrics(ref_logits, ana, tokens)
    tmr = acfg.tmr if acfg.tmr is not None else _device_for(kind, acfg).tmr
    fspec = acfg.faults
    frate = 0.0 if fspec is None else (fspec.rate or fspec.cell_fault_rate)
    return ModelAccuracyReport(
        arch=arch, kind=kind, mode=mode, adc_bits=acfg.adc_bits,
        tmr=float(tmr), corner=corner, write_ber=acfg.write_ber, kl=kl,
        token_match=match, ppl_analog=ppl_a, ppl_ref=ppl_r, batch=batch,
        seq_len=seq_len, fault_rate=float(frate),
        repair="none" if acfg.repair is None else acfg.repair.name)


def model_accuracy_surface(
    arch: str = "qwen2-0.5b",
    kind: str = "afmtj",
    mode: str = "fake",
    adc_bits: Sequence[int] = (4, 6, 8),
    tmrs: Sequence[Optional[float]] = (None,),
    corners: Sequence[str] = ("tt",),
    write_bers: Sequence[float] = (0.0,),
    fault_rates: Sequence[float] = (0.0,),
    repair: Optional[RepairPolicy] = None,
    batch: int = 2,
    seq_len: int = 64,
    seed: int = 0,
    smoke: bool = True,
    cache_dir: Optional[str] = None,
    device=None,
) -> Tuple[ModelAccuracyReport, ...]:
    """The model-level accuracy surface: the outer product of the
    non-ideality axes, model and reference logits set up once."""
    dev = resolve_device(device)
    state = _setup(arch, smoke, batch, seq_len, seed, dev)
    out = []
    for fr in fault_rates:
        fspec = None if fr == 0.0 else FaultSpec.at_rate(float(fr), seed=seed)
        for ber in write_bers:
            for corner in corners:
                for tmr in tmrs:
                    for bits in adc_bits:
                        acfg = AnalogConfig(
                            adc_bits=bits, tmr=tmr, write_ber=ber, seed=seed,
                            faults=fspec,
                            repair=repair if fspec is not None else None)
                        out.append(model_accuracy(
                            arch, acfg, kind=kind, mode=mode, corner=corner,
                            batch=batch, seq_len=seq_len, seed=seed,
                            smoke=smoke, cache_dir=cache_dir, device=dev,
                            _setup_state=state))
    return tuple(out)


def model_degradation_curves(
    arch: str = "qwen2-0.5b",
    kind: str = "afmtj",
    rates: Sequence[float] = (0.0, 1e-3, 3e-3, 1e-2, 3e-2),
    policies: Sequence[Optional[RepairPolicy]] = (None,
                                                 hard_faults.REPAIR_SPARE),
    adc_bits: int = 6,
    mode: str = "fake",
    batch: int = 2,
    seq_len: int = 64,
    seed: int = 0,
    smoke: bool = True,
    cache_dir: Optional[str] = None,
    device=None,
) -> Tuple[ModelAccuracyReport, ...]:
    """Model accuracy vs fault rate x repair policy (DESIGN.md §13); a
    ``FaultSpec`` at every point, rate 0 included, and defect maps paired
    across policies by the counter-RNG."""
    dev = resolve_device(device)
    state = _setup(arch, smoke, batch, seq_len, seed, dev)
    out = []
    for pol in policies:
        for r in rates:
            acfg = AnalogConfig(
                adc_bits=adc_bits, seed=seed,
                faults=FaultSpec.at_rate(float(r), seed=seed), repair=pol)
            out.append(model_accuracy(
                arch, acfg, kind=kind, mode=mode, batch=batch,
                seq_len=seq_len, seed=seed, smoke=smoke, cache_dir=cache_dir,
                device=dev, _setup_state=state))
    return tuple(out)


def degradation_knee(reports: Sequence[ModelAccuracyReport],
                     min_token_match: float = 0.8) -> Dict[str, float]:
    """Per repair policy, the largest swept fault rate still meeting the
    token-match bar."""
    knees: Dict[str, float] = {}
    for r in reports:
        knees.setdefault(r.repair, 0.0)
        if r.token_match >= min_token_match:
            knees[r.repair] = max(knees[r.repair], r.fault_rate)
    return knees
