"""End-to-end functional analog MVM through the bit-line and XNOR kernels
(port of ``repro.imc.analog_pipeline``, DESIGN.md §6).

Signal chain, as in the reference:

  1. programming — differential 2-cell encoding of ``w / max|w|`` onto the
     effective conductance span [G_AP, G_P] (junction through the access
     FET), optional junction variation (``core.params.VariationSpec``),
     drift, residual write errors at the G_AP floor, hard fault codes;
  2. IR drop — per-column attenuation, the mean calibrated out at decode;
  3. MVM — I = V @ G_diff through ``kernels.bitline_mac`` (one kernel pass
     over G+ - G-);
  4. ADC — signed quantizer, full scale ``full_scale_sigmas`` column-current
     sigmas rounded to 2 significant digits through a string, as the
     reference does (it is part of the result); decode by one float64 gain
     (``decode_gain``); both sized by ``kernels.adc_sizing``, shared with
     the fused fake path.

``binary_matmul`` is the 1-bit path through ``kernels.xnor_gemm`` with
per-column |w| and scalar |x| scales.

``analog_matmul(..., devices=)`` splits the batch rows over a device list,
as the reference's ``shard_map`` does (weights resident on every device,
activations split): the rows are zero-padded to a multiple of the device
count and each device's share runs through one bit-line MAC launch.  The
ADC full scale and the operands come from the whole batch
(``kernel_operands`` before the split), so only the launches are split.
A list may name one device several times (one launch per entry); an int
n means the first n CUDA devices.  ``mvm_accuracy`` and
``imc.mapping.decode_projection_accuracy`` pass ``devices`` on; the bnn
mode ignores it, as the reference's does.

Scalar arithmetic follows the reference's float32 / float64 steps: host
scalars are Python floats (float64), tensors float32, and divisions by a
host scalar take a float32 tensor divisor (an IEEE division on either
device).
"""
from __future__ import annotations

import dataclasses
import warnings
from typing import Optional, Tuple

import numpy as np
import torch

from repro_torch._device import resolve_device
from repro_torch._span import span
from repro_torch.circuit.bitline import (BitlineParams, cell_conductance,
                                         column_ir_drop)
from repro_torch.core.params import (AFMTJ_PARAMS, MTJ_PARAMS, DeviceParams,
                                     VariationSpec)
from repro_torch.imc import faults as hard_faults
from repro_torch.imc.faults import FaultSpec, RepairPolicy
from repro_torch.kernels.adc_sizing import adc_full_scale, decode_gain
from repro_torch.kernels.bitline_mac import bitline_mac_kernel
from repro_torch.kernels.xnor_gemm import binarize_acc, xnor_gemm_kernel

_F32 = torch.float32
WRITE_BER_SALT = 0x5EB      # the reference's fold_in salt of the BER draw


@dataclasses.dataclass(frozen=True)
class AnalogConfig:
    """Read/write-path non-ideality knobs (the accuracy surface axes)."""

    adc_bits: int = 6              # 0 = ideal ADC (no quantization)
    tmr: Optional[float] = None    # device TMR override (None = default)
    v_read: float = 0.1            # DAC full-scale read voltage [V]
    g_sigma: float = 0.0           # deprecated alias of variation=
                                   # VariationSpec.from_g_sigma(g_sigma, seed)
    ir_drop: bool = True           # per-column bit-line IR attenuation
    full_scale_sigmas: float = 4.0 # ADC full scale in column-current sigmas
    seed: int = 0                  # programming-variation / write-BER draw
    write_ber: float = 0.0         # residual write-error rate (cells left
                                   # at the erased G_AP floor)
    variation: Optional[VariationSpec] = None   # single-corner D2D spec
    faults: Optional[FaultSpec] = None          # hard-defect model
    repair: Optional[RepairPolicy] = None       # repair of the defect map


@dataclasses.dataclass(frozen=True, eq=False)
class ProgrammedArray:
    """A weight matrix resident in a differential crossbar pair."""

    g_diff: torch.Tensor     # (K, N) effective differential conductance [S]
    w_scale: float           # |w|_max used for normalization
    g_fs: float              # unit-weight differential conductance G_P-G_AP [S]
    att_mean: float          # mean IR-drop factor (decode gain calibration)
    g_rms: float             # rms of g_diff (ADC full-scale sizing)
    dev: DeviceParams
    bl: BitlineParams
    cfg: AnalogConfig

    @property
    def shape(self) -> Tuple[int, int]:
        return tuple(self.g_diff.shape)


def _device_for(kind: str, cfg: AnalogConfig) -> DeviceParams:
    dev = AFMTJ_PARAMS if kind == "afmtj" else MTJ_PARAMS
    if cfg.tmr is not None:
        dev = dataclasses.replace(dev, tmr=float(cfg.tmr))
    return dev


def _resolved_variation(cfg: AnalogConfig) -> Optional[VariationSpec]:
    """The D2D spec programming uses: ``cfg.variation``, or the deprecated
    ``g_sigma`` rewritten to its equivalent spec."""
    if cfg.variation is not None:
        assert cfg.g_sigma == 0.0, (
            "set either AnalogConfig.variation or the deprecated g_sigma, "
            "not both")
        assert cfg.variation.n_corners == 1, (
            "read-path programming models one corner's array; sweep corners "
            "by programming one AnalogConfig per corner (spec.at_corner)")
        return cfg.variation
    if cfg.g_sigma > 0.0:
        warnings.warn(
            "AnalogConfig.g_sigma is deprecated; pass variation="
            "VariationSpec.from_g_sigma(g_sigma, seed) instead",
            DeprecationWarning, stacklevel=3)
        return VariationSpec.from_g_sigma(cfg.g_sigma, seed=cfg.seed)
    return None


def effective_conductances(dp: DeviceParams, bl: BitlineParams
                           ) -> Tuple[float, float]:
    """(G_P, G_AP) through the access FET, float32 values as Python floats
    (the reference's ``float(cell_conductance(jnp.asarray(1/R), bl))``)."""
    g_p = cell_conductance(torch.tensor(1.0 / dp.r_parallel, dtype=_F32), bl)
    g_ap = cell_conductance(torch.tensor(1.0 / dp.r_antiparallel, dtype=_F32),
                            bl)
    return float(g_p), float(g_ap)


def write_ber_masks(seed: int, ber: float, shape, device
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(fail_pos, fail_neg) Bernoulli(``ber``) masks of the residual write
    errors, drawn from a CPU ``torch.Generator`` seeded with (seed, salt), so
    both devices and both the device and the fake path see the same
    faulty cells.  The reference draws these with ``jax.random``; the tests
    hand its draws over by replacing this function.  The draw runs inside
    the profiler span ``repro.analog.fail_planes``."""
    with span("repro.analog.fail_planes"):
        gen = torch.Generator(device="cpu").manual_seed(
            (int(seed) * 0x9E3779B1 + WRITE_BER_SALT) & 0xFFFFFFFF)
        u_pos = torch.rand(tuple(shape), generator=gen)
        u_neg = torch.rand(tuple(shape), generator=gen)
        return (u_pos < ber).to(device), (u_neg < ber).to(device)


def _scalar(x: float, device) -> torch.Tensor:
    return torch.tensor(float(x), dtype=_F32, device=device)


def _as_f32(x, device) -> torch.Tensor:
    if not torch.is_tensor(x):
        x = torch.from_numpy(np.array(x, dtype=np.float32))
    return x.to(device=device, dtype=_F32)


def program_weights(
    w,                               # (K, N) float weights
    kind: str = "afmtj",
    cfg: AnalogConfig = AnalogConfig(),
    bl: Optional[BitlineParams] = None,
    device=None,
) -> ProgrammedArray:
    """Program ``w`` into a differential conductance pair (steps 1-2) on
    ``device`` (None = the CUDA device)."""
    dev_t = resolve_device(device)
    w = _as_f32(w, dev_t)
    assert w.dim() == 2, tuple(w.shape)
    k_rows, n_cols = w.shape
    dp = _device_for(kind, cfg)
    bl = bl or BitlineParams(rows=k_rows)

    g_p_eff, g_ap_eff = effective_conductances(dp, bl)
    g_fs = g_p_eff - g_ap_eff

    w_scale = float(w.abs().max())
    if w_scale == 0.0:
        w_scale = 1.0
    wn = w / _scalar(w_scale, dev_t)
    tgt_pos = g_ap_eff + torch.clamp_min(wn, 0.0) * g_fs
    tgt_neg = g_ap_eff + torch.clamp_min(-wn, 0.0) * g_fs

    spec = _resolved_variation(cfg)
    if spec is not None:
        # junction variation: back through the access FET, the spec's
        # per-junction resistance factor (streams 0/1: pos/neg array),
        # forward again
        corner = spec.corners[0]

        def perturb(tgt, stream):
            g_j = tgt / (1.0 - bl.r_access * tgt)
            r_f = spec.lane_factors(corner, tgt.numel(), stream=stream)[3]
            g_scale = torch.as_tensor((1.0 / r_f).reshape(tuple(tgt.shape)),
                                      dtype=_F32).to(dev_t)
            return cell_conductance(g_j * g_scale, bl)

        g_pos, g_neg = perturb(tgt_pos, 0), perturb(tgt_neg, 1)
    else:
        g_pos, g_neg = tgt_pos, tgt_neg

    if cfg.faults is not None and cfg.faults.drift_sigma > 0.0:
        g_pos = g_pos * hard_faults.drift_factors(
            cfg.faults, k_rows, n_cols, negative=False, device=dev_t)
        g_neg = g_neg * hard_faults.drift_factors(
            cfg.faults, k_rows, n_cols, negative=True, device=dev_t)

    if cfg.write_ber > 0.0:
        fail_pos, fail_neg = write_ber_masks(cfg.seed, cfg.write_ber,
                                             tgt_pos.shape, dev_t)
        floor = _scalar(g_ap_eff, dev_t)
        g_pos = torch.where(fail_pos, floor, g_pos)
        g_neg = torch.where(fail_neg, floor, g_neg)

    col_ok = None
    if cfg.faults is not None:
        # hard defects before IR drop (stuck-on shorts load their columns,
        # dead pairs unload them), the fake path's decode order
        code, col_ok = cfg.faults.planes(k_rows, n_cols, device=dev_t)
        if cfg.repair is not None:
            code, col_ok = hard_faults.apply_repair(code, col_ok, cfg.repair)
        g_pos, g_neg = hard_faults.apply_cell_faults(
            code, g_pos, g_neg, g_off=g_ap_eff, g_on=g_ap_eff + g_fs)

    att_mean = 1.0
    if cfg.ir_drop:
        att_pos = column_ir_drop(torch.sum(g_pos, dim=0), bl)
        att_neg = column_ir_drop(torch.sum(g_neg, dim=0), bl)
        g_pos = g_pos * att_pos[None, :]
        g_neg = g_neg * att_neg[None, :]
        att_mean = float(0.5 * (torch.mean(att_pos) + torch.mean(att_neg)))

    if col_ok is not None:
        # dead bit-line drivers read zero; the decode gain calibrates over
        # live columns only (same association as the no-fault mean)
        g_pos = g_pos * col_ok[None, :]
        g_neg = g_neg * col_ok[None, :]
        if cfg.ir_drop:
            live = _scalar(max(float(torch.sum(col_ok)), 1.0), dev_t)
            att_mean = float(0.5 * (torch.sum(att_pos * col_ok) / live
                                    + torch.sum(att_neg * col_ok) / live))

    g_diff = g_pos - g_neg
    g_rms = float(torch.sqrt(torch.mean(g_diff * g_diff)))
    return ProgrammedArray(g_diff=g_diff, w_scale=w_scale, g_fs=g_fs,
                           att_mean=att_mean, g_rms=g_rms, dev=dp, bl=bl,
                           cfg=cfg)


def kernel_operands(arr: ProgrammedArray, x
                    ) -> Tuple[torch.Tensor, float, float]:
    """The exact (v, i_max, x_scale) ``analog_matmul`` feeds the kernel, on
    the programmed array's device.  Activations map to bipolar word-line
    voltages (``v_read`` full scale); the ADC full scale comes from
    column-current statistics rounded to 2 significant digits through a
    string, as the reference does."""
    cfg = arr.cfg
    dev_t = arr.g_diff.device
    x = _as_f32(x, dev_t)
    x_scale = float(x.abs().max())
    if x_scale == 0.0:
        x_scale = 1.0
    v = (cfg.v_read * x) / _scalar(x_scale, dev_t)
    v_rms = float(torch.sqrt(torch.mean(v * v)))
    i_max = adc_full_scale(v_rms, arr.g_rms, x.shape[1],
                           cfg.full_scale_sigmas)
    return v, i_max, x_scale


def split_devices(m: int, devices) -> list:
    """The devices an ``m``-row batch splits over: a list as given (one
    device named twice counts twice), an int n the first n CUDA devices;
    at most ``m`` of them and at least one (the reference's
    ``_usable_devices``)."""
    if isinstance(devices, int):
        resolve_device("cuda")
        n = min(devices, torch.cuda.device_count())
        devices = [torch.device("cuda", i) for i in range(n)]
    devs = [torch.device(d) for d in devices]
    return devs[:max(min(len(devs), m), 1)]


def _mvm_split(v: torch.Tensor, g: torch.Tensor, devs: list, adc_bits: int,
               i_max: float) -> torch.Tensor:
    """V @ G through the bit-line MAC, the rows of ``v`` zero-padded to a
    multiple of ``len(devs)`` and split in order, one launch per device on
    its share; the result on ``v``'s device, padding dropped."""
    m, n = v.shape[0], len(devs)
    pad = -m % n
    if pad:
        v = torch.cat([v, v.new_zeros((pad, v.shape[1]))])
    per = v.shape[0] // n
    outs = [bitline_mac_kernel(v[i * per:(i + 1) * per].to(d), g.to(d),
                               adc_bits, i_max)
            for i, d in enumerate(devs)]
    return torch.cat([o.to(v.device) for o in outs])[:m]


def analog_matmul(arr: ProgrammedArray, x, devices=None) -> torch.Tensor:
    """``x @ w`` through the programmed crossbar (steps 3-4), on the
    array's device; the ADC output decoded back to weight x activation
    units by the programming scales and the mean IR calibration.
    ``devices`` (a device list, or an int n: the first n CUDA devices)
    splits the batch rows over them (``split_devices``); None runs one
    launch on the array's device.

    The decode is one float32 multiply by the float64 gain rounded once
    (the reference multiplies and divides by two float32-rounded factors):
    the fused fake path's kernel epilogue does the same multiply, so the
    two modes agree bit for bit on the same inputs."""
    assert x.dim() == 2 and x.shape[1] == arr.g_diff.shape[0], (
        tuple(x.shape), tuple(arr.g_diff.shape))
    cfg = arr.cfg
    v, i_max, x_scale = kernel_operands(arr, x)
    if devices is None:
        i_out = bitline_mac_kernel(v, arr.g_diff, cfg.adc_bits, i_max)
    else:
        i_out = _mvm_split(v, arr.g_diff, split_devices(v.shape[0], devices),
                           cfg.adc_bits, i_max)
    return i_out * decode_gain(x_scale, arr.w_scale, cfg.v_read, arr.g_fs,
                               arr.att_mean)


def binary_matmul(x, w, tie: int = 1, device=None) -> torch.Tensor:
    """1-bit (XNOR-popcount) projection: sign-binarize both operands, run
    the XNOR kernel, rescale by per-column mean |w| and scalar mean |x|."""
    dev_t = resolve_device(device)
    x = _as_f32(x, dev_t)
    w = _as_f32(w, dev_t)
    xb = binarize_acc(x, tie)
    wb = binarize_acc(w, tie)
    pops = xnor_gemm_kernel(xb, wb, binarize=False, tie=tie)
    alpha_w = torch.mean(torch.abs(w), dim=0)
    alpha_x = torch.mean(torch.abs(x))
    return pops * alpha_w[None, :] * alpha_x


@dataclasses.dataclass(frozen=True)
class AccuracyReport:
    """Output error of one analog MVM vs the float32 matmul."""

    arch: str
    kind: str
    mode: str                      # "analog" (bitline+ADC) | "bnn" (xnor)
    adc_bits: int
    tmr: float
    g_sigma: float
    m: int
    k: int
    n: int
    mse: float
    nmse: float                    # mse / mean(y_ref^2)
    cosine: float
    max_abs_err: float
    write_ber: float = 0.0


def _report(y, y_ref, *, arch, kind, mode, cfg: AnalogConfig, tmr: float
            ) -> AccuracyReport:
    y = y.detach().double().cpu().numpy()
    y_ref = y_ref.detach().double().cpu().numpy()
    err = y - y_ref
    mse = float(np.mean(err**2))
    ref_pw = float(np.mean(y_ref**2))
    cos = float(np.sum(y * y_ref) /
                max(np.linalg.norm(y) * np.linalg.norm(y_ref), 1e-30))
    return AccuracyReport(
        arch=arch, kind=kind, mode=mode, adc_bits=cfg.adc_bits, tmr=tmr,
        g_sigma=cfg.g_sigma, m=y.shape[0], k=0, n=y.shape[1], mse=mse,
        nmse=mse / max(ref_pw, 1e-30), cosine=cos,
        max_abs_err=float(np.max(np.abs(err))), write_ber=cfg.write_ber)


def mvm_accuracy(w, x, kind: str = "afmtj", cfg: AnalogConfig = AnalogConfig(),
                 mode: str = "analog", arch: str = "", device=None,
                 devices=None) -> AccuracyReport:
    """Program ``w``, run ``x`` through the kernel path (the analog mode's
    batch split over ``devices``, as ``analog_matmul``), score vs
    float32."""
    dev_t = resolve_device(device)
    w = _as_f32(w, dev_t)
    x = _as_f32(x, dev_t)
    y_ref = x @ w
    if mode == "analog":
        arr = program_weights(w, kind, cfg, device=dev_t)
        y = analog_matmul(arr, x, devices=devices)
        tmr = arr.dev.tmr
    elif mode == "bnn":
        y = binary_matmul(x, w, device=dev_t)
        tmr = _device_for(kind, cfg).tmr
    else:
        raise ValueError(f"unknown mode {mode!r}")
    rep = _report(y, y_ref, arch=arch, kind=kind, mode=mode, cfg=cfg, tmr=tmr)
    return dataclasses.replace(rep, k=int(w.shape[0]))
