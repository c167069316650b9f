"""Plain PyTorch versions of the port's kernels.

``ref_llg_rk4`` is the port of ``repro.kernels.ref.ref_llg_rk4``: it steps
the production physics of ``core.llg`` on ``(cells, n_sub, 3)`` tensors,
one RK4 step per loop iteration.  It is what ``llg_rk4_kernel`` runs for
CPU tensors, and what ``chip_smoke.py`` holds the CUDA kernel against on
the card.

Early exit (``chunk > 0``) goes by groups of ``CELL_TILE`` lanes, the
exit group of the reference's Pallas kernel and of the CUDA kernel (one
thread block): before every chunk, a group whose lanes have all crossed or
run out of budget stops updating.  The reference's oracle instead stops
only when every lane of the whole block is done, so past a finished group
its rows 0-5 keep moving; row 7 (first crossing) is the same either way,
and with a single group the two are identical.

``ref_llg_write`` is the single-junction write loop of
``core.device.simulate_write`` (the reference's ``lax.scan`` in
``repro.core.device``) over a batch of lanes, one per drive voltage, at a
fixed horizon with the self-consistent a_J (times an optional per-lane
conductance factor); it is what ``llg_write.llg_write_kernel`` runs for
CPU tensors.

``ref_bitline_mac``, ``ref_xnor_gemm`` and ``ref_fake_analog`` are the plain
versions of the analog MAC kernels (``csrc/analog_mac.cu``,
``csrc/xnor_gemm.cu``, ``csrc/fake_analog.cu``), mirroring the
reference's jnp oracles: one float32 matmul plus the shared epilogue
helpers of ``bitline_mac`` / ``xnor_gemm`` / ``fake_analog``.
``ref_adc_aux`` is that of the fake-analog operand sizing
(``csrc/adc_sizing.cu``): host floats, sized as the device path sizes.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.core import llg, tmr
from repro_torch.core.integrator import rk4_step
from repro_torch.core.params import DeviceParams
from repro_torch.kernels import noise

CELL_TILE = 512       # lanes per early-exit group (one CUDA thread block)
ROWS = 8
VAR_ROWS = 3          # variation rows: alpha, B_k [T], g_scale


def ref_llg_rk4(
    state: torch.Tensor,          # (8, cells) f32 SoA (see kernels/llg_rk4.py)
    p: DeviceParams,
    dt: float,
    n_steps: int,
    switch_threshold: float = 0.9,
    thermal_sigma=0.0,            # scalar or (cells,) per-lane Brown sigma
    seeds: torch.Tensor | None = None,   # (cells,) int32 bits of uint32 seeds
    step_budget=None,             # optional (cells,) f32 per-lane step budget
    chunk: int = 0,               # >0: early-exit chunk size (steps)
    lane_params=None,             # optional (3, cells) f32: alpha, B_k, g_scale
    out: torch.Tensor | None = None,   # optional (8, cells) f32 result block
) -> torch.Tensor:
    """Advance the ``(8, cells)`` block ``n_steps`` RK4 steps; returns the
    block with rows 0-5 the final state, row 6 the drive and row 7 the
    first step (1-based, as float32) at which n_z < -threshold, or
    ``n_steps`` if none.  ``p.n_sublattices`` selects dual- (AFMTJ) or
    single-sublattice (MTJ) physics; the MTJ keeps rows 3-5 at zero and
    takes the first triple of each step's six thermal normals.  With
    ``out`` (which may be ``state`` itself) the block is copied into it
    once the whole horizon is done, and ``out`` is returned."""
    f32 = torch.float32
    dev = state.device
    cells = state.shape[1]
    n_sub = p.n_sublattices
    g_scale = None
    p_lane = p
    if lane_params is not None:
        lp = torch.as_tensor(lane_params, dtype=f32, device=dev)
        assert lp.shape == (VAR_ROWS, cells), (lp.shape, cells)
        p_lane = dataclasses.replace(p, alpha=lp[0].reshape(cells, 1, 1),
                                     b_aniso=lp[1].reshape(cells, 1, 1))
        g_scale = lp[2]
    if n_sub == 1:
        m = state[0:3].T[:, None, :]
    else:
        m = torch.stack([state[0:3].T, state[3:6].T], dim=1)
    v = state[6]
    use_noise = seeds is not None
    if use_noise:
        seeds = noise.as_uint32(seeds.reshape(cells))
        sigma = torch.broadcast_to(
            torch.as_tensor(thermal_sigma, dtype=f32, device=dev),
            (cells,)).reshape(cells, 1, 1)
    else:
        assert isinstance(thermal_sigma, (int, float)) and thermal_sigma == 0.0, \
            "thermal path needs per-cell stream seeds"
    budget = None
    if step_budget is not None or chunk > 0:
        budget = (torch.full((cells,), float(n_steps), dtype=f32, device=dev)
                  if step_budget is None else
                  torch.broadcast_to(torch.as_tensor(step_budget, dtype=f32,
                                                     device=dev), (cells,)))
    aj_scale = llg.const(p.area, state)
    neg_thr = -switch_threshold
    never = float(n_steps)

    def step(i: int, m, crossed, frozen):
        nz = llg.order_parameter_z(m)
        g = tmr.conductance_from_cos(nz, p)
        aj = p.stt_prefactor * v * g / aj_scale
        if g_scale is not None:
            aj = aj * g_scale
        if use_noise:
            d1, d2 = noise.thermal_draws(seeds, i)
            triples = [torch.stack(d1, dim=-1), torch.stack(d2, dim=-1)]
            b_th = sigma * torch.stack(triples[:n_sub], dim=1)
        else:
            b_th = None
        m_next = rk4_step(lambda mm, tt: llg.llg_rhs(mm, p_lane, aj, b_th),
                          m, 0.0, dt)
        newly = (llg.order_parameter_z(m_next) < neg_thr) & (crossed >= never)
        if budget is not None:
            active = float(i) < budget
            if frozen is not None:
                active = active & ~frozen
            newly = newly & active
            m_next = torch.where(active[:, None, None], m_next, m)
        crossed = torch.where(newly, torch.full_like(crossed, float(i + 1)),
                              crossed)
        return m_next, crossed

    crossed = torch.full((cells,), never, dtype=f32, device=dev)
    if chunk <= 0:
        for i in range(int(n_steps)):
            m, crossed = step(i, m, crossed, None)
    else:
        n_chunks = -(-int(n_steps) // int(chunk))
        n_groups = -(-cells // CELL_TILE)
        pad = n_groups * CELL_TILE - cells
        for c in range(n_chunks):
            done = (crossed < never) | (float(c * chunk) >= budget)
            group_done = torch.nn.functional.pad(done, (0, pad), value=True)
            group_done = group_done.reshape(n_groups, CELL_TILE).all(dim=1)
            if bool(group_done.all()):
                break
            frozen = group_done.repeat_interleave(CELL_TILE)[:cells]
            for j in range(int(chunk)):
                m, crossed = step(c * chunk + j, m, crossed, frozen)
    sub2 = m[:, 1, :].T if n_sub == 2 else torch.zeros_like(m[:, 0, :].T)
    res = torch.cat([m[:, 0, :].T, sub2, v[None], crossed[None]], dim=0)
    return res if out is None else out.copy_(res)


def llg_write_stepper(
    m0: torch.Tensor,             # (lanes, n_sub, 3) f32 initial states
    voltages: torch.Tensor,       # (lanes,) f32 drive voltages
    p: DeviceParams,
    dt: float,
    down: bool = True,
    g_scale: torch.Tensor | None = None,   # optional (lanes,) f32 factors
) -> tuple:
    """``(step, state)``: ``ref_llg_write``'s loop body and its initial
    state ``(m, t, t_switch, switched, energy)``; ``step(state)`` returns
    the state one RK4 step later.  Once a step has run, a step makes no
    host-to-device copy (its constants are cached), so it can be captured
    in a CUDA graph and replayed."""
    from repro_torch.core.device import a_j_from_voltage

    f32 = torch.float32
    dev = m0.device
    lanes = m0.shape[0]
    v = voltages.to(f32)
    v2 = v * v
    dt_t = llg.const(dt, m0)
    zero = torch.zeros((), dtype=f32, device=dev)
    t = torch.zeros((), dtype=f32, device=dev)
    t_sw = torch.full((lanes,), float("inf"), dtype=f32, device=dev)
    sw = torch.zeros((lanes,), dtype=torch.bool, device=dev)
    en = torch.zeros((lanes,), dtype=f32, device=dev)
    gs = (torch.ones((lanes,), dtype=f32, device=dev) if g_scale is None
          else g_scale.to(f32).reshape(lanes))

    def step(state: tuple) -> tuple:
        m, t, t_sw, sw, en = state
        a_j = a_j_from_voltage(v, m, p) * gs
        m = rk4_step(lambda mm, tt: llg.llg_rhs(mm, p, a_j), m, 0.0, dt)
        opz = llg.order_parameter_z(m)
        crossed = opz < -0.9 if down else opz > 0.9
        t_next = t + dt_t
        t_sw = torch.where(crossed & ~sw, t_next, t_sw)
        sw = sw | crossed
        g = tmr.conductance(m, p) * gs
        en = en + torch.where(sw, zero, v2 * g * dt_t)
        return m, t_next, t_sw, sw, en

    return step, (m0, t, t_sw, sw, en)


def ref_llg_write(
    m0: torch.Tensor,             # (lanes, n_sub, 3) f32 initial states
    voltages: torch.Tensor,       # (lanes,) f32 drive voltages
    p: DeviceParams,
    dt: float,
    n_steps: int,
    down: bool = True,
    g_scale: torch.Tensor | None = None,   # optional (lanes,) f32 factors
) -> tuple:
    """Advance ``lanes`` junctions ``n_steps`` RK4 steps, the STT amplitude
    re-evaluated from the conductance at every step (a_J = pref ((V G)/A),
    the order of ``core.device.a_j_from_voltage``, times ``g_scale``).  Per
    step: t = t + dt in float32; the first step whose order parameter
    crosses -0.9 (``down``) or +0.9 stamps ``t + dt``; the energy adds
    V^2 (G g_scale) dt until the lane has switched.  Without ``g_scale``
    the factor is 1 (a product with 1.0 is exact, so the result is the
    same).  Returns ``(m, t_switch, switched, energy)``: the final
    ``(lanes, n_sub, 3)`` state, ``(lanes,)`` float32 (inf where no crossing),
    bool and float32."""
    step, state = llg_write_stepper(m0, voltages, p, dt, down, g_scale)
    for _ in range(int(n_steps)):
        state = step(state)
    m, _, t_sw, sw, en = state
    return m, t_sw, sw, en


def ref_bitline_mac(v, g, adc_bits: int = 0, i_max=1.0):
    from repro_torch.kernels.bitline_mac import adc_quantize

    i_bl = v.to(torch.float32) @ g.to(torch.float32)
    return adc_quantize(i_bl, adc_bits, i_max)


def ref_fake_analog(v, wn, fail, aux, adc_bits: int = 0,
                    apply_fet: bool = False, use_fail: bool = False):
    """Plain version of the fused fake-analog MVM: the shared conductance
    replay (``_tile_g_diff``) over the whole array, one matmul, the shared
    ADC on the per-column full scale, the decode gain."""
    from repro_torch.kernels.bitline_mac import adc_quantize
    from repro_torch.kernels.fake_analog import (ROW_DECODE, ROW_I_MAX,
                                                 _tile_g_diff)

    f32 = torch.float32
    aux = aux.to(f32)
    g_diff = _tile_g_diff(wn.to(f32), fail.to(f32), aux,
                          apply_fet=apply_fet, use_fail=use_fail)
    i_bl = v.to(f32) @ g_diff
    i_max = aux[ROW_I_MAX:ROW_I_MAX + 1, :]
    return (adc_quantize(i_bl, adc_bits, i_max)
            * aux[ROW_DECODE:ROW_DECODE + 1, :])


def ref_adc_aux(att_p, att_n, cell, *, w_max, x_max, att_mean, g_rms, v_rms,
                k_rows: int, fs_sigmas: float, v_read: float, g_fs: float,
                decode: bool, i_max):
    """Plain version of the ADC sizing kernel (``kernels.adc_sizing``): the
    statistics read to host floats, the full scale and the decode gain sized
    on the host by ``adc_sizing.adc_full_scale`` / ``decode_gain`` (the
    device path's own), and the aux plane stacked from full-length rows."""
    from repro_torch.kernels.adc_sizing import adc_full_scale, decode_gain
    from repro_torch.kernels.fake_analog import (AUX_ROWS, ROW_ATT_NEG,
                                                 ROW_ATT_POS, ROW_DECODE,
                                                 ROW_G_AP, ROW_G_FS,
                                                 ROW_G_SCALE, ROW_I_MAX,
                                                 ROW_R_ACCESS)

    def scale(t):
        x = float(t)
        return 1.0 if x == 0.0 else x

    if i_max is None:
        i_max = adc_full_scale(float(v_rms), float(g_rms), k_rows, fs_sigmas)
    dec = 1.0
    if decode:
        att = 1.0 if att_mean is None else float(att_mean)
        dec = decode_gain(scale(x_max), scale(w_max), v_read, g_fs, att)
    n = att_p.shape[0]

    def full(val):
        return torch.broadcast_to(torch.as_tensor(
            val, dtype=torch.float32, device=att_p.device), (n,))

    rows = [None] * AUX_ROWS
    rows[ROW_ATT_POS], rows[ROW_ATT_NEG] = att_p, att_n
    rows[ROW_I_MAX], rows[ROW_DECODE] = full(i_max), full(dec)
    (rows[ROW_G_AP], rows[ROW_G_FS], rows[ROW_G_SCALE],
     rows[ROW_R_ACCESS]) = (full(c) for c in cell)
    return torch.stack(rows)


def ref_xnor_gemm(a, w, binarize: bool = False, tie: int = 1):
    from repro_torch.kernels.xnor_gemm import binarize_acc

    out = a.to(torch.float32) @ w.to(torch.float32)
    if binarize:
        out = binarize_acc(out, tie)
    return out


def ref_xnor_popcount(a_bits: torch.Tensor, w_bits: torch.Tensor):
    """Bit-domain identity: a, w in {0, 1}; result == the +-1 dot product."""
    K = a_bits.shape[-1]
    xnor = 1 - torch.bitwise_xor(a_bits[:, None, :], w_bits.T[None, :, :])
    return 2 * xnor.sum(dim=-1) - K
