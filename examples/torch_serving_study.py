"""Serving study on the PyTorch/CUDA port: offered load vs tail latency and
SLO attainment, AFMTJ vs MTJ vs CPU (DESIGN.md §11), the twin of
``examples/serving_study.py`` for ``src/repro_torch``.

Poisson offered load through the event-driven serving simulator — the
continuous-batching policy of ``launch.scheduler`` with every token priced
by each technology's ``DeviceCostModel`` (the AFMTJ / MTJ prices from the
measured hierarchy, whose device write solves run on the card) — per
(technology, load): p50 / p99 TTFT and TPOT, tokens per joule, device
utilization and the policy-normalized SLO attainment.  Load is normalized
to each technology's own capacity, so the curves compare across clocks
orders of magnitude apart.

    python examples/torch_serving_study.py                # GPU
    python examples/torch_serving_study.py --device cpu --quick
"""
import argparse
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

from repro_torch.configs.registry import ARCHS  # noqa: E402
from repro_torch.imc.cost_model import (device_cost_model,  # noqa: E402
                                        per_token_counts)
from repro_torch.launch.report import SLO, build_report  # noqa: E402
from repro_torch.launch.simulate import simulate_serving  # noqa: E402
from repro_torch.launch.traffic import (CHAT_OUTPUTS,  # noqa: E402
                                        CHAT_PROMPTS, poisson_at_load)

TECHS = ("afmtj", "mtj", "cpu")
N_SLOTS = 8


def sizes(quick: bool) -> tuple:
    """(offered loads, requests per cell)."""
    if quick:
        return (0.5, 0.95, 2.0), 5_000
    return (0.3, 0.5, 0.8, 0.95, 1.1, 1.5, 2.0), 100_000


def run(device=None, quick=False, arch="qwen2-0.5b") -> dict:
    """Per technology its token prices, its SLO and one report row per
    offered load."""
    loads, n_requests = sizes(quick)
    tc = per_token_counts(ARCHS[arch])
    out = dict(arch=arch, mac_weights=tc.mac_weights, kv_elems=tc.kv_elems,
               n_requests=n_requests, techs={})
    for tech in TECHS:
        prices = device_cost_model(tech, device=device).token_prices(tc)
        slo = SLO.normalized(prices, CHAT_PROMPTS, CHAT_OUTPUTS, N_SLOTS)
        rows = []
        for rho in loads:
            trace = poisson_at_load(prices, rho, n_requests, N_SLOTS,
                                    seed=5).trace()
            res = simulate_serving(prices, trace, n_slots=N_SLOTS)
            rows.append(build_report(
                tech, res.ttft_s, res.tpot_s, res.sim_time_s, res.energy_j,
                res.prefill_tokens, res.decode_tokens, offered_load=rho,
                slo=slo, busy_s=res.busy_s).row_dict())
        out["techs"][tech] = dict(t_tok=prices.t_tok, t_pos=prices.t_pos,
                                  slo_ttft=slo.ttft_s, slo_tpot=slo.tpot_s,
                                  rows=rows)
    return out


def report(res: dict) -> list:
    """The lines ``examples/serving_study.py`` prints, from ``run``'s
    numbers."""
    lines = [f"arch {res['arch']}: {res['mac_weights']:.3g} weight MACs + "
             f"{res['kv_elems']:.0f} KV elems per token, {N_SLOTS} slots, "
             f"{res['n_requests']} requests per cell"]
    header = (f"{'tech':6s} {'load':>5s} {'ttft_p50':>10s} {'ttft_p99':>10s} "
              f"{'tpot_p50':>10s} {'tpot_p99':>10s} {'tok/J':>10s} "
              f"{'util':>5s} {'SLO':>6s}")
    for tech, t in res["techs"].items():
        lines += ["", f"[{tech}] t_tok={t['t_tok']:.3e} s  "
                  f"t_pos={t['t_pos']:.3e} s/ctx  SLO: ttft<="
                  f"{t['slo_ttft']:.2e} s tpot<={t['slo_tpot']:.2e} s", header]
        for r in t["rows"]:
            lines.append(
                f"{tech:6s} {r['offered_load']:5.2f} {r['ttft_p50_s']:10.3e} "
                f"{r['ttft_p99_s']:10.3e} {r['tpot_p50_s']:10.3e} "
                f"{r['tpot_p99_s']:10.3e} {r['tokens_per_joule']:10.3e} "
                f"{r['utilization']:5.2f} {r['slo_attainment']:6.3f}")
    return lines


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="qwen2-0.5b",
                    help=f"architecture (choices: {sorted(ARCHS)})")
    ap.add_argument("--device", default=None,
                    help="cuda (default) or cpu (plain PyTorch versions)")
    ap.add_argument("--quick", action="store_true",
                    help="fewer requests and loads (seconds, not minutes)")
    args = ap.parse_args()
    print("\n".join(report(run(args.device, args.quick, args.arch))))


if __name__ == "__main__":
    main()
