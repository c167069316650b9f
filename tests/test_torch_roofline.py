"""``launch.roofline`` against the reference's on the same cell records,
the reference's three constants set to the port's H100 rates through
``monkeypatch`` (nothing in ``src/repro/`` is edited): ``analyze``,
``fmt_table`` less the port's fit column, and ``pick_hillclimb``.  The
records are the reference's schema (no ``flops_rank``), so the port
reads their compute term as the reference does; with ``flops_rank`` the
port reads that."""
import numpy as np
import pytest

from repro.launch import roofline as JR
from repro_torch.launch import roofline as R

CELLS = [("qwen2-0.5b", "train_4k"), ("qwen2-0.5b", "decode_32k"),
         ("gemma2-2b", "prefill_32k"), ("olmoe-1b-7b", "train_4k"),
         ("mamba2-780m", "long_500k"), ("jamba-1.5-large-398b", "train_4k"),
         ("llama4-maverick-400b-a17b", "decode_32k"),
         ("seamless-m4t-large-v2", "prefill_32k")]
KINDS = {"train_4k": "train", "prefill_32k": "prefill",
         "decode_32k": "decode", "long_500k": "decode"}


def _records(seed=0):
    rng = np.random.default_rng(seed)
    out = []
    for arch, shape in CELLS:
        flops = float(10 ** rng.uniform(11, 16))
        out.append({
            "arch": arch, "shape": shape, "mesh": "pod_16x16",
            "n_devices": 256, "kind": KINDS[shape], "microbatches": 1,
            "params_total": int(10 ** rng.uniform(8, 11.6)),
            "params_active": 0,
            "flops_audit_global": flops * 256,
            "flops_audit_per_device": flops,
            "memory": {"argument_size_in_bytes": int(rng.integers(1, 9e10)),
                       "temp_size_in_bytes": int(rng.integers(1, 9e10)),
                       "output_size_in_bytes": 0,
                       "generated_code_size_in_bytes": None,
                       "alias_size_in_bytes": 0},
            "cost": {"flops": flops / 3,
                     "bytes accessed": float(10 ** rng.uniform(9, 14))},
            "collectives": {k: {"count": 1,
                                "bytes": int(10 ** rng.uniform(6, 12))}
                            for k in ("all-reduce", "all-gather",
                                      "reduce-scatter", "all-to-all",
                                      "collective-permute")},
        })
    return out


@pytest.fixture
def h100_reference(monkeypatch):
    monkeypatch.setattr(JR, "PEAK_FLOPS", R.PEAK_FLOPS)
    monkeypatch.setattr(JR, "HBM_BW", R.HBM_BW)
    monkeypatch.setattr(JR, "ICI_BW", R.LINK_BW)
    return JR


def test_constants_are_the_h100_data_sheet():
    assert (R.PEAK_FLOPS, R.HBM_BW, R.LINK_BW) == (989e12, 3.35e12, 50e9)
    assert 79 * 2 ** 30 < R.CARD_BYTES < 80 * 2 ** 30


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_analyze_equals_reference(seed, h100_reference):
    for c in _records(seed):
        got, want = R.analyze(c), h100_reference.analyze(c)
        assert got == want


def _less_fit_column(table: str) -> str:
    return "\n".join(line.rsplit("|", 2)[0] + "|"
                     for line in table.splitlines())


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_fmt_table_and_picks_equal_reference(seed, h100_reference):
    recs = _records(seed)
    got = [R.analyze(c) for c in recs]
    want = [h100_reference.analyze(c) for c in recs]
    assert _less_fit_column(R.fmt_table(got)) == \
        h100_reference.fmt_table(want)
    assert R.pick_hillclimb(got) == h100_reference.pick_hillclimb(want)


def test_fit_column_and_flops_rank():
    c = _records()[0]
    m = c["memory"]
    m["argument_size_in_bytes"], m["temp_size_in_bytes"] = \
        R.CARD_BYTES - 10, 10
    assert R.fits(c) and R.fmt_table([R.analyze(c)]).endswith("| yes |")
    m["temp_size_in_bytes"] = 11
    assert not R.fits(c)
    assert R.fmt_table([R.analyze(c)]).endswith("| no |")
    c["flops_rank"] = 16 * c["flops_audit_per_device"]
    a = R.analyze(c)
    assert a["t_compute"] == c["flops_rank"] / R.PEAK_FLOPS
    assert a["useful_ratio"] == a["model_flops_dev"] / c["flops_rank"]


def test_main_reads_the_port_records(tmp_path, monkeypatch, capsys):
    import json

    for c in _records():
        (tmp_path / f"{c['arch']}__{c['shape']}__pod.json").write_text(
            json.dumps(c))
    monkeypatch.setattr(R, "RESULTS", tmp_path)
    R.main(["--md", str(tmp_path / "roofline.md")])
    out = capsys.readouterr().out
    assert "256 GPUs" in out and "### Hillclimb picks" in out
    assert (tmp_path / "roofline.md").read_text() == out
