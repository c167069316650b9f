"""Multi-process campaigns of the port on the CPU: the campaign mesh
(``launch.mesh``), the elastic device plan (``runtime.elastic``), a lone
process of a two-process mesh, two processes that split one campaign
through a shared cache directory, and a campaign killed on four devices and
resumed on two (``tests/test_scale.py:355-528``).

Children are ``python -c`` processes on the CPU (``device="cpu"``) with the
small grid of ``tests/test_scale.py:42``; a device count is a list naming
the one CPU device several times.  Everything a child assembles is held bit
for bit against this process's single-launch run.
"""
import hashlib
import json
import os
import signal
import subprocess
import sys
import textwrap
import time
from pathlib import Path

import numpy as np
import pytest
import torch

from repro.launch.mesh import CampaignMesh as JMesh
from repro.runtime import elastic as jelastic
from repro_torch.campaign import CampaignGrid, run_campaign
from repro_torch.campaign.grid import bucket_cells
from repro_torch.core.params import AFMTJ_PARAMS
from repro_torch.launch.mesh import CampaignMesh, build_campaign_mesh
from repro_torch.runtime import elastic

REPO = Path(__file__).resolve().parents[1]
_ENV = {**os.environ, "PYTHONPATH": str(REPO / "src")}
for _k in ("RANK", "WORLD_SIZE"):
    _ENV.pop(_k, None)
CHILD_TIMEOUT = 300

GRID = ("CampaignGrid(voltages=(0.6, 1.2), pulse_widths=(120e-12, 250e-12),"
        " temperatures=(300.0, 350.0, 400.0), n_samples=16, dt=0.1e-12,"
        " seed={seed})")


def _grid(seed: int, pulses=(120e-12, 250e-12)) -> CampaignGrid:
    return CampaignGrid(voltages=(0.6, 1.2), pulse_widths=pulses,
                        temperatures=(300.0, 350.0, 400.0), n_samples=16,
                        dt=0.1e-12, seed=seed)


# the tests in this process take shorter pulses (1,001 steps, a third of
# the children's grid's cost on the CPU)
SHORT = (60e-12, 100e-12)


def _lone(seed: int, pulses=(120e-12, 250e-12)):
    grid = _grid(seed, pulses)
    return run_campaign(AFMTJ_PARAMS, grid, use_cache=False, device="cpu",
                        max_cells_per_launch=bucket_cells(grid.cells))


def _sha(ct: np.ndarray) -> str:
    return hashlib.sha256(np.ascontiguousarray(ct).tobytes()).hexdigest()


# ------------------------------------------------------------------ mesh
def test_campaign_mesh_fields_and_checks_match_reference():
    import dataclasses

    names = [f.name for f in dataclasses.fields(CampaignMesh)]
    assert names == [f.name for f in dataclasses.fields(JMesh)]
    assert CampaignMesh(n_devices=1) == CampaignMesh(1, 0, 1, 60.0, 0.05)
    for bad in (dict(n_devices=0), dict(n_devices=1, process_count=0),
                dict(n_devices=1, process_index=2, process_count=2),
                dict(n_devices=1, process_index=-1),
                dict(n_devices=1, claim_ttl_s=0.0),
                dict(n_devices=1, poll_s=0.0)):
        with pytest.raises(AssertionError):
            CampaignMesh(**bad)
        with pytest.raises(AssertionError):
            JMesh(**bad)


def test_build_campaign_mesh_topology(monkeypatch):
    monkeypatch.delenv("RANK", raising=False)
    monkeypatch.delenv("WORLD_SIZE", raising=False)
    m = build_campaign_mesh()
    assert (m.process_index, m.process_count) == (0, 1)
    assert m.n_devices == max(1, torch.cuda.device_count())
    monkeypatch.setenv("RANK", "3")
    monkeypatch.setenv("WORLD_SIZE", "4")
    m = build_campaign_mesh(["cpu"] * 5, claim_ttl_s=7.0, poll_s=0.5)
    assert (m.process_index, m.process_count, m.n_devices) == (3, 4, 5)
    assert (m.claim_ttl_s, m.poll_s) == (7.0, 0.5)
    m = build_campaign_mesh(["cpu"] * 3, process_index=1, process_count=2,
                            elastic_from=4)
    assert (m.process_index, m.process_count, m.n_devices) == (1, 2, 2)
    # an int is clamped to the visible devices (one without a CUDA device)
    assert build_campaign_mesh(8).n_devices == max(1,
                                                   torch.cuda.device_count())


def test_build_campaign_mesh_reads_torch_distributed(monkeypatch):
    """An initialized process group wins over the environment."""
    import socket

    import torch.distributed as dist

    monkeypatch.setenv("RANK", "5")
    monkeypatch.setenv("WORLD_SIZE", "9")
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                            rank=0, world_size=1)
    try:
        m = build_campaign_mesh(["cpu"])
    finally:
        dist.destroy_process_group()
    assert (m.process_index, m.process_count) == (0, 1)


def _plan_fields(plan):
    return (plan.mesh_shape, plan.axis_names, plan.microbatch_scale,
            plan.note)


@pytest.mark.parametrize("n_available,old", [(8, 8), (12, 8), (3, 8), (0, 4),
                                             (5, 8), (1, 1), (2, 4), (7, 16),
                                             (1, 3)])
def test_plan_campaign_devices_matches_reference(n_available, old):
    assert _plan_fields(elastic.plan_campaign_devices(n_available, old)) \
        == _plan_fields(jelastic.plan_campaign_devices(n_available, old))


def test_plan_campaign_devices_ladder():
    full = elastic.plan_campaign_devices(8, 8)
    assert full.mesh_shape == (8,) and full.microbatch_scale == 1
    assert elastic.plan_campaign_devices(12, 8).mesh_shape == (8,)
    degraded = elastic.plan_campaign_devices(3, 8)
    assert degraded.mesh_shape == (2,) and degraded.microbatch_scale == 4
    floor = elastic.plan_campaign_devices(0, 4)
    assert floor.mesh_shape == (1,) and floor.microbatch_scale == 4


@pytest.mark.parametrize("args", [(256, 16, 16), (255, 16, 16), (16, 16, 16),
                                  (15, 16, 16), (512, 16, 16, 2),
                                  (100, 4, 32)])
def test_plan_elastic_remesh_matches_reference(args):
    got = elastic.plan_elastic_remesh(*args)
    want = jelastic.plan_elastic_remesh(*args)
    assert (got is None) == (want is None)
    if got is not None:
        assert _plan_fields(got) == _plan_fields(want)


# ----------------------------------------------------- multi-process
def test_multiprocess_mesh_requires_cache():
    mesh = CampaignMesh(n_devices=1, process_index=0, process_count=2)
    with pytest.raises(AssertionError, match="store"):
        run_campaign(AFMTJ_PARAMS, _grid(0, SHORT), use_cache=False,
                     mesh=mesh, device="cpu")


def test_multiprocess_mesh_lone_process_completes(tmp_path):
    """A process_count=2 mesh with no peer finishes: pass B claims and
    integrates what the absent peer never started; a late peer adopts the
    whole-campaign entry."""
    grid = _grid(21, SHORT)
    per = bucket_cells(grid.cells)
    fresh = _lone(21, SHORT)
    mesh = CampaignMesh(n_devices=1, process_index=0, process_count=2,
                        claim_ttl_s=5.0, poll_s=0.01)
    res = run_campaign(AFMTJ_PARAMS, grid, cache_dir=str(tmp_path),
                       max_cells_per_launch=per, mesh=mesh, device="cpu")
    assert res.n_computed == res.n_launches == 3
    np.testing.assert_array_equal(res.crossing_time, fresh.crossing_time)
    assert not list(tmp_path.glob("*.claim"))
    assert len(list(tmp_path.glob("*.npz"))) == 1     # slices retired
    late = run_campaign(AFMTJ_PARAMS, grid, cache_dir=str(tmp_path),
                        max_cells_per_launch=per, device="cpu",
                        mesh=CampaignMesh(n_devices=1, process_index=1,
                                          process_count=2))
    assert late.from_cache and late.n_computed == 0
    np.testing.assert_array_equal(late.crossing_time, fresh.crossing_time)


def test_multiprocess_mesh_steals_a_dead_peers_claim(tmp_path):
    """A claim left by a dead peer is stolen once older than the TTL."""
    from repro_torch.campaign import cache
    from repro_torch.campaign.engine import _slice_key

    grid = _grid(22, SHORT)
    per = bucket_cells(grid.cells)
    key = cache.campaign_key(AFMTJ_PARAMS, grid, "cpu-plain")
    dead = _slice_key(key, 1, 2, 64, "pow2")
    assert cache.try_claim(dead, str(tmp_path), owner="proc1")
    old = time.time() - 60.0
    os.utime(cache.claim_path(dead, str(tmp_path)), (old, old))
    mesh = CampaignMesh(n_devices=1, process_index=0, process_count=2,
                        claim_ttl_s=30.0, poll_s=0.01)
    res = run_campaign(AFMTJ_PARAMS, grid, cache_dir=str(tmp_path),
                       max_cells_per_launch=per, mesh=mesh, device="cpu")
    assert res.n_computed == 3
    np.testing.assert_array_equal(res.crossing_time,
                                  _lone(22, SHORT).crossing_time)
    assert not list(tmp_path.glob("*.claim"))


DEDUPE_CHILD = textwrap.dedent("""
    import hashlib, json, os, sys, time
    import numpy as np
    from repro_torch.campaign import CampaignGrid, run_campaign
    from repro_torch.campaign.grid import bucket_cells
    from repro_torch.core.params import AFMTJ_PARAMS
    from repro_torch.launch.mesh import CampaignMesh

    root, pi = sys.argv[1], int(sys.argv[2])
    grid = {grid}
    open(os.path.join(root, f"ready{{pi}}"), "w").close()
    while not os.path.exists(os.path.join(root, "go")):
        time.sleep(0.005)
    mesh = CampaignMesh(n_devices=1, process_index=pi, process_count=2,
                        claim_ttl_s=120.0, poll_s=0.01)
    res = run_campaign(AFMTJ_PARAMS, grid,
                       cache_dir=os.path.join(root, "cache"),
                       max_cells_per_launch=bucket_cells(grid.cells),
                       mesh=mesh, device="cpu")
    json.dump({{"n_computed": res.n_computed, "n_launches": res.n_launches,
               "sha": hashlib.sha256(
                   np.ascontiguousarray(res.crossing_time).tobytes()
               ).hexdigest()}},
              open(os.path.join(root, f"out{{pi}}.json"), "w"))
""")


def test_multiprocess_dedupe_two_processes(tmp_path):
    """Two processes sharing one cache directory split a 3-launch campaign
    without integrating any launch twice, and both assemble the crossing
    tensor bit-identically to a lone run.  A file barrier releases both
    together (after their imports)."""
    child = DEDUPE_CHILD.format(grid=GRID.format(seed=33))
    procs = [subprocess.Popen(
        [sys.executable, "-c", child, str(tmp_path), str(i)],
        env=_ENV, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for i in range(2)]
    try:
        deadline = time.time() + CHILD_TIMEOUT
        while not all((tmp_path / f"ready{i}").exists() for i in range(2)):
            assert time.time() < deadline, "children never became ready"
            for pr in procs:
                assert pr.poll() is None, pr.communicate()[1]
            time.sleep(0.01)
        (tmp_path / "go").touch()
        errs = [pr.communicate(timeout=CHILD_TIMEOUT)[1] for pr in procs]
    finally:
        for pr in procs:
            if pr.poll() is None:
                pr.kill()
                pr.wait()
    assert all(pr.returncode == 0 for pr in procs), errs
    outs = [json.load(open(tmp_path / f"out{i}.json")) for i in range(2)]
    sha = _sha(_lone(33).crossing_time)
    assert all(o["sha"] == sha for o in outs), outs
    assert all(o["n_launches"] == 3 for o in outs)
    assert sum(o["n_computed"] for o in outs) == 3, outs
    assert not list((tmp_path / "cache").glob("*.claim"))


KILLER = textwrap.dedent("""
    import os, signal, sys
    from repro_torch.campaign import CampaignGrid, run_campaign
    from repro_torch.campaign.grid import bucket_cells
    from repro_torch.core.params import AFMTJ_PARAMS

    grid = {grid}

    def die(i, n):
        if i == 0:
            os.kill(os.getpid(), signal.SIGKILL)

    run_campaign(AFMTJ_PARAMS, grid, cache_dir=sys.argv[1],
                 max_cells_per_launch=bucket_cells(grid.cells),
                 devices=["cpu"] * 4, on_slice_complete=die, device="cpu")
""")

RESUMER = textwrap.dedent("""
    import sys
    import numpy as np
    from repro_torch.campaign import CampaignGrid, run_campaign
    from repro_torch.campaign.grid import bucket_cells
    from repro_torch.core.params import AFMTJ_PARAMS
    from repro_torch.launch.mesh import build_campaign_mesh

    devices = ["cpu"] * 3
    mesh = build_campaign_mesh(devices, elastic_from=4)
    assert mesh.n_devices == 2, mesh
    grid = {grid}
    res = run_campaign(AFMTJ_PARAMS, grid, cache_dir=sys.argv[1],
                       max_cells_per_launch=bucket_cells(grid.cells),
                       devices=devices, mesh=mesh, device="cpu")
    assert res.n_resumed == 1 and res.n_computed == 2, res
    np.save(sys.argv[2], res.crossing_time)
""")


def test_elastic_kill_at_4_resume_at_2_devices(tmp_path):
    """A campaign SIGKILLed on four devices resumes on the elastic plan's
    two (of three named) from the same slice checkpoint (keys do not
    depend on the device count) and assembles bit-identically to a
    single-device run."""
    grid = GRID.format(seed=44)
    r = subprocess.run([sys.executable, "-c", KILLER.format(grid=grid),
                        str(tmp_path)], env=_ENV, capture_output=True,
                       text=True, timeout=CHILD_TIMEOUT)
    assert r.returncode == -signal.SIGKILL, r.stderr
    assert len(list(tmp_path.glob("*.npz"))) == 1, "no slice checkpoint"
    out = tmp_path / "resumed.npy"
    r = subprocess.run([sys.executable, "-c", RESUMER.format(grid=grid),
                        str(tmp_path), str(out)], env=_ENV,
                       capture_output=True, text=True, timeout=CHILD_TIMEOUT)
    assert r.returncode == 0, r.stderr
    np.testing.assert_array_equal(np.load(out), _lone(44).crossing_time)
    assert not list(tmp_path.glob("*.claim"))
