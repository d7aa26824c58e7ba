"""The cost tools across a mesh: ``train/step.build_case(mesh=)`` counted
inside ``launch/mesh.counting_world``, against the reference's compiled
per-device bytes and against real gloo ranks' collectives.

The module starts, at once, 4 gloo ranks (``tests/_torch_ranks.py ...
costs``, one thread each) and the reference in three subprocesses, one
an arch, on a 4-device host mesh
(``XLA_FLAGS=--xla_force_host_platform_device_count=4``):

- ``bytes_by_part`` summed (``Case.arg_bytes``) equals the reference's
  compiled ``argument_size_in_bytes`` on the (2, 2) mesh to the byte, for
  reduced stablelm-1.6b, mixtral-8x7b and hymba-1.5b, prefill, train and
  decode at 4 x 128, bf16, fsdp on and off;
- the collectives that ``utils/op_cost`` counts for rank 0 of a fake
  world of 4 on meta equal, call for call and byte for byte by kind,
  those it counts on rank 0 of the 4 gloo ranks running the same reduced
  steps on real blocks (float32);
- ``counting_world`` refuses to start inside a running group (on every
  rank), and a world after it starts clean (rank 0's fake world after
  its gloo one);
- ``launch/dryrun --mesh single`` writes a record with the mesh's fields
  and leaves no group behind; ``launch/perf --mesh-shape 2x2`` writes an
  ``ok`` row for each (fsdp, act) variant, and with fsdp off no param is
  gathered over 'data'.

The ranks alone: ``for r in 0 1 2 3; do PYTHONPATH=src python
tests/_torch_ranks.py $r 4 DIR/store DIR costs & done; wait``.
"""
import json
import os
import pathlib
import pickle
import subprocess
import sys
import time

import pytest
import torch
import torch.distributed as dist

from repro_torch import configs as TC
from repro_torch.configs.shapes import Shape
from repro_torch.launch import dryrun as TDR
from repro_torch.launch import mesh as LM
from repro_torch.launch import perf as TPF
from repro_torch.train import parallel as PAR
from repro_torch.train import shardings as SH
from repro_torch.train import step as TS
from repro_torch.utils import op_cost

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "tests"))
from _torch_ranks import (COST_BATCH, COST_CASES, COST_MESH,  # noqa: E402
                          COST_SEQ, drop_world)

WORLD = 4
TIMEOUT_S = 240
ARCHS = ("stablelm-1.6b", "mixtral-8x7b", "hymba-1.5b")
KINDS = ("prefill", "train", "decode")
BYTE_CASES = [(a, k, f) for a in ARCHS for k in KINDS for f in (False, True)]

REFERENCE = """
import pickle, sys
import jax
from repro import configs as C
from repro.configs.shapes import Shape
from repro.launch.mesh import make_host_mesh
from repro.train import step as TS
mesh = make_host_mesh((2, 2))
m = C.get_reduced(sys.argv[2])
out = {}
for kind in ("prefill", "train", "decode"):
    for fsdp in (False, True):
        case = TS.build_case(m, Shape(kind, int(sys.argv[4]),
                                      int(sys.argv[3]), kind), mesh,
                             fsdp=fsdp)
        with mesh:
            c = jax.jit(case.fn, in_shardings=case.in_shardings,
                        donate_argnums=case.donate_argnums
                        ).lower(*case.args).compile()
        out[kind, fsdp] = c.memory_analysis().argument_size_in_bytes
with open(sys.argv[1], "wb") as f:
    pickle.dump(out, f)
"""


def _env(**extra):
    env = dict(os.environ)
    src = str(ROOT / "src")
    env["PYTHONPATH"] = src + os.pathsep + env.get("PYTHONPATH", "")
    env.update(extra)
    return env


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """({rank: what it saw}, {(arch, kind, fsdp): the reference's compiled
    argument bytes})."""
    tmp = tmp_path_factory.mktemp("cost_ranks")
    refs = [subprocess.Popen(
        [sys.executable, "-c", REFERENCE, str(tmp / f"{a}.pkl"), a,
         str(COST_BATCH), str(COST_SEQ)],
        env=_env(JAX_PLATFORMS="cpu",
                 XLA_FLAGS="--xla_force_host_platform_device_count=4"),
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT) for a in ARCHS]
    ranks = [subprocess.Popen(
        [sys.executable, str(ROOT / "tests" / "_torch_ranks.py"), str(r),
         str(WORLD), str(tmp / "store"), str(tmp), "costs"],
        env=_env(OMP_NUM_THREADS="1"), stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT) for r in range(WORLD)]
    deadline = time.time() + TIMEOUT_S
    logs = []
    try:
        for p in ranks + refs:
            out, _ = p.communicate(timeout=max(deadline - time.time(), 1))
            logs.append(out.decode(errors="replace")[-4000:])
    finally:
        for p in ranks + refs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for p, log in zip(ranks + refs, logs):
        assert p.returncode == 0, log
    seen = {}
    for r in range(WORLD):
        with open(tmp / f"rank{r}.pkl", "rb") as f:
            seen[r] = pickle.load(f)
        assert "error" not in seen[r], seen[r]["error"]
    reference = {}
    for a in ARCHS:
        with open(tmp / f"{a}.pkl", "rb") as f:
            reference.update({(a, *k): v for k, v in pickle.load(f).items()})
    return seen, reference


@pytest.fixture
def no_world():
    drop_world()


@pytest.fixture
def mesh22(no_world):
    with LM.counting_world(WORLD):
        yield LM.make_mesh(COST_MESH, ("data", "model"), device="cpu")


@pytest.mark.parametrize("arch,kind,fsdp", BYTE_CASES)
def test_bytes_by_part_are_the_references_argument_bytes(world, mesh22, arch,
                                                         kind, fsdp):
    case = TS.build_case(TC.get_reduced(arch),
                         Shape(kind, COST_SEQ, COST_BATCH, kind), mesh22,
                         fsdp=fsdp)
    assert case.mesh == {"data": 2, "model": 2} and case.rank == 0
    assert case.arg_bytes == world[1][arch, kind, fsdp], case.bytes_by_part
    assert (TS.SAVED in case.bytes_by_part) == (kind == "train")


@pytest.mark.parametrize("arch,kind,fsdp", COST_CASES)
def test_fake_world_counts_the_gloo_ranks_collectives(world, arch, kind,
                                                      fsdp):
    seen = world[0][0]
    got, want = seen["fake"][arch, kind, fsdp], seen["gloo"][arch, kind, fsdp]
    assert want["n_coll"] > 0 and want["coll_bytes"] > 0
    assert got == want


def test_counting_world_refuses_a_running_group(world):
    for r in range(WORLD):
        assert "already running" in world[0][r]["refused"]


def test_dryrun_single_mesh_record(tmp_path, no_world):
    out = tmp_path / "d.jsonl"
    assert TDR.main(["--arch", "stablelm-1.6b", "--shape", "prefill_32k",
                     "--mesh", "single", "--out", str(out)]) == 0
    assert not dist.is_initialized()
    rec = json.loads(out.read_text())
    assert rec["status"] == "ok" and rec["mesh"] == "single_pod_16x16"
    assert rec["chips"] == 256 and rec["rank"] == 0
    for key in ("flops", "hbm_bytes", "coll_bytes", "collectives",
                "model_flops", "bytes_per_device", "arg_bytes",
                "bytes_by_part", "fits", "t_trace_s", "t_collective_s",
                "bottleneck", "mfu_bound", "useful_ratio"):
        assert key in rec, key
    assert rec["n_coll"] > 0 and rec["coll_bytes"] > 0
    assert rec["coll_bytes"] == sum(
        v for k, v in rec["collectives"].items() if k != "coll_bytes")
    assert set(rec["bytes_by_part"]) == {"params", "batch"}


def test_perf_sweeps_fsdp_and_act_on_a_mesh(tmp_path, no_world):
    out = tmp_path / "p.jsonl"
    assert TPF.main(["--arch", "stablelm-1.6b", "--reduced", "--batch", "4",
                     "--seq", "32", "--mesh-shape", "2x2", "--fsdp", "0,1",
                     "--act", "model,seq,none", "--out", str(out)]) == 0
    assert not dist.is_initialized()
    rows = [json.loads(line) for line in out.read_text().splitlines()]
    assert [(r["fsdp"], r["act"]) for r in rows] == [
        (f, a) for f in (0, 1) for a in ("model", "seq", "none")]
    assert all(r["status"] == "ok" and r["mesh"] == "2x2" for r in rows)
    # fsdp gathers the params' 'data' blocks: more calls, a smaller share
    assert rows[3]["n_coll"] > rows[0]["n_coll"]
    assert rows[3]["bytes_by_part"]["params"] < \
        rows[0]["bytes_by_part"]["params"]


@pytest.mark.parametrize("kind", KINDS)
def test_fsdp_off_gathers_no_param(mesh22, monkeypatch, kind):
    """With fsdp off no leaf's spec holds 'data' and ``unshard_data``
    issues no gather; with it on, it does."""
    gathers = [0]
    inner = PAR._all_gather

    def counted(t, group):
        gathers[0] += 1
        return inner(t, group)

    unshard = PAR.unshard_data
    in_unshard = []

    def spy(tree, specs):
        before = gathers[0]
        out = unshard(tree, specs)
        in_unshard.append(gathers[0] - before)
        return out

    monkeypatch.setattr(PAR, "_all_gather", counted)
    monkeypatch.setattr(PAR, "unshard_data", spy)
    m = TC.get_reduced("stablelm-1.6b")
    for fsdp in (False, True):
        in_unshard.clear()
        case = TS.build_case(m, Shape(kind, 32, 4, kind), mesh22,
                             dtype=torch.float32, fsdp=fsdp)
        specs = SH.spec_leaves(PAR.param_layout(m, mesh22, fsdp))
        assert any("data" in (SH.norm_axes(e) or ()) for sp in specs
                   for e in sp) == fsdp
        op_cost.analyze(case.fn, *case.args)
        assert in_unshard and (sum(in_unshard) > 0) == fsdp
