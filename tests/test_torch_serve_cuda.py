"""The serving tier's rules that only the card can show (``cuda`` marker:
skipped without an sm_90 card; on the card,
``PYTHONPATH=src python3 -m pytest -q -m cuda tests/test_torch_serve_cuda.py``;
no JAX is imported here).

- Two threads' first launches of ``mlp_forward_f32`` (the serving and the
  training thread may both be first) build its library once, and both
  get the plain version's result within 1e-4·max(1, max|y|).
- A G forward run by the front end's dispatch thread builds no autograd
  graph, even with params that require grad, and launches the kernel.
- A `CheckpointManager` round trip of card tensors returns them on the
  card with the same bits.
"""
import subprocess
import threading

import numpy as np
import pytest
import torch

from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.core import gan as G
from repro_torch.core import prng
from repro_torch.core.dse_api import GANDSE
from repro_torch.core.explorer import ExplorerConfig
from repro_torch.dataset.generator import generate_dataset, generate_tasks
from repro_torch.design_models import DnnWeaverModel
from repro_torch.kernels import build
from repro_torch.kernels import fused_mlp as fm
from repro_torch.kernels import ref
from repro_torch.serve import DSEServer, ServeConfig, ServeFrontend

TOL = 1e-4
WAIT = 300


@pytest.fixture
def h100():
    """Skip unless an sm_90 card is present (decided here, at run time)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    if torch.cuda.get_device_capability(0) != (9, 0):
        pytest.skip("the kernels are built for sm_90a (H100)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _gandse(dev, layers=2, neurons=64):
    model = DnnWeaverModel()
    cfg = G.GANConfig(n_net=model.net_space.n_dims).scaled(layers, neurons)
    e = GANDSE(model, cfg, ExplorerConfig(prob_threshold=0.1,
                                          max_candidates=128), device=dev)
    e.attach(generate_dataset(model, 256, seed=0),
             G.init_generator(prng.prng_key(torch.tensor(3)), cfg,
                              model.space, dev))
    return e


@pytest.mark.cuda
def test_cuda_two_first_launches_build_once(h100, tmp_path, monkeypatch):
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(build, "_LIBS", {})
    monkeypatch.setattr(build, "build_info", {})
    real, runs = subprocess.run, []

    def counting_run(cmd, **kw):
        runs.append(cmd)
        return real(cmd, **kw)

    monkeypatch.setattr(build.subprocess, "run", counting_run)
    rng = np.random.default_rng(0)
    dims = [18, 64, 64, 73]
    ws = [torch.tensor(rng.normal(size=(a, b)).astype(np.float32) * 0.2,
                       device=h100) for a, b in zip(dims[:-1], dims[1:])]
    bs = [torch.tensor(rng.normal(size=(b,)).astype(np.float32) * 0.1,
                       device=h100) for b in dims[1:]]
    x = torch.tensor(rng.normal(size=(64, 18)).astype(np.float32),
                     device=h100)
    barrier, out, errors = threading.Barrier(2), [], []

    def first_launch():
        try:
            barrier.wait(timeout=WAIT)
            y = fm.fused_mlp(x, ws, bs)
            torch.cuda.synchronize()
            out.append(y)
        except BaseException as e:    # pragma: no cover - surfaced below
            errors.append(e)

    threads = [threading.Thread(target=first_launch) for _ in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(WAIT)
    assert not any(t.is_alive() for t in threads) and not errors, errors
    assert len(runs) == 1 and list(build.build_info) == ["mlp_forward.cu"]
    want = ref.fused_mlp(x, ws, bs)
    tol = TOL * max(1.0, float(want.abs().max()))
    for y in out:
        assert float((y - want).abs().max()) <= tol
    assert torch.equal(out[0], out[1])


@pytest.mark.cuda
def test_cuda_served_forward_builds_no_graph(h100):
    e = _gandse(h100)
    params = {"layers": [{k: v.clone().requires_grad_() for k, v in p.items()}
                         for p in e.g_params["layers"]]}
    e.attach(e.ds, params)
    seen = []
    inner = e._explorer.generator_probs_device

    def spy(*a, **kw):
        out = inner(*a, **kw)
        seen.append((threading.current_thread().name,
                     torch.is_grad_enabled(), out.grad_fn is not None,
                     out.device.type))
        return out

    e._explorer.generator_probs_device = spy
    tasks = generate_tasks(e.model, 8, seed=2)
    direct = e.explore_tasks(tasks, seed=7)
    assert seen[0][1:] == (True, True, "cuda")      # the check is not vacuous
    srv = DSEServer(ServeConfig(max_batch=8))
    srv.register(e)
    before = fm.fused_mlp.launches
    with ServeFrontend(srv) as fe:
        futs = [fe.submit(e.model.name, tasks.net_idx[i], tasks.lat_obj[i],
                          tasks.pow_obj[i], seed=7 + i) for i in range(8)]
        resps = [f.result(timeout=WAIT) for f in futs]
    assert fm.fused_mlp.launches > before
    assert seen[1:] and all(s == ("dse-dispatcher", False, False, "cuda")
                            for s in seen[1:])
    for r, d in zip(resps, direct):
        assert r.ok and r.result.selection.n_candidates == \
            d.selection.n_candidates
        assert (r.result.selection.latency, r.result.selection.power) == \
            (d.selection.latency, d.selection.power)
    assert srv.summary()["kernels"]["fused"] == {e.model.name: True}


@pytest.mark.cuda
def test_cuda_checkpoint_round_trip_on_the_card(h100, tmp_path):
    e = _gandse(h100)
    params = e.g_params
    ck = CheckpointManager(str(tmp_path))
    ck.save(1, params)
    got = ck.restore(1, params)
    for p, q in zip(got["layers"], params["layers"]):
        for k in ("w", "b"):
            assert p[k].device.type == "cuda" and p[k].dtype == q[k].dtype
            assert p[k].data_ptr() != q[k].data_ptr()
            assert torch.equal(p[k].view(torch.int32), q[k].view(torch.int32))
