"""The port's cost tools against the reference's: ``utils/op_cost`` (the
counterpart of ``utils/hlo_cost`` and ``utils/hlo``), the kernels' meta
routes and their charges, ``utils/roofline``, and shapes without draws.

Flops: the port counts the plain route's aten products on the CPU, the
reference the dots of its jitted step's HLO.  At the reduced configs,
2 x 64, the prefills of stablelm-1.6b, gemma3-1b, mixtral-8x7b and
qwen2-vl-7b count the same flops exactly.  Where the counts differ, the
test names the ops and holds the difference to their formulas:

* hymba-1.5b (0.98871x): the SSM's dt projection, (B·S, 1) x (1, Di),
  is a product of K = 1 in the port and a broadcast multiply in XLA;
  the scan's y = h·c over N is a dot in the reference's ``lax.scan``
  body and a product and a sum in the port's loop;
* xlstm-1.3b (1.01527x): the mLSTM's chunk-state updates after the last
  chunk (C's kᵀv, n's sum of k) are dead in a prefill, which returns
  logits alone, so XLA removes them; eager torch runs them;
* stablelm-1.6b's train step without remat (1.02083x): the port's
  attention backward (``nn/attention.flash_backward``) recomputes
  S = QKᵀ from lse, where jax's autodiff keeps P: one QKᵀ more a layer.

The kernels' meta routes launch nothing and charge their own work,
``PERF.md`` §6's figures included.  In a fake world of 4
(``launch/mesh.counting_world``) c10d's all-reduce, all-gather and
reduce-scatter count their calls and result bytes by kind, on meta and
CPU tensors alike, and a sharded decode step's first count is its
second.
"""
import functools
import pathlib
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

from repro import configs as JC
from repro.models import base as JMB
from repro.train import step as JTS
from repro.utils import hlo_cost
from repro.utils import roofline as JRL
from repro_torch import configs as TC
from repro_torch.configs.shapes import Shape
from repro_torch.core import prng
from repro_torch.kernels import build
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import fused_dense as fd
from repro_torch.kernels import fused_mlp as fm
from repro_torch.kernels import slstm_scan as sl
from repro_torch.kernels import ssm_scan as ss
from repro_torch.launch import dryrun as TDR
from repro_torch.launch import mesh as LM
from repro_torch.launch import perf as TPF
from repro_torch.models import base as TMB
from repro_torch.train import step as TTS
from repro_torch.utils import op_cost
from repro_torch.utils import roofline as TRL

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent))
from _torch_ranks import drop_world  # noqa: E402

B, S = 2, 64
META = torch.device("meta")


# ---------------------------------------------------------------------------
# flops against hlo_cost.analyze
# ---------------------------------------------------------------------------
@functools.lru_cache(maxsize=None)
def _reference_flops(arch: str, kind: str) -> float:
    """hlo_cost's flops of the reference's jitted step at the reduced
    config, 2 x 64 (train: remat off)."""
    m = JC.get_reduced(arch)
    p = jax.eval_shape(lambda r: JMB.init_params(r, m),
                       jax.ShapeDtypeStruct((2,), jnp.uint32))
    tok = jax.ShapeDtypeStruct((B, S), jnp.int32)
    batch = {"tokens": tok}
    if m.family == "vlm":
        batch["positions"] = jax.ShapeDtypeStruct((3, B, S), jnp.int32)
    if kind == "prefill":
        c = jax.jit(JTS.make_prefill_step(m)).lower(p, batch).compile()
    else:
        step, opt = JTS.make_train_step(m, remat=False)
        c = jax.jit(step).lower(p, jax.eval_shape(opt.init, p),
                                dict(batch, labels=tok)).compile()
    return hlo_cost.analyze(c.as_text())["flops"]


def _port_count(arch: str, kind: str) -> op_cost.OpCounter:
    """op_cost's count of the port's step on the CPU (the plain route)."""
    m = TC.get_reduced(arch)
    p = TMB.init_params(prng.prng_key(torch.tensor(0)), m, "cpu")
    tok = torch.zeros((B, S), dtype=torch.int32)
    batch = {"tokens": tok}
    if m.family == "vlm":
        batch["positions"] = torch.zeros((3, B, S), dtype=torch.int32)
    if kind == "prefill":
        return op_cost.count(TTS.make_prefill_step(m), p, batch)[1]
    step, opt = TTS.make_train_step(m, remat=False)
    return op_cost.count(step, p, opt.init(p), dict(batch, labels=tok))[1]


@pytest.mark.parametrize("arch", ["stablelm-1.6b", "gemma3-1b",
                                  "mixtral-8x7b", "qwen2-vl-7b"])
def test_prefill_flops_equal_the_reference(arch):
    got = _port_count(arch, "prefill").totals()
    assert got["flops"] == _reference_flops(arch, "prefill")
    assert set(got["flops_by_unit"]) == {"fp32_simt"}   # the CPU route


def _layers(m, pred):
    return [spec.cfg for seg in m.segments for spec in seg.pattern
            for _ in range(seg.repeats) if pred(spec)]


def test_hymba_prefill_differs_by_the_dt_projection_and_the_scan_dot():
    m = TC.get_reduced("hymba-1.5b")
    want = _reference_flops("hymba-1.5b", "prefill")
    got = _port_count("hymba-1.5b", "prefill").totals()["flops"]
    dt_mm = scan_dot = 0
    for cfg in _layers(m, lambda s: s.cfg.ssm_state):
        di = 2 * cfg.d_model                        # the SSM's inner width
        dt_mm += 2 * B * S * 1 * di                 # (B·S, 1) x (1, Di)
        scan_dot += 2 * B * S * di * cfg.ssm_state  # y = Σ_n h·c, a step
    assert got == want + dt_mm - scan_dot
    assert round(got / want, 5) == 0.98871


def test_xlstm_prefill_differs_by_the_dead_chunk_state_update():
    m = TC.get_reduced("xlstm-1.3b")
    want = _reference_flops("xlstm-1.3b", "prefill")
    got = _port_count("xlstm-1.3b", "prefill").totals()["flops"]
    dead = 0
    for cfg in _layers(m, lambda s: s.kind == "mlstm"):
        dh = cfg.d_model // cfg.n_heads
        # one chunk of 64 at S = 64: C += kᵀv and n += Σ k, both dead
        dead += 2 * B * cfg.n_heads * S * dh * dh + 2 * B * cfg.n_heads * S * dh
    assert got == want + dead
    assert round(got / want, 5) == 1.01527


def test_stablelm_train_step_differs_by_the_backward_qk_recompute():
    m = TC.get_reduced("stablelm-1.6b")
    want = _reference_flops("stablelm-1.6b", "train")
    c = _port_count("stablelm-1.6b", "train")
    got = c.totals()["flops"]
    qk = sum(2 * B * cfg.n_heads * S * S * cfg.dh
             for cfg in _layers(m, lambda s: True))
    assert got == want + qk
    assert round(got / want, 5) == 1.02083


def test_scanned_program_counts_every_trip():
    """The reference's program of ``tests/test_hlo_cost.py``: TRIPS steps
    of relu(w @ c) give 2·K·K·N·TRIPS flops, as its loop-aware count."""
    k, n, trips = 256, 64, 8

    def f(w, x):
        for _ in range(trips):
            x = torch.relu(w @ x)
        return x.sum()

    w = torch.empty((k, k), device=META)
    x = torch.empty((k, n), device=META)
    got = op_cost.analyze(f, w, x)
    assert got["flops"] == 2 * k * k * n * trips
    assert got["flops_by_unit"] == {"fp32_simt": 2 * k * k * n * trips}
    # w and x are the arguments; at a later trip the last x, w @ x and
    # its relu are live besides
    assert got["arg_bytes"] == 4 * (k * k + k * n)
    assert got["peak_bytes"] == got["arg_bytes"] + 3 * 4 * k * n


def test_bytes_count_reads_and_writes_once():
    """An in-place op reads and writes its target once each, ``copy_``
    only writes it, views and allocations move nothing, an expanded
    operand counts its elements once."""
    a, b = torch.zeros(4, 8), torch.ones(4, 8)
    bias = torch.ones(8)

    def f(a, b, bias):
        a.add_(b)                         # 32 + 32 read, 32 written
        a[:, 0] = b[:, 0]                 # select views, copy_: 4 + 4
        c = torch.empty(4, 8)             # nothing
        c.copy_(bias.expand(4, 8))        # 8 read, 32 written
        return a.t().contiguous()         # 32 + 32

    got = op_cost.analyze(f, a, b, bias)
    assert got["hbm_bytes"] == 4 * (96 + 8 + 40 + 64)
    assert got["flops"] == 0.0 and got["coll_bytes"] == 0.0


@pytest.fixture
def world4():
    """Rank 0 of a fake world of 4 (``launch/mesh.counting_world``), any
    world an earlier test in this process left dropped first."""
    drop_world()
    with LM.counting_world(4):
        yield


@pytest.mark.parametrize("device", ["meta", "cpu"])
def test_collectives_count_their_results_by_kind(world4, device):
    """c10d's all-reduce (its tensors, in place), all-gather (the gathered
    outputs, a ``Tensor[][]``) and reduce-scatter (its output): one call
    each under the reference's kind, its result bytes there, and its
    inputs and results in ``hbm_bytes``, as ``hlo_cost`` counts a
    collective's operands and result."""
    t = torch.ones(32, device=device)

    def f(t):
        dist.all_reduce(t)                                  # 128 + 128
        parts = [torch.empty_like(t) for _ in range(4)]
        dist.all_gather(parts, t)                           # 128 + 512
        out = torch.empty(8, device=device)
        dist.reduce_scatter(out, list(t.split(8)))          # 128 + 32
        return parts, out

    got = op_cost.analyze(f, t)
    assert got["n_coll"] == 3.0
    assert (got["coll_all-reduce"], got["coll_all-gather"],
            got["coll_reduce-scatter"]) == (128.0, 512.0, 32.0)
    assert got["coll_bytes"] == 672.0
    assert got["coll_all-to-all"] == got["coll_collective-permute"] == 0.0
    # t.split's views move nothing; the collectives alone add bytes
    assert got["hbm_bytes"] == 256 + 640 + 160


def test_a_sharded_decode_steps_first_count_is_its_second(world4):
    """The decode step's state specs are set-up, out of the counter's
    sight: its first call for a batch size counts what its second does."""
    from repro_torch.train import shardings as SH

    mesh = LM.make_mesh((2, 2), ("data", "model"), device="cpu")
    for arch in ("stablelm-1.6b", "hymba-1.5b"):
        m = TC.get_reduced(arch)
        params = TTS.param_structs(m, torch.float32)
        states = SH.shard_states(TTS.state_structs(params, m, 4, 128,
                                                   torch.float32), mesh, 4)
        step = TTS.make_decode_step(m, mesh=mesh, cache_len=128)
        args = (SH.shard_params(params, mesh),
                torch.empty((4, 1), dtype=torch.int32, device=META), 127,
                states)
        first, second = (op_cost.analyze(step, *args) for _ in range(2))
        for key in ("peak_bytes", "hbm_bytes", "n_coll", "coll_bytes"):
            assert first[key] == second[key], (arch, key)
        assert first["n_coll"] > 0


def test_peak_counts_what_autograd_keeps_and_frees_the_rest():
    x = torch.empty((64, 64), device=META, requires_grad=True)

    def f(x):
        h = x
        for _ in range(4):
            h = torch.tanh(h)             # each output kept for the backward
        return torch.autograd.grad(h.sum(), x)[0]

    got = op_cost.analyze(f, x)
    one = 4 * 64 * 64
    assert got["arg_bytes"] == one
    assert 5 * one <= got["peak_bytes"] <= 7 * one + 8


def test_top_ops_rank_by_bytes():
    x, y = (torch.empty((128, 128), device=META) for _ in range(2))
    _, c = op_cost.count(lambda x, y: (x @ y).sum() + x.sum(), x, y)
    rows = c.top_ops(2)
    assert rows[0] == {"op": "mm", "shape": (128, 128), "calls": 1,
                       "bytes": 3 * 4 * 128 ** 2, "flops": 2 * 128 ** 3}
    assert rows[1]["op"] == "sum" and rows[1]["calls"] == 2


# ---------------------------------------------------------------------------
# the kernels' meta routes
# ---------------------------------------------------------------------------
def _launches():
    return (fa.flash_attention.launches, fa.flash_attention.lse_launches,
            fd.dense_forward.launches, fd.dense_dx.launches,
            fd.dense_dw_db.launches, fm.fused_mlp.launches,
            ss.ssm_scan.launches, ss.ssm_scan_bwd.launches,
            sl.slstm_scan.launches, sl.slstm_scan_bwd.launches)


def _meta(*tensors):
    return [t.to(META) for t in tensors]


def _same_layout(got, want):
    for g, w in zip(got, want):
        if w is None:
            assert g is None
            continue
        assert g.is_meta and g.shape == w.shape and g.dtype == w.dtype
        assert g.stride() == w.stride()


def _charged(fn, *args, **kwargs):
    out, c = op_cost.count(fn, *args, **kwargs)
    return out, c.totals()


@pytest.fixture
def no_launch():
    before = _launches()
    yield
    assert _launches() == before


@pytest.mark.parametrize("lse", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("causal,window,q_offset",
                         [(True, None, 0), (True, 24, 0), (True, None, 16),
                          (False, None, 0)])
def test_flash_meta_route(causal, window, q_offset, dtype, lse, no_launch):
    g = torch.Generator().manual_seed(0)
    b, h, hkv, sq, sk, d = 2, 4, 2, 48, 64, 32
    q = torch.randn(b, sq, h, d, generator=g).to(dtype).transpose(1, 2)
    k = torch.randn(b, hkv, sk, d, generator=g).to(dtype)
    v = torch.randn(b, hkv, sk, d, generator=g).to(dtype)
    kw = dict(causal=causal, window=window, q_offset=q_offset,
              return_lse=lse)
    want = fa.flash_attention(q.float(), k.float(), v.float(), **kw)
    got, t = _charged(fa.flash_attention, *_meta(q, k, v), **kw)
    want = want if lse else (want,)
    got = got if lse else (got,)
    assert got[0].stride() == q.stride()          # q's own layout
    _same_layout(got[1:], want[1:])
    assert got[0].shape == want[0].shape and got[0].dtype == dtype
    flops, n_bytes, unit = fa.work(b, h, hkv, sq, sk, d, causal, window,
                                   q_offset, dtype, lse)
    pairs = b * h * fa.kept_pairs(sq, sk, causal, window, q_offset)
    assert flops == (4 if dtype == torch.float32 else 6) * d * pairs
    assert t["flops_by_unit"] == {unit: flops}
    assert unit == ("tf32x3" if dtype == torch.float32 else "bf16")
    assert t["hbm_bytes"] == n_bytes


def test_flash_kept_pairs_at_gemma3s_layers():
    """gemma3-1b's global (causal) and local (window 1024) layers at 4096:
    the pairs behind PERF.md §6's bounds (0.4166 ms at 3·4·D a pair)."""
    assert fa.kept_pairs(4096, 4096, True, None, 0) == 4096 * 4097 // 2
    assert fa.kept_pairs(4096, 4096, True, 1024, 0) == (
        1024 * 1025 // 2 + (4096 - 1024) * 1024)
    flops = fa.work(2, 4, 1, 4096, 4096, 256, True, None, 0,
                    torch.float32)[0]
    assert round(3 * flops / 495e12 * 1e3, 4) == 0.4166


@pytest.mark.parametrize("relu", [True, False])
def test_dense_meta_routes(relu, no_launch):
    g = torch.Generator().manual_seed(1)
    m, k, n = 24, 40, 16
    x, w, b = (torch.randn(m, k, generator=g), torch.randn(k, n, generator=g),
               torch.randn(n, generator=g))
    y = fd.dense_forward(x, w, b, relu)
    dy = torch.randn(m, n, generator=g)
    for name, fn, args, want in (
            ("dense_forward_f32", fd.dense_forward, (x, w, b, relu), (y,)),
            ("dense_dx_f32", fd.dense_dx, (dy, y, w, relu),
             (fd.dense_dx(dy, y, w, relu),)),
            ("dense_dw_db_f32", fd.dense_dw_db, (x, dy, y, relu),
             fd.dense_dw_db(x, dy, y, relu))):
        got, t = _charged(fn, *_meta(*args[:3]), relu)
        _same_layout(got if isinstance(got, tuple) else (got,), want)
        flops, n_bytes, unit = fd.work(name, m, k, n, relu)
        assert flops == 2 * m * k * n and unit == "tf32x3"
        assert t["flops_by_unit"] == {unit: flops}
        assert t["hbm_bytes"] == n_bytes


def test_whole_mlp_meta_route_and_its_gradient(no_launch):
    g = torch.Generator().manual_seed(2)
    dims = [12, 32, 32, 5]
    ws = [torch.randn(a, c, generator=g) for a, c in zip(dims, dims[1:])]
    bs = [torch.randn(c, generator=g) for c in dims[1:]]
    x = torch.randn(7, dims[0], generator=g)
    want = fm.fused_mlp(x, ws, bs)
    got, t = _charged(fm.fused_mlp, *_meta(x), _meta(*ws), _meta(*bs))
    _same_layout((got,), (want,))
    flops, n_bytes, unit = fm.work(7, dims)
    assert flops == sum(2 * 7 * a * c for a, c in zip(dims, dims[1:]))
    assert t["flops_by_unit"] == {"tf32x3": flops}
    assert t["hbm_bytes"] == n_bytes
    # the gradient re-runs the chain forward on the dense kernels, then
    # dx (not into x, which needs none) and dW/db: their charges
    wm = [w.detach().requires_grad_() for w in _meta(*ws)]
    _, t = _charged(lambda: torch.autograd.grad(
        fm.fused_mlp(_meta(x)[0], wm, _meta(*bs)).sum(), wm))
    first = 2 * 7 * dims[0] * dims[1]
    assert t["flops_by_unit"]["tf32x3"] == 4 * flops - first


def test_ssm_scan_meta_routes(no_launch):
    g = torch.Generator().manual_seed(3)
    b, s, di, n = 2, 70, 8, 4
    dt = torch.rand(b, s, di, generator=g)
    bm, cm = torch.randn(b, s, n, generator=g), torch.randn(b, s, n, generator=g)
    x = torch.randn(b, s, di, generator=g)
    a = -torch.rand(di, n, generator=g)
    h0 = torch.randn(b, di, n, generator=g)
    want = ss.ssm_scan_fwd(dt, bm, cm, x, a, h0)
    got, t = _charged(ss.ssm_scan_fwd, *_meta(dt, bm, cm, x, a, h0))
    _same_layout(got, want)
    assert t["flops_by_unit"] == {"fp32_simt": 8 * b * s * di * n}
    assert t["hbm_bytes"] == ss.work(b, s, di, n, True)[1]
    dys = torch.randn(b, s, di, generator=g)
    want = ss.ssm_scan_bwd(dt, bm, cm, x, a, want[2], dys)
    got, t = _charged(ss.ssm_scan_bwd, *_meta(dt, bm, cm, x, a), got[2],
                      *_meta(dys))
    _same_layout(got, want)
    assert t["flops_by_unit"] == {"fp32_simt": 26 * b * s * di * n}
    assert t["hbm_bytes"] == ss.bwd_work(b, s, di, n)[1]


def test_ssm_scan_charge_at_hymbas_prefill(no_launch):
    """PERF.md §6: 3.36 G operations and 316.6 MB at 2 x 4096 x 3200 x 16."""
    b, s, di, n = 2, 4096, 3200, 16
    args = [torch.empty(sh, device=META) for sh in (
        (b, s, di), (b, s, n), (b, s, n), (b, s, di), (di, n), (b, di, n))]
    _, t = _charged(ss.ssm_scan, *args)
    assert round(t["flops"] / 1e9, 2) == 3.36
    assert round(t["hbm_bytes"] / 1e6, 1) == 316.6


def test_slstm_scan_meta_routes(no_launch):
    g = torch.Generator().manual_seed(4)
    b, s, d, h = 2, 70, 32, 2
    dh = d // h
    wx = torch.randn(b, s, 4 * d, generator=g) * 0.3
    rh = torch.randn(h, dh, 4 * dh, generator=g) * 0.1
    bias = torch.randn(4 * d, generator=g) * 0.1
    state = (torch.zeros(b, d), torch.ones(b, d) * 1e-6,
             torch.full((b, d), -1e30), torch.zeros(b, d))
    want = sl.slstm_scan_fwd(wx, rh, bias, state)
    got, t = _charged(sl.slstm_scan_fwd, *_meta(wx, rh, bias), _meta(*state))
    _same_layout((got[0], *got[1], *got[2]), (want[0], *want[1], *want[2]))
    assert t["flops_by_unit"] == {"fp32_simt": b * s * d * (8 * dh + 36)}
    assert t["hbm_bytes"] == sl.work(b, s, d, h, True)[1]
    dys = torch.randn(b, s, d, generator=g)
    want = sl.slstm_scan_bwd(wx, rh, bias, state, want[0], want[2], dys)
    got, t = _charged(sl.slstm_scan_bwd, *_meta(wx, rh, bias), _meta(*state),
                      got[0], got[2], *_meta(dys))
    _same_layout(got, want)
    kernel = b * s * d * (16 * dh + 80)
    # d_rh and d_bias are plain products after the kernel, counted as such
    assert t["flops_by_unit"] == {"fp32_simt": kernel + 2 * b * s * d * 4 * dh}


def test_slstm_takes_rows_in_groups_of_max_batch(no_launch):
    """More than ``MAX_BATCH`` rows: a launch (here a charge) a group of
    up to 8, the outputs joined along the batch."""
    b, s, d, h = 19, 70, 32, 2
    dh = d // h
    wx, rh, bias = (torch.empty(sh, device=META) for sh in (
        (b, s, 4 * d), (h, dh, 4 * dh), (4 * d,)))
    state = tuple(torch.empty((b, d), device=META) for _ in range(4))
    (hs, fin, chunks), c = op_cost.count(sl.slstm_scan_fwd, wx, rh, bias,
                                         state)
    assert hs.shape == (b, s, d) and all(t.shape == (b, d) for t in fin)
    assert all(t.shape == (b, sl.n_chunks(s), d) for t in chunks)
    rows = {r["op"]: r for r in c.top_ops(50)}
    assert rows["slstm_scan_f32"]["calls"] == 3
    assert rows["slstm_scan_f32"]["flops"] == sum(
        sl.work(n, s, d, h)[0] for n in (8, 8, 3))
    grads, c = op_cost.count(sl.slstm_scan_bwd, wx, rh, bias, state, hs,
                             chunks, torch.empty((b, s, d), device=META))
    assert [g.shape for g in grads] == [wx.shape, rh.shape, bias.shape,
                                        *(t.shape for t in state)]
    assert {r["op"]: r for r in c.top_ops(50)}[
        "slstm_scan_bwd_f32"]["calls"] == 3


def test_slstm_charge_at_xlstms_prefill(no_launch):
    """PERF.md §6: 69.3 G operations at 2 x 4096 x 2048, H 4."""
    assert round(sl.work(2, 4096, 2048, 4)[0] / 1e9, 1) == 69.3


def test_the_device_rule():
    assert [build.route(torch.device(d)) for d in ("cpu", "cuda", "meta")] \
        == ["plain", "kernel", "meta"]
    for other in ("xpu", "mps"):
        with pytest.raises(ValueError, match="CPU, CUDA or meta"):
            build.route(torch.device(other))


def test_meta_reaches_no_card_check(monkeypatch, no_launch):
    """A meta tensor reaches neither ``check_card`` nor a library build."""
    def boom(*a, **k):
        raise AssertionError("meta reached the card's path")

    monkeypatch.setattr(build, "check_card", boom)
    monkeypatch.setattr(build, "load", boom)
    m = TC.get_reduced("hymba-1.5b")
    case = TTS.build_case(m, Shape("t", 64, 2, "train"), remat=False,
                          dtype=torch.float32)
    t = op_cost.analyze(case.fn, *case.args)
    assert t["flops_by_unit"]["tf32x3"] > 0       # flash, forward only


# ---------------------------------------------------------------------------
# shapes without draws
# ---------------------------------------------------------------------------
def test_param_structs_make_no_draw(monkeypatch):
    def no_draw(*a, **k):
        raise AssertionError("a draw on meta")

    monkeypatch.setattr(prng, "normal", no_draw)
    monkeypatch.setattr(prng, "uniform", no_draw)
    for arch in ("hymba-1.5b", "mixtral-8x7b", "whisper-small"):
        m = TC.get_arch(arch)
        p = TTS.param_structs(m)         # bf16 by default, the reference's
        leaves = [t for t in jax.tree.leaves(p, is_leaf=torch.is_tensor)]
        assert all(t.is_meta and t.dtype == torch.bfloat16 for t in leaves)


def test_meta_shapes_are_the_cpu_draws_shapes_and_the_bits_stay():
    """The meta tree has the CPU draw's shapes (hymba: its SSM's A_log
    goes through the FMA helper too); the CPU draw keeps the reference's
    bits (the full check is ``tests/test_torch_lm_init.py``)."""
    m = TC.get_reduced("hymba-1.5b")
    cpu = TMB.init_params(prng.prng_key(torch.tensor(0)), m, "cpu")
    meta = TTS.param_structs(m)
    from repro_torch.optim import tree_leaves
    assert [t.shape for t in tree_leaves(cpu)] == \
        [t.shape for t in tree_leaves(meta)]
    arch = "stablelm-1.6b"
    want = JMB.init_params(jax.random.PRNGKey(0), JC.get_reduced(arch))
    got = TMB.init_params(prng.prng_key(torch.tensor(0)), TC.get_reduced(arch),
                          "cpu")
    assert np.array_equal(np.asarray(want["embed"]["table"]),
                          got["embed"]["table"].numpy())


# ---------------------------------------------------------------------------
# the tools
# ---------------------------------------------------------------------------
def test_roofline_row_has_the_references_keys():
    want = JRL.Roofline("x", 1e12, 1e9, 0.0, 1, model_flops=5e11).row()
    got = TRL.Roofline("x", 1e12, 1e9, 0.0, 1, model_flops=5e11).row()
    assert list(got) == list(want)


def test_roofline_sums_the_units():
    rl = TRL.from_counted("x", {"flops": 3e12, "hbm_bytes": 3.35e9,
                                "coll_bytes": 0.0, "flops_by_unit": {
                                    "fp32_simt": 67e10, "tf32x3": 494.7e10,
                                    "bf16": 989.4e10}})
    assert rl.t_compute == pytest.approx(0.01 + 0.03 + 0.01)
    assert rl.t_memory == pytest.approx(1e-3)
    assert rl.bottleneck == "compute" and rl.t_bound == rl.t_compute


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_mfu_bound_stays_at_or_under_one(dtype):
    m = TC.get_reduced("stablelm-1.6b")
    shape = Shape("t", 64, 4, "train")
    case = TTS.build_case(m, shape, dtype=dtype, remat=False)
    t = op_cost.analyze(case.fn, *case.args)
    rl = TRL.from_counted(case.name, t, 1,
                          model_flops=TDR.model_flops_for(m, shape,
                                                          case.args[0]),
                          dtype=str(dtype).split(".")[1])
    assert 0 < rl.mfu_bound <= 1


def test_run_cell_on_a_reduced_arch():
    rec = TDR.run_cell(TC.get_reduced("gemma3-1b"),
                       Shape("prefill_2x64", 64, 2, "prefill"))
    assert rec["status"] == "ok" and rec["fits"]
    assert rec["flops"] > 0 and rec["coll_bytes"] == 0
    assert rec["bytes_per_device"] >= rec["arg_bytes"] > 0
    assert set(JRL.Roofline("x", 1, 1, 0, 1).row()) - {"case"} <= set(rec)


def test_perf_main_on_a_reduced_arch(tmp_path, capsys):
    out = tmp_path / "perf.jsonl"
    assert TPF.main(["--arch", "stablelm-1.6b", "--reduced", "--batch", "2",
                     "--seq", "64", "--micro", "1,2", "--remat", "0,1",
                     "--out", str(out)]) == 0
    import json
    rows = [json.loads(line) for line in out.read_text().splitlines()]
    assert [(r["micro"], r["remat"]) for r in rows] == [
        (1, 0), (1, 1), (2, 0), (2, 1)]
    assert all(r["status"] == "ok" for r in rows)
    # remat recomputes the forward: more flops, a lower peak
    assert rows[1]["flops"] > rows[0]["flops"]
    assert rows[1]["bytes_per_device"] < rows[0]["bytes_per_device"]
    assert "[perf] micro=2 remat=1" in capsys.readouterr().out
