"""Layers as plain functions on tensors: the MLP of G and D, and the LM
substrate's RMSNorm, LayerNorm (whisper's), embedding and RoPE.

Params keep the reference package's layout — ``{"layers": [{"w": (in,
out), "b": (out,)}, ...]}``, ``{"scale"}``, ``{"table": (vocab, dim)}`` —
so the kernels read ``x @ w`` directly and converted params compare like
with like.  Across a 'model' axis the embedding is vocab parallel
(``embed_apply_vocab_parallel``).  M-RoPE (qwen2-vl's multimodal RoPE) rotates sections of the
rotary dims by the temporal, height and width rows of its positions.
"""
from __future__ import annotations

from typing import Callable, Optional, Sequence, Tuple

import torch

from repro_torch.core import prng
from repro_torch.kernels import dispatch as D


def mlp_init(key: torch.Tensor, in_dim: int, hidden: Sequence[int],
             out_dim: int, device):
    """The reference's ``mlp_init``, bit for bit: layer i draws its weights
    ``normal(split(keys[i])[0], (in, out)) * s`` from ``keys =
    split(key, n_layers)`` (``core/prng``; `key` a (2,) int64 threefry
    key), with s the He scale (ReLU layers) or 1/sqrt(in) at the linear
    head; zero biases.  All layers are drawn in one `prng.normals` call."""
    dims = [in_dim, *hidden, out_dim]
    keys = prng.split(key.to(device), len(dims) - 1)
    ws = prng.normals(prng.split(keys)[:, 0],
                      [i * o for i, o in zip(dims[:-1], dims[1:])])
    layers = []
    for i, w in enumerate(ws):
        last = i == len(ws) - 1
        s = (1.0 / dims[i]) ** 0.5 if last else (2.0 / dims[i]) ** 0.5
        layers.append({"w": w.reshape(dims[i], dims[i + 1]) * s,
                       "b": torch.zeros(dims[i + 1], dtype=torch.float32,
                                        device=device)})
    return {"layers": layers}


def mlp_apply(params, x: torch.Tensor,
              activation: Callable[[torch.Tensor], torch.Tensor] = torch.relu,
              use_fused: Optional[bool] = None) -> torch.Tensor:
    """Layer-by-layer MLP: hidden layers with `activation`, linear final
    layer — the training forward.  With ReLU every layer goes through
    ``kernels/dispatch.dense`` (the dense kernels and their backward on
    CUDA tensors; ``use_fused=False`` opts out to the plain version).  The
    kernels hard-wire ReLU, so another activation raises on an explicit
    ``use_fused=True`` and otherwise takes the plain path (it is never
    replaced by ReLU)."""
    layers = params["layers"]
    if activation is torch.relu:
        for p in layers[:-1]:
            x = D.dense(x, p["w"], p["b"], relu=True, use_fused=use_fused)
        return D.dense(x, layers[-1]["w"], layers[-1]["b"], relu=False,
                       use_fused=use_fused)
    if use_fused:
        raise ValueError(
            "mlp_apply(use_fused=True) supports only torch.relu — the dense "
            f"kernel hard-wires the ReLU epilogue; got {activation!r}. Pass "
            "use_fused=None/False to use the plain path.")
    for p in layers[:-1]:
        x = activation(x @ p["w"] + p["b"])
    return x @ layers[-1]["w"] + layers[-1]["b"]


def mlp_apply_chained(params, x: torch.Tensor,
                      use_fused: Optional[bool] = None) -> torch.Tensor:
    """Inference MLP forward (hidden ReLU, linear head) through the
    whole-MLP kernel on CUDA tensors (see ``kernels/fused_mlp.py``)."""
    return D.mlp_chain(params["layers"], x, use_fused=use_fused)


# ---------------------------------------------------------------------------
# the LM half: norms, embedding, RoPE
# ---------------------------------------------------------------------------
def rmsnorm_init(dim: int, device):
    return {"scale": torch.ones(dim, dtype=torch.float32, device=device)}


def rmsnorm_apply(params, x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    var = x.to(torch.float32).square().mean(-1, keepdim=True)
    y = x * torch.rsqrt(var + eps)
    return (y * params["scale"]).to(x.dtype)


def layernorm_init(dim: int, device):
    return {"scale": torch.ones(dim, dtype=torch.float32, device=device),
            "bias": torch.zeros(dim, dtype=torch.float32, device=device)}


def layernorm_apply(params, x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """The reference's LayerNorm: in float32, the population variance
    (``jnp.var``: the mean of the squared deviations), then cast back to
    x's dtype."""
    xf = x.to(torch.float32)
    centered = xf - xf.mean(-1, keepdim=True)
    var = centered.square().mean(-1, keepdim=True)
    y = centered * torch.rsqrt(var + eps)
    return (y * params["scale"] + params["bias"]).to(x.dtype)


def embed_init(key: torch.Tensor, vocab: int, dim: int, device):
    """The reference's ``embed_init``: ``normal(key, (vocab, dim)) *
    0.02`` (`key` a (2,) threefry key, ``core/prng``)."""
    return {"table": prng.normal_scaled(key, (vocab, dim), 0.02, device)}


def embed_apply(params, ids: torch.Tensor) -> torch.Tensor:
    """The table's rows at `ids`.  Through ``F.embedding``, whose backward
    sums each row's gradients in one fixed order on the CPU and on the
    card; indexing (``table[ids]``) sums them with atomic adds on the CPU,
    so two backward passes could differ in the last bits."""
    return torch.nn.functional.embedding(ids, params["table"])


def embed_logits(params, x: torch.Tensor) -> torch.Tensor:
    """Tied-embedding output head."""
    return x @ params["table"].t()


def embed_apply_vocab_parallel(params, ids: torch.Tensor, ax) -> torch.Tensor:
    """The embedding across a 'model' axis `ax` (``train/parallel``) whose
    rank r holds the table's vocab rows [r·Vr, (r+1)·Vr): each rank looks
    up the ids in its range, zeroes the others, and the ranks' rows are
    summed.  A sum of one row and zeros is that row: the result is the
    whole table's lookup, bit for bit."""
    from repro_torch.train import parallel as PAR

    table = params["table"]
    vr = table.shape[0]
    local = ids - ax.rank * vr
    mine = (local >= 0) & (local < vr)
    x = torch.nn.functional.embedding(local.clamp(0, vr - 1), table)
    return PAR.sum_over(torch.where(mine[..., None], x, 0.0), ax.group)


def rope_freqs(head_dim: int, theta: float = 10000.0, device=None):
    half = head_dim // 2
    return 1.0 / (theta ** (torch.arange(0, half, dtype=torch.float32,
                                         device=device) / half))


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float = 10000.0) -> torch.Tensor:
    """x: (..., seq, heads, head_dim); positions: broadcastable (..., seq)."""
    inv = rope_freqs(x.shape[-1], theta, x.device)             # (half,)
    ang = positions[..., :, None].to(torch.float32) * inv      # (..., seq, half)
    return _rotate(x, ang)


def _rotate(x: torch.Tensor, ang: torch.Tensor) -> torch.Tensor:
    """x (..., seq, heads, head_dim) with its two halves rotated by the
    angles (..., seq, half), shared by every head."""
    ang = ang[..., None, :]                                    # (..., seq, 1, half)
    cos, sin = torch.cos(ang), torch.sin(ang)
    x1, x2 = x.chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


def apply_mrope(x: torch.Tensor, positions_3d: torch.Tensor,
                sections: Tuple[int, int, int],
                theta: float = 10000.0) -> torch.Tensor:
    """Multimodal RoPE (Qwen2-VL): the rotary half-dims are cut into
    (temporal, height, width) sections, each rotated by its own row of
    the positions.

    x: (..., seq, heads, head_dim); positions_3d: (3, ..., seq);
    sections: the half-dims of each row, summing to head_dim // 2.  Each
    angle is the float32 product ``apply_rope`` forms, so where the three
    rows are equal the output has ``apply_rope``'s bits."""
    half = x.shape[-1] // 2
    assert sum(sections) == half, (sections, half)
    inv = rope_freqs(x.shape[-1], theta, x.device)             # (half,)
    angs, off = [], 0
    for axis, sec in enumerate(sections):
        p = positions_3d[axis]
        angs.append(p[..., :, None].to(torch.float32) * inv[off:off + sec])
        off += sec
    return _rotate(x, torch.cat(angs, dim=-1))
