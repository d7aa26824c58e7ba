"""mixtral-8x7b [moe] — 32L d=4096 32H (GQA kv=8) d_ff=14336 vocab=32000,
MoE 8 experts top-2, sliding-window attention (4096).  [arXiv:2401.04088]"""
from repro_torch.models.builders import decoder_arch

FULL = decoder_arch(
    "mixtral-8x7b", "moe", 32, 4096, 32, 8, 14336, 32000,
    head_dim=128, window=4096, n_experts=8, top_k=2, tied=False,
    theta=1e6, sub_quadratic=True,
    notes="SWA(4096) makes every layer banded -> long_500k eligible",
)

REDUCED = decoder_arch(
    "mixtral-8x7b-reduced", "moe", 2, 64, 4, 2, 128, 512,
    head_dim=16, window=32, n_experts=4, top_k=2, tied=False,
    sub_quadratic=True,
)
