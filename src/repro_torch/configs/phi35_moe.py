"""phi3.5-moe-42b-a6.6b [moe] — 32L d=4096 32H (GQA kv=8) d_ff=6400
vocab=32064, MoE 16 experts top-2, full attention.
[hf:microsoft/Phi-3.5-MoE-instruct]"""
from repro_torch.models.builders import decoder_arch

FULL = decoder_arch(
    "phi3.5-moe-42b-a6.6b", "moe", 32, 4096, 32, 8, 6400, 32064,
    head_dim=128, n_experts=16, top_k=2, tied=False,
    notes="pure full attention -> long_500k skipped (DESIGN.md §4)",
)

REDUCED = decoder_arch(
    "phi3.5-moe-reduced", "moe", 2, 64, 4, 2, 96, 512,
    head_dim=16, n_experts=4, top_k=2, tied=False,
)
