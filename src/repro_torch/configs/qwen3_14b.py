"""qwen3-14b [dense] — 40L d=5120 40H (GQA kv=8) d_ff=17408 vocab=151936,
qk-norm.  [hf:Qwen/Qwen3-14B]"""
from repro_torch.models.builders import decoder_arch

FULL = decoder_arch(
    "qwen3-14b", "dense", 40, 5120, 40, 8, 17408, 151936,
    head_dim=128, qk_norm=True, tied=False, theta=1e6,
    notes="pure full attention -> long_500k skipped (DESIGN.md §4)",
)

REDUCED = decoder_arch(
    "qwen3-14b-reduced", "dense", 2, 64, 4, 2, 128, 512,
    head_dim=16, qk_norm=True, tied=False,
)
