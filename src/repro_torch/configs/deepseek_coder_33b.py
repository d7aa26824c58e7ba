"""deepseek-coder-33b [dense] — 62L d=7168 56H (GQA kv=8) d_ff=19200
vocab=32256, llama-arch.  [arXiv:2401.14196]"""
from repro_torch.models.builders import decoder_arch

FULL = decoder_arch(
    "deepseek-coder-33b", "dense", 62, 7168, 56, 8, 19200, 32256,
    head_dim=128, tied=False,
    notes="pure full attention -> long_500k skipped (DESIGN.md §4)",
)

REDUCED = decoder_arch(
    "deepseek-coder-reduced", "dense", 2, 64, 4, 2, 128, 512,
    head_dim=16, tied=False,
)
