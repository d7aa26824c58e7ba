"""stablelm-1.6b [dense] — 24L d=2048 32H (kv=32: MHA) d_ff=5632
vocab=100352.  [hf:stabilityai/stablelm-2-1_6b]"""
from repro_torch.models.builders import decoder_arch

FULL = decoder_arch(
    "stablelm-1.6b", "dense", 24, 2048, 32, 32, 5632, 100352,
    tied=True,
    notes="pure full attention -> long_500k skipped (DESIGN.md §4)",
)

REDUCED = decoder_arch(
    "stablelm-1.6b-reduced", "dense", 2, 64, 4, 4, 128, 512, tied=True,
)
