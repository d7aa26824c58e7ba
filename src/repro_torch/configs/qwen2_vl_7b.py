"""qwen2-vl-7b [vlm] — 28L d=3584 28H (GQA kv=4) d_ff=18944 vocab=152064,
M-RoPE (temporal/height/width rotary sections), dynamic resolution.
[arXiv:2409.12191]

The vision patch frontend is a stub, as in the reference: a batch holds
token ids and, optionally, (3, B, S) M-RoPE position ids (all three rows
equal at text positions; without them the (B, S) text positions are
broadcast)."""
import torch

from repro_torch.models.builders import decoder_arch

FULL = decoder_arch(
    "qwen2-vl-7b", "vlm", 28, 3584, 28, 4, 18944, 152064,
    head_dim=128, mrope=(16, 24, 24), tied=False, theta=1e6,
    notes="pure full attention -> long_500k skipped (DESIGN.md §4); "
          "M-RoPE sections (16,24,24) over the 64 rotary half-dims",
)

REDUCED = decoder_arch(
    "qwen2-vl-reduced", "vlm", 2, 64, 4, 2, 128, 512,
    head_dim=16, mrope=(2, 3, 3), tied=False,
)


def vision_positions(batch: int, seq: int, text: int, grid: int,
                     device=None):
    """(3, batch, seq) M-RoPE position ids of a prompt laid out as
    Qwen2-VL lays out one image (arXiv:2409.12191 §2.1): `text` text
    tokens at t = h = w = 0 .. text-1, then a `grid` x `grid` image whose
    tokens share t = text and take h = text + row, w = text + col, then
    the remaining text tokens from text + grid on, all three rows equal."""
    rest = seq - text - grid * grid
    assert rest >= 0, (seq, text, grid)
    cell = torch.arange(grid * grid, device=device)
    lead = torch.arange(text, device=device)
    tail = torch.arange(rest, device=device) + text + grid
    rows = [torch.cat([lead, torch.full_like(cell, text), tail]),
            torch.cat([lead, text + cell // grid, tail]),
            torch.cat([lead, text + cell % grid, tail])]
    return torch.stack(rows)[:, None].expand(3, batch, seq)
