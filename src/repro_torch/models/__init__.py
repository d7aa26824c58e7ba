from repro_torch.models import base, builders  # noqa: F401
