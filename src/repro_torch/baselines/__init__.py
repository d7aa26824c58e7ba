from repro_torch.baselines.sa import SimulatedAnnealing  # noqa: F401
from repro_torch.baselines.mlp import LargeMLP  # noqa: F401
from repro_torch.baselines.drl import PolicyGradientDRL  # noqa: F401
from repro_torch.baselines.random_search import RandomSearch  # noqa: F401
