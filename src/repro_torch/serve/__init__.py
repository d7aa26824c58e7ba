"""Micro-batching DSE serving on the card.

Single DSE requests -> per-model queues -> pow2-bucketed micro-batches ->
one `explore_tasks` dispatch each -> per-request `DSEResult`s, with an LRU
result cache and a multi-model registry with params hot-swap.  See
`repro_torch.serve.server.DSEServer` for the sync event-loop semantics and
`repro_torch.serve.frontend.ServeFrontend` for the concurrent production
front end (futures, continuous batching, admission control, deadlines,
load shedding); `repro_torch.serve.faults` injects faults for the fault
runs; `repro_torch.serve.online` closes the train-while-serve loop
(harvest hard tasks -> incremental train -> checkpoint -> lock-disciplined
hot swap).
"""
from repro_torch.serve.batcher import MicroBatch, MicroBatcher  # noqa: F401
from repro_torch.serve.cache import ResultCache  # noqa: F401
from repro_torch.serve.faults import (FaultPlan, FaultyEngine,  # noqa: F401
                                      InjectedFault, corrupt_checkpoint)
from repro_torch.serve.frontend import (FrontendConfig,  # noqa: F401
                                        ServeFrontend)
from repro_torch.serve.online import (HardReplay, HardTaskBuffer,  # noqa: F401
                                      OnlineConfig, OnlineLoop,
                                      mine_hard_examples)
from repro_torch.serve.request import (DSERequest, DSEResponse,  # noqa: F401
                                       SOURCE_CACHE, SOURCE_COALESCED,
                                       SOURCE_DISPATCH, SOURCE_FAILED,
                                       SOURCE_REJECTED)
from repro_torch.serve.server import DSEServer, ServeConfig  # noqa: F401
