from repro_torch.federated.runtime import (
    STRATEGIES, AsyncStrategy, RoundEvent, Strategy, SyncStrategy, TaskResult,
    get_strategy, register_strategy, run_async, run_sync, run_task,
)
from repro_torch.federated.real import RealLearner
from repro_torch.federated.surrogate import SurrogateLearner
