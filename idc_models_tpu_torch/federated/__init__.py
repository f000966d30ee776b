"""Federated averaging: server state, local training, the FedAvg round,
aggregators, the self-healing round driver, and population-scale rounds
(virtual clients, cohort sampling, streamed waves, buffered async)."""

from idc_models_tpu_torch.federated.robust import (  # noqa: F401
    Aggregator,
    Median,
    NormClip,
    TrimmedMean,
    WeightedMean,
    get_aggregator,
)
from idc_models_tpu_torch.federated.fedavg import (  # noqa: F401
    ServerState,
    copy_tree,
    initialize_server,
    load_server,
    make_fedavg_round,
    make_federated_eval,
    seed_server_with,
)
from idc_models_tpu_torch.federated.driver import (  # noqa: F401
    DriverConfig,
    DriverResult,
    RoundFailure,
    run_rounds,
)
from idc_models_tpu_torch.federated.population import (  # noqa: F401
    ClientPopulation,
    CohortSampler,
    make_population_round,
)
from idc_models_tpu_torch.federated.async_fedavg import (  # noqa: F401
    ensure_async_compatible,
    make_async_round,
)
