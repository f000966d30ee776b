"""Federated averaging: server state, local training, the FedAvg round,
aggregators and the self-healing round driver."""

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
