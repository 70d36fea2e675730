from repro_torch.core.control.partition import (  # noqa: F401
    ControllerConfig, Decision, PartitionController,
)
