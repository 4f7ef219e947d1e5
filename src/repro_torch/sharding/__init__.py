from repro_torch.sharding.rules import (
    param_shardings, batch_shardings, state_shardings, DP_AXES, TP_AXIS,
    FSDP_AXIS)
