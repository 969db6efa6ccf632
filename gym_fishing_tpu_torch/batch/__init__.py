from gym_fishing_tpu_torch.batch.batch import (
    BatchState,
    RolloutStep,
    batched_reset,
    batched_step,
    batched_step_xi,
    rollout,
)
from gym_fishing_tpu_torch.batch.randomized import (
    make_param_sampler,
    randomized_reset,
    randomized_rollout,
    randomized_step,
)
