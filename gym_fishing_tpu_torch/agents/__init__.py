from gym_fishing_tpu_torch.agents.policies import (
    escapement,
    msy,
    surplus_production_msy,
    user_action,
)
from gym_fishing_tpu_torch.agents.ppo import PPOConfig, PPOPolicy, train
