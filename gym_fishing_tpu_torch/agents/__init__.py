from gym_fishing_tpu_torch.agents.dp import (
    MDP,
    DPSolution,
    build_mdp,
    dp,
    finite_horizon,
    policy_evaluation,
    value_iteration,
)
from gym_fishing_tpu_torch.agents.a2c import A2CConfig, A2CPolicy, a2c_train
from gym_fishing_tpu_torch.agents.es import ESConfig, ESPolicy, es_train
from gym_fishing_tpu_torch.agents.policies import (
    escapement,
    msy,
    surplus_production_msy,
    user_action,
)
from gym_fishing_tpu_torch.agents.ppo import PPOConfig, PPOPolicy, train
