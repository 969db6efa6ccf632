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
from gym_fishing_tpu_torch.agents.dqn import DQNConfig, DQNPolicy, dqn_train
from gym_fishing_tpu_torch.agents.es import ESConfig, ESPolicy, es_train
from gym_fishing_tpu_torch.agents.policies import (
    escapement,
    msy,
    surplus_production_msy,
    user_action,
)
from gym_fishing_tpu_torch.agents.ppo import PPOConfig, PPOPolicy, train
from gym_fishing_tpu_torch.agents.ppo_rnn import RecurrentPPOPolicy, RPPOConfig
from gym_fishing_tpu_torch.agents.ppo_rnn import train as rppo_train
from gym_fishing_tpu_torch.agents.sb3_like import A2C, DQN, PPO, SAC, TD3
from gym_fishing_tpu_torch.agents.sac import SACConfig, SACPolicy, sac_train
from gym_fishing_tpu_torch.agents.td3 import TD3Config, TD3Policy, td3_train
