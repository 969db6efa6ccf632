from gym_fishing_tpu_torch.bench.throughput import measure, measure_ppo_train
