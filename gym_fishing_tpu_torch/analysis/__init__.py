"""Evaluation. The plots (``analysis.plotting``) need matplotlib and pandas
and are imported where they are used; `simulate_mdp` and
`estimate_policyfn` import pandas only to build their frames."""

from gym_fishing_tpu_torch.analysis.simulate import estimate_policyfn, simulate_mdp
