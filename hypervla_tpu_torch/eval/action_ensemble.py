"""Host-side action-chunk ensembling (copy of
hypervla_tpu/eval/action_ensemble.py; numpy only): ActionEnsembler for one
environment and BatchActionEnsembler for a batch of them. The serving step
ensembles on the device (ops/serving.py); these are its host reference. At control step t the policy has predicted the action for t in
the last `pred_action_horizon` chunks, weighted by exp(-temp * age)."""
from collections import deque

import numpy as np


class ActionEnsembler:
    """Single-environment variant: actions are (horizon, action_dim)."""

    def __init__(self, pred_action_horizon: int,
                 action_ensemble_temp: float = 0.0):
        self.pred_action_horizon = pred_action_horizon
        self.action_ensemble_temp = action_ensemble_temp
        self.action_history = deque(maxlen=self.pred_action_horizon)

    def reset(self):
        self.action_history.clear()

    def ensemble_action(self, cur_action) -> np.ndarray:
        self.action_history.append(np.asarray(cur_action))
        num_actions = len(self.action_history)
        # chunk predicted i steps ago contributes its i-th action
        curr_act_preds = np.stack(
            [
                pred_actions[i]
                for (i, pred_actions) in zip(
                    range(num_actions - 1, -1, -1), self.action_history
                )
            ]
        )
        weights = np.exp(-self.action_ensemble_temp * np.arange(num_actions))
        weights = weights / weights.sum()
        return np.sum(weights[:, None] * curr_act_preds, axis=0)


class BatchActionEnsembler:
    """Batched variant: actions are (batch, horizon, action_dim)."""

    def __init__(self, pred_action_horizon: int,
                 action_ensemble_temp: float = 0.0):
        self.pred_action_horizon = pred_action_horizon
        self.action_ensemble_temp = action_ensemble_temp
        self.action_history = deque(maxlen=self.pred_action_horizon)

    def reset(self):
        self.action_history.clear()

    def ensemble_action(self, cur_action) -> np.ndarray:
        self.action_history.append(np.asarray(cur_action))
        num_actions = len(self.action_history)
        curr_act_preds = np.stack(
            [
                pred_actions[:, i]
                for (i, pred_actions) in zip(
                    range(num_actions - 1, -1, -1), self.action_history
                )
            ]
        )
        weights = np.exp(-self.action_ensemble_temp * np.arange(num_actions))
        weights = weights / weights.sum()
        return np.sum(weights[:, None, None] * curr_act_preds, axis=0)
