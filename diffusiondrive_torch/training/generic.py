"""Generic training loop for simple (non-Transfuser) agents.

Counterpart of `diffusiondrive_tpu/training/generic.py` (the reference trains
any `AbstractAgent` through its Lightning module: forward on the feature
dict, `agent.compute_loss`, the agent's optimizer). The agent supplies
`model` (an `nn.Module` on `agent.device`, built by `initialize`), its
optimizer (`get_optimizers`: for EgoStatusMLP `torch.optim.Adam`, the
counterpart of `optax.adam`) and a loss over (features, targets,
predictions).
"""

from __future__ import annotations

import logging
from typing import Callable, Dict, Tuple

import numpy as np
import torch

logger = logging.getLogger(__name__)


def make_generic_train_step(model: torch.nn.Module, loss_fn: Callable, optimizer: torch.optim.Optimizer,
                            feature_keys: Tuple[str, ...], device: torch.device):
    """One optimizer step on a numpy batch for agents whose model maps its
    feature tensors (in `feature_keys` order) to a prediction dict (or the
    trajectory tensor); returns the loss (a 0-d tensor on the device)."""

    def step(batch: Dict[str, np.ndarray]) -> torch.Tensor:
        tensors = {k: torch.as_tensor(np.asarray(v)).to(device) for k, v in batch.items()}
        features = {k: tensors[k] for k in feature_keys}
        targets = {k: v for k, v in tensors.items() if k not in feature_keys}
        preds = model(*[features[k] for k in feature_keys])
        if not isinstance(preds, dict):
            preds = {"trajectory": preds}
        loss = loss_fn(features, targets, preds)
        optimizer.zero_grad(set_to_none=True)
        loss.backward()
        optimizer.step()
        return loss.detach()

    return step


def train_agent(agent, dataset, batch_size: int, num_epochs: int, seed: int = 0, log_every: int = 50):
    """Train a simple agent (e.g. EgoStatusMLPAgent) from a Dataset."""
    from diffusiondrive_torch.training.dataset import batch_iterator

    agent.initialize()
    optimizer = agent.get_optimizers()
    features0, _ = dataset[0]
    step = make_generic_train_step(agent.model, agent.compute_loss, optimizer, tuple(features0.keys()),
                                   agent.device)
    agent.model.train()
    for epoch in range(num_epochs):
        losses = []
        for count, batch in enumerate(batch_iterator(dataset, batch_size, seed=seed + epoch)):
            losses.append(float(step(batch)))
            if (count + 1) % log_every == 0:
                logger.info("epoch %d step %d loss %.4f", epoch, count + 1, losses[-1])
        logger.info("epoch %d mean loss %.4f", epoch, float(np.mean(losses)) if losses else float("nan"))
    agent.model.eval()
    return agent
