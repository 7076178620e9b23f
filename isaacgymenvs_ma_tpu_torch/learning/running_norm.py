"""Running mean/std normalization (port of
isaacgymenvs_ma_tpu/learning/running_norm.py, the rl_games
``RunningMeanStd``).

The reference normalizes observations and values inside the rl_games model
(``normalize_input`` / ``normalize_value``).  Here it is a small object of
float32 tensors that ``update`` changes in place with Chan's parallel
merge.  Both the batch variance and the running one are population
variances (ddof 0), as ``jnp.var`` gives.  Under data parallelism
(parallel/mesh.py) ``update`` takes a ``reduce`` that sums over the ranks:
the batch's moments are then the global batch's (its sums and count, then
its centred sum of squares), merged in the same way.
"""
from __future__ import annotations

import torch

from ..device import DTYPE


class RunningMeanStd:
    def __init__(self, shape=(), device="cpu"):
        self.mean = torch.zeros(shape, dtype=DTYPE, device=device)
        self.var = torch.ones(shape, dtype=DTYPE, device=device)
        self.count = torch.tensor(1e-4, dtype=DTYPE, device=device)

    def update(self, batch: torch.Tensor, reduce=None) -> None:
        """Merge the batch's moments over all leading axes (Chan et al.);
        ``reduce`` (a sum over ranks) makes them the global batch's."""
        dims = tuple(range(batch.dim() - self.mean.dim()))
        b_count = float(batch.shape[:len(dims)].numel())   # exact in f32
        if reduce is None:
            b_mean = batch.mean(dim=dims)
            b_var = batch.var(dim=dims, correction=0)
        else:
            # equal shares: the count times the number of ranks, on the
            # device (no host wait)
            b_count = reduce(batch.new_ones(())) * b_count
            b_mean = reduce(batch.sum(dim=dims)) / b_count
            b_var = reduce(torch.square(batch - b_mean).sum(dim=dims)) \
                / b_count
        delta = b_mean - self.mean
        tot = self.count + b_count
        m2 = (self.var * self.count + b_var * b_count
              + torch.square(delta) * self.count * b_count / tot)
        self.mean = self.mean + delta * b_count / tot
        self.var = m2 / tot
        self.count = tot

    def normalize(self, x: torch.Tensor, clip: float = 5.0) -> torch.Tensor:
        y = (x - self.mean) / torch.sqrt(self.var + 1e-5)
        return torch.clamp(y, -clip, clip)

    def denormalize(self, y: torch.Tensor) -> torch.Tensor:
        return y * torch.sqrt(self.var + 1e-5) + self.mean

    def state_dict(self) -> dict:
        return {"mean": self.mean, "var": self.var, "count": self.count}

    def load_state_dict(self, d: dict) -> None:
        dev = self.mean.device
        self.mean, self.var, self.count = (
            torch.as_tensor(d[k], dtype=DTYPE).to(dev).clone()
            for k in ("mean", "var", "count"))
