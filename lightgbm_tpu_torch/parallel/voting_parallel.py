"""The voting-parallel (PV-Tree) train step over a torch.distributed
group (counterpart of lightgbm_tpu/parallel/voting_parallel.py; the
reference's VotingParallelTreeLearner): rows split like the data
learner, histograms stay local, each rank votes its top_k features by
local gain, and only the 2 top_k winners' histograms are summed (the
partitioned grower's "voting" mode)."""
from __future__ import annotations

from ._common import make_step


def make_voting_parallel_train_step(meta, cfg, num_bins_max: int,
                                    learning_rate: float, objective=None,
                                    top_k: int = 20, group=None):
    """The data step's contract, with the exchange bounded by the vote."""
    return make_step("voting", meta, cfg, num_bins_max, learning_rate,
                     objective, group, top_k)
