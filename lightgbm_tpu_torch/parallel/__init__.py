"""The distributed learners' launch and collectives (counterpart of
lightgbm_tpu/parallel/): `launch` brings a torch.distributed process
group up from the reference's machine list, `comm` holds the collectives
the growers and the boosting loop exchange through, and `find_bin` the
distributed bin boundaries."""
