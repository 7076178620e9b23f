"""Multi-process data parallelism of the port (counterpart of
isaacgymenvs_ma_tpu/parallel): ``mesh`` splits the envs over
``torch.distributed`` ranks, ``dryrun`` checks it on three tasks."""
