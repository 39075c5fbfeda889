"""Multi-view data parallelism on torch.distributed (sharding.py) and a
multi-process dry run of it (dryrun.py)."""
