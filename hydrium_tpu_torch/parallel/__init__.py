"""Multi-device and multi-process encodes: LF groups spread over a list
of torch devices (driver.py, shard.py, dryrun.py) or over the processes
of a torch.distributed group (multihost.py)."""
