"""Multi-process training over torch.distributed (counterpart of
moshi_tpu/parallel): the (dp, tp) mesh of ranks and its sharding rules
(mesh.py) and the collectives a train step needs (collectives.py)."""
