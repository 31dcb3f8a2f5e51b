"""The parallel layer of the port on ``torch.distributed``: the mesh of
ranks (:mod:`.mesh`), the logical-axis rules and each rank's shard
(:mod:`.sharding`), and joining a world of processes
(:mod:`.distributed`). serve/multihost.py stands on all three. The
reference's pipeline and ring-attention programs (parallel/pipeline.py,
parallel/ring.py) are not ported."""
