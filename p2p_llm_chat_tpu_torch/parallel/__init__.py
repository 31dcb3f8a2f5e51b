"""The parallel layer of the port on ``torch.distributed``: the mesh of
ranks and its collectives, the shift along a ring or a chain included
(:mod:`.mesh`), the logical-axis rules and each rank's shard, a pipeline
stage's layers among them (:mod:`.sharding`), joining a world of
processes (:mod:`.distributed`), and the reference's two programs over
the ``pp`` and ``sp`` axes: pipeline-parallel prefill and decode
(:mod:`.pipeline`) and ring-attention prefill with sequence-parallel
decode, composed with ``tp`` or ``ep`` (:mod:`.ring`). serve/multihost.py
and serve/tp.py stand on the first three."""
