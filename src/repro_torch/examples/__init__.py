"""The reference's four user-facing flows on the port, each runnable as
``python -m repro_torch.examples.<name> [--device cpu]``:

* :mod:`~repro_torch.examples.quickstart` -- config -> model -> synthetic data
  -> AdamW under WSD -> ``Trainer`` with checkpoints; the loss must fall;
* :mod:`~repro_torch.examples.serve` -- replicas placed through the scheduler
  registry, then the paged-KV engine on a reduced glm4-9b;
* :mod:`~repro_torch.examples.schedule_and_launch` -- comm matrix, affinity,
  Arnold's MILP against packing, the Arnold rank grid and its spreads, then
  the meshed train step on an Arnold-ordered mesh;
* :mod:`~repro_torch.examples.elastic_failover` -- a training crash restored
  from its checkpoint, then backup-node promotion and constrained re-placement.

Each ``main(device=None)`` runs on the card unless asked for ``"cpu"``, prints
what the reference prints, checks what it asserts, ends with ``OK`` and returns
what it printed as a dict.
"""
