"""The sharded (dp) learner over ``torch.distributed``.

Counterpart of :mod:`apex_tpu.parallel`: :mod:`~apex_tpu_torch.parallel.
mesh` (the dp group, its collectives and its rank processes),
:mod:`~apex_tpu_torch.parallel.learner` (:class:`~apex_tpu_torch.parallel.
learner.ShardedLearner`, one replay shard per rank) and
:mod:`~apex_tpu_torch.parallel.aggregate` (whole chunks round-robin onto
the ranks).  Nothing is imported here, so ``import apex_tpu_torch`` stays
stdlib-only.
"""
