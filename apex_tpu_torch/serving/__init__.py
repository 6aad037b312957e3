"""The serving tier: model-version fencing
(:mod:`~apex_tpu_torch.serving.fence`), identity-hashed infer-shard
routing (:mod:`~apex_tpu_torch.serving.shard`) and the deployment
controller (:mod:`~apex_tpu_torch.serving.deploy`, ``--role serve-ctl``).

Counterpart of :mod:`apex_tpu.serving`.  The submodules import lazily:
``deploy`` is stdlib at module level, so the learner reads
:class:`~apex_tpu_torch.serving.deploy.ServingStat` without zmq."""
