"""The multi-tenant plane: the tenant namespace
(:mod:`~apex_tpu_torch.tenancy.namespace`) and the placement scheduler
(:mod:`~apex_tpu_torch.tenancy.scheduler`, ``--role tenant-ctl``), the
counterpart of :mod:`apex_tpu.tenancy`."""
