"""The population plane: lineages (:mod:`~apex_tpu_torch.population.
lineage`) and the PBT controller (:mod:`~apex_tpu_torch.population.
controller`, ``--role pbt-ctl``).

Counterpart of :mod:`apex_tpu.population`.  Each lineage is a tenant
(:class:`~apex_tpu_torch.population.lineage.LineageSpec` extends
:class:`~apex_tpu_torch.tenancy.namespace.TenantSpec`), so the tenant
partitions, infer entries and ``@tenant`` SLO signals carry a population
of learner lineages unchanged.
"""

from apex_tpu_torch.population.lineage import (HPARAM_BANDS, LineageSpec,
                                               apply_lineage,
                                               load_population)

__all__ = ["HPARAM_BANDS", "LineageSpec", "apply_lineage",
           "load_population"]
