"""Multi-device training and the dry-run's counter: the port's counterpart
of ``repro.distributed``.  ``sharding`` holds the rule table,
``collectives`` the cost models and the two mesh-axis collectives,
``elastic`` moves host leaves onto a mesh and back, ``pipeline`` the
GPipe schedule, and ``cost_analysis`` counts what a traced step does on
each device (the counterpart of ``hlo_analysis``)."""
from repro_torch.distributed.sharding import ShardingRules, placements

__all__ = ["ShardingRules", "placements"]
