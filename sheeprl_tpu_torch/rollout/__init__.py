"""The rollout plane (port in progress): only ``supervisor.RestartBudget``
so far, which the serving tier's supervisor uses."""
