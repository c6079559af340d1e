"""fleet: the meta-optimizer rewrites the port has (gradient merge);
`fleet.init`, `DistributedStrategy` and `distributed_optimizer` are the
distribution slice (ROADMAP.md Queue 1, Distribution)."""
