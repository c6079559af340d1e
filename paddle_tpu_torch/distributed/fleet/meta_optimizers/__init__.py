"""Meta-optimizer program rewrites: gradient merge
(`gradient_merge_optimizer.apply_gradient_merge`) over the masked-update
helpers of `rewrite_utils`.  The strategy-driven `GradientMergeOptimizer`
wrapper and the other meta-optimizers wait for fleet (ROADMAP.md Queue 1,
Distribution)."""
