"""paddle_tpu_torch.distributed — the parts of paddle_tpu/distributed/ that
single-device training uses: the gradient-merge rewrite of
fleet/meta_optimizers (behind `static.gradient_merge`).  Data parallel,
ZeRO, tensor parallel and the fleet strategy are the distribution slice
(ROADMAP.md Queue 1, Distribution)."""
