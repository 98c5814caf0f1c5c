"""Context parallelism over torch.distributed (counterpart of tokenhawk_tpu/parallel/).

Only the context-parallel (CP) part is ported: `mesh` (the ctx group),
`ring` (ring attention and the cross-shard decode merge) and `cp` (the
Engine's CP step functions).  Tensor and pipeline parallelism wait in
ROADMAP.md Queue 1 item 5."""
