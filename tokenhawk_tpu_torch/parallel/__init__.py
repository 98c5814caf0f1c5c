"""Parallelism over torch.distributed (counterpart of tokenhawk_tpu/parallel/).

One process a rank, one device each; an axis of the reference's mesh is a
process group (`mesh`):

  - tensor parallelism: `tp` (the Engine's and the dense Scheduler's step
    functions), `tp_paged` (the PagedScheduler's) over the model axis;
    runtime/sharded_loader.py reads a rank's shard of a file;
  - context parallelism: `ring` (ring attention and the cross-shard decode
    merge) and `cp` (the Engine's CP step functions) over the ctx axis;
  - `multihost` (joining the group under torchrun) and
    `multihost_serving` (the lockstep server: rank 0 broadcasts each
    step's admissions to the other ranks).

Data parallelism (dp > 1) and pipeline parallelism wait in ROADMAP.md
Queue 1 items 4 and 5."""
