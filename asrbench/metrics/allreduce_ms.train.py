"""Device ms on rank 0 from the step's `mark("backward")` to its
`mark("allreduce")`: the gradients (and the loss) joined into one buffer,
NCCL's all-reduce of it over the data ranks, the wait for the slowest
rank included, and the division by their number; mean a step."""


def read(r):
    return r.mean_ms("allreduce_train")
