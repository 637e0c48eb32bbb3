"""Faults planted in the program under `loops/train_dp.py`'s ranks, in
this process (by a test's monkeypatch) and in each follower (started
with `plant` ahead of its `follow`), for the tests that a broken
data-parallel step comes out not correct:
  - half_batch: every rank's loss over the first half of its shard, the
    mean taken over it;
  - rank_left_out: rank 0's shard left out of the gradients' all-reduce,
    the mean taken over the other ranks';
  - exchange_left_out: no all-reduce, every rank stepping on its own
    shard's gradient alone.
The all-reduce patched is the data ranks' (a group of more than one:
the "model" group of the step's mesh holds one rank)."""

import torch.distributed as dist

import gasr_tpu_torch.train as train

from asrbench.tests.test_asrbench_faults import _half_batch_loss

FAULTS = ("half_batch", "rank_left_out", "exchange_left_out")


def _rank_left_out(real):
    def all_reduce(t, *a, group=None, **kw):
        n = dist.get_world_size(group)
        if n == 1:
            return real(t, *a, group=group, **kw)
        if dist.get_rank() == 0:
            t.zero_()
        out = real(t, *a, group=group, **kw)
        t.mul_(n / (n - 1))
        return out
    return all_reduce


def _exchange_left_out(real):
    def all_reduce(t, *a, group=None, **kw):
        n = dist.get_world_size(group)
        if n == 1:
            return real(t, *a, group=group, **kw)
        t.mul_(n)                  # the step divides by n: its own mean
        return None
    return all_reduce


def plant(fault: str, setattr=setattr) -> None:
    """Break the program's step in this process by `fault`."""
    if fault == "half_batch":
        setattr(train, "batch_loss", _half_batch_loss(train.batch_loss))
    elif fault == "rank_left_out":
        setattr(dist, "all_reduce", _rank_left_out(dist.all_reduce))
    elif fault == "exchange_left_out":
        setattr(dist, "all_reduce", _exchange_left_out(dist.all_reduce))
    else:
        raise KeyError(fault)


def follower_code(fault: str, follow: str) -> str:
    """A follower's program (`train_dp.FOLLOW`) with `fault` planted
    first."""
    return (f"from asrbench.tests._dp_faults import plant; "
            f"plant({fault!r}); {follow}")
