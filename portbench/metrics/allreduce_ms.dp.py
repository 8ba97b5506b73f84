"""allreduce_ms.dp (ms): rank 0's device time a step of the work launched
under the port's ``trainer.all_reduce`` span (``engines/trainer.py``: the
flat buffer's concatenation, NCCL's all_reduce of every gradient and the
loss, the division, the copies back), in the traced steps
(``bench/spans.py``).  Silent unless each traced step holds one
``trainer.step``, ``trainer.forward``, ``trainer.backward``,
``trainer.update`` and ``trainer.all_reduce``.  Moves train_step_ms."""

from portbench.bench import spans


def read(rec):
    if spans.training(rec) is None:
        return None
    att = spans.for_record(rec)
    got = att.named("trainer.all_reduce")
    if len(got) != rec.profile.units:
        return None
    return 1e3 * att.device(got) / rec.profile.units


def lines(rec):
    return spans.lines(rec)
