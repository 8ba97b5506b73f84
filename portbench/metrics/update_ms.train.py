"""update_ms.train (ms): the device time a step of the work launched under
the port's ``trainer.update`` span (``engines/trainer.py``), in the traced
steps (``bench/spans.py``).  Silent unless each traced step holds one
``trainer.step``, ``trainer.forward``, ``trainer.backward`` and
``trainer.update``.  Moves train_step_ms."""

from portbench.bench import spans


def read(rec):
    s = spans.training(rec)
    return None if s is None else s["update_ms"]


def lines(rec):
    return spans.lines(rec)
