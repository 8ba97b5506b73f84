"""edge_idle_ms.train (ms): the device's idle time a step in the gaps whose
midpoint lies outside ``trainer.forward`` and ``trainer.backward``: the
step's edges (the update, the loss and norm reads of ``trainer.sync``, the
next batch's preparation and draws), in the traced steps
(``bench/spans.py``).  Silent unless each traced step holds one
``trainer.step``, ``trainer.forward``, ``trainer.backward`` and
``trainer.update``.  Moves train_step_ms."""

from portbench.bench import spans


def read(rec):
    s = spans.training(rec)
    return None if s is None else s["edge_idle_ms"]


def lines(rec):
    return spans.lines(rec)
