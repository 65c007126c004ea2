"""Answers a batch over ``max_batch``, in percent, over the window
(``RuntimeMetrics``)."""


def read(run):
    batches = run.metrics_after.batches - run.metrics_before.batches
    answered = run.metrics_after.answered - run.metrics_before.answered
    return 100.0 * answered / batches / run.max_batch if batches else None
