"""Programs the service captured (``compile_counts``) inside the window:
a capture there is set-up work that leaked into the measured time."""


def read(run):
    return run.captures
