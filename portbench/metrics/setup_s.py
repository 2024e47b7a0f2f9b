"""setup_s (s): process start to the start of the timed window: the
objects drawn, the gateway loaded, the crash applied, every shape the
cell uses served once (autotune and first launches included)."""


def read(run):
    return run.setup_s
