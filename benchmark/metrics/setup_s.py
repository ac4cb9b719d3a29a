"""From the start of the process to the start of the window: imports, the
CUDA context, the dataset, the port's native library, the warm-up."""


def read(rec):
    return rec.setup_s
