"""Process start to the first due request: the CUDA context, the kernel
libraries, the weights drawn on the card and the warm-up batch."""


def read(run):
    return run.setup_s
