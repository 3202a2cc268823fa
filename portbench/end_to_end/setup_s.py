"""``setup_s``: seconds from the process's start to the window's opening:
the interpreter, ``import torch`` and the program, the kernel library's
load (its build with nvcc in a checkout's first run), the pool made on the
device and one warm call of each pool pair."""


def read(r):
    return r.setup_s
