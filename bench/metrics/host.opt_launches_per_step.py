"""The optimizer's launches a step in a cell that host dispatch paces: the
kernels of the full pass whose launch call has one of the program's
``optim.*`` spans on its stack (on any thread), over the pass's steps:
the server's and the clients' updates together. Exact and the same from
run to run. Left out where the program records no such span.

Layer: the optimizer and host dispatch (``optim/sgd.py``: one
elementwise chain for each parameter leaf). Moves ``peak_mem_gib``, the
cell's end-to-end metric besides ``setup_s``; ``host.samples_per_s`` is
the rate it bears on."""
from bench import spans


def read(trace):
    return spans.launches_under(trace, ("optim.",))
