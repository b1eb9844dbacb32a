"""``flash_decode``'s share of its roofline in the traced slice: the least
time of every call the slice's decode steps made (``peaks.py``: the K/V
rows at the lengths the harness logged, q and the output, the lengths,
at the card's published peaks) over the profiled time of the kernels
whose name holds ``flash_decode``."""


def read(run):
    tr = run.trace
    if not tr or not tr["fd_s"] or not tr["fd_bound_s"]:
        return None
    return 100.0 * tr["fd_bound_s"] / tr["fd_s"]
