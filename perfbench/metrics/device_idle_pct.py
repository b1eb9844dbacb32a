"""Share of the traced slice in which no device event ran: one minus the
union of the device intervals over the slice's length."""


def read(run):
    tr = run.trace
    if not tr or not tr["window_s"] or not tr["busy_s"]:
        return None
    return 100.0 * (1.0 - tr["busy_s"] / tr["window_s"])
