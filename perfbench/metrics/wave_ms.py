"""Window milliseconds per decode step completed (``decode_calls``)."""


def read(run):
    if not run.decode_calls:
        return None
    return 1e3 * run.window_s / run.decode_calls
