"""Device milliseconds per decode step in the traced slice: the summed
duration of every device event (kernels, copies, fills; one stream)
over the decode steps completed in the slice, as ``profile_waves`` of
``src/repro_torch/launch/serve.py`` sums them."""


def read(run):
    tr = run.trace
    if not tr or not tr["decode_calls"] or not tr["device_s"]:
        return None
    return 1e3 * tr["device_s"] / tr["decode_calls"]
