"""The whole decode step's model FLOPs utilisation over the window: the
model FLOPs (``flops.py``) of every token the window's decode steps
carried, prompt and output, over the window's seconds times the card's
published dense bf16 peak."""


def read(run):
    if not run.model_flops or not run.window_s:
        return None
    return 100.0 * run.model_flops / (run.window_s * run.peak_flops)
